// The WFA window-graph builder, hn_wfa_build: the one source of it, included
// by the native host library (hiphase_native.cc) and by the device WFA's
// window packer (wfa_pack.cc), so that both build the same graphs.
//
// The text between the markers is native/hiphase_native.cc's builder line
// for line (tests/test_torch_native_build.py holds it so).

#ifndef HIPHASE_TPU_TORCH_WFA_BUILD_H_
#define HIPHASE_TPU_TORCH_WFA_BUILD_H_

#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

// ---- hn_wfa_build: begin ----
extern "C" {

// Graph construction for the WFA window (the native form of
// align/wfa_graph.py::from_reference_variants_with_hom;
// ref: wfa_graph.rs:119-284).
//
// Inputs are the window's variants sorted by position (hets carry their
// variant index in var_index, homs carry -1; ignored/out-of-window variants
// must be pre-filtered by the caller):
//   a0_is_alt: 1 when allele0 is itself an ALT (multi-allelic)
//   allele blobs: truncated alleles (prefix/postfix removed)
// Outputs (caller-allocated, capacities in *_cap):
//   node_off/node_blob: node sequences
//   edge_off/edge_dst:  successor lists per node
//   alle_node/alle_var/alle_val: node→(variant, allele) triples
// Returns number of nodes, or -1 on capacity overflow.
int64_t hn_wfa_build(const uint8_t* reference, int64_t ref_start,
                     int64_t ref_end, int32_t n_variants,
                     const int64_t* var_pos, const int64_t* var_ref_len,
                     const int32_t* var_index, const uint8_t* a0_is_alt,
                     const uint8_t* a_blob,
                     const int64_t* a0_off, const int64_t* a0_len,
                     const int64_t* a1_off, const int64_t* a1_len,
                     int64_t* node_off, uint8_t* node_blob,
                     int64_t node_cap, int64_t blob_cap,
                     int64_t* edge_off, int32_t* edge_dst, int64_t edge_cap,
                     int32_t* alle_node, int32_t* alle_var, uint8_t* alle_val,
                     int64_t alle_cap, int64_t* n_alleles_out) {
  struct Reconnect {
    int64_t pos;
    int64_t order;
    int32_t node;
    bool operator>(const Reconnect& o) const {
      return pos != o.pos ? pos > o.pos : order > o.order;
    }
  };
  std::priority_queue<Reconnect, std::vector<Reconnect>,
                      std::greater<Reconnect>> reconnect_queue;
  int64_t push_counter = 0;

  int64_t n_nodes = 0;
  int64_t blob_len = 0;
  int64_t n_edges = 0;
  int64_t n_alleles = 0;
  std::vector<int32_t> reference_reconnect;
  std::vector<std::pair<int32_t, uint8_t>> reference_alleles;

  std::vector<std::pair<int32_t, int32_t>> edge_pairs;  // (parent, child)

  auto add_node = [&](const uint8_t* seq, int64_t len,
                      const std::vector<int32_t>& parents) -> int64_t {
    if (n_nodes >= node_cap || blob_len + len > blob_cap ||
        n_edges + static_cast<int64_t>(parents.size()) > edge_cap) {
      return -1;
    }
    std::memcpy(node_blob + blob_len, seq, len);
    node_off[n_nodes] = blob_len;
    blob_len += len;
    for (int32_t p : parents) {
      edge_pairs.emplace_back(p, static_cast<int32_t>(n_nodes));
      ++n_edges;
    }
    return n_nodes++;
  };

  auto flush_reference_alleles = [&](int64_t node) -> bool {
    for (auto& pa : reference_alleles) {
      if (n_alleles >= alle_cap) return false;
      alle_node[n_alleles] = static_cast<int32_t>(node);
      alle_var[n_alleles] = pa.first;
      alle_val[n_alleles] = pa.second;
      ++n_alleles;
    }
    reference_alleles.clear();
    return true;
  };

  int64_t previous_end = ref_start;

  auto drain = [&](int64_t limit) -> bool {
    while (!reconnect_queue.empty() && reconnect_queue.top().pos <= limit) {
      Reconnect rc = reconnect_queue.top();
      reconnect_queue.pop();
      int64_t ref_index = add_node(reference + previous_end,
                                   rc.pos - previous_end,
                                   reference_reconnect);
      if (ref_index < 0 || !flush_reference_alleles(ref_index)) return false;
      previous_end = rc.pos;
      reference_reconnect.assign({static_cast<int32_t>(ref_index), rc.node});
      while (!reconnect_queue.empty() &&
             reconnect_queue.top().pos == rc.pos) {
        reference_reconnect.push_back(reconnect_queue.top().node);
        reconnect_queue.pop();
      }
    }
    return true;
  };

  for (int32_t vi = 0; vi < n_variants; ++vi) {
    int64_t pos = var_pos[vi];
    int64_t ref_len = var_ref_len[vi];
    if (pos < ref_start || pos + ref_len > ref_end) continue;
    if (!drain(pos)) return -1;

    if (previous_end < pos || n_nodes == 0) {
      int64_t ref_index = add_node(reference + previous_end,
                                   pos - previous_end, reference_reconnect);
      if (ref_index < 0 || !flush_reference_alleles(ref_index)) return -1;
      reference_reconnect.assign({static_cast<int32_t>(ref_index)});
      previous_end = pos;
    }

    if (a0_is_alt[vi]) {
      int64_t alt = add_node(a_blob + a0_off[vi], a0_len[vi],
                             reference_reconnect);
      if (alt < 0) return -1;
      if (var_index[vi] >= 0) {
        if (n_alleles >= alle_cap) return -1;
        alle_node[n_alleles] = static_cast<int32_t>(alt);
        alle_var[n_alleles] = var_index[vi];
        alle_val[n_alleles] = 0;
        ++n_alleles;
      }
      reconnect_queue.push({pos + ref_len, push_counter++,
                            static_cast<int32_t>(alt)});
    } else if (var_index[vi] >= 0) {
      reference_alleles.emplace_back(var_index[vi], 0);
    }

    int64_t alt = add_node(a_blob + a1_off[vi], a1_len[vi],
                           reference_reconnect);
    if (alt < 0) return -1;
    if (var_index[vi] >= 0) {
      if (n_alleles >= alle_cap) return -1;
      alle_node[n_alleles] = static_cast<int32_t>(alt);
      alle_var[n_alleles] = var_index[vi];
      alle_val[n_alleles] = 1;
      ++n_alleles;
    }
    reconnect_queue.push({pos + ref_len, push_counter++,
                          static_cast<int32_t>(alt)});
  }

  if (!drain(INT64_MAX)) return -1;
  if (add_node(reference + previous_end, ref_end - previous_end,
               reference_reconnect) < 0) {
    return -1;
  }
  if (!reference_alleles.empty()) return -1;  // should be impossible

  node_off[n_nodes] = blob_len;
  *n_alleles_out = n_alleles;

  // materialize CSR edges
  std::vector<std::vector<int32_t>> succ(n_nodes);
  for (auto& pc : edge_pairs) {
    succ[pc.first].push_back(pc.second);
  }
  int64_t off = 0;
  std::vector<int32_t> flat;
  flat.reserve(n_edges);
  std::vector<int64_t> offs(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_nodes; ++i) {
    offs[i] = off;
    for (int32_t c : succ[i]) flat.push_back(c);
    off += static_cast<int64_t>(succ[i].size());
  }
  offs[n_nodes] = off;
  std::memcpy(edge_off, offs.data(), (n_nodes + 1) * sizeof(int64_t));
  std::memcpy(edge_dst, flat.data(), off * sizeof(int32_t));
  return n_nodes;
}

}  // extern "C"
// ---- hn_wfa_build: end ----

#endif  // HIPHASE_TPU_TORCH_WFA_BUILD_H_
