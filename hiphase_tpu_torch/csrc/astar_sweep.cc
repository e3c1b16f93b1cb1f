// The host A* oracle's right-to-left heuristic sweep in C++: the array
// H[0..nv] whose root value H[0] the --stats-file reports as
// `estimated_cost`.
//
// An exact twin of hiphase_tpu_torch/phasing/astar.py's
// calculate_astar_heuristic, astar_subsolver, _extend and
// _BlockReads.delta (ref: astar_phaser.rs:246-405), which stay there as
// the oracle the tests compare this with. For each variant, right to left,
// an unpruned best-first search over the window [v, v + max_clip_size)
// with a budget of min_queue_size // 10 + queue_increment * problem_size
// visits. Nodes are kept in flat arrays indexed by their node index (one
// counter a sub-solve, the root 0), with each node's per-read cost pairs
// in an arena over the reads local to the window, reused by every
// sub-solve: a child is a copy of its parent's pairs plus an update of
// the reads that overlap its column, and allocates nothing.
//
// Plain C ABI for ctypes. Build: g++ -O3 -std=c++17 -fPIC -shared.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <tuple>
#include <vector>

namespace {

constexpr uint8_t kRef = 0, kAlt = 1, kAmb = 2;
// extension order: heterozygous options first (ref: astar_phaser.rs:535-540)
constexpr uint8_t kHapOrder[4][2] = {
    {kRef, kAlt}, {kAlt, kRef}, {kRef, kRef}, {kAlt, kAlt}};

// One read at one column: the read's index (block-wide, or local to the
// window), its allele and its qual there.
struct Entry {
  int32_t read;
  uint8_t allele;
  uint8_t qual;
};

// A node's place in the queue: the reference's (Reverse(cost), hets,
// Reverse(idx)) max-queue as a min-queue of (cost + heuristic, -num_hets,
// node_index). Node indices are unique, so every pop order is heapq's.
struct Key {
  int64_t total;
  int32_t neg_hets;
  int32_t index;
  bool operator>(const Key& o) const {
    return std::tie(total, neg_hets, index) >
           std::tie(o.total, o.neg_hets, o.index);
  }
};

class Sweep {
 public:
  Sweep(int32_t nv, int32_t n_reads, const int32_t* seg_start,
        const int32_t* seg_end, const int64_t* seg_off,
        const uint8_t* alleles, const uint8_t* quals)
      : col_ptr_(nv + 1, 0), local_of_(n_reads, -1) {
    // a read overlaps column j when start <= j < end, whatever its
    // allele there (_BlockReads.overlapping)
    for (int32_t r = 0; r < n_reads; ++r)
      for (int32_t j = seg_start[r]; j < seg_end[r]; ++j) ++col_ptr_[j + 1];
    for (int32_t j = 0; j < nv; ++j) col_ptr_[j + 1] += col_ptr_[j];
    col_.resize(col_ptr_[nv]);
    std::vector<int64_t> fill(col_ptr_.begin(), col_ptr_.end() - 1);
    for (int32_t r = 0; r < n_reads; ++r)
      for (int32_t j = seg_start[r]; j < seg_end[r]; ++j) {
        int64_t at = seg_off[r] + (j - seg_start[r]);
        col_[fill[j]++] = {r, alleles[at], quals[at]};
      }
  }

  // astar_subsolver: max over x of best_path(o..o+x) + H[o+x], and the
  // depth it reached. False where the Python body's assertion would fail.
  bool subsolve(int32_t o, int32_t problem_size, const int64_t* heuristics,
                const uint8_t* bad, int64_t max_visits, int64_t* max_cost,
                int64_t* solve_size) {
    window(o, problem_size);
    cost_.clear();
    heuristic_.clear();
    depth_.clear();
    hets_.clear();
    identical_.clear();
    heap_.clear();
    add_node(0, heuristics[o + 1], 0, 0, true);
    std::fill(pairs_.begin(), pairs_.begin() + stride_, 0);
    heap_.push_back({heuristics[o + 1], 0, 0});

    int64_t next_expected = 0;
    int64_t max_cost_so_far = 0;
    int64_t nodes_visited = 0;
    while (depth_[heap_.front().index] < problem_size &&
           nodes_visited < max_visits) {
      std::pop_heap(heap_.begin(), heap_.end(), std::greater<Key>());
      int32_t top = heap_.back().index;
      heap_.pop_back();
      int32_t allele_count = depth_[top];
      ++nodes_visited;
      if (allele_count == next_expected) {
        max_cost_so_far =
            std::max(max_cost_so_far, cost_[top] + heuristic_[top]);
        ++next_expected;
      }
      int64_t h_next = heuristics[o + allele_count + 1];
      if (bad[o + allele_count]) {
        int32_t child = extend(top, kAmb, kAmb, h_next);
        if (cost_[child] + heuristic_[child] != cost_[top] + heuristic_[top])
          return false;
        push(child);
      } else {
        for (const auto& hap : kHapOrder) {
          if (hap[0] == kAlt && hap[1] == kRef && identical_[top]) continue;
          push(extend(top, hap[0], hap[1], h_next));
        }
      }
    }
    int32_t front = heap_.front().index;
    if (depth_[front] == problem_size) {
      max_cost_so_far =
          std::max(max_cost_so_far, cost_[front] + heuristic_[front]);
      ++next_expected;
    }
    *max_cost = max_cost_so_far;
    *solve_size = next_expected - 1;
    return true;
  }

 private:
  // The window's columns with window-local read indices, and the stride
  // of a node's cost pairs (two a local read).
  void window(int32_t o, int32_t problem_size) {
    locals_.clear();
    win_.clear();
    win_ptr_.assign(1, 0);
    for (int32_t c = 0; c < problem_size; ++c) {
      for (int64_t k = col_ptr_[o + c]; k < col_ptr_[o + c + 1]; ++k) {
        const Entry& e = col_[k];
        int32_t& local = local_of_[e.read];
        if (local < 0) {
          local = static_cast<int32_t>(locals_.size());
          locals_.push_back(e.read);
        }
        win_.push_back({local, e.allele, e.qual});
      }
      win_ptr_.push_back(static_cast<int64_t>(win_.size()));
    }
    for (int32_t r : locals_) local_of_[r] = -1;
    stride_ = 2 * static_cast<int64_t>(locals_.size());
  }

  int32_t add_node(int64_t cost, int64_t heuristic, int32_t depth,
                   int32_t hets, bool identical) {
    int32_t index = static_cast<int32_t>(cost_.size());
    cost_.push_back(cost);
    heuristic_.push_back(heuristic);
    depth_.push_back(depth);
    hets_.push_back(hets);
    identical_.push_back(identical ? 1 : 0);
    size_t need = static_cast<size_t>(index + 1) * stride_;
    if (pairs_.size() < need) pairs_.resize(std::max(need, 2 * pairs_.size()));
    return index;
  }

  void push(int32_t node) {
    heap_.push_back({cost_[node] + heuristic_[node], -hets_[node], node});
    std::push_heap(heap_.begin(), heap_.end(), std::greater<Key>());
  }

  // _extend: the (a1, a2) child of `parent`, with the next node index.
  int32_t extend(int32_t parent, uint8_t a1, uint8_t a2, int64_t heuristic) {
    int32_t child =
        add_node(cost_[parent], heuristic, depth_[parent] + 1,
                 hets_[parent] + (a1 != a2 ? 1 : 0),
                 identical_[parent] && a1 == a2);
    int64_t* pairs = pairs_.data() + child * stride_;
    if (stride_ > 0)
      std::memcpy(pairs, pairs_.data() + parent * stride_,
                  stride_ * sizeof(int64_t));
    int64_t cost = cost_[child];
    int32_t c = depth_[parent];
    for (int64_t k = win_ptr_[c]; k < win_ptr_[c + 1]; ++k) {
      const Entry& e = win_[k];
      int64_t& c1 = pairs[2 * e.read];
      int64_t& c2 = pairs[2 * e.read + 1];
      int64_t old = std::min(c1, c2);
      // _BlockReads.delta: nothing for an unset haplotype allele, else the
      // read's qual where its allele differs
      if (a1 < kAmb && e.allele != a1) c1 += e.qual;
      if (a2 < kAmb && e.allele != a2) c2 += e.qual;
      cost += std::min(c1, c2) - old;
    }
    cost_[child] = cost;
    return child;
  }

  std::vector<int64_t> col_ptr_;  // the block's columns: CSR over col_
  std::vector<Entry> col_;
  std::vector<int32_t> local_of_;  // block read -> local index, -1 outside
  std::vector<int32_t> locals_;    // the window's block reads
  std::vector<Entry> win_;         // the window's columns, local reads
  std::vector<int64_t> win_ptr_;
  int64_t stride_ = 0;
  // the sub-solve's nodes, by node index
  std::vector<int64_t> cost_, heuristic_;
  std::vector<int32_t> depth_, hets_;
  std::vector<uint8_t> identical_;
  std::vector<int64_t> pairs_;  // node k's (c1, c2) pairs at k * stride_
  std::vector<Key> heap_;
};

// Python's floor division by a positive divisor.
int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

}  // namespace

extern "C" {

// calculate_astar_heuristic over one block of `nv` variants and `n_reads`
// reads: read r covers columns [seg_start[r], seg_end[r]) and its alleles
// and quals there are alleles[seg_off[r]..] and quals[seg_off[r]..].
// `ignored` seeds the bad variants. Writes heuristics[0..nv] and
// bad_variants[0..nv). Returns 0; -1 on inputs out of range; -2 where one
// of the Python sweep's assertions fails (its caller runs the Python body,
// which raises).
int32_t hn_astar_heuristic(int32_t nv, int32_t max_segment_size,
                           int32_t n_reads, const int32_t* seg_start,
                           const int32_t* seg_end, const int64_t* seg_off,
                           const uint8_t* alleles, const uint8_t* quals,
                           const uint8_t* ignored, int64_t min_queue_size,
                           int64_t queue_increment, int64_t* heuristics,
                           uint8_t* bad_variants) {
  if (nv < 0 || n_reads < 0 || max_segment_size < 2) return -1;
  for (int32_t r = 0; r < n_reads; ++r) {
    if (seg_start[r] < 0 || seg_start[r] > seg_end[r] || seg_end[r] > nv ||
        seg_off[r + 1] - seg_off[r] != seg_end[r] - seg_start[r])
      return -1;
  }
  for (int32_t v = 0; v < nv; ++v) bad_variants[v] = ignored[v] ? 1 : 0;
  std::fill(heuristics, heuristics + nv + 1, 0);
  Sweep sweep(nv, n_reads, seg_start, seg_end, seg_off, alleles, quals);
  const int64_t base_visits = floor_div(min_queue_size, 10);
  int32_t max_clip_size = 1;
  for (int32_t v = nv - 1; v >= 0; --v) {
    int64_t max_estimate = 0, solve_size = 0;
    if (!sweep.subsolve(v, max_clip_size, heuristics, bad_variants,
                        base_visits + queue_increment * max_clip_size,
                        &max_estimate, &solve_size))
      return -2;
    if (solve_size < std::min(max_clip_size, 2)) return -2;
    if (bad_variants[v]) {
      heuristics[v] = heuristics[v + 1];
    } else {
      if (max_estimate < heuristics[v + 1]) return -2;
      heuristics[v] = max_estimate;
    }
    max_clip_size = static_cast<int32_t>(
        std::min<int64_t>(solve_size + 1, max_segment_size));
  }
  return 0;
}

}  // extern "C"
