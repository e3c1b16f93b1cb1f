// wfa_forward_backward — banded graph edit-distance DP over linearized
// variant graphs: a forward min-plus scan over each graph's positions, then
// a backward pass that marks every cell on any optimal path. One launch
// carries a ragged batch of (graph, read) pairs, each read against its own
// graph; one CTA per pair.
//
// Replaces: hiphase_tpu/align/wfa_device.py::wfa_forward_backward (lines
// 111-289, K2): two lax.scans over the positions with [B, 2H+1] vector work
// per step, one graph per call. Outputs are bit-identical, pair by pair:
// score, in_band, and the traversed flag of every node.
//
// The problem on an H100 is latency. A pair is a chain of G dependent band
// columns forward and G backward (G is about the window's length, 8-16 k
// positions for a HiFi read), and one column is at most 2H + 1 = 1025 cells
// of integer work. Its bytes (every out-column written once and read once,
// 4·T·C bytes a position) are far below the card's rate. So the design is
// about the length of one step's dependent chain, and about having many
// chains on the card at once:
//  - many pairs per launch: the caller aligns every read of a block at one
//    rung of the band ladder in one launch (grid = pairs), so hundreds of
//    CTAs fill the 132 SMs where one read per launch held one warp;
//  - several warps per pair where the band is wide: a CTA of NW warps, each
//    thread holding C consecutive band cells in registers (NW·32·C >= 2H+1;
//    H = 512 runs 4 warps of 9 cells a thread where one warp held 33 cells
//    a lane, H = 128 4 warps of 3 cells). Cells at or past Wb are padding,
//    held at INF and unmarked;
//  - the pair's read is staged in shared memory (bytes, read once), and the
//    position stream (band center, character, node, start/end flags packed
//    in 8 bytes a position) in chunks of kChunk positions, double-buffered
//    with cp.async, so a step reads no control data from device memory;
//  - Hopper's DPX instructions on the min-plus chain: __vimin3_s32 for the
//    transition min(diag, del + 1, INF), __viaddmin_s32 for the closure's
//    min(v - k, m) and its final min(v + k, INF).
// What bounds it now (PERF.md has the numbers): at H = 512 a batch of a few
// hundred windows keeps every SM busy and reaches a fifth of the card's
// int32 rate, so the scan's instructions (and its one barrier a step) are
// the limit; at H = 32 (one warp a pair) and H = 128 a step is a short
// chain of shuffles, and a block's few hundred pairs give an SM only a few
// warps, so latency bounds it there.
//
// The two in-column recurrences are block scans over per-thread aggregates:
//  - the insertion closure D[k] = min(base[k], D[k-1] + 1), closed as
//    cummin(base - k) + k capped at INF: a thread-local prefix min, a
//    shuffle scan of the thread minima, then one shared-memory exchange of
//    the warp minima (one barrier per scan);
//  - chain_left, P[k] = mark[k] | (link[k] & P[k+1]), a suffix scan of
//    boolean affine maps x -> M | (L & x): each thread composes its cells'
//    maps right to left, a shuffle scan from the right composes the lane
//    maps as f_l ∘ f_{l+1}, and the warp maps are composed the same way
//    through shared memory, always with the map further right innermost
//    (composing them the other way round is the fault a reversed
//    associative scan makes).
// The forward transition needs, at a warp's last cell, the next warp's
// first in-column cell; that value is published before the closure's
// barrier and folded in after it (it can only lower that last cell, and so
// the warp aggregates further right), so a step costs one barrier. The
// backward reads a neighbouring warp's cells from the column in device
// memory, and derives the deletion mark carried into a warp's first cell
// from the previous warp's published pre-chain mark, so a step costs one
// barrier too; node starts and node ends add one each.
// Band cells outside the read (j < 0 or j > read_len) are computed like the
// others and masked only after the closure, as the JAX code does.
//
// Scratch in device memory, from the wrapper, per pair: out-columns [G, RW]
// (RW = 32·NW·C), in-columns [N, RW] (a node's in-column at its first
// position, node 0's at g = 0; elsewhere the in-column is the previous
// out-column), end columns [N, Wb] and their marks [N, Wb]. A column is kept
// lane-major (cell i of thread t at i·T + t), so each of the C stores and
// loads of a column is one coalesced access per warp. A mark routed to a
// parent is a store of 1, never a read-modify-write, so threads and parents
// that hit one cell do not race.

#include <cuda_pipeline_primitives.h>

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 20;
constexpr int kBig = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;      // positions per staged chunk of the stream
constexpr int kMetaFields = 12;  // see the meta layout in the entry point

struct Args {
  const int2* pos;          // [sum G] (band center, packed code)
  const int* par_idx;       // [sum N, P] parents of each node (-1 pad)
  const int* par_shift;     // [sum N, P]
  const unsigned char* reads;
  const int* meta;          // [B, kMetaFields]
  int B, P, H, read_smem;
  int* cols_in;
  int* cols_out;
  int* endcols;
  unsigned char* mark_end;
  int* score;
  unsigned char* in_band;
  unsigned char* trav;
};

// v[i] <- min_{k' <= k0 + i, k' in this thread} (v[k'] - k'); returns the
// thread's minimum.
template <int C>
__device__ __forceinline__ int local_prefix(int (&v)[C], int k0) {
  int m = kBig;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    m = __viaddmin_s32(v[i], -(k0 + i), m);
    v[i] = m;
  }
  return m;
}

__device__ __forceinline__ int warp_inclusive_min(int agg, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, agg, o);
    if (lane >= o) agg = min(agg, y);
  }
  return agg;
}

// v[k] <- min(min_{k' <= k} (v[k'] - k') + k, INF) over the whole band.
template <int NW, int C>
__device__ __forceinline__ void closure_block(int (&v)[C], int k0, int lane, int w,
                                              int* s_agg) {
  const int incl = warp_inclusive_min(local_prefix(v, k0), lane);
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = kBig;
  if constexpr (NW > 1) {
    if (lane == 31) s_agg[w] = incl;
    __syncthreads();
    for (int j = 0; j < w; ++j) excl = min(excl, s_agg[j]);
  }
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = __viaddmin_s32(min(v[i], excl), k0 + i, kInf);
}

// mark <- P with P[k] = mark[k] | (link[k] & P[k+1]),
// link[k] = (col[k+1] == col[k] + 1) for k < Wb - 1, false at Wb - 1.
// `src` is the column in device memory (lane-major), for the first cell of
// the next warp.
template <int NW, int C>
__device__ __forceinline__ void chain_left(bool (&mark)[C], const int (&col)[C], const int* src,
                                           int k0, int Wb, int lane, int w, int tid, int* s_m,
                                           int* s_l) {
  constexpr int T = 32 * NW;
  int right = __shfl_down_sync(kFull, col[0], 1);
  if (lane == 31) right = (tid + 1 < T) ? src[tid + 1] : kInf;
  bool link[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int nxt = (i + 1 < C) ? col[i + 1] : right;
    link[i] = (k0 + i < Wb - 1) && nxt == col[i] + 1;
  }
  // this thread's run as one map: P[k0] = M | (L & P[k0 + C])
  int M = 0, L = 1;
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    M = mark[i] | (link[i] & M);
    L = link[i] & L;
  }
  // lane l ends with f_l ∘ f_{l+1} ∘ ... ∘ f_31
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int m2 = __shfl_down_sync(kFull, M, o);
    const int l2 = __shfl_down_sync(kFull, L, o);
    if (lane + o < 32) {
      M = M | (L & m2);
      L = L & l2;
    }
  }
  // P at the first cell of the next warp: the warps further right composed
  // with the rightmost innermost
  int cw = 0;
  if constexpr (NW > 1) {
    if (lane == 0) {
      s_m[w] = M;
      s_l[w] = L;
    }
    __syncthreads();
    for (int j = NW - 1; j > w; --j) cw = s_m[j] | (s_l[j] & cw);
  }
  const int mx = __shfl_down_sync(kFull, M, 1);
  const int lx = __shfl_down_sync(kFull, L, 1);
  int carry = (lane == 31) ? cw : (mx | (lx & cw));  // P at the next thread's first cell
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    carry = mark[i] | (link[i] & carry);
    mark[i] = carry != 0;
  }
}

template <int T, int C>
__device__ __forceinline__ void load_lane_major(int (&v)[C], const int* src, int tid) {
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = src[i * T + tid];
}

template <int T, int C>
__device__ __forceinline__ void store_lane_major(int* dst, const int (&v)[C], int tid) {
#pragma unroll
  for (int i = 0; i < C; ++i) dst[i * T + tid] = v[i];
}

struct Step {
  int c, ch, node;
  bool eps, start, end;
};

// code = char | eps << 8 | start << 9 | end << 10 | node << 11
__device__ __forceinline__ Step decode(int2 p) {
  Step s;
  s.c = p.x;
  s.ch = p.y & 0xff;
  s.eps = (p.y >> 8) & 1;
  s.start = (p.y >> 9) & 1;
  s.end = (p.y >> 10) & 1;
  s.node = p.y >> 11;
  return s;
}

template <int NW, int C>
__global__ void __launch_bounds__(32 * NW) wfa_kernel(Args a) {
  constexpr int T = 32 * NW;
  constexpr int RW = T * C;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_pos = reinterpret_cast<int2*>(smem);  // [2][kChunk]
  unsigned char* s_read = smem + 2 * kChunk * sizeof(int2);
  __shared__ int s_agg[3][NW];
  __shared__ int s_edge[2][NW];
  __shared__ int s_m[3][NW];
  __shared__ int s_l[3][NW];
  __shared__ int s_ml[2][NW];

  const int* meta = a.meta + static_cast<size_t>(blockIdx.x) * kMetaFields;
  const int goff = meta[0], G = meta[1], gnoff = meta[2], N = meta[3];
  const int roff = meta[4], rl = meta[5], last_node = meta[6], c_end = meta[7];
  const int soff = meta[8], snoff = meta[9], out_idx = meta[10], toff = meta[11];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int H = a.H;
  const int Wb = 2 * H + 1;
  const int k0 = tid * C;
  const int P = a.P;
  const int2* gpos = a.pos + goff;
  const int* pidx = a.par_idx + static_cast<size_t>(gnoff) * P;
  const int* pshift = a.par_shift + static_cast<size_t>(gnoff) * P;
  int* cols_out = a.cols_out + static_cast<size_t>(soff) * RW;
  int* cols_in = a.cols_in + static_cast<size_t>(snoff) * RW;
  int* endcols = a.endcols + static_cast<size_t>(snoff) * Wb;
  unsigned char* mark_end = a.mark_end + static_cast<size_t>(snoff) * Wb;
  unsigned char* trav = a.trav + toff;
  const int nchunks = (G + kChunk - 1) / kChunk;
  const int rmax = max(rl - 1, 0);

  // chunk `ci` of the position stream into buffer `buf` (G is a multiple of
  // 64 and the stream 16-byte aligned, so a chunk is whole 16-byte units)
  auto prefetch = [&](int ci, int buf) {
    const int n16 = min(kChunk, G - ci * kChunk) / 2;
    const char* src = reinterpret_cast<const char*>(gpos + ci * kChunk);
    char* dst = reinterpret_cast<char*>(s_pos + buf * kChunk);
    for (int i = tid; i < n16; i += T) __pipeline_memcpy_async(dst + 16 * i, src + 16 * i, 16);
    __pipeline_commit();
  };

  prefetch(0, 0);
  const size_t nw = static_cast<size_t>(N) * Wb;
  for (size_t i = tid; i < nw; i += T) {
    endcols[i] = kInf;
    mark_end[i] = 0;
  }
  for (int i = tid; i < N; i += T) trav[i] = 0;
  // the read in shared memory when it fits (the wrapper sizes read_smem to
  // the batch's longest read up to a cap); its slot is padded to 16 bytes
  const unsigned char* rd = a.reads + roff;
  if (rl <= a.read_smem) {
    const uint4* src = reinterpret_cast<const uint4*>(rd);
    uint4* dst = reinterpret_cast<uint4*>(s_read);
    for (int i = tid; i < (rl + 15) / 16; i += T) dst[i] = src[i];
    rd = s_read;
  }

  // ---- forward ----
  // initial column at the root (center 0): D[j] = j
  int col[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = k0 + i;
    col[i] = (k < Wb && k >= H && k - H <= rl) ? k - H : kInf;
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ci + 1 < nchunks) prefetch(ci + 1, (ci + 1) & 1);
    const int2* sp = s_pos + (ci & 1) * kChunk;
    const int g_end = min(G, (ci + 1) * kChunk);
    for (int g = ci * kChunk; g < g_end; ++g) {
      const Step s = decode(sp[g - ci * kChunk]);
      const int par = g & 1;
      if (s.start) {
        // join: parents' end columns rebased by their shift, min over
        // parents, then the insertion closure
        __syncthreads();  // end columns stored by other threads
#pragma unroll
        for (int i = 0; i < C; ++i) col[i] = kInf;
        for (int p = 0; p < P; ++p) {
          const int pid = pidx[s.node * P + p];
          const int sh = pshift[s.node * P + p];
          if (pid < 0) continue;
          const int* pe = endcols + static_cast<size_t>(pid) * Wb;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int idx = k0 + i - sh;
            if (k0 + i < Wb && idx >= 0 && idx < Wb) col[i] = min(col[i], pe[idx]);
          }
        }
        closure_block<NW, C>(col, k0, lane, w, s_agg[2]);
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (k0 + i >= Wb) col[i] = kInf;
      }
      if (s.start || g == 0) store_lane_major<T, C>(cols_in + static_cast<size_t>(s.node) * RW, col, tid);
      if constexpr (NW > 1)
        if (lane == 0) s_edge[par][w] = col[0];

      // transition; a warp's last cell takes the next warp's first cell
      // after the barrier
      int right = __shfl_down_sync(kFull, col[0], 1);
      if (lane == 31) right = kInf;
      int v[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int k = k0 + i;
        if (s.eps) {
          v[i] = col[i];
        } else {
          const int j = s.c + k - H;
          const int nxt = (k >= Wb - 1) ? kInf : ((i + 1 < C) ? col[i + 1] : right);
          const int rc = rd[min(max(j - 1, 0), rmax)];
          const int diag = (j >= 1) ? col[i] + (rc == s.ch ? 0 : 1) : kInf;
          v[i] = __vimin3_s32(diag, nxt + 1, kInf);
        }
      }
      // the insertion closure, with the cross-warp transition folded in
      const int incl = warp_inclusive_min(local_prefix(v, k0), lane);
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kBig;
      int edge_fix = kInf;  // this thread's last cell: min(next warp's cin + 1, INF)
      if constexpr (NW > 1) {
        if (lane == 31) s_agg[par][w] = incl;
        __syncthreads();
        for (int jw = 0; jw < w; ++jw) {
          int agg = s_agg[par][jw];
          const int klast = (jw + 1) * 32 * C - 1;
          if (!s.eps && klast < Wb - 1) agg = min(agg, min(s_edge[par][jw + 1] + 1, kInf) - klast);
          excl = min(excl, agg);
        }
        if (lane == 31 && w + 1 < NW && !s.eps && k0 + C - 1 < Wb - 1)
          edge_fix = min(s_edge[par][w + 1] + 1, kInf);
      }
#pragma unroll
      for (int i = 0; i < C; ++i) v[i] = __viaddmin_s32(min(v[i], excl), k0 + i, kInf);
      v[C - 1] = min(v[C - 1], edge_fix);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int k = k0 + i;
        const int j = s.c + k - H;
        col[i] = (k < Wb && j >= 0 && j <= rl) ? v[i] : kInf;
      }
      store_lane_major<T, C>(cols_out + static_cast<size_t>(g) * RW, col, tid);
      if (s.end) {
        int* dst = endcols + static_cast<size_t>(s.node) * Wb;
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (k0 + i < Wb) dst[k0 + i] = col[i];
      }
    }
  }

  __syncthreads();
  const int kstar = rl - c_end + H;
  const bool in_band = kstar >= 0 && kstar < Wb;
  if (tid == 0) {
    const int score = in_band ? endcols[static_cast<size_t>(last_node) * Wb + kstar] : kInf;
    a.score[out_idx] = score;
    a.in_band[out_idx] = in_band;
    if (in_band && score < kInf) mark_end[static_cast<size_t>(last_node) * Wb + kstar] = 1;
  }
  prefetch(nchunks - 1, (nchunks - 1) & 1);

  // ---- backward: mark every cell on any optimal path ----
  bool mark[C];
#pragma unroll
  for (int i = 0; i < C; ++i) mark[i] = false;
  for (int ci = nchunks - 1; ci >= 0; --ci) {
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ci > 0) prefetch(ci - 1, (ci - 1) & 1);
    const int2* sp = s_pos + (ci & 1) * kChunk;
    const int g_end = min(G, (ci + 1) * kChunk);
    for (int g = g_end - 1; g >= ci * kChunk; --g) {
      const Step s = decode(sp[g - ci * kChunk]);
      const int par = g & 1;
      const int* out_src = cols_out + static_cast<size_t>(g) * RW;
      const int* cin_src = (s.start || g == 0) ? cols_in + static_cast<size_t>(s.node) * RW
                                               : cols_out + static_cast<size_t>(g - 1) * RW;
      int out[C], cin[C];
      load_lane_major<T, C>(out, out_src, tid);
      load_lane_major<T, C>(cin, cin_src, tid);
      // marks routed from children arrive at this node's end column
      if (s.end) __syncthreads();
      const unsigned char* me = mark_end + static_cast<size_t>(s.node) * Wb;
      int any = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        bool m = mark[i] || (s.end && k0 + i < Wb && me[k0 + i] != 0);
        m = m && out[i] < kInf;
        mark[i] = m;
        any |= m;
      }
      if (__any_sync(kFull, any) && lane == 0) trav[s.node] = 1;
      if constexpr (NW > 1)
        if (lane == 31) s_ml[par][w] = mark[C - 1];
      // undo the out-closure, then the char transition back to the in-column
      chain_left<NW, C>(mark, out, out_src, k0, Wb, lane, w, tid, s_m[par], s_l[par]);
      bool mark_in[C];
      if (s.eps) {
#pragma unroll
        for (int i = 0; i < C; ++i) mark_in[i] = mark[i] && cin[i] == out[i];
      } else {
        int right = __shfl_down_sync(kFull, cin[0], 1);
        if (lane == 31) right = (tid + 1 < T) ? cin_src[tid + 1] : kInf;
        bool dele_ok[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int k = k0 + i;
          const int j = s.c + k - H;
          const int nxt = (k >= Wb - 1) ? kInf : ((i + 1 < C) ? cin[i + 1] : right);
          const int rc = rd[min(max(j - 1, 0), rmax)];
          const int base_diag = (j >= 1) ? cin[i] + (rc == s.ch ? 0 : 1) : kInf;
          mark_in[i] = mark[i] && base_diag == out[i];
          // out[k] came from in[k+1] (deletion): the mark lands one cell right
          dele_ok[i] = mark[i] && nxt + 1 == out[i];
        }
        int left = __shfl_up_sync(kFull, static_cast<int>(dele_ok[C - 1]), 1);
        if (lane == 0) {
          left = 0;
          if constexpr (NW > 1) {
            if (w > 0) {
              // the previous warp's last cell k0 - 1: its chain mark from its
              // pre-chain mark and this warp's first, then its deletion test
              const int klast = k0 - 1;
              const int out_last = out_src[(C - 1) * T + tid - 1];
              const bool link = klast < Wb - 1 && out[0] == out_last + 1;
              const bool p_last = s_ml[par][w - 1] || (link && mark[0]);
              left = p_last && klast < Wb - 1 && cin[0] + 1 == out_last;
            }
          }
        }
#pragma unroll
        for (int i = C - 1; i >= 1; --i) mark_in[i] = mark_in[i] || dele_ok[i - 1];
        mark_in[0] = mark_in[0] || left != 0;
      }
      if (s.start) {
        // undo the join-closure and route to every parent whose rebased end
        // cell equals the joined cell (ties mark several parents)
        chain_left<NW, C>(mark_in, cin, cin_src, k0, Wb, lane, w, tid, s_m[2], s_l[2]);
        for (int p = 0; p < P; ++p) {
          const int pid = pidx[s.node * P + p];
          const int sh = pshift[s.node * P + p];
          if (pid < 0) continue;
          const int* pe = endcols + static_cast<size_t>(pid) * Wb;
          unsigned char* pm = mark_end + static_cast<size_t>(pid) * Wb;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const int idx = k0 + i - sh;
            if (mark_in[i] && k0 + i < Wb && idx >= 0 && idx < Wb && pe[idx] == cin[i]) pm[idx] = 1;
          }
        }
        // across a start the previous out-column is not the in-column (the
        // join replaced it): marks flow via mark_end only
#pragma unroll
        for (int i = 0; i < C; ++i) mark[i] = false;
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i) mark[i] = mark_in[i];
      }
    }
  }
}

template <int NW, int C>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wfa_kernel<NW, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wfa_kernel<NW, C><<<a.B, 32 * NW, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch over B pairs. meta[b] = (graph position offset, G, graph node
// offset, N, read byte offset, read length, last node, c_end, scratch
// position offset, scratch node offset, output index, traversed offset):
// the graph offsets index pos and the parent tables, the scratch offsets
// the column buffers (in positions and nodes), the output index score and
// in_band, the traversed offset trav. (warps, cells) is the CTA shape the
// wrapper sized the scratch rows for (RW = 32·warps·cells >= 2H + 1);
// read_smem is the shared-memory bytes for a read (a multiple of 16): a
// longer read is read from device memory.
HP_EXPORT int hp_wfa_forward_backward(const int* pos, const int* par_idx, const int* par_shift,
                                      const unsigned char* reads, const int* meta, int B, int P,
                                      int H, int warps, int cells, int read_smem, int* cols_in,
                                      int* cols_out, int* endcols, unsigned char* mark_end,
                                      int* score, unsigned char* in_band, unsigned char* trav,
                                      int device, void* stream) {
  if (B <= 0 || P <= 0 || H < 0 || read_smem < 16 || read_smem % 16 != 0 ||
      32 * warps * cells < 2 * H + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{reinterpret_cast<const int2*>(pos), par_idx, par_shift, reads, meta, B, P, H,
               read_smem, cols_in, cols_out, endcols, mark_end, score, in_band, trav};
  const int smem = 2 * kChunk * static_cast<int>(sizeof(int2)) + read_smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    switch (warps * 100 + cells) {
      case 103: return launch<1, 3>(a, smem, s);
      case 403: return launch<4, 3>(a, smem, s);
      case 409: return launch<4, 9>(a, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }));
}
