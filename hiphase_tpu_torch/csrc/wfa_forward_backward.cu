// wfa_forward_backward — banded graph edit-distance DP over the linearized
// variant graph: a forward min-plus scan over the G positions, then a
// backward pass that marks every cell on any optimal path.
//
// Replaces: hiphase_tpu/align/wfa_device.py::wfa_forward_backward (lines
// 111-289, K2): two lax.scans over the positions with [B, 2H+1] vector work
// per step. Outputs are bit-identical: score [B], traversed [B, N],
// in_band [B].
//
// What bounds it on an H100: latency. Each read row is a chain of G
// dependent band columns forward and G backward (G is about the window's
// length: 8-16 k positions for a HiFi read), and one column is at most
// 1025 cells of integer work, far too little to fill an SM. Bytes: the
// forward writes every out-column (4·Wb bytes a position) and the
// in-columns at node starts; the backward reads them back.
//
// Design: one warp per read row (a CTA of 32 threads), so that no step needs
// a block barrier; the sequential grid of the TPU scan is a loop in the
// warp. Lane l holds the C consecutive band cells [l·C, l·C + C) in
// registers (C = 3, 9, 33 at H = 32, 128, 512; cells at or past Wb are
// padding, held at INF and unmarked). Wb = 1025 at H = 512 exceeds a
// block's 1024 threads, which is one more reason a thread owns a run of
// cells. Both in-column recurrences are warp scans over per-lane
// aggregates:
//  - the insertion closure D[k] = min(base[k], D[k-1] + 1), closed as
//    cummin(base - k) + k capped at INF: a lane-local prefix min, then a
//    shuffle scan of the lane minima;
//  - chain_left, P[k] = mark[k] | (link[k] & P[k+1]), a suffix scan of
//    boolean affine maps x -> M | (L & x): each lane composes its cells'
//    maps right to left, then a shuffle scan from the right composes the
//    lane maps as f_l ∘ f_{l+1}, the map further right innermost
//    (composing them the other way round is the fault a reversed
//    associative scan makes).
// Band cells outside the read (j < 0 or j > read_len) are computed like
// the others and masked only after the closure, as the JAX code does.
// Scratch in device memory, from the wrapper: out-columns [G, B, 32·C],
// in-columns [G, B, 32·C] (written and read only at g = 0 and at node
// starts; elsewhere the in-column is the previous out-column), end columns
// [B, N, Wb] and their marks [B, N, Wb]. A column is kept lane-major (cell
// i of lane l at i·32 + l), so that each of the C stores and loads of a
// column is one coalesced 128-byte access of the warp. A mark routed to a
// parent is a store of 1, never a read-modify-write, so lanes and parents
// that hit one cell do not race; __syncwarp() after each step makes the
// stores visible.

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 20;
constexpr int kBig = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int* pchar;
  const int* pnode;
  const unsigned char* pstart;
  const unsigned char* pend;
  const int* c_out;
  const int* par_idx;
  const int* par_shift;
  const int* reads;
  const int* read_len;
  int G, P, B, Lr, H, N, last_node, c_end;
  int* cols_in;
  int* cols_out;
  int* endcols;
  unsigned char* mark_end;
  int* score;
  unsigned char* trav;
  unsigned char* in_band;
};

// v[k] <- min(min_{k' <= k} (v[k'] - k') + k, INF) over the whole band.
template <int C>
__device__ __forceinline__ void closure(int (&v)[C], int k0, int lane) {
  int m = kBig;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    m = min(m, v[i] - (k0 + i));
    v[i] = m;
  }
  int agg = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, agg, o);
    if (lane >= o) agg = min(agg, y);
  }
  int excl = __shfl_up_sync(kFull, agg, 1);
  if (lane == 0) excl = kBig;
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = min(min(v[i], excl) + k0 + i, kInf);
}

// mark <- P with P[k] = mark[k] | (link[k] & P[k+1]),
// link[k] = (col[k+1] == col[k] + 1) for k < Wb - 1, false at Wb - 1.
template <int C>
__device__ __forceinline__ void chain_left(bool (&mark)[C], const int (&col)[C], int k0, int Wb,
                                           int lane) {
  const int right = __shfl_down_sync(kFull, col[0], 1);
  bool link[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int nxt = (i + 1 < C) ? col[i + 1] : right;
    link[i] = (k0 + i < Wb - 1) && nxt == col[i] + 1;
  }
  // this lane's run as one map: P[k0] = M | (L & P[k0 + C])
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
  int carry = __shfl_down_sync(kFull, M, 1);  // P at the next lane's first cell
  if (lane == 31) carry = 0;
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    carry = mark[i] | (link[i] & carry);
    mark[i] = carry != 0;
  }
}

// a column of the lane-major forward scratch (padding cells hold INF)
template <int C>
__device__ __forceinline__ void load_lane_major(int (&v)[C], const int* src, int lane) {
#pragma unroll
  for (int i = 0; i < C; ++i) v[i] = src[i * 32 + lane];
}

template <int C>
__device__ __forceinline__ void store_lane_major(int* dst, const int (&v)[C], int lane) {
#pragma unroll
  for (int i = 0; i < C; ++i) dst[i * 32 + lane] = v[i];
}

template <int C>
__device__ __forceinline__ void store_col(int* dst, const int (&v)[C], int k0, int Wb) {
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (k0 + i < Wb) dst[k0 + i] = v[i];
}

template <int C>
__global__ void __launch_bounds__(32) wfa_kernel(Args a) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int H = a.H;
  const int Wb = 2 * H + 1;
  const int k0 = lane * C;
  const int Lr = a.Lr;
  const int* read = a.reads + static_cast<size_t>(b) * Lr;
  const int rl = a.read_len[b];
  const size_t nw = static_cast<size_t>(a.N) * Wb;
  int* endcols = a.endcols + static_cast<size_t>(b) * nw;
  unsigned char* mark_end = a.mark_end + static_cast<size_t>(b) * nw;
  unsigned char* trav = a.trav + static_cast<size_t>(b) * a.N;
  const size_t pos_stride = static_cast<size_t>(a.B) * 32 * C;  // one position of cols
  int* cols_in = a.cols_in + static_cast<size_t>(b) * 32 * C;
  int* cols_out = a.cols_out + static_cast<size_t>(b) * 32 * C;

  for (size_t i = lane; i < nw; i += 32) {
    endcols[i] = kInf;
    mark_end[i] = 0;
  }
  for (int i = lane; i < a.N; i += 32) trav[i] = 0;
  __syncwarp();

  // ---- forward ----
  // initial column at the root (center 0): D[j] = j
  int col[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int k = k0 + i;
    col[i] = (k < Wb && k >= H && k - H <= rl) ? k - H : kInf;
  }
  for (int g = 0; g < a.G; ++g) {
    const int ch = a.pchar[g];
    const int c = a.c_out[g];
    const bool start = a.pstart[g] != 0;
    if (start) {
      // join: parents' end columns rebased by their shift, min over
      // parents, then the insertion closure
#pragma unroll
      for (int i = 0; i < C; ++i) col[i] = kInf;
      for (int p = 0; p < a.P; ++p) {
        const int pid = a.par_idx[g * a.P + p];
        const int sh = a.par_shift[g * a.P + p];
        if (pid < 0) continue;
        const int* pe = endcols + static_cast<size_t>(pid) * Wb;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int idx = k0 + i - sh;
          if (k0 + i < Wb && idx >= 0 && idx < Wb) col[i] = min(col[i], pe[idx]);
        }
      }
      closure(col, k0, lane);
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (k0 + i >= Wb) col[i] = kInf;
    }
    if (start || g == 0) store_lane_major(cols_in + g * pos_stride, col, lane);

    const int right = __shfl_down_sync(kFull, col[0], 1);
    int v[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = k0 + i;
      int base = col[i];
      if (ch >= 0) {
        const int j = c + k - H;
        const int nxt = (k >= Wb - 1) ? kInf : ((i + 1 < C) ? col[i + 1] : right);
        const int rc = __ldg(read + min(max(j - 1, 0), Lr - 1));
        const int diag = (j >= 1) ? col[i] + (rc == ch ? 0 : 1) : kInf;
        base = min(diag, nxt + 1);
      }
      v[i] = min(base, kInf);
    }
    closure(v, k0, lane);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = k0 + i;
      const int j = c + k - H;
      col[i] = (k < Wb && j >= 0 && j <= rl) ? v[i] : kInf;
    }
    store_lane_major(cols_out + g * pos_stride, col, lane);
    if (a.pend[g]) store_col(endcols + static_cast<size_t>(a.pnode[g]) * Wb, col, k0, Wb);
    __syncwarp();
  }

  const int kstar = rl - a.c_end + H;
  const bool in_band = kstar >= 0 && kstar < Wb;
  const int score = in_band ? endcols[static_cast<size_t>(a.last_node) * Wb + kstar] : kInf;
  if (lane == 0) {
    a.score[b] = score;
    a.in_band[b] = in_band;
    if (in_band && score < kInf) mark_end[static_cast<size_t>(a.last_node) * Wb + kstar] = 1;
  }
  __syncwarp();

  // ---- backward: mark every cell on any optimal path ----
  bool mark[C];
#pragma unroll
  for (int i = 0; i < C; ++i) mark[i] = false;
  for (int g = a.G - 1; g >= 0; --g) {
    const int ch = a.pchar[g];
    const int c = a.c_out[g];
    const int node = a.pnode[g];
    const bool start = a.pstart[g] != 0;
    int out[C], cin[C];
    load_lane_major(out, cols_out + g * pos_stride, lane);
    load_lane_major(
        cin, (start || g == 0) ? cols_in + g * pos_stride : cols_out + (g - 1) * pos_stride, lane);
    // marks routed from children arrive at this node's end column
    const unsigned char* me = mark_end + static_cast<size_t>(node) * Wb;
    const bool end = a.pend[g] != 0;
    int any = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      bool m = mark[i] || (end && k0 + i < Wb && me[k0 + i] != 0);
      m = m && out[i] < kInf;
      mark[i] = m;
      any |= m;
    }
    if (__any_sync(kFull, any) && lane == 0) trav[node] = 1;
    // undo the out-closure, then the char transition back to the in-column
    chain_left(mark, out, k0, Wb, lane);
    bool mark_in[C];
    if (ch < 0) {
#pragma unroll
      for (int i = 0; i < C; ++i) mark_in[i] = mark[i] && cin[i] == out[i];
    } else {
      const int right = __shfl_down_sync(kFull, cin[0], 1);
      bool dele_ok[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int k = k0 + i;
        const int j = c + k - H;
        const int nxt = (k >= Wb - 1) ? kInf : ((i + 1 < C) ? cin[i + 1] : right);
        const int rc = __ldg(read + min(max(j - 1, 0), Lr - 1));
        const int base_diag = (j >= 1) ? cin[i] + (rc == ch ? 0 : 1) : kInf;
        mark_in[i] = mark[i] && base_diag == out[i];
        // out[k] came from in[k+1] (deletion): the mark lands one cell right
        dele_ok[i] = mark[i] && nxt + 1 == out[i];
      }
      int left = __shfl_up_sync(kFull, static_cast<int>(dele_ok[C - 1]), 1);
      if (lane == 0) left = 0;
#pragma unroll
      for (int i = C - 1; i >= 1; --i) mark_in[i] = mark_in[i] || dele_ok[i - 1];
      mark_in[0] = mark_in[0] || left != 0;
    }
    if (start) {
      // undo the join-closure and route to every parent whose rebased end
      // cell equals the joined cell (ties mark several parents)
      chain_left(mark_in, cin, k0, Wb, lane);
      for (int p = 0; p < a.P; ++p) {
        const int pid = a.par_idx[g * a.P + p];
        const int sh = a.par_shift[g * a.P + p];
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
    __syncwarp();
  }
}

template <int C>
int launch(const Args& a, cudaStream_t stream) {
  wfa_kernel<C><<<a.B, 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `cells` is the wrapper's C (cells per lane, which sizes the scratch
// columns as 32·C): it must be the one this entry point picks for H.
HP_EXPORT int hp_wfa_forward_backward(const int* pchar, const int* pnode,
                                      const unsigned char* pstart, const unsigned char* pend,
                                      const int* c_out, const int* par_idx, const int* par_shift,
                                      const int* reads, const int* read_len, int G, int P, int B,
                                      int Lr, int H, int N, int last_node, int c_end, int cells,
                                      int* cols_in, int* cols_out, int* endcols,
                                      unsigned char* mark_end, int* score, unsigned char* trav,
                                      unsigned char* in_band, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{pchar,   pnode,    pstart,   pend,   c_out, par_idx,  par_shift, reads,
               read_len, G,       P,        B,      Lr,    H,        N,         last_node,
               c_end,   cols_in,  cols_out, endcols, mark_end, score, trav,     in_band};
  const int need = (2 * H + 1 + 31) / 32;
  const int C = need <= 3 ? 3 : need <= 9 ? 9 : need <= 17 ? 17 : need <= 33 ? 33 : 0;
  if (C == 0 || C != cells) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 3: return launch<3>(a, s);
    case 9: return launch<9>(a, s);
    case 17: return launch<17>(a, s);
    default: return launch<33>(a, s);
  }
}
