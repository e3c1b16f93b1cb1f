// beam_select — one beam column, up to and including the survivor selection.
//
// Replaces: hiphase_tpu/phasing/beam.py::_step (lines 105-208): the column
// unpack, e0 and D2, the three min-sums over δ (m0, mp, mm), the 4W
// candidate costs with their validity rules, the two-key lax.sort, and the
// decode of parents / choices / hets / pruned / discard_min. The survivor
// gather that ends _step is permute_update.cu.
//
// What bounds it on an H100: per batch row, one read of δ[b] (W·R int32,
// 512 KiB at W=1024, R=128) and an exact ordering of 4W 64-bit keys. The
// read is cheap; the ordering is a chain of block-wide barriers, so the
// kernel is latency bound with one block per row (B blocks of 1024
// threads; B = 64, 16 or 8 on the main path).
//
// Design: rows are independent, so one CTA owns one batch row and no block
// ever waits on another. Each warp reduces whole δ rows (lanes over the
// slots, coalesced) into m0 / mp / mm and lanes 0-3 write the row's four
// candidate keys. A key is (cost, secondary) with both halves' sign bits
// flipped, so one unsigned 64-bit comparison is the signed lexicographic
// order of JAX's two-key sort; the secondary key is unique per candidate,
// so any exact ordering reproduces JAX's. The keys sit in dynamic shared
// memory (32 KiB at W=1024; 128 KiB at W=2560, padded to 16384 keys), and a
// bitonic network sorts them in place. The (W+1)-th key gives discard_min.
// Candidate costs are formed only for valid candidates (an invalid parent
// carries cost BIG, where BIG + D2 + m would overflow) and all int32 sums
// use unsigned arithmetic, so they wrap where XLA's wrap. Widths whose keys
// do not fit in shared memory (W > 4096) are refused by the Python wrapper.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kQualBits = 16;

__device__ __forceinline__ unsigned long long make_key(int cost, int sec) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(cost) ^ 0x80000000u) << 32) |
         static_cast<unsigned long long>(static_cast<unsigned>(sec) ^ 0x80000000u);
}
__device__ __forceinline__ int key_cost(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int key_sec(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(kThreads) beam_select_kernel(
    const int* __restrict__ delta, int* __restrict__ cost, int* __restrict__ hets,
    unsigned char* __restrict__ valid, const int* __restrict__ packed,
    const unsigned char* __restrict__ skip, int W, int R, int C, int V, int col,
    int order_bits, int hets_cap, int big, int npow2, short* __restrict__ parents,
    signed char* __restrict__ choices, int* __restrict__ pruned, int* __restrict__ dmin,
    int* __restrict__ sgn, int* __restrict__ e0_out, int* __restrict__ rn_out) {
  extern __shared__ unsigned long long keys[];          // [npow2]
  int* e0s = reinterpret_cast<int*>(keys + npow2);       // [R]
  __shared__ unsigned red[3][32];

  const int B = gridDim.x;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool sk = skip[static_cast<size_t>(b) * V + col] != 0;
  const int* pk = packed + static_cast<size_t>(b) * R * C;

  // Column unpack: e0 per slot, the D2 sums, the lookahead reset.
  unsigned s0 = 0, s1 = 0;
  for (int r = tid; r < R; r += blockDim.x) {
    const int v = pk[static_cast<size_t>(r) * C + col];
    const int a = (v >> kQualBits) & 3;
    const int qe = sk ? 0 : (v & ((1 << kQualBits) - 1));
    const int q0 = a == 0 ? qe : 0, q1 = a == 1 ? qe : 0;
    e0s[r] = q1 - q0;
    e0_out[static_cast<size_t>(b) * R + r] = q1 - q0;
    rn_out[static_cast<size_t>(b) * R + r] =
        (pk[static_cast<size_t>(r) * C + col + 1] >> (kQualBits + 2)) & 1;
    s0 += q0;
    s1 += q1;
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  if (lane == 0) {
    red[0][warp] = s0;
    red[1][warp] = s1;
  }
  __syncthreads();
  unsigned t0 = 0, t1 = 0;
  for (int i = 0; i < nwarps; ++i) {
    t0 += red[0][i];
    t1 += red[1][i];
  }
  const int sum_q0 = static_cast<int>(t0), sum_q1 = static_cast<int>(t1);

  // Candidate keys: one warp per parent row at a time.
  const int* drow_base = delta + static_cast<size_t>(b) * W * R;
  unsigned nvalid = 0;
  for (int w = warp; w < W; w += nwarps) {
    const int* drow = drow_base + static_cast<size_t>(w) * R;
    unsigned m0 = 0, mp = 0, mm = 0;
    for (int r = lane; r < R; r += 32) {
      const int d = drow[r], e = e0s[r];
      m0 += static_cast<unsigned>(min(d, 0));
      mp += static_cast<unsigned>(min(wrap_add(d, e), 0));
      mm += static_cast<unsigned>(min(wrap_add(d, -e), 0));
    }
    m0 = warp_sum(m0);
    mp = warp_sum(mp);
    mm = warp_sum(mm);
    if (lane < 4) {
      const int c = lane;
      const size_t sw = static_cast<size_t>(b) * W + w;
      const int cw = cost[sw], hw = hets[sw];
      const bool cv = valid[sw] != 0 && !(hw == 0 && c == 1) && (!sk || c == 0);
      int kc = big;
      if (cv) {
        const unsigned d2 = static_cast<unsigned>((c == 0 || c == 3) ? sum_q0 : sum_q1);
        const unsigned m = c == 0 ? mp : (c == 1 ? mm : m0);
        kc = static_cast<int>(static_cast<unsigned>(cw) - m0 + d2 + m);
      }
      const int inc = sk ? 0 : 1 - (c >> 1);
      const unsigned sec = (static_cast<unsigned>(hets_cap - (hw + inc)) << order_bits) |
                           static_cast<unsigned>(w * 4 + c);
      keys[w * 4 + c] = make_key(kc, static_cast<int>(sec));
      nvalid += cv ? 1u : 0u;
    }
  }
  for (int i = 4 * W + tid; i < npow2; i += blockDim.x) keys[i] = ~0ull;
  nvalid = warp_sum(nvalid);
  if (lane == 0) red[2][warp] = nvalid;
  __syncthreads();

  // Bitonic sort, ascending; each thread takes whole compare-exchange pairs.
  const int half = npow2 >> 1;
  for (int k = 2; k <= npow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int ixj = i | j;
        const unsigned long long x = keys[i], y = keys[ixj];
        const bool ascending = (i & k) == 0;
        if ((x > y) == ascending) {
          keys[i] = y;
          keys[ixj] = x;
        }
      }
      __syncthreads();
    }
  }

  // Survivors: decode the W smallest keys.
  const int omask = (1 << order_bits) - 1;
  const size_t tcol = static_cast<size_t>(col) * B * W + static_cast<size_t>(b) * W;
  for (int i = tid; i < W; i += blockDim.x) {
    const unsigned long long kk = keys[i];
    const int kc = key_cost(kk), sec = key_sec(kk);
    const int flat = sec & omask;
    const int ch = flat & 3;
    const size_t o = static_cast<size_t>(b) * W + i;
    parents[tcol + i] = static_cast<short>(flat >> 2);
    choices[tcol + i] = static_cast<signed char>(ch);
    cost[o] = kc;
    hets[o] = hets_cap - (sec >> order_bits);
    valid[o] = kc < big ? 1 : 0;
    sgn[o] = ch == 0 ? 1 : (ch == 1 ? -1 : 0);
  }
  if (tid == 0) {
    unsigned nv = 0;
    for (int i = 0; i < nwarps; ++i) nv += red[2][i];
    const int n = static_cast<int>(nv) - W;
    pruned[static_cast<size_t>(col) * B + b] = n > 0 ? n : 0;
    dmin[static_cast<size_t>(col) * B + b] = key_cost(keys[W]);
  }
}

}  // namespace

HP_EXPORT int hp_beam_select(const int* delta, int* cost, int* hets, unsigned char* valid,
                             const int* packed, const unsigned char* skip, int B, int W,
                             int R, int C, int V, int col, int order_bits, int hets_cap,
                             int big, short* parents, signed char* choices, int* pruned,
                             int* dmin, int* sgn, int* e0, int* rn, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int npow2 = 1;
  while (npow2 < 4 * W) npow2 <<= 1;
  const size_t smem = static_cast<size_t>(npow2) * 8 + static_cast<size_t>(R) * 4;
  static size_t smem_opted = 48 * 1024;
  if (smem > smem_opted) {
    err = cudaFuncSetAttribute(beam_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_opted = smem;
  }
  beam_select_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      delta, cost, hets, valid, packed, skip, W, R, C, V, col, order_bits, hets_cap, big,
      npow2, parents, choices, pruned, dmin, sgn, e0, rn);
  return static_cast<int>(cudaGetLastError());
}
