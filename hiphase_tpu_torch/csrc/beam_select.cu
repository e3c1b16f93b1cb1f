// beam_select — one beam column, up to and including the survivor selection.
//
// Replaces: hiphase_tpu/phasing/beam.py::_step (lines 105-208): the column
// unpack, e0 and D2, the three min-sums over δ (m0, mp, mm), the 4W
// candidate costs with their validity rules, the two-key lax.sort, and the
// decode of parents / choices / hets / pruned / discard_min. The survivor
// gather that ends _step is permute_update.cu.
//
// What bounds it on an H100: the read of δ, W·R int32 a batch row (32 MiB
// over the batch at every production bucket: 10 µs at 3.35 TB/s), and then
// a chain of short dependent phases (sort, cluster barriers, ranking) that
// only latency bounds. Only the W + 1 smallest of the 4W keys a row are
// needed, in order.
//
// Design: one thread-block cluster of C CTAs per batch row, so that B·C CTAs
// share the read (C, the threads a CTA, the copy stride `sample` and the
// shared bytes come from kernels.beam_select_plan). CTA q of a cluster owns
// the parents [q·W/C, (q+1)·W/C):
//  1. Score. Every CTA parks its parents' cost / hets / valid in shared
//     memory, unpacks the column (e0, the D2 sums; rank 0 writes e0 / rn for
//     permute_update), then each warp reads four of its δ rows at a time
//     with 16-byte loads (one int at a time when R % 4 != 0 or δ is not
//     16-byte aligned), sums them with one reduce-scatter over the warp and
//     forms their 4 candidate keys. A key is (cost, secondary) with both
//     halves' sign bits flipped, so one unsigned 64-bit comparison is the
//     signed lexicographic order of JAX's two-key sort. Candidate costs are
//     formed only for valid candidates (an invalid parent carries cost BIG,
//     where BIG + D2 + m would overflow) and the int32 sums use unsigned
//     arithmetic, so they wrap where XLA's wrap.
//  2. Local sort: a bitonic sort, ascending, of the CTA's 4W/C keys in its
//     shared memory, padded to a power of two (at least 64) with ~0ull,
//     which is above every real key. Strides below 64 run in registers, two
//     keys a lane, with shuffles; larger strides go through shared memory,
//     two strides a block barrier.
//  3. Cluster barrier. After it every run is sorted, and every CTA has read
//     the cost / hets / valid of its parents, which the next step
//     overwrites in place.
//  4. Rank by counting. A key's rank in the row is its local index plus,
//     for each other CTA, the count of that CTA's keys below it. Each CTA
//     copies every sample-th key of the other CTAs' runs through
//     distributed shared memory (every key when sample is 1, as at the
//     production widths), so a count is a binary search in the local copy
//     and, for sample > 1, one in a window of the remote run; the C − 1
//     searches are interleaved. The secondary key holds the candidate's
//     flat index, so keys are unique and the ranks are the order of JAX's
//     sort. Padding sentinels are never below a real key, so they are never
//     counted. A key whose local index is above W cannot rank ≤ W and is not
//     searched. The key of rank i < W is stored, through distributed shared
//     memory, in the survivor slice of the CTA that owns position i; rank W
//     writes discard_min; rank 0 of the cluster sums the CTAs' valid counts
//     into pruned.
//  5. Cluster barrier. Then each CTA decodes its slice of W/C survivors and
//     writes them (parents, choices, cost, hets, valid, sgn) coalesced; no
//     CTA reads another's shared memory after the barrier.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// Threads a CTA at most; the bound also holds a thread to 64 registers, so
// that two 512-thread CTAs fit on one SM and clusters are placed easily.
constexpr int kMaxThreads = 1024;
constexpr int kQualBits = 16;
constexpr int kRows = 4;    // δ rows a warp reads at once
constexpr int kChunk = 64;  // keys a warp sorts in registers (two a lane)
constexpr int kCopyBatch = 4;  // remote keys a thread copies at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;  // device ordinals the launch records cover

struct Params {
  const int* delta;
  int* cost;
  int* hets;
  unsigned char* valid;
  const int* packed;
  const unsigned char* skip;
  short* parents;
  signed char* choices;
  int* pruned;
  int* dmin;
  int* sgn;
  int* e0_out;
  int* rn_out;
  int B, W, R, ncols, V, col, order_bits, hets_cap, big;
  int npow2;   // a CTA's keys, padded
  int sample;  // the stride at which other CTAs' runs are copied
};

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

// Address of this CTA's shared variable `p` in the shared memory of
// cluster rank `rank`, and loads through such an address.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ unsigned long long ld_cluster_u64(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster_u64(unsigned addr, unsigned long long v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(addr), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned ld_cluster_u32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void cmp_swap(unsigned long long& a, unsigned long long& b,
                                         bool asc) {
  if ((a > b) == asc) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

__device__ __forceinline__ void accumulate(int d, int e, unsigned* m) {
  m[0] += static_cast<unsigned>(min(d, 0));
  m[1] += static_cast<unsigned>(min(wrap_add(d, e), 0));
  m[2] += static_cast<unsigned>(min(wrap_add(d, -e), 0));
}

// The lane's partial (m0, mp, mm) of rows w0 .. w0 + kRows - 1 (those
// below nrows) into acc[3u .. 3u + 2].
template <bool kVec>
__device__ __forceinline__ void row_sums(const int* rows, const int* e0s, int w0, int nrows,
                                         int R, int lane, unsigned (&acc)[16]) {
  if (kVec) {
    const int R4 = R >> 2;
#pragma unroll 2
    for (int r4 = lane; r4 < R4; r4 += 32) {
      int4 d[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        d[u] = w0 + u < nrows ? __ldg(reinterpret_cast<const int4*>(
                                    rows + static_cast<size_t>(w0 + u) * R) + r4)
                              : make_int4(0, 0, 0, 0);
      const int4 e = reinterpret_cast<const int4*>(e0s)[r4];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        accumulate(d[u].x, e.x, acc + 3 * u);
        accumulate(d[u].y, e.y, acc + 3 * u);
        accumulate(d[u].z, e.z, acc + 3 * u);
        accumulate(d[u].w, e.w, acc + 3 * u);
      }
    }
  } else {
    for (int r = lane; r < R; r += 32) {
      int d[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        d[u] = w0 + u < nrows ? __ldg(rows + static_cast<size_t>(w0 + u) * R + r) : 0;
      const int e = e0s[r];
#pragma unroll
      for (int u = 0; u < kRows; ++u) accumulate(d[u], e, acc + 3 * u);
    }
  }
}

// Sums sixteen values over the warp, each lane keeping half of what it
// carries at every step (16 shuffles, where sixteen warp sums take 80).
// Returns, in every lane, the warp's total of value (lane >> 1) & 15.
__device__ __forceinline__ unsigned warp_reduce_scatter16(unsigned (&v)[16], int lane) {
#pragma unroll
  for (int half = 8; half >= 1; half >>= 1) {
    const bool upper = (lane & (2 * half)) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const unsigned send = upper ? v[i] : v[i + half];
      const unsigned keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, 2 * half);
    }
  }
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// One bitonic merge step of block size k over strides jmax, jmax/2, ..., 1
// (jmax ≤ 32) on a warp's 64-key chunk at base cb: lane l holds keys
// cb + l (x0) and cb + 32 + l (x1).
__device__ __forceinline__ void chunk_merge(unsigned long long& x0, unsigned long long& x1,
                                            int cb, int lane, int k, int jmax) {
  const int i0 = cb + lane, i1 = i0 + 32;
  if (jmax == 32) {
    const bool asc = (i0 & k) == 0;
    cmp_swap(x0, x1, asc);
    jmax = 16;
  }
  for (int j = jmax; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
    const unsigned long long y0 = __shfl_xor_sync(kFull, x0, j);
    const unsigned long long y1 = __shfl_xor_sync(kFull, x1, j);
    // the lower index of a pair keeps the minimum when the block ascends
    const bool min0 = lower == ((i0 & k) == 0), min1 = lower == ((i1 & k) == 0);
    x0 = (x0 < y0) == min0 ? x0 : y0;
    x1 = (x1 < y1) == min1 ? x1 : y1;
  }
}

template <int C, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1) beam_select_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned long long keys[];  // [npow2]
  const int nsamp = p.npow2 / p.sample;
  unsigned long long* samples = keys + p.npow2;            // [C][nsamp] if C > 1
  unsigned long long* out = samples + (C > 1 ? C * nsamp : 0);  // [W/C], rounded up to even
  int* e0s = reinterpret_cast<int*>(out + ((p.W / C + 1) & ~1));  // [R]
  __shared__ unsigned red[2][32];
  __shared__ unsigned s_nvalid;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned crank = cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Wc = p.W / C, w_begin = static_cast<int>(crank) * Wc, nkeys = 4 * Wc;
  const bool sk = p.skip[static_cast<size_t>(b) * p.V + p.col] != 0;
  const int* pk = p.packed + static_cast<size_t>(b) * p.R * p.ncols;
  if (tid == 0) s_nvalid = 0;

  // 1. The owned parents' cost, hets and valid, parked in their first two
  // key slots until the row's keys are formed; the column unpack: e0 per
  // slot, the D2 sums, the lookahead reset.
  for (int wl = tid; wl < Wc; wl += blockDim.x) {
    const size_t sw = static_cast<size_t>(b) * p.W + w_begin + wl;
    keys[wl * 4] = (static_cast<unsigned long long>(static_cast<unsigned>(p.cost[sw])) << 32) |
                   static_cast<unsigned>(p.hets[sw]);
    keys[wl * 4 + 1] = p.valid[sw];
  }
  unsigned s0 = 0, s1 = 0;
  for (int r = tid; r < p.R; r += blockDim.x) {
    const int v = pk[static_cast<size_t>(r) * p.ncols + p.col];
    const int a = (v >> kQualBits) & 3;
    const int qe = sk ? 0 : (v & ((1 << kQualBits) - 1));
    const int q0 = a == 0 ? qe : 0, q1 = a == 1 ? qe : 0;
    e0s[r] = q1 - q0;
    if (crank == 0) {
      p.e0_out[static_cast<size_t>(b) * p.R + r] = q1 - q0;
      p.rn_out[static_cast<size_t>(b) * p.R + r] =
          (pk[static_cast<size_t>(r) * p.ncols + p.col + 1] >> (kQualBits + 2)) & 1;
    }
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
  const unsigned sum_q0 = t0, sum_q1 = t1;

  // Candidate keys, kRows parents a warp at a time; lane 4u + c forms the
  // key of choice c of row u.
  const int* rows = p.delta + (static_cast<size_t>(b) * p.W + w_begin) * p.R;
  unsigned nvalid = 0;
  for (int w0 = warp * kRows; w0 < Wc; w0 += nwarps * kRows) {
    unsigned acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    row_sums<kVec>(rows, e0s, w0, Wc, p.R, lane, acc);
    const unsigned total = warp_reduce_scatter16(acc, lane);
    const int u = (lane >> 2) & (kRows - 1), c = lane & 3;
    // value 3u + s (s: m0, mp, mm) sits in lanes 2(3u + s) and 2(3u + s) + 1
    const unsigned m0 = __shfl_sync(kFull, total, 6 * u);
    const unsigned mp = __shfl_sync(kFull, total, 6 * u + 2);
    const unsigned mm = __shfl_sync(kFull, total, 6 * u + 4);
    const int wl = w0 + u;
    const bool mine = lane < 4 * kRows && wl < Wc;
    unsigned long long parked = 0, parked_valid = 0;
    if (mine) {
      parked = keys[wl * 4];
      parked_valid = keys[wl * 4 + 1];
    }
    __syncwarp();
    if (mine) {
      const int w = w_begin + wl;
      const int cw = static_cast<int>(parked >> 32), hw = static_cast<int>(parked);
      const bool cv = parked_valid != 0 && !(hw == 0 && c == 1) && (!sk || c == 0);
      int kc = p.big;
      if (cv) {
        const unsigned d2 = (c == 0 || c == 3) ? sum_q0 : sum_q1;
        const unsigned m = c == 0 ? mp : (c == 1 ? mm : m0);
        kc = static_cast<int>(static_cast<unsigned>(cw) - m0 + d2 + m);
      }
      const int inc = sk ? 0 : 1 - (c >> 1);
      const unsigned sec = (static_cast<unsigned>(p.hets_cap - (hw + inc)) << p.order_bits) |
                           static_cast<unsigned>(w * 4 + c);
      keys[wl * 4 + c] = make_key(kc, static_cast<int>(sec));
      nvalid += cv ? 1u : 0u;
    }
  }
  for (int i = nkeys + tid; i < p.npow2; i += blockDim.x) keys[i] = ~0ull;
  nvalid = warp_sum(nvalid);
  if (lane == 0 && nvalid != 0) atomicAdd(&s_nvalid, nvalid);
  __syncthreads();

  // 2. Local bitonic sort, ascending: each 64-key chunk in registers, then
  // every larger block size k, its strides ≥ 64 in shared memory and the
  // rest in registers.
  for (int cb = warp * kChunk; cb < p.npow2; cb += nwarps * kChunk) {
    unsigned long long x0 = keys[cb + lane], x1 = keys[cb + 32 + lane];
    for (int k = 2; k <= kChunk; k <<= 1) chunk_merge(x0, x1, cb, lane, k, k >> 1);
    keys[cb + lane] = x0;
    keys[cb + 32 + lane] = x1;
  }
  __syncthreads();
  for (int k = 2 * kChunk; k <= p.npow2; k <<= 1) {
    // strides ≥ 64 through shared memory, two a barrier where both are
    for (int j = k >> 1; j >= kChunk; j >>= 2) {
      if (j >= 2 * kChunk) {
        const int h = j >> 1;
        for (int q = tid; q < p.npow2 >> 2; q += blockDim.x) {
          const int i = ((q & ~(h - 1)) << 2) | (q & (h - 1));
          const bool asc = (i & k) == 0;
          unsigned long long x[4] = {keys[i], keys[i + h], keys[i + j], keys[i + j + h]};
          cmp_swap(x[0], x[2], asc);
          cmp_swap(x[1], x[3], asc);
          cmp_swap(x[0], x[1], asc);
          cmp_swap(x[2], x[3], asc);
          keys[i] = x[0];
          keys[i + h] = x[1];
          keys[i + j] = x[2];
          keys[i + j + h] = x[3];
        }
      } else {
        for (int q = tid; q < p.npow2 >> 1; q += blockDim.x) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          unsigned long long x = keys[i], y = keys[i + j];
          cmp_swap(x, y, (i & k) == 0);
          keys[i] = x;
          keys[i + j] = y;
        }
      }
      __syncthreads();
    }
    for (int cb = warp * kChunk; cb < p.npow2; cb += nwarps * kChunk) {
      unsigned long long x0 = keys[cb + lane], x1 = keys[cb + 32 + lane];
      chunk_merge(x0, x1, cb, lane, k, 32);
      keys[cb + lane] = x0;
      keys[cb + 32 + lane] = x1;
    }
    __syncthreads();
  }

  // 3. Every run is sorted and every parent's state has been read.
  cluster.sync();

  // 4. Rank by counting. Each other CTA's run, sampled at its every
  // sample-th key (the last of each window of `sample`; every key when
  // sample is 1), is copied into this CTA's shared memory; a key's count
  // in that run is then found by a binary search in the local copy and,
  // for sample > 1, one in the run's window remotely.
  for (int x0 = tid; x0 < C * nsamp; x0 += kCopyBatch * blockDim.x) {
    unsigned long long v[kCopyBatch];  // all loads in flight, then the stores
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int x = x0 + u * blockDim.x, q = x / nsamp;
      if (x < C * nsamp && q != static_cast<int>(crank))
        v[u] = ld_cluster_u64(cluster_addr(keys + (x - q * nsamp + 1) * p.sample - 1, q));
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x < C * nsamp && x / nsamp != static_cast<int>(crank)) samples[x] = v[u];
    }
  }
  __syncthreads();
  const int limit = min(nkeys, p.W + 1);
  for (int i = tid; i < limit; i += blockDim.x) {
    const unsigned long long key = keys[i];
    // win[q]: the samples of run q below key, so its keys below key are
    // win[q]·sample plus those below key in window win[q]
    int win[C];
#pragma unroll
    for (int q = 0; q < C; ++q) win[q] = 0;
    for (int step = nsamp >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q != static_cast<int>(crank) && samples[q * nsamp + win[q] + step - 1] < key)
          win[q] += step;
    }
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (q != static_cast<int>(crank) && samples[q * nsamp + win[q]] < key) ++win[q];
    int rank = i, off[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      off[q] = 0;
      if (q != static_cast<int>(crank)) rank += win[q] * p.sample;
    }
    // the window's last key is not below key, so `sample` - 1 keys remain
    for (int step = p.sample >> 1; step > 0; step >>= 1) {
      unsigned long long probe[C];
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q != static_cast<int>(crank) && win[q] < nsamp)
          probe[q] = ld_cluster_u64(
              cluster_addr(keys + win[q] * p.sample + off[q] + step - 1, q));
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q != static_cast<int>(crank) && win[q] < nsamp && probe[q] < key) off[q] += step;
    }
#pragma unroll
    for (int q = 0; q < C; ++q) rank += off[q];

    if (rank < p.W) {
      // survivor `rank` goes to the output slice of the CTA that owns it
      const int owner = rank / Wc;
      st_cluster_u64(cluster_addr(out + (rank - owner * Wc), owner), key);
    } else if (rank == p.W) {
      p.dmin[static_cast<size_t>(p.col) * p.B + b] = key_cost(key);
    }
  }
  if (crank == 0 && tid == 0) {
    unsigned nv = 0;
    for (int q = 0; q < C; ++q) nv += ld_cluster_u32(cluster_addr(&s_nvalid, q));
    const int n = static_cast<int>(nv) - p.W;
    p.pruned[static_cast<size_t>(p.col) * p.B + b] = n > 0 ? n : 0;
  }

  // 5. Every survivor is in its slice, and no CTA reads another's shared
  // memory after this barrier. Each CTA writes its slice of survivors
  // [q·W/C, (q+1)·W/C), coalesced.
  cluster.sync();
  const int omask = (1 << p.order_bits) - 1;
  const size_t tcol = static_cast<size_t>(p.col) * p.B * p.W + static_cast<size_t>(b) * p.W;
  for (int j = tid; j < Wc; j += blockDim.x) {
    const unsigned long long key = out[j];
    const int kc = key_cost(key), sec = key_sec(key);
    const int flat = sec & omask;
    const int ch = flat & 3;
    const int rank = w_begin + j;
    const size_t o = static_cast<size_t>(b) * p.W + rank;
    p.parents[tcol + rank] = static_cast<short>(flat >> 2);
    p.choices[tcol + rank] = static_cast<signed char>(ch);
    p.cost[o] = kc;
    p.hets[o] = p.hets_cap - (sec >> p.order_bits);
    p.valid[o] = kc < p.big ? 1 : 0;
    p.sgn[o] = ch == 0 ? 1 : (ch == 1 ? -1 : 0);
  }
}

template <int C, bool kVec>
cudaError_t launch(const Params& p, int device, int threads, size_t smem, cudaStream_t stream) {
  void (*fn)(Params) = beam_select_kernel<C, kVec>;
  // per instantiation and device (cudaFuncSetAttribute holds per device):
  // the shared memory opted into, and the last configuration whose cluster
  // placement was checked
  static size_t opted[kMaxDevices] = {};
  static int checked_threads[kMaxDevices] = {};
  static size_t checked_smem[kMaxDevices] = {};
  cudaError_t err;
  if (smem > opted[device]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted[device] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.B * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (threads != checked_threads[device] || smem != checked_smem[device]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return err;
    // the card cannot place one cluster of this shape
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    checked_threads[device] = threads;
    checked_smem[device] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch(int cluster, const Params& p, int device, int threads, size_t smem,
                     cudaStream_t stream) {
  switch (cluster) {
    case 1: return launch<1, kVec>(p, device, threads, smem, stream);
    case 2: return launch<2, kVec>(p, device, threads, smem, stream);
    case 4: return launch<4, kVec>(p, device, threads, smem, stream);
    case 8: return launch<8, kVec>(p, device, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cluster, threads, sample and smem are kernels.beam_select_plan(B, W, R).
HP_EXPORT int hp_beam_select(const int* delta, int* cost, int* hets, unsigned char* valid,
                             const int* packed, const unsigned char* skip, int B, int W,
                             int R, int ncols, int V, int col, int order_bits, int hets_cap,
                             int big, int cluster, int threads, int sample, int smem,
                             short* parents, signed char* choices, int* pruned, int* dmin,
                             int* sgn, int* e0, int* rn, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (cluster < 1 || W % cluster != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || sample < 1 || (sample & (sample - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int npow2 = kChunk;
  while (npow2 < 4 * (W / cluster)) npow2 <<= 1;
  const size_t copies = cluster > 1 ? static_cast<size_t>(cluster) * (npow2 / sample) : 0;
  const size_t slice = (W / cluster + 1) & ~1;
  if (sample > npow2 ||
      static_cast<size_t>(smem) < (npow2 + copies + slice) * 8 + static_cast<size_t>(R) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{delta,  cost, hets, valid, packed, skip,       parents,  choices, pruned,
                 dmin,   sgn,  e0,   rn,    B,      W,          R,        ncols,   V,
                 col,    order_bits, hets_cap,     big,         npow2,    sample};
  const bool vec = R % 4 == 0 && (reinterpret_cast<uintptr_t>(delta) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    return vec ? dispatch<true>(cluster, p, device, threads, smem, s)
               : dispatch<false>(cluster, p, device, threads, smem, s);
  }));
}
