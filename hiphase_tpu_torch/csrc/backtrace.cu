// backtrace — haplotypes from the beam trace, newest column to oldest.
//
// Replaces: hiphase_tpu/phasing/beam.py::backtrace_tile (lines 362-385),
// which tiles_backtrace_device (lines 341-359) calls once per tile, newest
// tile first, carrying the slot. Here one launch walks every column of a
// batch, since the port keeps one [V, B, W] trace per batch.
//
// From column T-1 down to 0, with c = choices[j, b, s]: h1[j, b] = c & 1 and
// h2[j, b] = 1 - ((c & 1) ^ (c >> 1)), or 2 on skipped columns; then
// s = parents[j, b, s]. The final s is returned.
//
// What bounds it on an H100: latency. Each batch row is a chain of T
// dependent lookups (the parent read at column j picks the slot read at
// column j-1) that move almost no bytes (3 a column and row). Walked in
// device memory, every step is a round trip of about 0.5 µs.
//
// Design: kernels.backtrace_plan(B, W, T) gives the branch and the ring.
//  - Streamed walk: one CTA per batch row, three roles.
//    Warp 1 (the producer) keeps a ring of `stages` stages in dynamic
//    shared memory full, each of `cols` (G) columns of the row's parents,
//    newest first: lane u issues one TMA bulk copy of column u's slice
//    (2W contiguous bytes), and all complete on the stage's `full` mbarrier
//    (complete_tx). Only the parents stream: the chain needs nothing else,
//    and one copy a column halves the copies, which set the pace below
//    W = 4096 (each costs about 65 ns of the SM's copy engine, whatever its
//    size up to a few KB; above it the SM's ~84 GB/s does).
//    Warp 0 (the walk) follows the chain through the ring, every lane on
//    the same slot, so a step is one address add and one shared-memory
//    load; it records each column's slot in a two-chunk history in shared
//    memory, and its 32 arrivals on the stage's `empty` mbarrier hand the
//    stage back once a stage. No device memory access is on the chain.
//    Warp 2 (the writer) turns each kChunk-column chunk of the history into
//    h1 / h2 once the walk has left it: the choice at each recorded slot
//    (independent loads, kChunk / 32 in flight a lane) and the row's skip
//    flags. The writes are strided by B, one byte a lane.
//    Bulk copies need 16-byte-aligned addresses and sizes, and a slice
//    starts at any even byte when W % 8 != 0, so each copy covers the
//    16-byte-aligned span around its slice and the walk indexes from the
//    slice's offset in its span; the span lies inside the tensor except for
//    a slice that ends in its last 15 bytes (when its size is not a
//    multiple of 16), whose column the walk reads from device memory
//    instead. The kernel thus reads the whole parents trace, 2·B·T·W bytes,
//    over B SMs, to take the latency off the chain.
//    The walk indexes shared memory with parent values unchecked: that is
//    safe because beam_select writes every slot's parent in [0, W), padded
//    batch rows included; the initial slot is the caller's (0).
//  - Direct chain: one thread per batch row walking its chain in device
//    memory (the kernel's first design), for widths above the crossover,
//    where streaming a column into one SM takes longer than the chain's
//    dependent load, and for traces whose base is not 16-byte aligned. The
//    crossover, measured on an H100 80GB HBM3 at 700 W, lies between
//    W = 8192 and 16384 at B = 64 and between 16384 and 32768 at B = 8;
//    kernels.backtrace_plan holds it (BACKTRACE_STREAM_MAX_WIDTH and
//    BACKTRACE_STREAM_MAX_ROW_SUM) with the times.
//
// The entry point restores the calling thread's current device after the
// launch.

#include "common.cuh"

namespace {

constexpr int kDirectThreads = 64;
constexpr int kStreamThreads = 96;  // warp 0 walks, warp 1 copies, warp 2 writes
constexpr int kProducer = 32;
constexpr int kWriter = 64;
// columns of a history chunk: a multiple of every stage's column count
constexpr int kChunk = 128;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kDirectThreads) backtrace_direct_kernel(
    const int* __restrict__ slot_in, const short* __restrict__ parents,
    const signed char* __restrict__ choices, const unsigned char* __restrict__ skip, int T,
    int B, int W, int* __restrict__ slot_out, unsigned char* __restrict__ h1,
    unsigned char* __restrict__ h2) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = slot_in[b];
  for (int j = T - 1; j >= 0; --j) {
    const size_t o = (static_cast<size_t>(j) * B + b) * W + s;
    const int c = choices[o];
    const int p = parents[o];
    const bool sk = skip[static_cast<size_t>(b) * T + j] != 0;
    h1[static_cast<size_t>(j) * B + b] = sk ? 2 : static_cast<unsigned char>(c & 1);
    h2[static_cast<size_t>(j) * B + b] =
        sk ? 2 : static_cast<unsigned char>(1 - ((c & 1) ^ (c >> 1)));
    s = p;
  }
  slot_out[b] = s;
}

struct StreamParams {
  const int* slot_in;
  const short* parents;
  const signed char* choices;
  const unsigned char* skip;
  int T, B, W;
  int* slot_out;
  unsigned char* h1;
  unsigned char* h2;
  int stages;     // ring stages, G columns each
  int col_bytes;  // a column's parents span (multiple of 16)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One TMA bulk copy of `bytes` (a multiple of 16) from 16-byte-aligned
// device memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ int lds_s16(unsigned a) {
  int v;
  asm volatile("ld.shared.s16 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

template <int G>
__global__ void __launch_bounds__(kStreamThreads, 1) backtrace_stream_kernel(
    const StreamParams p) {
  // [stages] full barriers, [stages] empty barriers, then the stages, each
  // G column spans of col_bytes
  extern __shared__ __align__(16) unsigned long long bars[];
  // the walk's slots, column j at j % (2·kChunk): two chunks, each with a
  // full (walked) and an empty (written out) barrier
  __shared__ short hist[2 * kChunk];
  __shared__ unsigned long long hist_bars[4];
  const int b = blockIdx.x, S = p.stages, tid = threadIdx.x, lane = tid & 31;
  const unsigned full0 = smem_addr(bars), empty0 = full0 + 8u * S;
  const unsigned ring0 = full0 + 16u * S;
  const unsigned hfull0 = smem_addr(hist_bars), hempty0 = hfull0 + 16u;
  const unsigned col_bytes = static_cast<unsigned>(p.col_bytes);
  const unsigned stage_bytes = G * col_bytes;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8u * i, 1);
      mbar_init(empty0 + 8u * i, 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(hfull0 + 8u * i, 1);
      mbar_init(hempty0 + 8u * i, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The row's parents slice at column j is [2·c0, 2·c0 + 2W) in bytes,
  // c0 = j·B·W + b·W. A slice ending past the tensor's last 16-byte
  // boundary has no aligned span: its column is read in place. Stage m
  // holds columns G·m + G - 1 down to G·m (those below T), so a stage
  // never straddles two chunks.
  const size_t BW = static_cast<size_t>(p.B) * p.W;
  const size_t row0 = static_cast<size_t>(b) * p.W;
  const size_t par_end = (2 * static_cast<size_t>(p.T) * BW) & ~static_cast<size_t>(15);
  constexpr size_t kAlign = ~static_cast<size_t>(15);
  const int mtop = (p.T - 1) / G, ctop = (p.T - 1) / kChunk;

  if (tid >= kProducer && tid < kWriter) {
    const unsigned char* pbase = reinterpret_cast<const unsigned char*>(p.parents);
    int slot = 0;
    unsigned phase = 0;
    for (int m = mtop; m >= 0; --m) {
      mbar_wait(empty0 + 8u * slot, phase ^ 1u);
      // lane u < G copies column G·m + G - 1 - u
      const int j = G * m + G - 1 - lane;
      const size_t c0 = static_cast<size_t>(j) * BW + row0, c1 = c0 + p.W;
      const size_t from = (2 * c0) & kAlign;
      const unsigned bytes = lane < G && j < p.T && 2 * c1 <= par_end
                                 ? static_cast<unsigned>(((2 * c1 + 15) & kAlign) - from)
                                 : 0u;
      const unsigned total = __reduce_add_sync(kFull, bytes);
      const unsigned full = full0 + 8u * slot;
      if (lane == 0) mbar_arrive_expect_tx(full, total);
      __syncwarp();
      if (bytes) bulk_copy(ring0 + slot * stage_bytes + lane * col_bytes, pbase + from, bytes, full);
      if (++slot == S) {
        slot = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  if (tid >= kWriter) {
    // h1 and h2 of each chunk once the walk has left it, one column a lane
    constexpr int kPerLane = kChunk / 32;
    const unsigned char* skip_row = p.skip + static_cast<size_t>(b) * p.T;
    for (int c = ctop; c >= 0; --c) {
      const int buf = c & 1;
      mbar_wait(hfull0 + 8u * buf, ((ctop - c) >> 1) & 1);
      int ch[kPerLane];
      bool sk[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = c * kChunk + i * 32 + lane;
        if (j < p.T) {
          const size_t o = static_cast<size_t>(j) * BW + row0 + hist[j & (2 * kChunk - 1)];
          ch[i] = p.choices[o];
          sk[i] = skip_row[j] != 0;
        }
      }
      mbar_arrive(hempty0 + 8u * buf);  // the slots are read
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = c * kChunk + i * 32 + lane;
        if (j < p.T) {
          const size_t o = static_cast<size_t>(j) * p.B + b;
          p.h1[o] = sk[i] ? 2 : static_cast<unsigned char>(ch[i] & 1);
          p.h2[o] = sk[i] ? 2 : static_cast<unsigned char>(1 - ((ch[i] & 1) ^ (ch[i] >> 1)));
        }
      }
    }
    return;
  }

  // The walk: every lane of warp 0 on the same slot, so the lookups are
  // broadcasts and the barriers see whole-warp arrivals.
  const unsigned bw8 = static_cast<unsigned>(BW & 7);
  int s = p.slot_in[b];
  int slot = 0;
  unsigned phase = 0;
  for (int m = mtop; m >= 0; --m) {
    const int jtop = G * m + G - 1, c = (G * m) / kChunk, buf = c & 1;
    if (m == mtop || (jtop + 1) % kChunk == 0)  // entering chunk c
      mbar_wait(hempty0 + 8u * buf, (((ctop - c) >> 1) & 1) ^ 1u);
    mbar_wait(full0 + 8u * slot, phase);
    const unsigned stage = ring0 + slot * stage_bytes;
    const size_t top0 = static_cast<size_t>(jtop) * BW + row0;
    if (jtop < p.T && 2 * (top0 + p.W) <= par_end) {
      // every column of the stage is in the ring: the chain is one
      // address add and one shared load a column
      const unsigned o = static_cast<unsigned>(top0);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const unsigned off = (o - u * bw8) & 7;  // the slice's offset in its span
        hist[(jtop - u) & (2 * kChunk - 1)] = static_cast<short>(s);
        s = lds_s16(stage + u * col_bytes + 2 * (off + s));
      }
    } else {
      for (int u = 0; u < G; ++u) {
        const int j = jtop - u;
        if (j >= p.T) continue;
        const size_t c0 = static_cast<size_t>(j) * BW + row0;
        hist[j & (2 * kChunk - 1)] = static_cast<short>(s);
        s = 2 * (c0 + p.W) <= par_end
                ? lds_s16(stage + u * col_bytes + 2 * (static_cast<unsigned>(c0 & 7) + s))
                : p.parents[c0 + s];
      }
    }
    mbar_arrive(empty0 + 8u * slot);
    if (++slot == S) {
      slot = 0;
      phase ^= 1u;
    }
    if ((G * m) % kChunk == 0 && lane == 0) mbar_arrive(hfull0 + 8u * buf);  // leaving chunk c
  }
  if (lane == 0) p.slot_out[b] = s;
}

template <int G>
cudaError_t launch_stream(const StreamParams& p, int smem, cudaStream_t stream) {
  // the opt-in holds per device, so it is set before every launch
  const cudaError_t err = cudaFuncSetAttribute(
      backtrace_stream_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  backtrace_stream_kernel<G><<<p.B, kStreamThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_stream(int cols, const StreamParams& p, int smem, cudaStream_t stream) {
  switch (cols) {
    case 1: return launch_stream<1>(p, smem, stream);
    case 2: return launch_stream<2>(p, smem, stream);
    case 4: return launch_stream<4>(p, smem, stream);
    case 8: return launch_stream<8>(p, smem, stream);
    case 16: return launch_stream<16>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

int up16(int n) { return (n + 15) & ~15; }

}  // namespace

// branch 0: the direct chain; branch 1: the streamed walk, with stages,
// cols (columns a stage) and smem from kernels.backtrace_plan(B, W, T).
HP_EXPORT int hp_backtrace(const int* slot, const short* parents, const signed char* choices,
                           const unsigned char* skip, int T, int B, int W, int branch,
                           int stages, int cols, int smem, int* slot_out, unsigned char* h1,
                           unsigned char* h2, int device, void* stream) {
  if (T < 1 || B < 1 || W < 1 || (branch != 0 && branch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_bytes = up16(2 * W) + 16;
  if (branch == 1 &&
      (cols < 1 || stages < 1 || stages > (T + cols - 1) / cols ||
       static_cast<long long>(smem) <
           static_cast<long long>(stages) * (16 + static_cast<long long>(cols) * col_bytes) ||
       (reinterpret_cast<uintptr_t>(parents) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    if (branch == 1) {
      const StreamParams p{slot, parents, choices, skip, T, B, W, slot_out, h1, h2, stages,
                           col_bytes};
      return dispatch_stream(cols, p, smem, s);
    }
    backtrace_direct_kernel<<<(B + kDirectThreads - 1) / kDirectThreads, kDirectThreads, 0, s>>>(
        slot, parents, choices, skip, T, B, W, slot_out, h1, h2);
    return cudaGetLastError();
  }));
}
