// permute_update — the survivor gather that ends each beam column:
//   out[b, w, :] = rn[b, :] ? 0 : delta[b, idx[b, w], :] + sgn[b, w] * e0[b, :]
//
// Replaces: scripts/pallas_permute.py::permute_update_pallas (pallas_call at
// line 63, kernel body lines 36-57), the Pallas form of the gather at
// hiphase_tpu/phasing/beam.py:216-220 inside _step. On the TPU the gather
// was a one-hot bf16 matmul on the MXU with a hi/lo digit split, exact only
// for |δ| < 2^15. Hopper gathers natively, so this is a plain int32 gather
// with no bound on δ.
//
// What bounds it on an H100: device-memory bandwidth. Each column reads and
// writes δ once, 2 x 32 MiB at (B, W, R) = (64, 1024, 128), against
// 3.35 TB/s; the arithmetic is one multiply-add per element.
//
// Design: the grid spans B x (W / rows-per-block), about 2048 blocks on the
// main path's shapes, so every SM shares the traffic. Each block copies a
// few whole survivor rows with 16-byte loads and stores (when R % 4 == 0 and
// the buffers are 16-byte aligned; one int at a time otherwise), neighbouring
// threads on neighbouring addresses. Input and output are two distinct δ
// buffers that the caller swaps every column (ping-pong), so no block reads
// a row that another block is overwriting.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = 1024;  // vectors (or ints) copied per block

__device__ __forceinline__ int upd(int d, int s, int e, int z) {
  return z ? 0 : static_cast<int>(static_cast<unsigned>(d) + static_cast<unsigned>(s * e));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) permute_update_kernel(
    const int* __restrict__ delta, const short* __restrict__ idx, const int* __restrict__ sgn,
    const int* __restrict__ e0, const int* __restrict__ rn, int* __restrict__ out, int W, int R,
    int rows_per_block) {
  const int b = blockIdx.y;
  const int w0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, W - w0);
  const int per_row = kVec ? (R >> 2) : R;
  const size_t row_b = static_cast<size_t>(b) * W;
  for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
    const int wl = t / per_row;
    const int r = t - wl * per_row;
    const size_t sw = row_b + w0 + wl;
    const size_t src = row_b + idx[sw];
    const int s = sgn[sw];
    if (kVec) {
      const int4 d = reinterpret_cast<const int4*>(delta + src * R)[r];
      const int4 e = reinterpret_cast<const int4*>(e0 + static_cast<size_t>(b) * R)[r];
      const int4 z = reinterpret_cast<const int4*>(rn + static_cast<size_t>(b) * R)[r];
      int4 o;
      o.x = upd(d.x, s, e.x, z.x);
      o.y = upd(d.y, s, e.y, z.y);
      o.z = upd(d.z, s, e.z, z.z);
      o.w = upd(d.w, s, e.w, z.w);
      reinterpret_cast<int4*>(out + sw * R)[r] = o;
    } else {
      const size_t br = static_cast<size_t>(b) * R + r;
      out[sw * R + r] = upd(delta[src * R + r], s, e0[br], rn[br]);
    }
  }
}

}  // namespace

HP_EXPORT int hp_permute_update(const int* delta, const short* idx, const int* sgn,
                                const int* e0, const int* rn, int* out, int B, int W, int R,
                                int device, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(delta) | reinterpret_cast<uintptr_t>(e0) |
                         reinterpret_cast<uintptr_t>(rn) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0;
  const bool vec = R % 4 == 0 && aligned;
  const int per_row = vec ? R / 4 : R;
  const int rows_per_block = std::max(1, kItemsPerBlock / std::max(per_row, 1));
  const dim3 grid((W + rows_per_block - 1) / rows_per_block, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    if (vec) {
      permute_update_kernel<true><<<grid, kThreads, 0, s>>>(delta, idx, sgn, e0, rn, out, W, R,
                                                            rows_per_block);
    } else {
      permute_update_kernel<false><<<grid, kThreads, 0, s>>>(delta, idx, sgn, e0, rn, out, W,
                                                             R, rows_per_block);
    }
    return cudaGetLastError();
  }));
}
