// backtrace — haplotypes from the beam trace, newest column to oldest.
//
// Replaces: hiphase_tpu/phasing/beam.py::backtrace_tile (lines 362-385),
// which tiles_backtrace_device (lines 341-359) calls once per tile, newest
// tile first, carrying the slot. Here one launch walks every column of a
// batch, since the port keeps one [V, B, W] trace per batch.
//
// What bounds it on an H100: latency. Each batch row is a chain of V
// dependent reads (the parent read at column j picks the slot read at column
// j-1), two loads per column, with almost no bytes moved: V x B x 3 bytes
// read and V x B x 2 written.
//
// Design: one thread per batch row, walking its chain; rows are
// independent, so B threads run side by side. At the carried slot it reads
// the choice and the parent, and writes h1 = c & 1 and
// h2 = 1 - ((c & 1) ^ (c >> 1)), or 2 on skipped columns.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) backtrace_kernel(
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

}  // namespace

HP_EXPORT int hp_backtrace(const int* slot, const short* parents, const signed char* choices,
                           const unsigned char* skip, int T, int B, int W, int* slot_out,
                           unsigned char* h1, unsigned char* h2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  backtrace_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(slot, parents, choices, skip, T, B,
                                                           W, slot_out, h1, h2);
  return static_cast<int>(cudaGetLastError());
}
