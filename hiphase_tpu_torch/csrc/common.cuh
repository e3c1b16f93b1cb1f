// Shared by the port's kernels: the C export macro, the error-string entry
// point each library exposes, the device guard of every entry point, and
// warp reductions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HP_EXPORT extern "C" __attribute__((visibility("default")))

// One translation unit per library, so this definition is not duplicated.
HP_EXPORT const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Runs launch() (returning a cudaError_t) with `device` current on the
// calling thread, and gives the caller's current device back afterwards on
// every path: torch keeps its own record of the current device, and a launch
// on cuda:1 must not leave the thread on cuda:1 behind its back. Returns
// launch()'s error, else the restore's.
template <typename F>
cudaError_t on_device(int device, F&& launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  err = launch();
  if (prev != device) {
    const cudaError_t restore = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restore;
  }
  return err;
}

// Sum over the warp; every lane gets the total. Unsigned, so the int32
// sums wrap exactly as XLA's do.
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
