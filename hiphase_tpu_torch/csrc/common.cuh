// Shared by the port's kernels: the C export macro, the error-string entry
// point each library exposes, and warp reductions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HP_EXPORT extern "C" __attribute__((visibility("default")))

// One translation unit per library, so this definition is not duplicated.
HP_EXPORT const char* hp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sum over the warp; every lane gets the total. Unsigned, so the int32
// sums wrap exactly as XLA's do.
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
