// Shared helpers of the port's CUDA sources. Every source is built on its
// own into one shared library with a plain C interface (loaded with ctypes
// by jegal_torch/ops/kernels/_build.py), so each includes this header once.
#pragma once

#include <cuda_runtime.h>

// Return the pending launch error, if any, from the calling C entry point.
#define JT_CHECK_LAUNCH()                                   \
  do {                                                      \
    cudaError_t jt_err_ = cudaGetLastError();               \
    if (jt_err_ != cudaSuccess) return (int)jt_err_;        \
  } while (0)

// Returned by an entry point for a shape it was not built for (the Python
// wrapper checks shapes first, so this signals a wrapper bug).
#define JT_ERR_SHAPE (-1)

extern "C" const char* jt_error_string(int code) {
  if (code == JT_ERR_SHAPE) return "shape not supported by the kernel";
  return cudaGetErrorString((cudaError_t)code);
}

namespace jt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace jt
