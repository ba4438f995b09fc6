// Shared helpers of the svc_tpu_torch CUDA kernels.
//
// Every kernel library entry point is a plain C function taking device
// pointers, sizes and a cudaStream_t (PyTorch's current stream, passed from
// Python as an integer). It launches, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SVC_EXPORT extern "C" __attribute__((visibility("default")))

// Largest dynamic shared memory a launch may request without the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in.
constexpr int kSvcDefaultSmemBytes = 48 * 1024;

// A SAD (an exact integer below 2^23) as a kernel's output type: float32
// by 2^23 + sad in the mantissa less 2^23 (an integer-to-float conversion
// issues at a quarter of that rate), int32 as it is.
template <class Out>
__device__ __forceinline__ Out sad_as(uint32_t sad) {
  if constexpr (std::is_same<Out, float>::value) {
    return __uint_as_float(0x4b000000u | sad) - 8388608.0f;
  } else {
    return static_cast<Out>(sad);
  }
}
