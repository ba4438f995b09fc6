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

#define SVC_EXPORT extern "C" __attribute__((visibility("default")))

// Largest dynamic shared memory a launch may request without the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in.
constexpr int kSvcDefaultSmemBytes = 48 * 1024;
