// Error reporting for the ctypes bindings (svc_tpu_torch/kernels/build.py).
#include "common.cuh"

SVC_EXPORT const char* svc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
