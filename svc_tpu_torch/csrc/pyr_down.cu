// K4 pyr_down_u8: one cv::pyrDown level of a batch of uint8 planes.
//
// Replaces svc_tpu/ops/pyramid_pallas.py pyr_down_mxu_pallas (:271) and
// pyr_down_pallas (:95), and the odd-size path of svc_tpu/ops/pyramid.py
// (_pyr_down_general, :92). The MXU band matrices of the TPU kernel are
// dropped: on this card the filter is integer adds. Arithmetic, bound and
// design: pyr_down.cuh, over dense planes.
#include "pyr_down.cuh"

// src: (n, h, w) uint8, dst: (n, (h+1)/2, (w+1)/2) uint8, both contiguous.
SVC_EXPORT int svc_pyr_down_u8(const void* src, void* dst, int n, int h,
                               int w, void* stream) {
  const DensePlanes planes{static_cast<const uint8_t*>(src), h, w};
  return launch_pyr_down(planes, dst, n, h, w, stream);
}
