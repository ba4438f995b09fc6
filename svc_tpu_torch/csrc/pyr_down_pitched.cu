// K8 (pyramid) pyr_down_pitched_general: one cv::pyrDown level read from
// column-pitched luma subplanes, written as spatial planes, at any
// subplane count.
//
// Replaces svc_tpu/ops/pyramid_pallas.py pyr_down_mxu_pitched_pallas
// (:435), which folds the un-pitch permutation into per-subplane MXU band
// matrices, for the shapes the fused kernel (pyr_down_pitched_levels.cu:
// tbw 4 or 8, levels 1-3 in one launch) does not take, and as its
// yardstick. Here K4's single-level kernel (pyr_down.cuh) reads its input
// tile through a pitched accessor (planes.cuh), so the output is K4's for
// the respatialized input, bit for bit, and no spatial copy of the input is
// built.
//
// Bound: memory, as K4; a tile row's reads touch tbw subplanes, so its
// loads are not coalesced (K4's are).
#include "pyr_down.cuh"

// y8: (tbw, n, h, nbx) uint8, w = tbw * nbx; dst: (n, (h+1)/2, (w+1)/2)
// uint8. Both contiguous.
SVC_EXPORT int svc_pyr_down_pitched_general(const void* y8, void* dst, int tbw,
                                            int n, int h, int nbx, void* stream) {
  const PitchedPlanes planes{static_cast<const uint8_t*>(y8), n, h, nbx, tbw};
  return launch_pyr_down(planes, dst, n, h, tbw * nbx, stream);
}
