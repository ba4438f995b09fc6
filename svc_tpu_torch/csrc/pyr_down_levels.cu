// K4 pyr_down_levels: pyramid levels 1..D (D <= 3 halvings) of a batch of
// dense uint8 planes in one launch, each level bit-equal to chained
// cv::pyrDown.
//
// Replaces svc_tpu/ops/pyramid_pallas.py pyr_down_mxu_pallas (:271) on the
// encoder's path, where ops/pyramid.py build_pyramid called the
// single-level kernel (pyr_down.cu, kept as the yardstick and for single
// levels) once per level: three launches, and levels 1 and 2 written to
// device memory and read back.
//
// Bound: bytes. Level 0 read once and levels 1..D written once: 24.97 MB
// for the 9 x 1088 x 1920 stack at D = 3, 0.0075 ms on an H100. The kernel
// and its design are pyr_down_levels.cuh's; here level 0 arrives as
// 16-byte vector loads of the dense rows (DenseLevel0; rows must be
// 16-byte aligned, else byte loads).
#include "pyr_down_levels.cuh"

// src: (n, h, w) uint8; dst_l: (n, h_l, w_l) uint8 for l = 1..halvings,
// h_l = (h_{l-1} + 1) / 2 (likewise w), unused pointers null. All
// contiguous; 1 <= halvings <= 3. Refuses (cudaErrorInvalidValue) anything
// else.
SVC_EXPORT int svc_pyr_down_levels(const void* src, void* dst1, void* dst2,
                                   void* dst3, int n, int h, int w, int halvings,
                                   void* stream) {
  const DenseLevel0 level0{static_cast<const uint8_t*>(src),
                           reinterpret_cast<uintptr_t>(src) % 16 == 0 && w % 16 == 0};
  return launch_pyr_down_levels(level0, dst1, dst2, dst3, n, h, w, halvings, stream);
}
