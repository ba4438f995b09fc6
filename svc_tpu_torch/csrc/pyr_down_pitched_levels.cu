// K8 (pyramid) pyr_down_pitched_levels: pyramid levels 1..D (D <= 3
// halvings) of column-pitched luma subplanes in one launch, written as
// spatial planes, each level bit-equal to chained cv::pyrDown of the
// respatialized input.
//
// Replaces svc_tpu/ops/pyramid_pallas.py pyr_down_mxu_pitched_pallas (:435)
// and, on the pitched encoder's path, the two pyr_down_mxu_pallas calls
// after it (svc_tpu/models/encoder.py:402-420): level 1 from the subplanes,
// levels 2-3 from the spatial level 1. The port ran that as three launches
// (pyr_down_pitched.cu, kept as the general kernel, then the single-level
// K4 twice), with levels 1 and 2 written to device memory and read back.
//
// Bound: bytes. The subplanes read once and levels 1..D written once:
// 24.97 MB for 9 x 1088 x 1920 at D = 3, 0.0075 ms on an H100. The kernel
// is K4's fused one (pyr_down_levels.cuh: every level after 0 is the same
// code); only the level-0 loader differs. A 16-byte chunk of a spatial row
// is 16 / tbw lanes of each of the tbw subplanes: at tbw = 8, one 2-byte
// load from each of the 8 subplanes, at tbw = 4 one 4-byte load from each
// of the 4, then byte transposes (transpose4, planes.cuh) give the chunk's
// four spatial words, which go to the same shared level-0 region as K4's.
// Rows whose loads would be unaligned, and chunks across the frame's edge,
// take byte loads through the pitched layout. A subplane row's run of a
// region row is 20 bytes, so the loads move more sectors than K4's 16-byte
// ones; they mostly hit L2 (the CTAs of a tile row share them).
#include "pyr_down_levels.cuh"

namespace {

// Level 0 as (Tbw, n, h0, nbx) subplanes, w0 = Tbw * nbx: spatial column x
// of a plane is lane x / Tbw of subplane x % Tbw.
template <int Tbw>
struct PitchedLevel0 {
  static_assert(Tbw == 4 || Tbw == 8, "a 16-byte chunk is whole words or halves");
  const uint8_t* base;
  size_t sub;  // subplane stride, n * h0 * nbx bytes
  int nbx;
  int vec;  // subplane rows aligned for loads of 16 / Tbw bytes
  __device__ __forceinline__ uint4 chunk(int plane, int y, int x, int h0, int w0) const {
    const uint8_t* row = base + (static_cast<size_t>(plane) * h0 + y) * nbx;
    if (vec && x >= 0 && x + 16 <= w0) {
      const int lane = x / Tbw;
      uint32_t lo[4];
      if constexpr (Tbw == 8) {
        // h[j]: lanes x/8 and x/8 + 1 of subplane j, spatial bytes j and 8 + j
        uint32_t h[8], hi[4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = __ldg(reinterpret_cast<const unsigned short*>(row + j * sub + lane));
        }
        transpose4(h[0], h[1], h[2], h[3], lo);
        transpose4(h[4], h[5], h[6], h[7], hi);
        return make_uint4(lo[0], hi[0], lo[1], hi[1]);
      } else {
        // w[j]: lanes x/4 .. x/4 + 3 of subplane j, spatial bytes j + 4m
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = __ldg(reinterpret_cast<const unsigned int*>(row + j * sub + lane));
        }
        transpose4(w[0], w[1], w[2], w[3], lo);
        return make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int xx = x + j;
      if (xx >= 0 && xx < w0) {
        const unsigned ux = static_cast<unsigned>(xx);
        u[j >> 2] |= static_cast<uint32_t>(__ldg(row + (ux % Tbw) * sub + ux / Tbw))
                     << (8 * (j & 3));
      }
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <int Tbw>
int launch_pitched(const void* y8, void* dst1, void* dst2, void* dst3, int n, int h,
                   int nbx, int halvings, void* stream) {
  constexpr int kAlign = 16 / Tbw;  // bytes of one subplane's share of a chunk
  const PitchedLevel0<Tbw> level0{
      static_cast<const uint8_t*>(y8), static_cast<size_t>(n) * h * nbx, nbx,
      reinterpret_cast<uintptr_t>(y8) % kAlign == 0 && nbx % kAlign == 0};
  return launch_pyr_down_levels(level0, dst1, dst2, dst3, n, h, Tbw * nbx, halvings,
                                stream);
}

}  // namespace

// y8: (tbw, n, h, nbx) uint8 subplanes, tbw 4 or 8, w = tbw * nbx; dst_l:
// (n, h_l, w_l) uint8 for l = 1..halvings, h_l = (h_{l-1} + 1) / 2
// (likewise w), unused pointers null. All contiguous; 1 <= halvings <= 3.
// Refuses (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_pyr_down_pitched_levels(const void* y8, void* dst1, void* dst2,
                                           void* dst3, int tbw, int n, int h, int nbx,
                                           int halvings, void* stream) {
  switch (tbw) {
    case 8: return launch_pitched<8>(y8, dst1, dst2, dst3, n, h, nbx, halvings, stream);
    case 4: return launch_pitched<4>(y8, dst1, dst2, dst3, n, h, nbx, halvings, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
