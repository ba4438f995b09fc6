// Accessors for stacks of uint8 luma planes, shared by the kernels that
// template their reads on the plane layout (window_sads.cuh, pyr_down.cuh).
//
// at(f, y, x) is pixel (y, x) of frame f; callers keep (y, x) inside the
// frame.
#pragma once

#include "common.cuh"

// (frames, h, w) contiguous planes.
struct DensePlanes {
  const uint8_t* base;
  int h, w;
  __device__ __forceinline__ uint8_t at(int f, int y, int x) const {
    return base[(static_cast<size_t>(f) * h + y) * w + x];
  }
};

// Column-pitched subplanes (tbw, frames, h, nbx), w = tbw * nbx: spatial
// column x of a frame is lane x / tbw of subplane x % tbw (svc_tpu's
// j-split luma layout).
struct PitchedPlanes {
  const uint8_t* base;
  int frames, h, nbx, tbw;
  __device__ __forceinline__ uint8_t at(int f, int y, int x) const {
    const int j = x % tbw;
    return base[((static_cast<size_t>(j) * frames + f) * h + y) * nbx + x / tbw];
  }
};

// 4x4 byte transpose: byte k of t[m] is byte m of wk. Four words of four
// subplanes at the same lanes become the spatial words of those lanes (the
// un-pitch of the specialised K8 kernels).
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3, uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
  const uint32_t b = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
  const uint32_t c = __byte_perm(w2, w3, 0x5140);
  const uint32_t d = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}
