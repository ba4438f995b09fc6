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
