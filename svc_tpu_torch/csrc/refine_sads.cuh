// The lane-per-anchor-row refine kernel of K3 and K7 (defined in
// refine_sads.cu): candidate SADs at radius r = 1 to 4 of square block x
// block MV blocks (block 4, 8 or 16) for t_count frames, frame t's tracked
// plane at tracked + t * frame_stride and its anchor at anchor + t *
// frame_stride.
#pragma once

#include <stddef.h>

// tracked, anchor: (fh, fw) uint8 planes, 16-byte aligned; mv: (t_count,
// fh/block, fw/block, 2) int32 (x, y); out: (t_count, (2r + 1)^2,
// fh/block, fw/block) int32. All contiguous; block divides fh and fw.
// Refuses (cudaErrorInvalidValue) anything else.
int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int block, int r,
                       void* stream);
