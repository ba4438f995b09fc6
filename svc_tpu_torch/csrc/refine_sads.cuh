// The SAD launchers shared across the entries of K3, K7 and K9: candidate
// SADs at radius r = 1 to 4 of square MV blocks for t_count frames, frame
// t's tracked plane at tracked + t * frame_stride and its anchor at anchor
// + t * frame_stride (K3: the stack and the stack plus one plane, stride a
// plane; K7: the pair, stride 0; K9: the two stacks, stride a plane). Each
// refuses (cudaErrorInvalidValue) what it does not take.
#pragma once

#include <stddef.h>
#include <stdint.h>

// K3's lane-per-anchor-row kernel (refine_sads.cu, over refine_rows.cuh)
// for B x B blocks: B = 4, 8, 16 with int32 output (K3, K7), 4 and 8 with
// float32 (K9). tracked, anchor: (fh, fw) uint8 planes, 16-byte aligned,
// frame_stride a multiple of 16; mv: (t_count, fh/B, fw/B, 2) int32 (x,
// y); out: (t_count, (2r + 1)^2, fh/B, fw/B). All contiguous; B divides
// fh and fw.
template <int B, class Out>
int launch_refine_rows(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, Out* out,
                       int t_count, int fh, int fw, int r, void* stream);

// K9's 2x2 kernel (candidate_sads.cu), a thread a block: float32 output
// (K9) or int32 (K3, K7), the frame stride a plane (fh * fw: K9, K3; K7
// has one frame). tracked 4-byte and anchor 2-byte aligned; mv: (t_count,
// fh/2, fw/2, 2) int32 (x, y); out: (t_count, (2r + 1)^2, fh/2, fw/2). All
// contiguous; fh and fw even.
template <class Out>
int launch_block2_sads(const void* tracked, const void* anchor, const void* mv,
                       Out* out, int t_count, int fh, int fw, int r, void* stream);

// K3's and K7's entry: block 2 on K9's 2x2 kernel, blocks 4, 8 and 16 on
// launch_refine_rows, int32 output.
int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int block, int r,
                       void* stream);
