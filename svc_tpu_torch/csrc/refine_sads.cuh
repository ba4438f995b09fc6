// The SAD launchers shared across the entries of K3, K7 and K9: candidate
// SADs at radius r = 1 to 4 (5 to 8 at 16x16, 8x8, 4x4 and 2x2, K3's and
// K7's 32x32 and K9's 1x1) of BW x BH MV blocks (BW columns, BH rows) for
// t_count frames, frame t's tracked plane at tracked + t * frame_stride and
// its anchor at anchor + t * frame_stride (K3: the stack and the stack
// plus one plane, stride a plane; K7: the pair, stride 0; K9: the two
// stacks, stride a plane). Each refuses (cudaErrorInvalidValue) what it
// does not take.
#pragma once

#include <stddef.h>
#include <stdint.h>

// One case label for a block shape of the entries' dispatch.
constexpr int shape_key(int bw, int bh) { return bw << 8 | bh; }

// K3's lane-per-anchor-row kernel (refine_sads.cu, over refine_rows.cuh)
// for BW x BH blocks: 4x4, 8x8, 16x16, 32x32, 8x4, 4x8, 16x8, 8x16, 32x16,
// 16x32, 32x8, 16x4, 8x32, 4x16 with int32 output (K3, K7), 4x4, 8x8,
// 16x16, 8x4, 4x8, 16x8, 8x16, 16x4, 4x16 with float32 (K9). tracked,
// anchor:
// (fh, fw) uint8 planes, 16-byte aligned, frame_stride a multiple of 16;
// mv: (t_count, fh/BH, fw/BW, 2) int32 (x, y); out: (t_count, (2r + 1)^2,
// fh/BH, fw/BW). All contiguous; BH divides fh and BW divides fw.
template <int BW, int BH, class Out>
int launch_refine_rows(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, Out* out,
                       int t_count, int fh, int fw, int r, void* stream);

// K9's thread-a-block kernel (candidate_sads.cu) for BW x BH blocks: 2x2,
// 4x2, 2x4, 8x2 and 2x8 with float32 output (K9) or int32 (K3, K7), 2x1,
// 1x2, 4x1 and 1x4 with float32; the frame stride a plane (fh * fw: K9,
// K3; K7 has one frame). tracked 4-byte aligned, anchor aligned to its
// rows' bytes (BW: 8, 4, 2 or 1) and fh * fw a multiple of 4; mv:
// (t_count, fh/BH, fw/BW, 2) int32 (x, y); out: (t_count, (2r + 1)^2,
// fh/BH, fw/BW). All contiguous; BH divides fh and BW divides fw.
template <int BW, int BH, class Out>
int launch_block_sads(const void* tracked, const void* anchor, const void* mv,
                      Out* out, int t_count, int fh, int fw, int r, void* stream);

// K3's and K7's entry, int32 output: 2x2, 4x2, 2x4, 8x2 and 2x8 on K9's
// thread-a-block kernel, the other shapes of launch_refine_rows on it.
int launch_refine_sads(const void* tracked, const void* anchor,
                       size_t frame_stride, const void* mv, void* out,
                       int t_count, int fh, int fw, int bw, int bh, int r,
                       void* stream);
