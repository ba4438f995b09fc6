// K7 refine_mads: candidate SADs of one hierarchical motion refinement
// level for ONE frame pair, from separate tracked and anchor planes — the
// per-frame refine behind ops/motion.py refine() and hbma() — specialised
// for K3's block shapes (square 2, 4, 8, 16, 32, the ratio-2 rectangles
// 4x2, 2x4, 8x4, 4x8, 16x8, 8x16, 32x16, 16x32 and the ratio-4 ones 8x2,
// 2x8, 16x4, 4x16, 32x8, 8x32, columns x rows) at radius r = 1 to 4, and
// 32x32, 16x16, 8x8, 4x4 and 2x2 at r = 5 to 8 (the levels under the top
// of 16x16 blocks at 2-5 levels, ranges 10-143, of 8x8 blocks at 4 levels,
// ranges 40-71, and of 32x32 blocks at 2-5 levels, ranges 10-143): the
// refinement levels of the per-frame search at 16x16 blocks and 4 levels,
// range 8 (r = 1, the default) to 39, at 8x8 blocks or 2, 3 or 5 levels,
// at 16x8 or 8x16 blocks and 2, 3 or 4 levels, at 32x32, 32x16 or 16x32
// blocks and 2 to 5 levels, and at 32x8 or 8x32 blocks and 2, 3 or 4
// levels.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_pallas (:541), which
// svc_tpu's per-frame hbma reaches through _refine_spread (motion.py:346).
// It launches K3's kernels (launch_refine_sads, refine_sads.cuh: at 4x4
// and up the lane-per-anchor-row kernel of refine_sads.cu over
// refine_rows.cuh, at 2x2, 4x2, 2x4, 8x2 and 2x8 K9's thread-per-block
// kernel of candidate_sads.cu) with one frame: the tracked plane and the
// anchor as two bases, frame stride 0. Window rows come as aligned words or chunks
// with the frame-edge zero fill by predicate, and all index math is
// compile-time; each window sits at its block's own MV (odd, unbounded).
// Output: the TPU kernel's first (2r + 1)^2 rows, ((2r + 1)^2, mfh, mfw)
// int32 in (oy, ox) raster order, bit-equal on valid candidates, and
// bit-equal to refine_mads_general.cu (window_sads.cuh, every other shape)
// and to the plain version on every candidate.
//
// Bound: bytes at r = 1 (0.002 ms for the three 1080p levels of one pair
// at 16x16 blocks on an H100; K3's integer bound at level 0 from r = 3),
// but one pair gives grids of 136 / 272 / 544 CTAs of 256 at levels 2 / 1
// / 0, under one wave on 132 SMs: each launch is latency-bound.
#include "common.cuh"
#include "refine_sads.cuh"

// tracked, anchor: (fh, fw) uint8, 16-byte aligned (on the thread-a-block
// kernel: 4-byte and aligned to the anchor rows' bytes); mv: (fh/bh,
// fw/bw, 2) int32 (x, y); out: ((2r + 1)^2, fh/bh, fw/bw) int32. All contiguous; (bw,
// bh) one of K3's shapes, dividing fw and fh; 1 <= r <= 4 (5 <= r <= 8
// at 32x32, 16x16, 8x8, 4x4 and 2x2). Refuses
// (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_refine_mads(const void* tracked, const void* anchor,
                               const void* mv, void* out, int fh, int fw,
                               int bw, int bh, int r, void* stream) {
  return launch_refine_sads(tracked, anchor, 0, mv, out, 1, fh, fw, bw, bh, r,
                            stream);
}
