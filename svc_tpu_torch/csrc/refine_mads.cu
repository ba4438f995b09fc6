// K7 refine_mads: candidate SADs of one hierarchical motion refinement
// level for ONE frame pair, from separate tracked and anchor planes — the
// per-frame refine behind ops/motion.py refine() and hbma() — specialised
// for square B x B MV blocks (B = 2, 4, 8, 16) at radius r = 1 to 4: the
// refinement levels of the per-frame search at 16x16 blocks and 4 levels,
// range 8 (r = 1, the default) to 39, and at 8x8 blocks or 2, 3 or 5
// levels.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_pallas (:541), which
// svc_tpu's per-frame hbma reaches through _refine_spread (motion.py:346).
// It launches K3's kernels (launch_refine_sads, refine_sads.cuh: at B = 4,
// 8, 16 the lane-per-anchor-row kernel of refine_sads.cu over
// refine_rows.cuh, at B = 2 K9's thread-per-block kernel of
// candidate_sads.cu) with one frame: the tracked plane and the anchor as
// two bases, frame stride 0. Window rows come as aligned words or chunks
// with the frame-edge zero fill by predicate, and all index math is
// compile-time; each window sits at its block's own MV (odd, unbounded).
// Output: the TPU kernel's first (2r + 1)^2 rows, ((2r + 1)^2, mfh, mfw)
// int32 in (oy, ox) raster order, bit-equal on valid candidates, and
// bit-equal to refine_mads_general.cu (window_sads.cuh, every other shape)
// and to the plain version on every candidate.
//
// Bound: bytes at r = 1 (0.002 ms for the three 1080p levels of one pair
// on an H100; K3's integer bound at level 0 from r = 3), but one pair
// gives grids of 136 / 272 / 544 CTAs of 256 at levels 2 / 1 / 0, under
// one wave on 132 SMs: each launch is latency-bound.
#include "common.cuh"
#include "refine_sads.cuh"

// tracked, anchor: (fh, fw) uint8, 16-byte aligned (at bw = 2: 4- and
// 2-byte); mv: (fh/bw, fw/bw, 2) int32 (x, y); out: ((2r + 1)^2, fh/bw,
// fw/bw) int32. All contiguous; bw == bh in {2, 4, 8, 16} divides fh and
// fw; 1 <= r <= 4. Refuses (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_refine_mads(const void* tracked, const void* anchor,
                               const void* mv, void* out, int fh, int fw,
                               int bw, int bh, int r, void* stream) {
  if (bw != bh) return static_cast<int>(cudaErrorInvalidValue);
  return launch_refine_sads(tracked, anchor, 0, mv, out, 1, fh, fw, bw, r,
                            stream);
}
