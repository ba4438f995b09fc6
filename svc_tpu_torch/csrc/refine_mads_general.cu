// K7 refine_mads_general: candidate SADs of one hierarchical motion
// refinement level for ONE frame pair, from separate tracked and anchor
// planes, at any block shape and range.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_pallas (:541) for the
// shapes the specialised entry (refine_mads.cu: K3's blocks, square 2/4/8/16
// and 4x2, 8x4, 16x8, 2x4, 4x8, 8x16, at r = 1 to 4 on 16-byte aligned
// planes, K3's kernels) does not take. The TPU
// kernel reads a block-pitched copy of the padded tracked plane and
// selects each block's window with masked-select chains over the even
// shifts in [-bound_in, bound_in]; here each warp loads its block's window
// straight from the plane at the block's own MV (window_sads.cuh), so odd
// and unbounded MVs work too and no pitched copy exists. Output: the TPU
// kernel's first (2r+1)^2 rows, (ncand, mfh, mfw) int32 in (oy, ox) raster
// order, bit-equal on valid candidates.
//
// Bound: memory and latency, as the general K3 (window_sads.cuh): one warp
// per MV block, half its lanes idle on 4x4 blocks.
#include "window_sads.cuh"

// tracked, anchor: (fh, fw) uint8; mv: (fh/bh, fw/bw, 2) int32 (x, y);
// out: ((2r+1)^2, fh/bh, fw/bw) int32. All contiguous.
SVC_EXPORT int svc_refine_mads_general(const void* tracked, const void* anchor,
                                       const void* mv, void* out, int fh,
                                       int fw, int bw, int bh, int r,
                                       void* stream) {
  const DensePlanes trk{static_cast<const uint8_t*>(tracked), fh, fw};
  const DensePlanes anc{static_cast<const uint8_t*>(anchor), fh, fw};
  return launch_window_sads<DensePlanes, int32_t>(
      trk, anc, 0, mv, out, 1, fh, fw, bw, bh, r, stream);
}
