// K9 candidate_sads_general: per-block SADs of every (2r+1)^2 candidate
// around each block's MV, for T separate (tracked, anchor) plane pairs, as
// float32, for any block shape and range. Square 1x1, 2x2, 4x4 and 8x8
// blocks and the rectangles 2x1, 1x2, 4x2, 2x4, 8x4, 4x8 at r = 1 to 4
// (the encoder's top-level EBMA at ranges 8 to 39, 8x8 MV blocks, 2, 3 or
// 5 levels, 16x8 or 8x16 MV blocks at 2, 3 or 4 levels) run
// candidate_sads.cu; ops/motion.py dispatches, and general=True forces
// this kernel.
//
// Replaces svc_tpu/ops/motion_pallas.py candidate_sads (:121) and its
// static-addressing twin refine_sads_static (:285). The TPU kernels pad the
// tracked plane by mv_pad + r (or select among even shifts up to mv_bound);
// here each warp loads its block's window at the block's own MV with the
// frame edge zero-filled (window_sads.cuh), which gives the same SADs on
// every entry whose MV lies within the TPU kernel's bound, with no padded
// copy. The shared memory per CTA depends on r and the block only: 4 warps x
// (bh*bw + (bh+2r)*(bw+2r)) bytes, 3.3 KB at r = 4 and 16x16 blocks; a
// launch past the default 48 KB is refused. ops/motion.py ebma() runs the
// exhaustive search through it (zero MVs, r = the search range) at every
// shape but those.
//
// Bound: at r = 4 and 16x16 blocks, operations: 81 candidates x 256
// absolute-difference accumulates per block against 512 bytes read.
#include "window_sads.cuh"

// tracked, anchor: (t_count, fh, fw) uint8; mv: (t_count, fh/bh, fw/bw, 2)
// int32 (x, y); out: (t_count, (2r+1)^2, fh/bh, fw/bw) float32. All
// contiguous.
SVC_EXPORT int svc_candidate_sads_general(const void* tracked, const void* anchor,
                                          const void* mv, void* out,
                                          int t_count, int fh, int fw, int bw,
                                          int bh, int r, void* stream) {
  const DensePlanes trk{static_cast<const uint8_t*>(tracked), fh, fw};
  const DensePlanes anc{static_cast<const uint8_t*>(anchor), fh, fw};
  return launch_window_sads<DensePlanes, float>(
      trk, anc, 0, mv, out, t_count, fh, fw, bw, bh, r, stream);
}
