// K3 refine_sads_general: candidate SADs of one hierarchical motion
// refinement level, for a whole frame stack, at any block shape and range.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pallas (:887,
// pallas_call in _refine_stack_call :1093) for the shapes the specialised
// kernels (refine_sads.cu: square 4/8/16 blocks and 8x4, 4x8, 16x8, 8x16;
// candidate_sads.cu: 2x2, 4x2, 2x4; r = 1 to 4) do not take.
// Frame t is tracked against anchor t+1 (the reference's pyramid swap) of
// one (T+1, fh, fw) stack. The arithmetic, bound and design are
// window_sads.cuh's: one warp per MV block, window and anchor block staged
// in shared memory with the frame-edge zero fill done on load. Exact int32
// arithmetic: bit-equal to the TPU kernel on valid candidates. The TPU
// kernel's block-pitched cell tensor has no counterpart here.
#include "window_sads.cuh"

// stack: (t_count + 1, fh, fw) uint8; mv: (t_count, fh/bh, fw/bw, 2) int32
// (x, y); out: (t_count, (2r+1)^2, fh/bh, fw/bw) int32. All contiguous.
SVC_EXPORT int svc_refine_sads_general(const void* stack, const void* mv,
                                       void* out, int t_count, int fh, int fw,
                                       int bw, int bh, int r, void* stream) {
  const DensePlanes planes{static_cast<const uint8_t*>(stack), fh, fw};
  return launch_window_sads<DensePlanes, int32_t>(
      planes, planes, 1, mv, out, t_count, fh, fw, bw, bh, r, stream);
}
