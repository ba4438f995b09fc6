// K8 (refine) refine_sads_pitched: K3 over column-pitched luma subplanes.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pitched_pallas
// (:994, pallas_call in _refine_stack_call :1093), which builds the stack
// refine's cell tensor from svc_tpu's j-split luma layout with selection
// einsums. Here the SAD kernel reads the subplanes through a pitched
// accessor (planes.cuh: column x is lane x / tbw of subplane x % tbw), so
// the SADs are K3's for the respatialized stack, bit for bit, and no
// spatial plane is built. Frame t is tracked against anchor t+1.
//
// Bound: memory and latency, as K3; the pitched reads of a window row
// touch tbw subplanes, so its loads are not coalesced (K3's are).
#include "window_sads.cuh"

// y8: (tbw, t_count + 1, fh, nbx) uint8, fw = tbw * nbx; mv: (t_count,
// fh/bh, fw/bw, 2) int32 (x, y); out: (t_count, (2r+1)^2, fh/bh, fw/bw)
// int32. All contiguous.
SVC_EXPORT int svc_refine_sads_pitched(const void* y8, const void* mv,
                                       void* out, int tbw, int t_count,
                                       int fh, int nbx, int bw, int bh,
                                       int r, void* stream) {
  const PitchedPlanes planes{static_cast<const uint8_t*>(y8), t_count + 1, fh,
                             nbx, tbw};
  return launch_window_sads<PitchedPlanes, int32_t>(
      planes, planes, 1, mv, out, t_count, fh, tbw * nbx, bw, bh, r, stream);
}
