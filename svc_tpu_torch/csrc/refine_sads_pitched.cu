// K8 (refine) refine_sads_pitched: candidate SADs of the level-0 refine of
// hbma_stack(..., base_pitched=) read straight from column-pitched luma
// subplanes, specialised for the pitched frontend's shape: tbw = 8
// subplanes, square 16x16 MV blocks, r = 1.
//
// Replaces svc_tpu/ops/motion_pallas.py refine_mads_stack_pitched_pallas
// (:994, pallas_call in _refine_stack_call :1093). Every other shape runs
// refine_sads_pitched_general.cu; ops/motion.py dispatches. The contract is
// K3's on the respatialized stack (spatial column x is lane x / 8 of
// subplane x % 8): frame t tracked against anchor t+1, tracked pixels
// outside the frame read as 0, each window placed at its block's own MV
// (any MV), exact integer sums, bit-equal to the general kernel and to
// refine_sads_pitched_plain on every candidate, valid or not.
//
// Bound: bytes (the stack read once, the MVs read and the SADs written
// once: 0.0065 ms for 9 x 1088 x 1920 on an H100). The general kernel reads
// byte by byte through the pitched accessor, with an integer division and
// modulo by the runtime tbw per byte, and eight neighbouring spatial bytes
// lie in eight subplanes 2.35 MB apart at 1080p. Design:
//   - K3's work split and arithmetic (refine_rows.cuh): 256 lanes, a lane
//     per anchor row, 16 MV blocks of one block row per CTA;
//   - the CTA un-pitches its anchor (16 rows x 256 columns) and a band of
//     the tracked frame (48 rows x 320 columns: every window of a block
//     whose MV lies within +-kReach = 15, svc_tpu's bound on the level-0
//     MVs plus r) into shared memory in spatial order. A 32-byte run of a
//     row is one aligned word (4 lanes) of each of the 8 subplanes:
//     coalesced 4-byte loads, all of a thread's issued before its first
//     shared store, then two 4x4 byte transposes (__byte_perm) give the
//     run's 8 spatial words, stored as two 16-byte words. Positions outside
//     the frame hold 0;
//   - a lane reads each window row from the band as two 16-byte and one
//     4-byte shared load (row strides are odd multiples of 16 bytes, so the
//     8 rows of a quarter warp's 16-byte loads fall in 8 bank groups);
//   - a block whose MV leaves the band reads its window bytes from global
//     memory through the pitched layout, one byte at a time (the same
//     bits, slowly; svc_tpu's search never asks for it).
#include "planes.cuh"
#include "refine_rows.cuh"

namespace {

constexpr int kB = 16;                     // MV block side
constexpr int kTbw = 8;                    // subplanes
constexpr int kWords = kB / 4 + 1;         // window words per row
constexpr int kBlocks = kThreads / kB;     // MV blocks of one block row per CTA
constexpr int kCtaCols = kBlocks * kB;     // 256 spatial columns
constexpr int kReach = 15;                 // |mvx|, |mvy| that read from the band
constexpr int kRun = 4 * kTbw;             // spatial bytes of one word per subplane
constexpr int kLead = kRun;                // band columns before the CTA's first
constexpr int kBandRows = kB + 2 * (kReach + 1);          // 48
constexpr int kBandRuns = (kCtaCols + 2 * kLead) / kRun;  // 10
constexpr int kBandStride = kBandRuns * kRun + 16;        // 336 = 21 x 16
constexpr int kAncRuns = kCtaCols / kRun;                 // 8
constexpr int kAncStride = kCtaCols + 16;                 // 272 = 17 x 16
constexpr int kAncItems = kB * kAncRuns;                  // 128
constexpr int kItems = kAncItems + kBandRows * kBandRuns; // 608
constexpr int kIters = (kItems + kThreads - 1) / kThreads;
static_assert(kLead >= kReach + 1 && kLead % kRun == 0, "band lead");
// the last block's window at mvx = kReach: its bytes inside the band's
// runs, its aligned shared loads inside the row
static_assert(kLead + kCtaCols + kReach + 1 <= kBandRuns * kRun, "band runs");
static_assert(((kLead + kCtaCols - kB + kReach - 1) & ~15) + 36 <= kBandStride,
              "band row");
static_assert((kBandStride / 16) % 2 == 1 && (kAncStride / 16) % 2 == 1,
              "row strides");

// The 32 spatial bytes of lanes l..l+3 from one word of each subplane
// (w[j]: subplane j, lanes l..l+3), into dst (16-byte aligned): spatial
// byte 8m + j is byte m of w[j].
__device__ __forceinline__ void unpitch_run(const uint32_t (&w)[kTbw], uint8_t* dst) {
  uint32_t lo[4], hi[4];  // [m]: subplanes 0-3 / 4-7 of lane l + m
  transpose4(w[0], w[1], w[2], w[3], lo);
  transpose4(w[4], w[5], w[6], w[7], hi);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(lo[0], hi[0], lo[1], hi[1]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(lo[2], hi[2], lo[3], hi[3]);
}

// A window row from the band: its words from byte c of a band row on.
__device__ __forceinline__ void band_window_row(const uint8_t* row, int c,
                                                uint32_t (&al)[kWords]) {
  const int cb = c & ~15;
  const uint4 u = *reinterpret_cast<const uint4*>(row + cb);
  const uint4 v = *reinterpret_cast<const uint4*>(row + cb + 16);
  const uint32_t w[kB / 2 + 1] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w,
                                  *reinterpret_cast<const uint32_t*>(row + cb + 32)};
  align_window_row<kB>(w, c - cb, al);
}

// A window row outside the band: bytes [x0, x0 + kB + 4) of row y of a
// pitched frame (frame: its subplane-0 plane; sub: the subplane stride),
// one byte at a time, 0 outside the frame.
__device__ __forceinline__ void pitched_window_row(const uint8_t* __restrict__ frame,
                                                   size_t sub, int y, int x0, int fh,
                                                   int nbx, uint32_t (&al)[kWords]) {
  const bool row_in = y >= 0 && y < fh;
  const uint8_t* row = frame + static_cast<size_t>(row_in ? y : 0) * nbx;
  const int fw = kTbw * nbx;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = x0 + 4 * k + b;
      if (row_in && x >= 0 && x < fw) {
        const unsigned ux = static_cast<unsigned>(x);
        word |= static_cast<uint32_t>(__ldg(row + (ux % kTbw) * sub + ux / kTbw))
                << (8 * b);
      }
    }
    al[k] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
refine_sads_pitched_kernel(const uint8_t* __restrict__ y8,
                           const int32_t* __restrict__ mv, int32_t* __restrict__ out,
                           int t_count, int fh, int nbx, int mfh, int mfw) {
  __shared__ __align__(16) uint8_t s_band[kBandRows * kBandStride];
  __shared__ __align__(16) uint8_t s_anc[kB * kAncStride];
  __shared__ int32_t s_out[kCand][kBlocks];

  const unsigned i = threadIdx.x % kB;  // anchor row of this lane
  const unsigned blk = threadIdx.x / kB;
  const int bx = blockIdx.x * kBlocks + blk;
  const int by = blockIdx.y;
  const int t = blockIdx.z;
  const bool active = bx < mfw;  // a whole 16-lane group is in or out
  const size_t sub = static_cast<size_t>(t_count + 1) * fh * nbx;

  int mvx = 0, mvy = 0;
  if (active) {
    const int32_t* m = mv + ((static_cast<size_t>(t) * mfh + by) * mfw + bx) * 2;
    mvx = __ldg(m);
    mvy = __ldg(m + 1);
  }

  // staging: items [0, kAncItems) are the anchor's runs (frame t + 1), the
  // rest the band's (frame t); run k of a region row starts at subplane
  // lane l = (first lane) + 4k. nbx % 4 == 0, so a run is wholly inside or
  // outside the frame.
  const int lane0 = blockIdx.x * (kCtaCols / kTbw);
  uint32_t w[kIters][kTbw];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const bool anc = e < kAncItems;
    const int b = anc ? e : e - kAncItems;
    const int f = anc ? t + 1 : t;
    const int y = anc ? by * kB + e / kAncRuns : by * kB - kReach - 1 + b / kBandRuns;
    const int l = anc ? lane0 + 4 * (e % kAncRuns)
                      : lane0 - kLead / kTbw + 4 * (b % kBandRuns);
    const bool in = e < kItems && y >= 0 && y < fh && l >= 0 && l < nbx;
    const uint8_t* p = y8 + (static_cast<size_t>(f) * fh + (in ? y : 0)) * nbx + (in ? l : 0);
#pragma unroll
    for (int j = 0; j < kTbw; ++j) {
      w[it][j] = in ? __ldg(reinterpret_cast<const unsigned int*>(p + j * sub)) : 0u;
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e >= kItems) continue;
    const int b = e - kAncItems;
    uint8_t* dst = e < kAncItems
                       ? s_anc + (e / kAncRuns) * kAncStride + kRun * (e % kAncRuns)
                       : s_band + (b / kBandRuns) * kBandStride + kRun * (b % kBandRuns);
    unpitch_run(w[it], dst);
  }
  __syncthreads();

  uint32_t a[kB / 4] = {};
  uint32_t r0[kWords] = {}, ext[kWords] = {};
  if (active) {
    const uint4 v = *reinterpret_cast<const uint4*>(s_anc + i * kAncStride + kB * blk);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
    if (abs(mvx) <= kReach && abs(mvy) <= kReach) {
      // window row i at oy = 0 is band row mvy + kReach + i; its first
      // byte is band column kLead + 16 blk + mvx - 1
      const uint8_t* row = s_band + (mvy + kReach + static_cast<int>(i)) * kBandStride;
      const int c = kLead + kB * static_cast<int>(blk) + mvx - 1;
      band_window_row(row, c, r0);
      // lanes 14 and 15 also read rows 16 and 17 of the window
      if (i >= kB - 2) band_window_row(row + 2 * kBandStride, c, ext);
    } else {
      const uint8_t* trk = y8 + static_cast<size_t>(t) * fh * nbx;
      const int x0 = bx * kB + mvx - 1;
      const int y0 = by * kB + mvy - 1 + static_cast<int>(i);
      pitched_window_row(trk, sub, y0, x0, fh, nbx, r0);
      if (i >= kB - 2) pitched_window_row(trk, sub, y0 + 2, x0, fh, nbx, ext);
    }
  }
  block_sads<kB>(r0, ext, a, i, blk, s_out);
  __syncthreads();
  store_sads<kB>(s_out, out, t, by, mfh, mfw);
}

}  // namespace

// y8: (8, t_count + 1, fh, nbx) uint8 subplanes, 4-byte aligned, nbx % 4 ==
// 0, fh % 16 == 0; mv: (t_count, fh/16, 8 nbx/16, 2) int32 (x, y); out:
// (t_count, 9, fh/16, 8 nbx/16) int32. All contiguous. Refuses
// (cudaErrorInvalidValue) anything else.
SVC_EXPORT int svc_refine_sads_pitched(const void* y8, const void* mv, void* out,
                                       int t_count, int fh, int nbx, void* stream) {
  if (reinterpret_cast<uintptr_t>(y8) % 4 || nbx % 4 || nbx < 4 || fh % kB ||
      fh < kB || t_count < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mfh = fh / kB;
  const int mfw = kTbw * nbx / kB;
  const dim3 grid((mfw + kBlocks - 1) / kBlocks, mfh, t_count);
  refine_sads_pitched_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y8), static_cast<const int32_t*>(mv),
      static_cast<int32_t*>(out), t_count, fh, nbx, mfh, mfw);
  return static_cast<int>(cudaGetLastError());
}
