// K10 ccl_converge: the converged min-label image of a batch of cluster
// images, in one launch that loops on the device until nothing changes.
//
// Replaces the two lax.while_loops of svc_tpu/ops/ccl.py
// block_types_from_clusters (:249 and :263; no pl.pallas_call: XLA runs
// the loop inside the encoder's one compiled program). The port's plain
// version (ops/ccl.py converge_labels_plain) polls for convergence from
// the host; this kernel needs no host check, so the encode batch can be
// captured into one CUDA graph.
//
// Contract: clusters (B, H, W) int32, < 0 = background; out (B, H, W)
// int32. Each valid cell's label is the smallest raster index of its
// component, a maximal region of same-cluster cells joined by 4- or
// 8-neighbour steps; a background cell's label is H*W. That is a
// canonical function of the input, so it equals the plain loop's result
// bit for bit whatever order the updates below run in.
//
// Bound: latency. The bytes are the cluster image in and the labels out
// (0.52 MB for 8 frames of 68x120 cells, 0.16 us at 3.35 TB/s); the time
// is the number of passes a component needs, each a block-wide barrier.
// Design:
//   - one CTA of 1024 threads per frame; a thread owns the cells
//     threadIdx.x + k * 1024, so no thread ever waits on another CTA;
//   - the frame's labels (int32) and each cell's same-cluster neighbour
//     bits (one byte: bit d set when neighbour d is in the frame and in
//     the same cluster) sit in dynamic shared memory: 5 bytes a cell,
//     40,800 B at 1080p, 162,000 B at 4K; larger grids run the same loop
//     over global memory (labels in out, neighbour bits in scratch);
//   - a pass: each valid cell takes the minimum label over itself and its
//     neighbours, follows that label down to its root (label[m] < m),
//     and lowers both its own label and the label its old label pointed
//     at (atomicMin: union by smallest index, pointer jumping), so a long
//     snake merges in far fewer passes than its length;
//   - labels only decrease and always name a cell of the same component,
//     so a pass in which no thread lowered anything (__syncthreads_or)
//     is a fixed point: every neighbour pair agrees and each component's
//     label is its root, i.e. its smallest index.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
// the most dynamic shared memory one CTA may use on an H100 (232,448 B)
constexpr int kMaxSmemBytes = 227 * 1024;

__host__ __device__ constexpr int smem_bytes(int n) { return n * 5; }

// neighbour d: (dy, dx); 0-3 are the 4-neighbours, 4-7 the diagonals
__constant__ int kDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
__constant__ int kDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};

template <int kShared>
__global__ void __launch_bounds__(kThreads)
ccl_converge_kernel(const int32_t* __restrict__ clusters,
                    int32_t* __restrict__ out, uint8_t* __restrict__ scratch,
                    int h, int w, int n_dirs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = h * w;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int32_t* cl = clusters + base;
  int32_t* lab;
  uint8_t* edge;
  if (kShared) {
    lab = reinterpret_cast<int32_t*>(smem);
    edge = smem + 4 * static_cast<size_t>(n);
  } else {
    lab = out + base;
    edge = scratch + base;
  }
  volatile int32_t* vlab = lab;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = __ldg(cl + i);
    const int y = i / w;
    const int x = i - y * w;
    unsigned bits = 0;
    if (c >= 0) {
      for (int d = 0; d < n_dirs; ++d) {
        const int ny = y + kDy[d];
        const int nx = x + kDx[d];
        if (ny >= 0 && ny < h && nx >= 0 && nx < w &&
            __ldg(cl + ny * w + nx) == c) {
          bits |= 1u << d;
        }
      }
    }
    edge[i] = static_cast<uint8_t>(bits);
    lab[i] = c >= 0 ? i : n;
  }
  __syncthreads();

  for (;;) {
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned bits = edge[i];
      if (bits == 0) continue;  // background or a component of one cell
      const int l = vlab[i];
      int m = l;
      for (int d = 0; d < n_dirs; ++d) {
        if (bits & (1u << d)) m = min(m, vlab[i + kDy[d] * w + kDx[d]]);
      }
      for (;;) {  // down to the root: labels point at smaller indices
        const int r = vlab[m];
        if (r >= m) break;
        m = r;
      }
      if (m < l) {
        atomicMin(lab + i, m);
        atomicMin(lab + l, m);
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  if (kShared) {
    int32_t* dst = out + base;
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = lab[i];
  }
}

}  // namespace

// clusters: (b, h, w) int32, < 0 = background; out: (b, h, w) int32;
// scratch: (b, h, w) uint8, read only when the frame does not fit shared
// memory or use_global is set (may be null otherwise). connectivity: 4 or
// 8.
SVC_EXPORT int svc_ccl_converge(const void* clusters, void* out,
                                void* scratch, int b, int h, int w,
                                int connectivity, int use_global,
                                void* stream) {
  if (b < 1 || h < 1 || w < 1 || (connectivity != 4 && connectivity != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_dirs = connectivity;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cl = static_cast<const int32_t*>(clusters);
  auto* o = static_cast<int32_t*>(out);
  const int smem = smem_bytes(h * w);
  if (!use_global && smem <= kMaxSmemBytes) {
    // set on every call: the limit an earlier call set must not decide
    // this one
    const cudaError_t e = cudaFuncSetAttribute(
        ccl_converge_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ccl_converge_kernel<1><<<b, kThreads, smem, s>>>(cl, o, nullptr, h, w,
                                                     n_dirs);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    ccl_converge_kernel<0><<<b, kThreads, 0, s>>>(
        cl, o, static_cast<uint8_t*>(scratch), h, w, n_dirs);
  }
  return static_cast<int>(cudaGetLastError());
}
