// K10 ccl_converge: the converged min-label image of a batch of cluster
// images, in one launch with no convergence loop: a thread block cluster
// of 8 CTAs per frame runs a union-find over bands of rows.
//
// Replaces the two lax.while_loops of svc_tpu/ops/ccl.py
// block_types_from_clusters (:249 and :263; no pl.pallas_call: XLA runs
// the loop inside the encoder's one compiled program). The port's plain
// version (ops/ccl.py converge_labels_plain) polls for convergence from
// the host; this kernel needs no host check, so the encode batch runs as
// one CUDA graph. ccl_converge_general.cu (the first port: one CTA per
// frame, looping until a pass changes nothing) is the yardstick and the
// route for frames whose band does not fit shared memory.
//
// Contract: clusters (B, H, W) int32, < 0 = background; out (B, H, W)
// int32. Each valid cell's label is the smallest raster index of its
// component, a maximal region of same-cluster cells joined by 4- or
// 8-neighbour steps; a background cell's label is H*W. That is a
// canonical function of the input, so it equals the plain loop's result
// bit for bit whatever order the atomics below land in.
//
// Bound: latency. The bytes are the cluster image in and the labels out
// (0.52 MB for 8 frames of 68x120 cells, 0.16 us at 3.35 TB/s). The
// general kernel runs 8 CTAs on 8 of 132 SMs and ends every pass in a
// block-wide barrier. Design (union-find after Playne & Hawick, "A New
// Algorithm for Parallel Connected-Component Labelling on GPUs", IEEE
// TPDS 29(6), 2018):
//   - one cluster of kCluster CTAs per frame; CTA `rank` owns the rows
//     [rank * R, (rank + 1) * R), R = ceil(H / kCluster) (a band may be
//     empty). Global raster order is band order, so a label g lies in
//     band g / (R * W) at offset g % (R * W): no table;
//   - the band's parents (int32, global raster indices) and each cell's
//     link bits (one byte) sit in dynamic shared memory: 5 bytes a cell,
//     5,400 B a band at 68x120, 20,400 B at 135x240, 81,600 B at 270x480;
//   - links: each valid cell joins its same-cluster neighbours that come
//     before it in raster order (left and up; at 8-connectivity also
//     up-left and up-right), less those its neighbours' own links already
//     join (up-left and up-right beside up, up-left beside left);
//   - a parent never exceeds its cell's index, and a union links the
//     larger root under the smaller (atomicMin; it holds only if the old
//     value was still the root, else it retries from the old value), so
//     each tree's root is its smallest member: the canonical label;
//   - phase 1, inside the band: each cell's parent starts at its smallest
//     in-band up link, else at the start of its run of left links among
//     the warp's 32 cells (a ballot; a row of W cells is then a chain of
//     about W / 32, not W), the chains are compressed, the other in-band
//     links of the cells with an up link united, the chains compressed
//     again, which leaves every cell pointing at its band's root for it
//     (its "top"); phase 2, after cluster.sync: the band's first row
//     unites with the last row of the band above through distributed
//     shared memory (a find may cross several CTAs); phase 3, after
//     cluster.sync: each top follows its chain to the root, then every
//     cell reads its top's root from its own band, and the labels are
//     written with coalesced stores; a last cluster.sync keeps every CTA's
//     shared memory alive while a peer may still read it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs (bands) per frame
constexpr int kThreads = 1024;
// the most dynamic shared memory one CTA may use on an H100 (232,448 B)
constexpr int kMaxSmemBytes = 227 * 1024;

// link bits of a cell, in raster order of the neighbour they name
constexpr unsigned kUpLeft = 1, kUp = 2, kUpRight = 4, kLeft = 8;
constexpr unsigned kUpLinks = kUpLeft | kUp | kUpRight;
constexpr unsigned kValid = 16;
// set on the cells that are their band's roots after phase 1 ("tops")
constexpr unsigned kTop = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int smem_bytes(int band_cells) {
  return band_cells * 5;
}

// the neighbour that link bit `bit` names, for the cell at raster index g
__device__ __forceinline__ int linked(int g, int w, unsigned bit) {
  switch (bit) {
    case kUpLeft: return g - w - 1;
    case kUp: return g - w;
    case kUpRight: return g - w + 1;
    default: return g - 1;
  }
}

// Root of g while every parent of the chain lies in this band (phase 1).
__device__ __forceinline__ int band_root(const volatile int32_t* par,
                                         int base, int g) {
  for (;;) {
    const int p = par[g - base];
    if (p == g) return g;
    g = p;
  }
}

// Unite the trees of a and b, both in this band.
__device__ void band_union(int32_t* par, int base, int a, int b) {
  for (;;) {
    a = band_root(par, base, a);
    b = band_root(par, base, b);
    if (a == b) return;
    const int hi = max(a, b);
    const int lo = min(a, b);
    const int old = atomicMin(par + (hi - base), lo);
    if (old == hi) return;
    // hi was linked meanwhile, under old: join old's tree to lo's
    a = old;
    b = lo;
  }
}

// The parent slot of g in whichever CTA of the cluster owns it.
__device__ __forceinline__ int32_t* slot(cg::cluster_group& cluster,
                                         int32_t* par, int rank, int cells,
                                         int g) {
  const int r = g / cells;
  int32_t* p = r == rank ? par : cluster.map_shared_rank(par, r);
  return p + (g - r * cells);
}

__device__ __forceinline__ int cluster_root(cg::cluster_group& cluster,
                                            int32_t* par, int rank,
                                            int cells, int g) {
  for (;;) {
    const int p = *static_cast<volatile int32_t*>(
        slot(cluster, par, rank, cells, g));
    if (p == g) return g;
    g = p;
  }
}

// Unite the trees of a and b anywhere in the frame (phase 2).
__device__ void cluster_union(cg::cluster_group& cluster, int32_t* par,
                              int rank, int cells, int a, int b) {
  for (;;) {
    a = cluster_root(cluster, par, rank, cells, a);
    b = cluster_root(cluster, par, rank, cells, b);
    if (a == b) return;
    const int hi = max(a, b);
    const int lo = min(a, b);
    const int old = atomicMin(slot(cluster, par, rank, cells, hi), lo);
    if (old == hi) return;
    a = old;
    b = lo;
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
ccl_cluster_kernel(const int32_t* __restrict__ clusters,
                   int32_t* __restrict__ out, int h, int w, int eight) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows_per_band = (h + kCluster - 1) / kCluster;
  const int cells = rows_per_band * w;  // a full band; the rank's stride
  const int row0 = rank * rows_per_band;
  const int len = max(0, min(h, row0 + rows_per_band) - row0) * w;
  const int base = rank * cells;  // == row0 * w
  const int n = h * w;
  const size_t frame = static_cast<size_t>(blockIdx.x / kCluster) * n;
  const int32_t* cl = clusters + frame;
  int32_t* par = reinterpret_cast<int32_t*>(smem);
  uint8_t* link = smem + 4 * static_cast<size_t>(cells);
  volatile int32_t* vpar = par;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  // links, and each cell's parent: its smallest in-band up link, else the
  // start of its run of left links among the warp's 32 cells (or, when the
  // run starts before them, the cell before the warp's first), else itself
  for (int l0 = tid - lane; l0 < len; l0 += kThreads) {
    const int l = l0 + lane;
    const int g = base + l;
    unsigned bits = 0;
    if (l < len) {
      const int y = g / w;
      const int x = g - y * w;
      const int c = __ldg(cl + g);
      if (c >= 0) {
        bits = kValid;
        if (x > 0 && __ldg(cl + g - 1) == c) bits |= kLeft;
        if (y > 0) {
          if (__ldg(cl + g - w) == c) bits |= kUp;
          if (eight) {
            if (x > 0 && __ldg(cl + g - w - 1) == c) bits |= kUpLeft;
            if (x + 1 < w && __ldg(cl + g - w + 1) == c) bits |= kUpRight;
          }
        }
        // drop the links that other links already join
        if (bits & kUp) bits &= ~(kUpLeft | kUpRight);
        if (bits & kLeft) bits &= ~kUpLeft;
      }
      link[l] = static_cast<uint8_t>(bits);
    }
    const unsigned lefts = __ballot_sync(kFullMask, (bits & kLeft) != 0);
    if (l < len) {
      const unsigned up = l >= w ? bits & kUpLinks : 0;
      int p = g;
      if (up) {
        p = linked(g, w, up & -up);
      } else if (bits & kLeft) {
        const unsigned starts = ~lefts & (kFullMask >> (31 - lane));
        p = starts ? g - lane + (31 - __clz(starts)) : g - lane - 1;
      }
      par[l] = p;
    }
  }
  __syncthreads();

  // phase 1: compress, unite the other in-band links, compress again
  for (int l = tid; l < len; l += kThreads) vpar[l] = band_root(vpar, base, base + l);
  __syncthreads();
  for (int l = tid; l < len; l += kThreads) {
    // a cell with an in-band up link unites its other links; a run's
    // cells already hang under its start
    unsigned rest = l >= w ? link[l] & (kUpLinks | kLeft) : 0;
    if (!(rest & kUpLinks)) rest = 0;
    rest &= rest - 1;  // the first up link is the initial parent
    const int g = base + l;
    while (rest) {
      const unsigned bit = rest & -rest;
      rest &= rest - 1;
      band_union(par, base, g, linked(g, w, bit));
    }
  }
  __syncthreads();
  for (int l = tid; l < len; l += kThreads) {
    const int r = band_root(vpar, base, base + l);
    vpar[l] = r;
    if (r == base + l) link[l] |= kTop;
  }
  cluster.sync();

  // phase 2: the band's first row against the last row of the band above
  if (rank > 0) {
    for (int l = tid; l < min(len, w); l += kThreads) {
      unsigned up = link[l] & kUpLinks;
      const int g = base + l;
      while (up) {
        const unsigned bit = up & -up;
        up &= up - 1;
        cluster_union(cluster, par, rank, cells, g, linked(g, w, bit));
      }
    }
  }
  cluster.sync();

  // phase 3: the band's tops follow their chains to the root (the only
  // walks that cross CTAs); every other cell reads its top's root
  for (int l = tid; l < len; l += kThreads) {
    if (link[l] & kTop) vpar[l] = cluster_root(cluster, par, rank, cells, base + l);
  }
  __syncthreads();
  int32_t* dst = out + frame + base;
  for (int l = tid; l < len; l += kThreads) {
    const unsigned bits = link[l];
    dst[l] = !(bits & kValid) ? n : (bits & kTop) ? vpar[l] : vpar[vpar[l] - base];
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster.sync();
}

}  // namespace

// clusters: (b, h, w) int32, < 0 = background; out: (b, h, w) int32;
// connectivity: 4 or 8. Refuses (cudaErrorInvalidValue) a frame whose band
// of ceil(h / 8) rows does not fit one CTA's shared memory.
SVC_EXPORT int svc_ccl_converge(const void* clusters, void* out, int b, int h,
                                int w, int connectivity, void* stream) {
  if (b < 1 || h < 1 || w < 1 || (connectivity != 4 && connectivity != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells =
      static_cast<long long>((h + kCluster - 1) / kCluster) * w;
  if (cells * 5 > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(static_cast<int>(cells));
  // set on every call: the limit an earlier call set must not decide this
  // one
  const cudaError_t e = cudaFuncSetAttribute(
      ccl_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ccl_cluster_kernel<<<b * kCluster, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(clusters), static_cast<int32_t*>(out), h, w,
      connectivity == 8);
  return static_cast<int>(cudaGetLastError());
}
