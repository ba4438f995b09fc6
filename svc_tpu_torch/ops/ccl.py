"""Per-cluster connected components -> block types (``svc_tpu/ops/ccl.py``).

Reproduces the reference's loop over k-means clusters — one
``cv::connectedComponents`` per cluster mask, block type = component id +
running offset, offset advanced by that call's label count (component
count + 1; libs/encoder.cpp:597-623) — by labelling every cluster of every
frame in one propagation: a component of cluster ``c``'s mask is exactly a
maximal same-cluster-connected region of the cluster image.

The labelling converges to each valid cell's smallest same-component
raster index, a canonical function of the cluster image, so it equals
``svc_tpu``'s bit for bit:

* kernel K10 (:func:`converge_labels`, ``csrc/ccl_converge.cu``) on a
  CUDA tensor: a thread block cluster of 8 CTAs per frame, each CTA a band
  of rows, runs a union-find in one launch — no host check, so the encode
  batch can run as one CUDA graph (svc_tpu's ``lax.while_loop`` s,
  ``svc_tpu/ops/ccl.py:249`` and :263). Its first port,
  ``csrc/ccl_converge_general.cu`` (one CTA per frame, looping until a pass
  changes nothing), takes ``general=True``, ``global_memory=True`` and the
  frames whose band does not fit shared memory;
* its plain version :func:`converge_labels_plain` on a CPU tensor:
  min-label propagation (each valid cell repeatedly takes the minimum over
  itself and its same-cluster neighbours) with pointer jumping (``label =
  min(label, label[label])``), iterated in Python until nothing changes.

The canonical numbering after convergence is plain torch on both devices.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from svc_tpu_torch.kernels.build import INT, PTR, Kernel, stream_handle

_SWEEPS_PER_CHECK = 4
#: K10's cluster kernel: CTAs (bands of ceil(H / 8) rows) per frame
K10_CLUSTER = 8
#: K10 keeps a band in shared memory up to this many cells (5 bytes a cell
#: of the 227 KB a CTA may use); larger bands take the general kernel
K10_BAND_CELLS = 227 * 1024 // 5
#: the general kernel keeps a frame in shared memory up to this many cells
#: (5 bytes a cell too); larger frames loop over global memory
K10_SHARED_CELLS = 227 * 1024 // 5

CCL_CONVERGE = Kernel(
    "ccl_converge",
    "svc_ccl_converge",
    [PTR, PTR, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/ccl_converge.cu",
    replaces="svc_tpu/ops/ccl.py:249",
)
CCL_CONVERGE_GENERAL = Kernel(
    "ccl_converge_general",
    "svc_ccl_converge_general",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/ccl_converge_general.cu",
    replaces="svc_tpu/ops/ccl.py:249",
)


def band_cells(h: int, w: int) -> int:
    """Cells of one band of K10's cluster kernel: ``ceil(h / 8)`` rows."""
    return -(-h // K10_CLUSTER) * w


def _shifted(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y + dy, x + dx]``, ``fill`` outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _neighbour_shifts(connectivity: int):
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    return shifts


def converge_labels_plain(
    cluster_labels: torch.Tensor, connectivity: int = 4
) -> torch.Tensor:
    """Plain PyTorch version of K10 (same contract as
    :func:`converge_labels`): sweeps polled for convergence from the host
    every ``_SWEEPS_PER_CHECK``."""
    shifts = _neighbour_shifts(connectivity)
    b, h, w = cluster_labels.shape
    n = h * w
    dev = cluster_labels.device
    valid = cluster_labels >= 0
    cl = torch.where(valid, cluster_labels.to(torch.int64), -1)
    idx = torch.arange(n, device=dev).reshape(1, h, w)
    big = n
    labels = torch.where(valid, idx, big)
    # same-cluster neighbour masks are label-independent
    neigh_ok = [
        (dy, dx, (_shifted(cl, dy, dx, -2) == cl) & valid)
        for dy, dx in shifts
    ]

    def sweep(lab):
        m = lab
        for dy, dx, eq in neigh_ok:
            m = torch.minimum(m, torch.where(eq, _shifted(lab, dy, dx, big), big))
        m = torch.where(valid, m, big)
        flat = m.reshape(b, n)
        ext = torch.cat([flat, torch.full((b, 1), big, device=dev)], dim=1)
        jumped = torch.gather(ext, 1, flat)
        return torch.where(valid, torch.minimum(jumped, flat).reshape(b, h, w), big)

    while True:
        new = labels
        for _ in range(_SWEEPS_PER_CHECK):
            new = sweep(new)
        if torch.equal(new, labels):
            return labels
        labels = new


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"converge_labels: unsupported device {x.device}")


def converge_labels(
    cluster_labels: torch.Tensor,
    connectivity: int = 4,
    *,
    general: bool = False,
    global_memory: bool = False,
) -> torch.Tensor:
    """The converged min-label image of ``(B, H, W)`` cluster labels
    (``< 0`` = background): ``(B, H, W)`` int64, each valid cell's smallest
    same-component raster index, ``H * W`` outside.

    A CPU tensor takes :func:`converge_labels_plain`. A CUDA tensor launches
    K10's cluster kernel when a band of ``ceil(H / 8)`` rows fits
    ``K10_BAND_CELLS``, and the general kernel otherwise or with
    ``general=True``; that kernel holds the frame in shared memory up to
    ``K10_SHARED_CELLS`` cells and loops over global memory past that or
    with ``global_memory=True``.
    """
    if cluster_labels.device.type == "cpu":
        return converge_labels_plain(cluster_labels, connectivity)
    _neighbour_shifts(connectivity)
    _check_cuda(cluster_labels)
    if cluster_labels.ndim != 3:
        raise TypeError("converge_labels: cluster_labels must be (B, H, W)")
    b, h, w = cluster_labels.shape
    cl = cluster_labels.to(torch.int32).contiguous()
    out = torch.empty((b, h, w), dtype=torch.int32, device=cl.device)
    if out.numel() == 0:
        return out.to(torch.int64)
    with torch.cuda.device(cl.device):
        if not (general or global_memory) and band_cells(h, w) <= K10_BAND_CELLS:
            CCL_CONVERGE.launch(cl.data_ptr(), out.data_ptr(), b, h, w,
                                connectivity, stream_handle(cl))
        else:
            use_global = global_memory or h * w > K10_SHARED_CELLS
            scratch = (torch.empty((b, h, w), dtype=torch.uint8, device=cl.device)
                       if use_global else None)
            CCL_CONVERGE_GENERAL.launch(
                cl.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                b, h, w, connectivity, int(use_global), stream_handle(cl),
            )
    return out.to(torch.int64)


def block_types_from_clusters(
    cluster_labels: torch.Tensor, k: int, connectivity: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block types from ``(B, H, W)`` cluster labels (``< 0`` = background).

    Returns ``(block_types (B, H, W) int32, 0 = background; counts (B, k)
    int32)``: cluster ``c``'s components are numbered in raster order of
    their first cell, starting after the previous clusters' (n + 1) counts.
    """
    labels = converge_labels(cluster_labels, connectivity)
    b, h, w = cluster_labels.shape
    n = h * w
    dev = cluster_labels.device
    valid = cluster_labels >= 0
    cl = torch.where(valid, cluster_labels.to(torch.int64), -1)
    idx = torch.arange(n, device=dev).reshape(1, h, w)

    # per-cluster canonical numbering + running offsets
    flat_lab = labels.reshape(b, n)
    flat_cl = cl.reshape(b, n)
    roots = valid.reshape(b, n) & (flat_lab == idx.reshape(1, n))
    ranked = torch.zeros((b, n), dtype=torch.int64, device=dev)
    offset = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    counts = []
    for c in range(k):
        root_c = roots & (flat_cl == c)
        rank_c = torch.cumsum(root_c.to(torch.int64), dim=1)
        ranked = torch.where(root_c, rank_c + offset, ranked)
        n_c = rank_c[:, -1:]
        counts.append(n_c + 1)
        offset = offset + n_c + 1
    ext = torch.cat([ranked, torch.zeros((b, 1), dtype=torch.int64, device=dev)], 1)
    btypes = torch.gather(ext, 1, flat_lab)
    btypes = torch.where(valid.reshape(b, n), btypes, 0)
    return (
        btypes.reshape(b, h, w).to(torch.int32),
        torch.cat(counts, dim=1).to(torch.int32),
    )
