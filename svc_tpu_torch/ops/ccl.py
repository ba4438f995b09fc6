"""Per-cluster connected components -> block types (``svc_tpu/ops/ccl.py``).

Reproduces the reference's loop over k-means clusters — one
``cv::connectedComponents`` per cluster mask, block type = component id +
running offset, offset advanced by that call's label count (component
count + 1; libs/encoder.cpp:597-623) — by labelling every cluster of every
frame in one propagation: a component of cluster ``c``'s mask is exactly a
maximal same-cluster-connected region of the cluster image.

Labelling is min-label propagation (each valid cell starts with its raster
index and repeatedly takes the minimum over itself and its same-cluster
neighbours) with pointer jumping (``label = min(label, label[label])``),
iterated in Python until nothing changes. The result is a canonical
function of the cluster image, so it equals ``svc_tpu``'s bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SWEEPS_PER_CHECK = 4


def _shifted(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """``out[..., y, x] = x[..., y + dy, x + dx]``, ``fill`` outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def block_types_from_clusters(
    cluster_labels: torch.Tensor, k: int, connectivity: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block types from ``(B, H, W)`` cluster labels (``< 0`` = background).

    Returns ``(block_types (B, H, W) int32, 0 = background; counts (B, k)
    int32)``: cluster ``c``'s components are numbered in raster order of
    their first cell, starting after the previous clusters' (n + 1) counts.
    """
    if connectivity not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    b, h, w = cluster_labels.shape
    n = h * w
    dev = cluster_labels.device
    valid = cluster_labels >= 0
    cl = torch.where(valid, cluster_labels.to(torch.int64), -1)
    idx = torch.arange(n, device=dev).reshape(1, h, w)
    big = n
    labels = torch.where(valid, idx, big)

    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
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
            break
        labels = new

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
