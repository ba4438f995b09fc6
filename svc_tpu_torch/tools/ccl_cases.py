"""Cluster images that stress K10's band-local union-find
(``csrc/ccl_converge.cu``): components that cross every band border of
the 8-CTA cluster many times, roots far from where the merges happen, and
frames with fewer rows than bands. ``chip_smoke.py`` and the tests hold
both K10 kernels to ``ops/ccl.py:converge_labels_plain`` on them.

Every function returns an int32 tensor on the CPU, ``(1, H, W)`` but for
:func:`blobs` (``< 0`` is background).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def spiral(h: int = 68, w: int = 120) -> torch.Tensor:
    """A one-cell-wide path of cluster 0 from (0, 0) spiralling inwards,
    one cell of cluster 1 between its turns: two interleaved components
    that cross every band border many times, the path's root in row 0."""
    lab = np.ones((h, w), dtype=np.int32)
    lab[0, 0] = 0
    y, x, d = 0, 0, 0
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))

    def free(yy, xx):
        return 0 <= yy < h and 0 <= xx < w and lab[yy, xx] != 0

    turns = 0
    while turns < 2:
        dy, dx = dirs[d]
        # step while the next cell is free and the one after it is not path
        if free(y + dy, x + dx) and (not (0 <= y + 2 * dy < h and 0 <= x + 2 * dx < w)
                                     or lab[y + 2 * dy, x + 2 * dx] != 0):
            y, x = y + dy, x + dx
            lab[y, x] = 0
            turns = 0
        else:
            d = (d + 1) % 4
            turns += 1
    return torch.from_numpy(lab)[None]


def comb(h: int = 68, w: int = 120, bands: int = 8) -> torch.Tensor:
    """One component of cluster 0 on background: a tooth from row 0 of
    band 0 (the root) and a tooth from the middle of each band 1..7, all
    running down to the last row, where a spine joins them and nothing
    else does."""
    lab = np.full((h, w), -1, dtype=np.int32)
    rows = -(-h // bands)
    cols = [2 + j * (w - 4) // (bands - 1) for j in range(bands)]
    for j, x in enumerate(cols):
        first, last = min(h - 1, j * rows), min(h, (j + 1) * rows) - 1
        lab[0 if j == 0 else (first + last) // 2 :, x] = 0
    lab[h - 1, cols[0] : cols[-1] + 1] = 0
    return torch.from_numpy(lab)[None]


def checkerboard(h: int = 68, w: int = 120) -> torch.Tensor:
    """Cluster 0 on the cells with y + x even, background on the others:
    one component at 8-connectivity, H * W / 2 singletons at 4."""
    yy, xx = np.mgrid[:h, :w]
    return torch.from_numpy(np.where((yy + xx) % 2 == 0, 0, -1).astype(np.int32))[None]


def blobs(g: torch.Generator, b: int, h: int, w: int, k: int) -> torch.Tensor:
    """``(b, h, w)`` cluster images like the encoder's: k clusters in
    8x8-cell regions, a tenth of the cells background."""
    lab = torch.randint(0, k, (b, h // 8 + 1, w // 8 + 1), generator=g,
                        dtype=torch.int32)
    lab = lab.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w]
    return torch.where(torch.rand((b, h, w), generator=g) < 0.1, -1, lab)


def random_clusters(h: int, w: int, k: int, seed: int) -> torch.Tensor:
    """Cluster labels drawn uniformly from ``[-1, k)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-1, k, (1, h, w), dtype=np.int32))


def adversarial() -> Dict[str, torch.Tensor]:
    """The named cases, each to be run at both connectivities."""
    return {
        "68x120 spiral": spiral(),
        "68x120 comb": comb(),
        "68x120 one cluster": torch.zeros((1, 68, 120), dtype=torch.int32),
        "68x120 all background": torch.full((1, 68, 120), -1, dtype=torch.int32),
        "68x120 checkerboard": checkerboard(),
        "1x1": torch.zeros((1, 1, 1), dtype=torch.int32),
        "5x120 random": random_clusters(5, 120, 3, 5),
        "1x120 random": random_clusters(1, 120, 3, 1),
    }
