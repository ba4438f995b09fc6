"""RANSAC global-motion estimation as parallel hypothesis scoring
(``svc_tpu/ops/ransac.py``).

All ``k`` hypotheses are drawn up front from an explicit key and scored
against the whole motion field in one ``(k, N)`` broadcast:

* ``k = ceil(log(1-p) / log(1 - w**n))`` in float32 (libs/motion.cpp:144-149);
* hypothesis = mean MV of an ``n``-subset (libs/motion.cpp:151-163);
* inlier iff squared error < thresh**2 (libs/motion.cpp:228);
* the LAST hypothesis attaining the max inlier count wins (``>=`` keep rule,
  libs/motion.cpp:233-237);
* refit: mean + RMSE over the best hypothesis's inliers; the degenerate case
  (fewer inliers than the subset) keeps the hypothesis and its subset RMSE.

Batched over leading frame dims, one key per frame. A 1-subset is one
``randint`` draw per hypothesis; a larger subset splits the frame's key into
one key per hypothesis and draws ``choice(..., replace=False)`` from each
(``ops.prng``), as ``svc_tpu`` does. Subset means are summed in index order
and divided, jnp's float32 ``mean``.
"""

from __future__ import annotations

import math
import sys
from typing import Tuple

import numpy as np
import torch

from svc_tpu_torch.config import RansacParams
from svc_tpu_torch.ops import prng

#: Budget for the (k, N) hypothesis-scoring tensors (svc_tpu/ops/ransac.py).
_HYPOTHESIS_MEM_BUDGET = 64 << 20


def hypothesis_cap(
    n_points: int, budget_bytes: int = _HYPOTHESIS_MEM_BUDGET
) -> int:
    """Largest hypothesis count whose scoring tensors fit the budget (4
    bytes of squared error plus a 1-byte flag per cell), floored at 1024."""
    return max(1024, budget_bytes // (5 * max(n_points, 1)))


def iter_count(params: RansacParams, max_hypotheses: int = 65536) -> int:
    """Number of hypotheses, float32 math like the reference
    (libs/motion.cpp:144-149); degenerate parameters that make it unbounded
    are clamped to ``max_hypotheses``."""
    p = np.float32(params.success_prob)
    w = np.float32(params.inlier_ratio)
    n = np.float32(params.subset_sz)
    with np.errstate(divide="ignore", invalid="ignore"):
        quot = np.log(np.float32(1) - p)
        div = np.log(np.float32(1) - np.power(w, n))
        ratio = quot / div
    if not np.isfinite(ratio) or ratio < 0:
        return max_hypotheses if (w <= 0 or p >= 1) else 0
    return min(int(math.ceil(float(ratio))), max_hypotheses)


def _take(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``f[i, idx[i]]`` per frame: ``(F, N)`` at ``(F, k, m)`` indices."""
    return torch.gather(f, 1, idx.reshape(f.shape[0], -1)).reshape(idx.shape)


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, summed in index order from 0 then divided
    (jnp.mean's float32 order; exact for the integer MVs of the encoder).
    A 1-subset is its own mean (the MVs and squared errors are never -0)."""
    if x.shape[-1] == 1:
        return x[..., 0]
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    # a device tensor: CUDA divides by a host scalar through its
    # reciprocal; filled on the device, as a copy from pageable memory
    # would sync the stream
    return acc / torch.full((), float(x.shape[-1]), dtype=x.dtype, device=x.device)


def estimate_global_motion_ransac(
    motion_field: torch.Tensor, params: RansacParams, keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Estimate global motion per frame; the inlier mask marks background.

    Args:
      motion_field: ``(F, mfh, mfw, 2)`` float32 MVs.
      params: RANSAC parameters.
      keys: ``(F, 2)`` PRNG keys (``ops.prng``), one per frame.

    Returns ``(global_motion (F, 2), rmse (F,), inliers (F, mfh, mfw))``.
    """
    f = motion_field.shape[0]
    lead = motion_field.shape[:-1]
    dev = motion_field.device
    f0 = motion_field[..., 0].reshape(f, -1)
    f1 = motion_field[..., 1].reshape(f, -1)
    n_points = f0.shape[1]
    if n_points < params.subset_sz:
        raise ValueError("motion field smaller than RANSAC subset size")
    k = iter_count(params)
    cap = hypothesis_cap(n_points)
    if k > cap:
        print(
            f"warning: RANSAC parameters ask for {k} hypotheses; capping "
            f"at {cap} to bound the ({k}, {n_points}) scoring tensor "
            f"(~{5 * k * n_points >> 20} MB)",
            file=sys.stderr,
        )
        k = cap
    if k == 0:
        return (
            torch.zeros((f, 2), dtype=torch.float32, device=dev),
            torch.zeros((f,), dtype=torch.float32, device=dev),
            torch.zeros(lead, dtype=torch.bool, device=dev),
        )
    m = params.subset_sz
    if m == 1:
        idx = prng.randint(keys, (k, 1), 0, n_points).to(torch.int64)
    else:
        idx = prng.choice(prng.split(keys, k), n_points, m)  # (F, k, m)
    gm0 = _mean_last(_take(f0, idx))  # hypothesis models: subset means
    gm1 = _mean_last(_take(f1, idx))

    d0 = gm0[:, :, None] - f0[:, None, :]
    d1 = gm1[:, :, None] - f1[:, None, :]
    err2 = d0 * d0 + d1 * d1
    # the float32 square, filled on the device (no host copy)
    thresh = np.float32(params.inlier_thresh)
    inliers = err2 < torch.full((), float(thresh * thresh), dtype=torch.float32,
                                device=dev)
    counts = inliers.sum(dim=2)  # (F, k)

    # ">=" keep rule: the LAST hypothesis attaining the max count wins
    best = (k - 1) - torch.argmax(torch.flip(counts, dims=[1]), dim=1)
    rows = torch.arange(f, device=dev)
    best_gm = torch.stack([gm0[rows, best], gm1[rows, best]], dim=-1)
    best_count = counts[rows, best]
    best_mask = inliers[rows, best]  # (F, N)
    best_subset = idx[rows, best]  # (F, m)

    degenerate = best_count < params.subset_sz
    denom = torch.clamp(best_count, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    refit_gm = torch.stack(
        [
            torch.where(best_mask, f0, zero).sum(dim=1) / denom,
            torch.where(best_mask, f1, zero).sum(dim=1) / denom,
        ],
        dim=-1,
    )
    gm = torch.where(degenerate[:, None], best_gm, refit_gm)

    e0 = f0 - gm[:, 0:1]
    e1 = f1 - gm[:, 1:2]
    err2_final = e0 * e0 + e1 * e1
    rmse_inliers = torch.sqrt(
        torch.where(best_mask, err2_final, zero).sum(dim=1) / denom
    )
    rmse_subset = torch.sqrt(_mean_last(torch.gather(err2_final, 1, best_subset)))
    rmse = torch.where(degenerate, rmse_subset, rmse_inliers)
    return gm, rmse, best_mask.reshape(lead)
