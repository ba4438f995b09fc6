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

Batched over leading frame dims, one key per frame. Only ``subset_sz == 1``
(the reference default) is implemented: larger subsets draw without
replacement through ``jax.random.choice``, which the port does not carry yet.
"""

from __future__ import annotations

import math
import sys
from typing import Tuple

import numpy as np
import torch

from svc_tpu.config import RansacParams
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
    if params.subset_sz != 1:
        raise NotImplementedError(
            "svc_tpu_torch RANSAC implements subset_sz == 1 only (the "
            "reference default); larger subsets need jax.random.choice's "
            "without-replacement draw, not yet ported"
        )

    idx = prng.randint(keys, (k, 1), 0, n_points).to(torch.int64)  # (F, k, 1)
    gm0 = torch.gather(f0, 1, idx[..., 0])  # mean of a 1-subset: exact
    gm1 = torch.gather(f1, 1, idx[..., 0])

    d0 = gm0[:, :, None] - f0[:, None, :]
    d1 = gm1[:, :, None] - f1[:, None, :]
    err2 = d0 * d0 + d1 * d1
    thresh = torch.tensor(params.inlier_thresh, dtype=torch.float32)
    inliers = err2 < (thresh * thresh).to(dev)
    counts = inliers.sum(dim=2)  # (F, k)

    # ">=" keep rule: the LAST hypothesis attaining the max count wins
    best = (k - 1) - torch.argmax(torch.flip(counts, dims=[1]), dim=1)
    rows = torch.arange(f, device=dev)
    best_gm = torch.stack([gm0[rows, best], gm1[rows, best]], dim=-1)
    best_count = counts[rows, best]
    best_mask = inliers[rows, best]  # (F, N)
    best_subset = idx[rows, best]  # (F, 1)

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
    rmse_subset = torch.sqrt(torch.gather(err2_final, 1, best_subset).mean(dim=1))
    rmse = torch.where(degenerate, rmse_subset, rmse_inliers)
    return gm, rmse, best_mask.reshape(lead)
