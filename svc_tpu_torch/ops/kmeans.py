"""K-means clustering of foreground motion features
(``svc_tpu/ops/kmeans.py``), the ``opencv_split`` (reference-compat) rule.

Replaces ``cv::kmeans(features, k, ..., attempts, KMEANS_PP_CENTERS)``
(libs/encoder.cpp:557-578), batched over frames AND attempts:

* k-means++ seeding by Gumbel-max: ``argmax(log w + g)`` over valid points
  with all ``(k, N)`` gumbels drawn up front from the frame's key
  (``ops.prng``, bit-equal to ``jax.random.uniform``);
* Lloyd iterations with first-wins argmin assignment, OpenCV's
  stop rule (squared center shift <= ``epsilon**2`` or ``max_iter``) and
  reciprocal-multiply center normalization (``scale = 1.f / count``);
* OpenCV's empty-cluster repair: each empty cluster, in index order, takes
  the farthest member (last-wins) of the biggest cluster (first-wins);
* best of ``attempts`` by compactness (first-wins).

Distances sum the D feature terms sequentially (d = 0, 1, ...) like the
reference's per-dimension loop. Only ``repair="opencv_split"`` exists here:
the default ``global_farthest`` rule runs the fused Lloyd kernel K5
(``kmeans_pallas.lloyd_pallas_batched``), which is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svc_tpu_torch.ops import prng

_BIG = 1e30

K5_MESSAGE = (
    "k-means repair={!r} runs the fused Lloyd kernel K5 "
    "(svc_tpu/ops/kmeans_pallas.py lloyd_pallas_batched), not yet ported to "
    "svc_tpu_torch (ROADMAP.md Queue 1, K5); use "
    "EncoderConfig(reference_compat=True), whose repair='opencv_split' runs "
    "the plain Lloyd"
)


def _sqdist(xt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 from points ``xt (..., D, N)`` to centers ``c (..., D)``,
    summed over D in order: ``(..., N)``."""
    acc = None
    for d in range(xt.shape[-2]):
        diff = xt[..., d, :] - c[..., d, None]
        acc = diff * diff if acc is None else acc + diff * diff
    return acc


def _gather_points(xt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns ``idx (F, A)`` of ``xt (F, D, N)``: ``(F, A, D)``."""
    f, d, _ = xt.shape
    ix = idx[:, :, None].expand(f, idx.shape[1], d)
    return torch.gather(xt.transpose(1, 2), 1, ix)


def _plus_plus_init(keys, xt, mask, k):
    """k-means++ seeding per (frame, attempt): centers ``(F, A, k, D)``."""
    n = xt.shape[-1]
    u = prng.uniform(keys, (k, n), 1e-12, 1.0)  # (F, A, k, N)
    gumbels = -torch.log(-torch.log(u))
    maskf = mask.to(xt.dtype)[:, None, :]  # (F, 1, N)
    valid = mask[:, None, :]
    neg = torch.tensor(-_BIG, dtype=torch.float32, device=xt.device)
    zero = torch.zeros((), dtype=torch.float32, device=xt.device)

    def pick(w, g):
        score = torch.where(w > 0, torch.log(w) + g, neg)
        return torch.argmax(score, dim=-1)

    idx = pick(maskf.expand_as(gumbels[:, :, 0]), gumbels[:, :, 0])
    centers = [_gather_points(xt, idx)]
    d2 = torch.full(gumbels.shape[:2] + (n,), _BIG, dtype=torch.float32,
                    device=xt.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, _sqdist(xt[:, None], centers[-1]))
        w = torch.where(valid, d2, zero)
        # all residual weights vanish (fewer distinct points than k):
        # uniform over valid points
        w = torch.where((w > 0).any(dim=-1, keepdim=True), w, maskf)
        centers.append(_gather_points(xt, pick(w, gumbels[:, :, i])))
    return torch.stack(centers, dim=2)


def _assign(xt, centers, mask):
    """First-wins argmin over the k centers: labels and point distances."""
    d2 = torch.stack(
        [_sqdist(xt[:, None], centers[:, :, j]) for j in range(centers.shape[2])],
        dim=2,
    )  # (F, A, k, N)
    labels = torch.argmin(d2, dim=2)
    point_d2 = torch.amin(d2, dim=2)
    zero = torch.zeros((), dtype=torch.float32, device=xt.device)
    point_d2 = torch.where(
        mask[:, None, :], torch.clamp(point_d2, min=0.0), zero
    )
    return labels, point_d2


def _opencv_split_repair(xt, mask, labels, sums, counts, k):
    """cv::kmeans' empty-cluster rule, every (frame, attempt) at once: each
    empty cluster in index order takes the farthest member (squared L2 to
    its center, last-wins) of the biggest cluster (first-wins), updating
    labels/sums/counts before the next empty cluster."""
    n = xt.shape[-1]
    dev = xt.device
    lanes = torch.arange(n, device=dev)
    ks = torch.arange(k, device=dev)
    neg1 = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    for kk in range(k):
        need = counts[..., kk] == 0.0  # (F, A)
        if not bool(need.any()):
            continue
        max_k = torch.argmax(counts, dim=-1)  # (F, A)
        cnt = torch.gather(counts, 2, max_k[..., None])[..., 0]
        center = torch.gather(
            sums, 2, max_k[..., None, None].expand(-1, -1, 1, sums.shape[-1])
        )[:, :, 0] * (1.0 / torch.clamp(cnt, min=1.0))[..., None]
        d2 = _sqdist(xt[:, None], center)  # (F, A, N)
        memb = (labels == max_k[..., None]) & mask[:, None, :]
        d2 = torch.where(memb, d2, neg1)
        mx = d2.max(dim=-1, keepdim=True).values
        far = torch.where(d2 >= mx, lanes, -1).max(dim=-1).values  # last max
        point = _gather_points(xt, far)  # (F, A, D)
        labels = torch.where(
            need[..., None] & (lanes == far[..., None]), kk, labels
        )
        add = need[..., None] & (ks == kk)  # (F, A, k)
        sub = need[..., None] & (ks == max_k[..., None])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sums = sums + torch.where(add[..., None], point[:, :, None], zero)
        sums = sums - torch.where(sub[..., None], point[:, :, None], zero)
        counts = counts + add.to(counts.dtype)
        counts = counts - sub.to(counts.dtype)
    return labels, sums, counts


def kmeans_t_frames(
    features_t: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    keys: torch.Tensor,
    attempts: int = 3,
    max_iter: int = 10,
    epsilon: float = 1.0,
    repair: str = "opencv_split",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster every frame's valid feature columns.

    Args:
      features_t: ``(F, D, N)`` float32, points on the last axis.
      mask: ``(F, N)`` bool validity (foreground blocks).
      keys: ``(F, 2)`` frame keys; attempt keys are ``split(key, attempts)``
        as in ``svc_tpu``, so seeds match bit for bit.

    Returns ``(labels (F, N) int32, -1 where invalid; centers (F, k, D);
    compactness (F,))`` of each frame's best attempt.
    """
    if repair != "opencv_split":
        raise NotImplementedError(K5_MESSAGE.format(repair))
    f = features_t.shape[0]
    dev = features_t.device
    xt = features_t.to(torch.float32)
    attempt_keys = prng.split(keys, attempts)  # (F, A, 2)
    centers = _plus_plus_init(attempt_keys, xt, mask, k)  # (F, A, k, D)
    maskf = mask.to(torch.float32)[:, None, None, :]  # (F, 1, 1, N)
    ks = torch.arange(k, device=dev)[:, None]
    done = torch.zeros(centers.shape[:2], dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        labels, _ = _assign(xt, centers, mask)
        onehot = (labels[:, :, None, :] == ks).to(torch.float32) * maskf
        counts = onehot.sum(dim=-1)  # (F, A, k)
        # elementwise products summed in float32: exact for the
        # integer-valued motion features in any order (a matmul could run
        # in TF32 where a caller enabled it)
        sums = torch.stack(
            [(xt[:, None, None, d] * onehot).sum(dim=-1)
             for d in range(xt.shape[1])],
            dim=-1,
        )  # (F, A, k, D)
        _, sums, counts = _opencv_split_repair(xt, mask, labels, sums, counts, k)
        new_centers = sums * (1.0 / torch.clamp(counts, min=1.0))[..., None]
        diff = new_centers - centers
        shift2 = diff[..., 0] * diff[..., 0]
        for d in range(1, diff.shape[-1]):
            shift2 = shift2 + diff[..., d] * diff[..., d]
        shift2 = shift2.max(dim=-1).values  # (F, A)
        centers = torch.where(done[..., None, None], centers, new_centers)
        done = done | (shift2 <= epsilon**2)
    labels, point_d2 = _assign(xt, centers, mask)
    compact = point_d2.sum(dim=-1)  # (F, A)
    best = torch.argmin(compact, dim=1)  # first-wins across attempts
    rows = torch.arange(f, device=dev)
    labels = torch.where(mask, labels[rows, best], -1).to(torch.int32)
    return labels, centers[rows, best], compact[rows, best]
