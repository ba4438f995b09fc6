"""K-means clustering of foreground motion features
(``svc_tpu/ops/kmeans.py``), both empty-cluster repair rules.

Replaces ``cv::kmeans(features, k, ..., attempts, KMEANS_PP_CENTERS)``
(libs/encoder.cpp:557-578), batched over frames AND attempts:

* k-means++ seeding by Gumbel-max: ``argmax(log w + g)`` over valid points
  with all ``(k, N)`` gumbels drawn up front from the frame's key
  (``ops.prng``, bit-equal to ``jax.random.uniform``);
* Lloyd iterations with first-wins argmin assignment and OpenCV's stop
  rule (squared center shift <= ``epsilon**2`` or ``max_iter``);
* best of ``attempts`` by compactness (first-wins).

Two repair rules, as in svc_tpu:

* ``global_farthest`` (the default config): the r-th empty cluster takes
  the r-th farthest valid point, centers are ``sums / counts``. The Lloyd
  loop is kernel K5 (:func:`lloyd`: the cluster kernel ``csrc/lloyd.cu``,
  or ``csrc/lloyd_general.cu`` for slices too large for shared memory)
  beside its plain version :func:`lloyd_plain`;
* ``opencv_split`` (``reference_compat``): cv::kmeans' rule — each empty
  cluster, in index order, takes the farthest member (last-wins) of the
  biggest cluster (first-wins) — with reciprocal-multiply centers
  (``scale = 1.f / count``), in plain PyTorch.

Distances sum the D feature terms sequentially (d = 0, 1, ...) like the
reference's per-dimension loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svc_tpu_torch.kernels.build import FLOAT, INT, PTR, Kernel, stream_handle
from svc_tpu_torch.ops import prng

_BIG = 1e30
_MAX_K = 16  # K5's shared-memory cluster capacity (svc_tpu's _KPAD)
_MAX_D = 7  # K5's feature capacity (svc_tpu's x_aug rows minus the ones row)

# K5's cluster kernel (csrc/lloyd.cu): kCluster CTAs per (frame, attempt),
# each holding a slice of the points in shared memory
_K5_CLUSTER = 8
_K5_CHUNKS = 32  # label-word chunks of its sums scan
# its static shared memory, at most (chip_smoke.py phase 2 holds the
# kernel's ptxas figure to it; svc_lloyd reads the real one)
_K5_STATIC_SMEM = 20 * 1024
_K5_MAX_SMEM = 227 * 1024  # the most one CTA may use on an H100

LLOYD = Kernel(
    "lloyd",
    "svc_lloyd",
    [PTR] * 6 + [INT] * 6 + [FLOAT, PTR],
    source="svc_tpu_torch/csrc/lloyd.cu",
    replaces="svc_tpu/ops/kmeans_pallas.py:485",
)
LLOYD_GENERAL = Kernel(
    "lloyd_general",
    "svc_lloyd_general",
    [PTR] * 7 + [INT] * 6 + [FLOAT, PTR],
    source="svc_tpu_torch/csrc/lloyd_general.cu",
    replaces="svc_tpu/ops/kmeans_pallas.py:485",
)


def cluster_smem_bytes(n: int, d: int) -> int:
    """Dynamic shared memory of one CTA of K5's cluster kernel: features,
    parked distances, labels and mask of a slice padded to whole chunks of
    4-label words (``dynamic_smem`` in ``csrc/lloyd.cu``)."""
    slice_words = -(-(-(-n // _K5_CLUSTER)) // 4)  # ceil(ceil(n / 8) / 4)
    words = -(-slice_words // _K5_CHUNKS)  # per chunk
    return _K5_CHUNKS * 4 * words * (4 * d + 6)


def _cluster_fits(n: int, d: int) -> bool:
    return cluster_smem_bytes(n, d) + _K5_STATIC_SMEM <= _K5_MAX_SMEM


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
    neg = torch.full((), -_BIG, dtype=torch.float32, device=xt.device)
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


def _shift2(new_centers, centers):
    """Largest squared center move per (frame, attempt), D summed in order."""
    diff = new_centers - centers
    shift2 = diff[..., 0] * diff[..., 0]
    for d in range(1, diff.shape[-1]):
        shift2 = shift2 + diff[..., d] * diff[..., d]
    return shift2.max(dim=-1).values


def _opencv_split_repair(xt, mask, labels, sums, counts, k):
    """cv::kmeans' empty-cluster rule, every (frame, attempt) at once: each
    empty cluster in index order takes the farthest member (squared L2 to
    its center, last-wins) of the biggest cluster (first-wins), updating
    labels/sums/counts before the next empty cluster."""
    n = xt.shape[-1]
    dev = xt.device
    lanes = torch.arange(n, device=dev)
    ks = torch.arange(k, device=dev)
    neg1 = torch.full((), -1.0, dtype=torch.float32, device=dev)
    for kk in range(k):
        need = counts[..., kk] == 0.0  # (F, A)
        # the skip is a host sync: taken on the CPU only (with no cluster
        # in need every update below is masked out)
        if dev.type == "cpu" and not bool(need.any()):
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


def _lloyd_opencv_split(xt, mask, centers, k, max_iter, epsilon):
    """The reference-compat Lloyd loop on ``(F, A, k, D)`` seeds: labels
    ``(F, A, N)``, centers ``(F, A, k, D)``, compactness ``(F, A)``."""
    dev = xt.device
    maskf = mask.to(torch.float32)[:, None, None, :]  # (F, 1, 1, N)
    ks = torch.arange(k, device=dev)[:, None]
    done = torch.zeros(centers.shape[:2], dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        # the early exit is a host sync: taken on the CPU only (once every
        # attempt is done, further iterations change nothing)
        if dev.type == "cpu" and bool(done.all()):
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
        shift2 = _shift2(new_centers, centers)
        centers = torch.where(done[..., None, None], centers, new_centers)
        done = done | (shift2 <= epsilon**2)
    labels, point_d2 = _assign(xt, centers, mask)
    return labels, centers, point_d2.sum(dim=-1)


def _global_farthest_repair(xt, mask, point_d2, empty, cand):
    """The r-th empty cluster (by index) of each (frame, attempt) moves onto
    the r-th farthest valid point: sequential argmaxes (ties to the lowest
    index) over the pre-update distances, each taken point set to -1."""
    n_pick = int(empty.sum(dim=-1).max())
    lanes = torch.arange(xt.shape[-1], device=xt.device)
    neg1 = torch.full((), -1.0, dtype=torch.float32, device=xt.device)
    d2left = torch.where(mask[:, None, :], point_d2, neg1)  # (F, A, N)
    far = []
    for _ in range(n_pick):
        idx = torch.argmax(d2left, dim=-1)  # (F, A), first of the maxima
        far.append(_gather_points(xt, idx))
        d2left = torch.where(lanes == idx[..., None], neg1, d2left)
    far = torch.stack(far, dim=2)  # (F, A, n_pick, D)
    rank = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=-1) - 1, 0)
    reseed = torch.gather(far, 2, rank[..., None].expand(-1, -1, -1, far.shape[-1]))
    return torch.where(empty[..., None], reseed, cand)


def _eps2(epsilon: float) -> float:
    """``float32(epsilon) ** 2`` rounded to float32, K5's stop threshold."""
    e = np.float32(epsilon)
    return float(e * e)


def lloyd_plain(
    x: torch.Tensor,
    mask: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    max_iter: int,
    epsilon: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 (same contract as :func:`lloyd`).

    Per-cluster sums are accumulated in float64 and rounded once to
    float32 (exact for integer-valued features at any frame size, where a
    float32 sum past 2**24 would depend on the order); compactness is
    summed in float64 too.
    """
    return _lloyd_plain(x, mask, init_centers, k, max_iter, epsilon)[:3]


def lloyd_iterations(
    x: torch.Tensor,
    mask: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    max_iter: int,
    epsilon: float,
) -> torch.Tensor:
    """``(A, F)`` int32: the Lloyd iterations each attempt of each frame
    runs before it converges (or reaches ``max_iter``) — the work K5 does on
    these inputs, for its roofline bound."""
    return _lloyd_plain(x, mask, init_centers, k, max_iter, epsilon)[3]


def _lloyd_plain(x, mask, init_centers, k, max_iter, epsilon):
    xt = x.to(torch.float32)
    x64 = xt.to(torch.float64)
    dev = xt.device
    centers = init_centers.to(torch.float32).transpose(0, 1)  # (F, A, k, D)
    maskf = mask.to(torch.float32)[:, None, None, :]  # (F, 1, 1, N)
    ks = torch.arange(k, device=dev)[:, None]
    eps2 = torch.tensor(_eps2(epsilon), dtype=torch.float32, device=dev)
    done = torch.zeros(centers.shape[:2], dtype=torch.bool, device=dev)
    iterations = torch.zeros(centers.shape[:2], dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        iterations += (~done).to(torch.int32)
        labels, point_d2 = _assign(xt, centers, mask)
        onehot = (labels[:, :, None, :] == ks).to(torch.float32) * maskf
        counts = onehot.sum(dim=-1)  # (F, A, k), exact
        oh64 = onehot.to(torch.float64)
        sums = torch.stack(
            [(x64[:, None, None, d] * oh64).sum(dim=-1)
             for d in range(xt.shape[1])],
            dim=-1,
        ).to(torch.float32)  # (F, A, k, D)
        cand = sums / torch.clamp(counts, min=1.0)[..., None]
        empty = counts == 0.0
        if bool(empty.any()):
            cand = _global_farthest_repair(xt, mask, point_d2, empty, cand)
        shift2 = _shift2(cand, centers)
        # the update that sets done still applies (previous-done freeze)
        centers = torch.where(done[..., None, None], centers, cand)
        done = done | (shift2 <= eps2)
    labels, point_d2 = _assign(xt, centers, mask)
    compact = point_d2.to(torch.float64).sum(dim=-1).to(torch.float32)
    return (
        labels.transpose(0, 1).to(torch.int32).contiguous(),
        centers.transpose(0, 1).contiguous(),
        compact.transpose(0, 1).contiguous(),
        iterations.transpose(0, 1).contiguous(),
    )


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"lloyd: unsupported device {x.device}")


def lloyd(
    x: torch.Tensor,
    mask: torch.Tensor,
    init_centers: torch.Tensor,
    k: int,
    max_iter: int,
    epsilon: float,
    *,
    general: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every Lloyd attempt of every frame with the ``global_farthest``
    repair (kernel K5: the cluster kernel, 8 CTAs per (frame, attempt),
    when a slice of ``ceil(N / 8)`` points fits a CTA's shared memory —
    every frame size up to and beyond 4K — and the one-CTA general kernel
    otherwise).

    Args:
      x: ``(F, D, N)`` float32 features, points on the last axis.
      mask: ``(F, N)`` bool validity.
      init_centers: ``(A, F, k, D)`` float32 seeded centers.
      general: launch the general kernel whatever the size (the yardstick
        the cluster kernel is held and timed against).

    Returns ``(labels (A, F, N) int32 — every point, masked or not;
    centers (A, F, k, D); compactness (A, F))``.
    """
    if x.device.type == "cpu":
        return lloyd_plain(x, mask, init_centers, k, max_iter, epsilon)
    _check_cuda(x)
    if x.dtype != torch.float32 or x.ndim != 3:
        raise TypeError("lloyd: x must be (F, D, N) float32")
    f, d, n = x.shape
    a = init_centers.shape[0]
    if init_centers.dtype != torch.float32 or tuple(init_centers.shape) != (a, f, k, d):
        raise TypeError("lloyd: init_centers must be (A, F, k, D) float32")
    if mask.dtype != torch.bool or tuple(mask.shape) != (f, n):
        raise TypeError("lloyd: mask must be (F, N) bool")
    if not (1 <= k <= _MAX_K and 1 <= d <= _MAX_D and n >= 1):
        raise ValueError(f"lloyd: needs 1 <= k <= {_MAX_K}, 1 <= D <= "
                         f"{_MAX_D} and N >= 1 (got k={k}, D={d}, N={n})")
    if mask.device != x.device or init_centers.device != x.device:
        raise ValueError("lloyd: inputs on different devices")
    dev = x.device
    xc = x.contiguous()
    m = mask.to(torch.uint8).contiguous()
    c0 = init_centers.contiguous()
    labels = torch.empty((a, f, n), dtype=torch.int32, device=dev)
    centers = torch.empty((a, f, k, d), dtype=torch.float32, device=dev)
    compact = torch.empty((a, f), dtype=torch.float32, device=dev)
    if compact.numel() == 0:
        return labels, centers, compact
    with torch.cuda.device(dev):
        if _cluster_fits(n, d) and not general:
            LLOYD.launch(
                xc.data_ptr(), m.data_ptr(), c0.data_ptr(), labels.data_ptr(),
                centers.data_ptr(), compact.data_ptr(),
                a, f, n, d, k, max_iter, _eps2(epsilon), stream_handle(xc),
            )
        else:
            scratch = torch.empty((a, f, n), dtype=torch.float32, device=dev)
            LLOYD_GENERAL.launch(
                xc.data_ptr(), m.data_ptr(), c0.data_ptr(), labels.data_ptr(),
                centers.data_ptr(), compact.data_ptr(), scratch.data_ptr(),
                a, f, n, d, k, max_iter, _eps2(epsilon), stream_handle(xc),
            )
    return labels, centers, compact


def lloyd_inputs_from_jax(x_aug, mask_f, init, k: int, d: int):
    """svc_tpu's Lloyd-kernel inputs as the port's, on the CPU.

    Takes numpy arrays in ``kmeans_pallas.lloyd_pallas_batched``'s layouts —
    ``x_aug (F, 8, N)`` (rows ``0..d-1`` features, row ``d`` ones),
    ``mask_f (F, 1, N)`` float validity, ``init (A, F, 16, 128)`` padded
    seeds — and returns ``(x (F, D, N) float32, mask (F, N) bool,
    init_centers (A, F, k, D) float32)`` for :func:`lloyd_plain` /
    :func:`lloyd`, so both run from the same start.
    """
    x = torch.tensor(np.asarray(x_aug, np.float32)[:, :d])
    mask = torch.tensor(np.asarray(mask_f)[:, 0] > 0)
    c0 = torch.tensor(np.asarray(init, np.float32)[:, :, :k, :d])
    return x, mask, c0


def kmeans_t_frames(
    features_t: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    keys: torch.Tensor,
    attempts: int = 3,
    max_iter: int = 10,
    epsilon: float = 1.0,
    repair: str = "global_farthest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster every frame's valid feature columns.

    Args:
      features_t: ``(F, D, N)`` float32, points on the last axis.
      mask: ``(F, N)`` bool validity (foreground blocks).
      keys: ``(F, 2)`` frame keys; attempt keys are ``split(key, attempts)``
        as in ``svc_tpu``, so seeds match bit for bit.
      repair: ``"global_farthest"`` (kernel K5 on a CUDA tensor, its plain
        version on a CPU tensor) or ``"opencv_split"``.

    Returns ``(labels (F, N) int32, -1 where invalid; centers (F, k, D);
    compactness (F,))`` of each frame's best attempt.
    """
    if repair not in ("global_farthest", "opencv_split"):
        raise ValueError(f"unknown k-means repair rule {repair!r}")
    f = features_t.shape[0]
    dev = features_t.device
    xt = features_t.to(torch.float32)
    attempt_keys = prng.split(keys, attempts)  # (F, A, 2)
    # seeding stays outside the Lloyd loop, as in svc_tpu
    centers = _plus_plus_init(attempt_keys, xt, mask, k)  # (F, A, k, D)
    if repair == "global_farthest":
        lab_a, cen_a, compact = lloyd(
            xt.contiguous(), mask, centers.transpose(0, 1).contiguous(), k,
            max_iter, epsilon,
        )
        labels = lab_a.transpose(0, 1)
        centers = cen_a.transpose(0, 1)
        compact = compact.transpose(0, 1)
    else:
        labels, centers, compact = _lloyd_opencv_split(
            xt, mask, centers, k, max_iter, epsilon
        )
    best = torch.argmin(compact, dim=1)  # first-wins across attempts
    rows = torch.arange(f, device=dev)
    labels = torch.where(mask, labels[rows, best], -1).to(torch.int32)
    return labels, centers[rows, best], compact[rows, best]
