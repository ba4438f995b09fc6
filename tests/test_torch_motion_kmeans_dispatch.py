"""K3's and K5's dispatch (the specialised / cluster kernels and the general
ones), the cluster kernel's slice geometry, and a CPU replay of its
decomposition against ``lloyd_plain``.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing
computes. The replay runs Lloyd with the cluster kernel's order of work —
per-slice partial sums added in rank order, the repair's argmax taken per
slice and then across slices — and must give ``lloyd_plain``'s labels and
centers bit for bit.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import kmeans, motion, prng


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the K3 / K5 wrappers' CUDA path to a meta device; record each
    launch as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(
        motion, "_check_sad_args",
        lambda name, planes, mv, lead, fh, fw, bw, bh, r: (fh // bh, fw // bw))
    monkeypatch.setattr(kmeans, "_check_cuda", lambda x: None)
    for mod in (motion, kmeans):
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (motion.REFINE_SADS, motion.REFINE_SADS_GENERAL,
              motion.CANDIDATE_SADS, kmeans.LLOYD, kmeans.LLOYD_GENERAL):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _meta_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bw,bh,r,general,kernel",
    [(4, 4, 1, False, "refine_sads"), (8, 8, 1, False, "refine_sads"),
     (16, 16, 1, False, "refine_sads"), (16, 8, 1, False, "refine_sads_general"),
     (16, 16, 2, False, "refine_sads_general"),
     (16, 16, 1, True, "refine_sads_general")],
)
def test_refine_sads_dispatch(meta_launches, bw, bh, r, general, kernel):
    fh, fw = 4 * bh, 6 * bw
    stack = _meta_u8(3, fh, fw)
    mv = torch.zeros((2, 4, 6, 2), dtype=torch.int32, device="meta")
    out = motion.refine_sads(stack, mv, r, bw, bh, general=general)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (2, (2 * r + 1) ** 2, 4, 6)
    ((name, args),) = meta_launches
    assert name == kernel
    k = motion.REFINE_SADS if kernel == "refine_sads" else motion.REFINE_SADS_GENERAL
    assert len(args) == len(k.argtypes)
    if kernel == "refine_sads":
        assert args[3:7] == (2, fh, fw, bw)  # t_count, fh, fw, block
    else:
        assert args[3:9] == (2, fh, fw, bw, bh, r)


def test_hbma_stack_default_levels_take_the_specialised_k3(meta_launches):
    # the default encoder's search (16x16 MV blocks, range 8, 4 levels):
    # the top-level EBMA on K9, then levels 2, 1, 0 on the new K3
    pyr = [_meta_u8(9, 1088 >> lvl, 1920 >> lvl) for lvl in range(4)]
    mv, mm = motion.hbma_stack(pyr, 8, 16, 16)
    assert tuple(mv.shape) == (8, 68, 120, 2) and tuple(mm.shape) == (8, 68, 120)
    names = [name for name, _ in meta_launches]
    assert names == ["candidate_sads"] + ["refine_sads"] * 3
    blocks = [args[6] for name, args in meta_launches if name == "refine_sads"]
    assert blocks == [4, 8, 16]


def test_k3_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "refine_sads.cu").read_text()
    cases = set(map(int, re.findall(r"case (\d+): return launch<", src)))
    assert cases == set(motion._K3_BLOCKS)
    # the SAD arithmetic K3 shares with the K8 refine: r = 1 only
    assert '#include "refine_rows.cuh"' in src
    rows = (build.CSRC_DIR / "refine_rows.cuh").read_text()
    assert "constexpr int kCand = 9;" in rows


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,d,general,kernel",
    [(8160, 4, False, "lloyd"), (32400, 4, False, "lloyd"),
     (32400, 7, False, "lloyd"), (1, 4, False, "lloyd"),
     (200000, 4, False, "lloyd_general"), (8160, 4, True, "lloyd_general")],
)
def test_lloyd_dispatch(meta_launches, n, d, general, kernel):
    f, a, k = 8, 3, 10
    x = torch.zeros((f, d, n), device="meta")
    mask = torch.zeros((f, n), dtype=torch.bool, device="meta")
    init = torch.zeros((a, f, k, d), device="meta")
    labels, centers, compact = kmeans.lloyd(x, mask, init, k, 10, 1.0,
                                            general=general)
    assert tuple(labels.shape) == (a, f, n) and labels.dtype == torch.int32
    assert tuple(centers.shape) == (a, f, k, d)
    assert tuple(compact.shape) == (a, f)
    ((name, args),) = meta_launches
    assert name == kernel
    kern = kmeans.LLOYD if kernel == "lloyd" else kmeans.LLOYD_GENERAL
    assert len(args) == len(kern.argtypes)
    ints = 6 if kernel == "lloyd" else 7  # pointers before the sizes
    assert args[ints:ints + 6] == (a, f, n, d, k, 10)
    assert args[ints + 6] == kmeans._eps2(1.0)


def test_lloyd_cluster_smem_limits():
    # the 1080p and 4K fields fit, 4K at D = 7 too; 8K (129,600 MV blocks)
    # goes to the general kernel; the cut sits where the slice's bytes pass
    # what a CTA may use
    assert kmeans.cluster_smem_bytes(8160, 4) == 1024 * 22  # 22.5 KB
    assert kmeans.cluster_smem_bytes(32400, 4) == 4096 * 22  # 88 KB
    # under 48 KB alone, past it with the kernel's ~19 KB of static smem
    assert kmeans.cluster_smem_bytes(14400, 4) == 42240  # 2560x1440
    assert kmeans.cluster_smem_bytes(8160, 7) == 34816
    assert kmeans._cluster_fits(32400, 7)
    assert not kmeans._cluster_fits(129600, 4)
    assert not kmeans._cluster_fits(200000, 4)
    n = 8
    while kmeans._cluster_fits(n, 7):
        n += 8
    assert kmeans.cluster_smem_bytes(n, 7) + kmeans._K5_STATIC_SMEM > 227 * 1024
    assert kmeans.cluster_smem_bytes(n - 8, 7) + kmeans._K5_STATIC_SMEM <= 227 * 1024


def test_k5_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "lloyd.cu").read_text()
    k = {n: v for n, v in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(k["kCluster"]) == kmeans._K5_CLUSTER
    assert int(k["kThreads"]) // 16 == kmeans._K5_CHUNKS  # kThreads / kMaxK
    assert eval(k["kMaxSmemBytes"]) == kmeans._K5_MAX_SMEM
    # the launch takes the static part from the loaded kernel, not from a
    # second hand-kept constant, and opts in to its dynamic part every time
    launch = src[src.index("SVC_EXPORT int svc_lloyd("):]
    assert "cudaFuncGetAttributes" in launch and "sharedSizeBytes" in launch
    assert "kSvcDefaultSmemBytes" not in launch


def cluster_slices(n):
    """``(start, stop)`` of the points each CTA of a K5 cluster owns, as
    ``csrc/lloyd.cu`` cuts them: ``p0 = min(n, rank * S)``, ``len =
    min(n, p0 + S) - p0`` with ``S = ceil(n / kCluster)``."""
    s = -(-n // kmeans._K5_CLUSTER)
    out = []
    for rank in range(kmeans._K5_CLUSTER):
        p0 = min(n, rank * s)
        out.append((p0, min(n, p0 + s)))
    return out


@pytest.mark.parametrize("n", [1, 37, 8160, 32400])
def test_cluster_slices_cover_every_point_once(n):
    slices = cluster_slices(n)
    assert len(slices) == kmeans._K5_CLUSTER
    owner = np.zeros(n, np.int64)
    prev = 0
    for start, stop in slices:
        assert start == prev and stop >= start  # contiguous, in rank order
        assert stop - start <= -(-n // kmeans._K5_CLUSTER)
        owner[start:stop] += 1
        prev = stop
    assert prev == n and (owner == 1).all()
    # the padded slice the kernel allocates holds every slice: 32 chunks
    # of whole 4-label words
    per_point = 4 * 4 + 6
    pitch = kmeans.cluster_smem_bytes(n, 4) // per_point
    assert pitch % (4 * kmeans._K5_CHUNKS) == 0
    assert pitch >= max(stop - start for start, stop in slices)


# ---------------------------------------------------------------------------
# The cluster decomposition, replayed on the CPU
# ---------------------------------------------------------------------------


def _replay_lloyd(x, mask, init, k, max_iter, epsilon):
    """Lloyd for each (frame, attempt) the way K5's cluster kernel orders
    it: per-slice float64 partials added in rank order, the repair's
    argmax per slice (first of its maxima) and then across slices (the
    larger value, the lower global index on ties)."""
    f, d, n = x.shape
    a = init.shape[0]
    slices = cluster_slices(n)
    eps2 = np.float32(kmeans._eps2(epsilon))
    labels = torch.empty((a, f, n), dtype=torch.int32)
    centers = torch.empty((a, f, k, d), dtype=torch.float32)
    compact = torch.empty((a, f), dtype=torch.float32)
    for fi in range(f):
        xt, m = x[fi], mask[fi]
        for ai in range(a):
            cen = init[ai, fi].clone()
            for _ in range(max_iter):
                lab, pd = kmeans._assign(xt[None], cen[None, None], m[None])
                lab, pd = lab[0, 0], pd[0, 0]
                pd = torch.where(m, pd, torch.tensor(-1.0))
                sums = torch.zeros((k, d), dtype=torch.float64)
                counts = torch.zeros(k, dtype=torch.int64)
                for start, stop in slices:  # rank order
                    ls, ms = lab[start:stop], m[start:stop]
                    onehot = (ls[None, :] == torch.arange(k)[:, None]) & ms
                    part = onehot.to(torch.float64) @ xt[:, start:stop].T.to(torch.float64)
                    sums = sums + part
                    counts = counts + onehot.sum(dim=1)
                cand = sums.to(torch.float32) / torch.clamp(counts, min=1).to(torch.float32)[:, None]
                for j in torch.nonzero(counts == 0).flatten().tolist():
                    best_v, best_i = -np.inf, None
                    for start, stop in slices:
                        if stop == start:
                            continue
                        i = start + int(torch.argmax(pd[start:stop]))
                        if pd[i].item() > best_v:  # strictly: ties keep the lower rank
                            best_v, best_i = pd[i].item(), i
                    cand[j] = xt[:, best_i]
                    pd[best_i] = -1.0
                shift2 = kmeans._shift2(cand[None], cen[None])[0]
                cen = cand
                if shift2.item() <= eps2:
                    break
            lab, pd = kmeans._assign(xt[None], cen[None, None], m[None])
            labels[ai, fi] = lab[0, 0].to(torch.int32)
            centers[ai, fi] = cen
            total = 0.0
            for start, stop in slices:
                total += pd[0, 0, start:stop].to(torch.float64).sum().item()
            compact[ai, fi] = float(np.float32(total))
    return labels, centers, compact


def _motion_like(seed, f, n, k, attempts=3):
    """Integer motion-like features (MVs in [-8, 8], block coordinates),
    40% of the points valid (frame 0 none), k-means++ seeds."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, (f, 4, n)).astype(np.float32)
    x[:, 2:] *= 16
    mask = rng.random((f, n)) < 0.4
    mask[0] = False
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    keys = prng.split(prng.fold_in(prng.key(seed), torch.arange(f)), attempts)
    init = kmeans._plus_plus_init(keys, x, mask, k).transpose(0, 1).contiguous()
    return x, mask, init


@pytest.mark.parametrize("n,k", [(37, 5), (8160, 10)])
def test_cluster_replay_equals_lloyd_plain(n, k):
    x, mask, init = _motion_like(n, 2, n, k)
    got = _replay_lloyd(x, mask, init, k, 10, 1.0)
    ref = kmeans.lloyd_plain(x, mask, init, k, 10, 1.0)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


def test_cluster_replay_repairs_across_slices():
    # fewer distinct valid points than clusters: empty clusters every
    # iteration, their repair points drawn from several slices, with ties
    # in distance between slices
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2, (2, 3, 300)).astype(np.float32) * 5)
    mask = torch.from_numpy(rng.random((2, 300)) < 0.7)
    init = x[:, :, :6].transpose(1, 2)[None].expand(2, -1, -1, -1).contiguous()
    got = _replay_lloyd(x, mask, init, 6, 10, 1.0)
    ref = kmeans.lloyd_plain(x, mask, init, 6, 10, 1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
