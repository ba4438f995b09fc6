"""K4's fused pyramid kernel and K9's 2x2 kernel: their dispatch, and CPU
replays of what each CUDA kernel does, held bit for bit against the plain
versions.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing
computes. The replays follow the kernels' own index arithmetic:

* ``csrc/pyr_down_levels.cu``: a CTA per tile of the coarsest level, each
  finer level's region (with its halo) recomputed per CTA, positions
  outside a level read at their reflect-101 image clamped into the region,
  the level-0 chunk base and its halo filled from the region itself,
  level-0 positions past the halo and padded columns read from whatever
  the shared row holds (noise here), and each CTA writing its own part of
  every level;
* ``csrc/candidate_sads.cu``: per MV block, each window row as two aligned
  32-bit words joined by a funnel shift, a byte mask at the row's edges,
  and ``__vsadu4`` sums.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import motion, pyramid


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the K4 / K9 wrappers' CUDA path to a meta device; record each
    launch as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(
        motion, "_check_sad_args",
        lambda name, planes, mv, lead, fh, fw, bw, bh, r: (fh // bh, fw // bw))
    monkeypatch.setattr(pyramid, "_check_cuda_u8", lambda name, img: None)
    for mod in (motion, pyramid):
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (motion.CANDIDATE_SADS, motion.CANDIDATE_SADS_GENERAL,
              motion.REFINE_SADS, pyramid.PYR_DOWN, pyramid.PYR_DOWN_LEVELS):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _meta_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bw,bh,r,general,kernel",
    [(2, 2, 1, False, "candidate_sads"), (4, 4, 1, False, "candidate_sads_general"),
     (2, 2, 2, False, "candidate_sads_general"),
     (2, 4, 1, False, "candidate_sads_general"),
     (2, 2, 1, True, "candidate_sads_general")],
)
def test_candidate_sads_dispatch(meta_launches, bw, bh, r, general, kernel):
    t, fh, fw = 3, 4 * bh, 6 * bw
    tr, an = _meta_u8(t, fh, fw), _meta_u8(t, fh, fw)
    mv = torch.zeros((t, 4, 6, 2), dtype=torch.int32, device="meta")
    out = motion.candidate_sads(tr, an, mv, r, bw, bh, general=general)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (t, (2 * r + 1) ** 2, 4, 6)
    ((name, args),) = meta_launches
    assert name == kernel
    k = motion.CANDIDATE_SADS if kernel == "candidate_sads" else motion.CANDIDATE_SADS_GENERAL
    assert len(args) == len(k.argtypes)
    if kernel == "candidate_sads":
        assert args[4:7] == (t, fh, fw)
    else:
        assert args[4:10] == (t, fh, fw, bw, bh, r)


@pytest.mark.parametrize("levels,launches", [(1, []), (2, [1]), (3, [2]), (4, [3]),
                                             (5, [3, 1]), (7, [3, 3])])
def test_build_pyramid_dispatch(meta_launches, levels, launches):
    img = _meta_u8(9, 1088, 1920)
    pyr = pyramid.build_pyramid(img, levels)
    assert [tuple(p.shape) for p in pyr] == [
        (9, -(-1088 // 2 ** l), -(-1920 // 2 ** l)) for l in range(levels)]
    assert [name for name, _ in meta_launches] == ["pyr_down_levels"] * len(launches)
    for (_, args), halvings, src in zip(meta_launches, launches, (0, 3)):
        assert len(args) == len(pyramid.PYR_DOWN_LEVELS.argtypes)
        assert args[4:8] == (9, *pyr[src].shape[1:], halvings)
        assert args[1 + halvings:4] == (0,) * (3 - halvings)  # unused outputs


def test_build_pyramid_general_takes_the_single_level_kernel(meta_launches):
    pyramid.build_pyramid(_meta_u8(9, 1088, 1920), 4, general=True)
    assert [name for name, _ in meta_launches] == ["pyr_down_u8"] * 3


def test_hbma_stack_default_levels_take_the_new_kernels(meta_launches):
    # the encoder's motion path: the fused pyramid, then the top-level
    # EBMA on the 2x2 K9 and levels 2, 1, 0 on the specialised K3
    pyr = pyramid.build_pyramid(_meta_u8(9, 1088, 1920), 4)
    motion.hbma_stack(pyr, 8, 16, 16)
    assert [name for name, _ in meta_launches] == (
        ["pyr_down_levels", "candidate_sads"] + ["refine_sads"] * 3)


def test_pyr_down_levels_rejects_bad_halvings():
    with pytest.raises(ValueError, match="halvings"):
        pyramid.pyr_down_levels(torch.zeros((1, 8, 8), dtype=torch.uint8), 4)


# ---------------------------------------------------------------------------
# K4: the fused tile walk, replayed on the CPU
# ---------------------------------------------------------------------------

_TAPS = np.array([1, 4, 6, 4, 1], np.int64)
_ROW0 = 160  # level-0 shared row (kLvRow0)
_SMEM_LIMIT = 48 * 1024  # static shared memory a CTA may declare


def _pad4(x):
    return (x + 3) & ~3


class _Geo:
    """``Geo<D>`` of csrc/pyr_down_levels.cu."""

    def __init__(self, d):
        self.d = d
        self.th, self.tw = 64 >> d, 128 >> d
        self.off0 = 18 - (2 << d)

    def r(self, l):
        return self.th if l == self.d else 2 * self.r(l + 1) + 3

    def c(self, l):
        return self.tw if l == self.d else 2 * self.c(l + 1) + 3

    def s(self, l):
        if l == 0:
            return _ROW0
        return max(_pad4(self.c(l)), 8 * (_pad4(self.c(l + 1)) // 4) + 8)

    def smem_bytes(self):
        a = max([self.r(0) * _ROW0] + [self.r(l) * self.s(l) for l in range(1, self.d)])
        b = max(self.r(l - 1) * _pad4(self.c(l)) for l in range(1, self.d + 1))
        return a + 2 * b


def _reflect101(i, n):
    """``reflect101`` of csrc/pyr_down.cuh, elementwise."""
    i = np.asarray(i, np.int64)
    if n == 1:
        return np.zeros_like(i)
    i = np.clip(i, -2, n + 1)
    while ((i < 0) | (i >= n)).any():
        i = np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))
    return i


def _region_image(q, n, q0, length):
    return np.clip(_reflect101(q, n), q0, q0 + length - 1)


def _replay_levels(img, d, rng, level0=None):
    """Levels 1..d of ``(N, H, W)`` uint8 as the fused kernel computes
    them, and how often each output byte was written. ``level0(z, y, x)``
    reads the bytes of rows ``y`` and columns ``x`` (inside the frame) of
    plane ``z`` as the kernel's level-0 loader does; by default K4's dense
    loader, which reads ``img`` itself."""
    if level0 is None:
        def level0(z, y, x):
            return img[z][y][:, x]
    g = _Geo(d)
    n, h, w = img.shape
    hs, ws = [h], [w]
    for _ in range(d):
        hs.append((hs[-1] + 1) // 2)
        ws.append((ws[-1] + 1) // 2)
    outs = [np.zeros((n, hs[l], ws[l]), np.uint8) for l in range(1, d + 1)]
    writes = [np.zeros((n, hs[l], ws[l]), np.int64) for l in range(1, d + 1)]
    for z in range(n):
        for by in range(-(-hs[d] // g.th)):
            for bx in range(-(-ws[d] // g.tw)):
                p0, q0 = [0] * (d + 1), [0] * (d + 1)
                p0[d], q0[d] = by * g.th, bx * g.tw
                for l in range(d - 1, -1, -1):
                    p0[l], q0[l] = 2 * p0[l + 1] - 2, 2 * q0[l + 1] - 2
                cb = q0[0] - g.off0
                assert cb % 16 == 0
                # the frame's own pixels, then the halo from shared memory:
                # columns -2, -1, w, w + 1 of the rows inside the frame, then
                # rows -2, -1, h, h + 1 as copies of their (clamped) images;
                # positions further out hold what no output reads (noise)
                y = p0[0] + np.arange(g.r(0))
                x = cb + np.arange(_ROW0)
                a = rng.integers(0, 256, (g.r(0), _ROW0))
                yin, xin = (y >= 0) & (y < h), (x >= 0) & (x < w)
                if yin.any() and xin.any():
                    a[np.ix_(yin, xin)] = level0(z, y[yin], x[xin])
                for col in (-2, -1, w, w + 1):
                    c = col - cb
                    if 0 <= c < _ROW0:
                        sc = int(np.clip(_reflect101(col, w) - cb, 0, _ROW0 - 1))
                        a[yin, c] = a[yin, sc]
                for r in np.nonzero(~yin & (y >= -2) & (y <= h + 1))[0]:
                    sr = int(np.clip(_reflect101(y[r], h) - p0[0], 0, g.r(0) - 1))
                    a[r] = a[sr]
                off = g.off0
                for l in range(1, d + 1):
                    hl, wl, cout = hs[l], ws[l], _pad4(g.c(l))
                    # horizontal pass: groups of four columns inside the
                    # level read straight, the others through the image
                    c = np.arange(cout)
                    grp = 4 * (c // 4) + q0[l]
                    inside = (grp >= 0) & (grp + 3 < wl)
                    src = np.where(inside, c,
                                   _region_image(q0[l] + c, wl, q0[l], g.c(l)) - q0[l])
                    idx = off + 2 * src[:, None] + np.arange(5)
                    assert idx.max() < a.shape[1]
                    hsum = (a[:, idx] * _TAPS).sum(-1)
                    assert hsum.max() < 2 ** 16
                    # vertical pass
                    p = p0[l] + np.arange(g.r(l))
                    rp = np.where((p >= 0) & (p < hl), p,
                                  _region_image(p, hl, p0[l], g.r(l)))
                    ridx = 2 * (rp - p0[l])[:, None] + np.arange(5)
                    assert ridx.max() < hsum.shape[0]
                    val = ((hsum[ridx] * _TAPS[None, :, None]).sum(1) + 128) >> 8
                    if l < d:
                        ko = (2 << (d - l)) - 2
                        own_h, own_w = g.th << (d - l), g.tw << (d - l)
                        keep = (slice(ko, ko + own_h), slice(ko, ko + own_w))
                        ys, xs = p0[l] + ko, q0[l] + ko
                    else:
                        keep = (slice(0, g.r(l)), slice(0, g.tw))
                        ys, xs = p0[l], q0[l]
                    blk = val[keep]
                    y1, x1 = min(ys + blk.shape[0], hl), min(xs + blk.shape[1], wl)
                    outs[l - 1][z, ys:y1, xs:x1] = blk[:y1 - ys, :x1 - xs]
                    writes[l - 1][z, ys:y1, xs:x1] += 1
                    if l < d:
                        # the next level reads this region from a shared row
                        # of stride S(l) whose padding holds whatever was there
                        nxt = rng.integers(0, 256, (g.r(l), g.s(l)))
                        nxt[:, :cout] = val
                        a, off = nxt, 0
    return outs, writes


@pytest.mark.parametrize(
    "shape",
    [(1, 1, 1), (1, 1, 9), (2, 9, 1), (1, 5, 7), (3, 5, 7), (1, 2, 3),
     (1, 384, 683), (1, 1087, 1919), (2, 70, 530), (1, 130, 66)],
)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_fused_tile_walk_equals_chained_plain(shape, d):
    rng = np.random.default_rng(sum(shape) * 10 + d)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got, writes = _replay_levels(img, d, rng)
    ref = [torch.from_numpy(img)]
    for _ in range(d):
        ref.append(pyramid.pyr_down_plain(ref[-1]))
    for lvl, (g, w_) in enumerate(zip(got, writes), start=1):
        assert (w_ == 1).all(), f"level {lvl}: some output written {w_.min()}-{w_.max()} times"
        np.testing.assert_array_equal(g, ref[lvl].numpy(), err_msg=f"level {lvl}")


def test_fused_kernel_host_constants_match_the_source():
    # the kernel lives in pyr_down_levels.cuh, shared with the K8 pyramid
    assert '#include "pyr_down_levels.cuh"' in (
        build.CSRC_DIR / "pyr_down_levels.cu").read_text()
    src = (build.CSRC_DIR / "pyr_down_levels.cuh").read_text()
    assert "constexpr int kLvRow0 = 160;" in src
    assert "static constexpr int kTH = 64 >> D;" in src
    assert "static constexpr int kTW = 128 >> D;" in src
    assert "static constexpr int kOff0 = 18 - (2 << D);" in src
    cases = set(map(int, re.findall(r"case (\d+): return launch_levels<", src)))
    assert cases | {3} == set(range(1, pyramid._MAX_HALVINGS + 1))
    # both shared buffers fit the static 48 KB at every depth
    assert _Geo(3).smem_bytes() == 26520
    for d in (1, 2, 3):
        assert _Geo(d).smem_bytes() <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# K9: the 2x2 kernel's word arithmetic, replayed on the CPU
# ---------------------------------------------------------------------------


def _vsadu4(a, b):
    return sum(np.abs(((a >> (8 * k)) & 0xFF).astype(np.int64)
                      - ((b >> (8 * k)) & 0xFF).astype(np.int64)) for k in range(4))


def _word(frame, a):
    """Little-endian 32-bit words of the flat frame at byte offsets ``a``
    (multiples of 4, inside the frame)."""
    f = frame.astype(np.uint64)
    return f[a] | (f[a + 1] << 8) | (f[a + 2] << 16) | (f[a + 3] << 24)


def _window_row(frame, y, x0, fh, fw):
    """``window_row`` of csrc/candidate_sads.cu, vectorised over blocks."""
    live = (y >= 0) & (y < fh) & (x0 > -4) & (x0 < fw)
    y_, x_ = np.where(live, y, 0), np.where(live, x0, 0)
    row0 = y_ * fw
    row1 = row0 + fw
    o = row0 + x_
    a = o & ~3
    s = o - a
    lo_ok = live & (a + 4 > row0)
    hi_ok = live & (s != 0) & (a + 4 < row1)
    assert ((a >= 0) | ~lo_ok).all() and ((a + 8 <= frame.size) | ~hi_ok).all()
    lo = np.where(lo_ok, _word(frame, np.where(lo_ok, a, 0)), 0)
    hi = np.where(hi_ok, _word(frame, np.where(hi_ok, a + 4, 0)), 0)
    v = ((hi << 32) | lo) >> (8 * s).astype(np.uint64) & 0xFFFFFFFF
    first = np.maximum(0, -x_)
    last = np.minimum(4, fw - x_)
    below = np.where(last >= 4, 0xFFFFFFFF, (1 << (8 * np.clip(last, 0, 3))) - 1)
    mask = below & ((0xFFFFFFFF << (8 * np.clip(first, 0, 3))) & 0xFFFFFFFF)
    return np.where(live, v & mask.astype(np.uint64), 0)


def _replay_k9(tracked, anchor, mv):
    t, fh, fw = tracked.shape
    mfh, mfw = fh // 2, fw // 2
    out = np.zeros((t, 9, mfh, mfw), np.float32)
    by, bx = np.meshgrid(np.arange(mfh), np.arange(mfw), indexing="ij")
    for ti in range(t):
        trk = tracked[ti].reshape(-1)
        anc = anchor[ti].astype(np.uint64)
        a0 = anc[2 * by, 2 * bx] | (anc[2 * by, 2 * bx + 1] << 8)
        a1 = anc[2 * by + 1, 2 * bx] | (anc[2 * by + 1, 2 * bx + 1] << 8)
        x0 = 2 * bx + mv[ti, ..., 0].astype(np.int64) - 1
        y0 = 2 * by + mv[ti, ..., 1].astype(np.int64) - 1
        acc = np.zeros((9, mfh, mfw), np.int64)
        for wr in range(4):
            w = _window_row(trk, y0 + wr, x0, fh, fw)
            for ox in range(3):
                c = (w >> np.uint64(8 * ox)) & np.uint64(0xFFFF)
                if wr <= 2:
                    acc[wr * 3 + ox] += _vsadu4(c, a0)
                if wr >= 1:
                    acc[(wr - 1) * 3 + ox] += _vsadu4(c, a1)
        out[ti] = acc
    return out


@pytest.mark.parametrize(
    "t,fh,fw,mv_kind",
    [(2, 16, 24, "zero"), (2, 16, 24, "random"),  # fw % 4 == 0
     (3, 14, 10, "random"), (1, 6, 14, "edge"),   # fw % 4 == 2
     (2, 12, 18, "edge"), (1, 2, 2, "edge"), (2, 20, 22, "far"),
     (1, 34, 60, "random")],
)
def test_k9_word_replay_equals_plain(t, fh, fw, mv_kind):
    rng = np.random.default_rng(fh * fw + t)
    tracked = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    anchor = rng.integers(0, 256, (t, fh, fw)).astype(np.uint8)
    shape = (t, fh // 2, fw // 2, 2)
    if mv_kind == "zero":
        mv = np.zeros(shape, np.int32)
    elif mv_kind == "random":
        mv = rng.integers(-14, 15, shape).astype(np.int32)
    elif mv_kind == "edge":  # odd MVs that reach past every frame edge
        mv = (2 * rng.integers(-3, 4, shape) + 1).astype(np.int32)
    else:  # windows wholly outside the frame, and just inside
        mv = rng.choice(np.array([-40, -5, -4, -3, 3, 4, 5, 40], np.int32), shape)
    got = _replay_k9(tracked, anchor, mv)
    ref = motion.candidate_sads_plain(torch.from_numpy(tracked),
                                      torch.from_numpy(anchor),
                                      torch.from_numpy(mv), 1, 2, 2)
    np.testing.assert_array_equal(got, ref.numpy())


def test_k9_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "candidate_sads.cu").read_text()
    assert "constexpr int kCand = 9;" in src  # r = 1 only
    assert "fh % 2 || fw % 2" in src  # 2x2 blocks
