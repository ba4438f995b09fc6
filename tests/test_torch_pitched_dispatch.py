"""K8's specialised kernels, the refine and the fused pyramid: their
dispatch, and CPU replays of what each CUDA kernel does, held bit for bit
against the plain versions.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing
computes. The replay follows ``csrc/refine_sads_pitched.cu``'s own index
arithmetic: per CTA (16 MV blocks of one block row) the anchor and a band
of the tracked frame staged in shared memory in spatial order through the
kernel's un-pitch (one aligned word of each of the 8 subplanes, two 4x4
byte transposes by ``__byte_perm``), padding columns holding noise; each
lane's window rows read from the band as aligned 16-byte words where its
block's MV lies within +-kReach, byte by byte through the pitched layout
elsewhere; then K3's arithmetic (``csrc/refine_rows.cuh``: selects and
funnel shifts, the row shuffles, ``__vsadu4``). The fused pitched pyramid
(``csrc/pyr_down_pitched_levels.cu``) is K4's tile walk, replayed by
``test_torch_pyramid_ebma_dispatch._replay_levels``, with its level-0
loader replayed here: 16-byte chunks as one 2-byte (8 subplanes) or 4-byte
(4 subplanes) load per subplane and byte transposes, byte loads through
the pitched layout across the frame's edge or on unaligned rows.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import motion, pyramid
from test_torch_pyramid_ebma_dispatch import _replay_levels

# csrc/refine_sads_pitched.cu and csrc/refine_rows.cuh
_THREADS = 256
_B, _TBW = 16, 8
_BLOCKS = _THREADS // _B
_CTA_COLS = _BLOCKS * _B
_REACH = 15
_RUN = 4 * _TBW
_LEAD = _RUN
_BAND_ROWS = _B + 2 * (_REACH + 1)
_BAND_RUNS = (_CTA_COLS + 2 * _LEAD) // _RUN
_BAND_STRIDE = _BAND_RUNS * _RUN + 16
_ANC_RUNS = _CTA_COLS // _RUN
_ANC_STRIDE = _CTA_COLS + 16
_SMEM_LIMIT = 48 * 1024  # static shared memory a CTA may declare
_M32 = np.uint64(0xFFFFFFFF)


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the K3 / K8 / K9 wrappers' CUDA path to a meta device; record
    each launch as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(
        motion, "_check_sad_args",
        lambda name, planes, mv, lead, fh, fw, bw, bh, r: (fh // bh, fw // bw))
    monkeypatch.setattr(
        motion, "_check_pitched_args",
        lambda y8, mv, bw, bh: (y8.shape[2] // bh, y8.shape[0] * y8.shape[3] // bw))
    monkeypatch.setattr(pyramid, "_check_cuda_u8", lambda name, img: None)
    for mod in (motion, pyramid):
        monkeypatch.setattr(mod, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (motion.REFINE_SADS, motion.REFINE_SADS_GENERAL, motion.CANDIDATE_SADS,
              motion.CANDIDATE_SADS_GENERAL, motion.REFINE_SADS_PITCHED,
              motion.REFINE_SADS_PITCHED_GENERAL, pyramid.PYR_DOWN,
              pyramid.PYR_DOWN_LEVELS, pyramid.PYR_DOWN_PITCHED_LEVELS,
              pyramid.PYR_DOWN_PITCHED_GENERAL):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _meta_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "tbw,nbx,block,r,general,kernel",
    [(8, 240, 16, 1, False, "refine_sads_pitched"),   # 1080p, the path shape
     (8, 172, 16, 1, False, "refine_sads_pitched"),   # 1376 columns, nbx % 16 == 12
     (8, 44, 16, 1, False, "refine_sads_pitched"),    # CIF
     (8, 240, 16, 1, True, "refine_sads_pitched_general"),
     (8, 240, 16, 2, False, "refine_sads_pitched_general"),
     (4, 480, 16, 1, False, "refine_sads_pitched_general"),
     (8, 240, 8, 1, False, "refine_sads_pitched_general"),
     (8, 6, 16, 1, False, "refine_sads_pitched_general")],  # nbx % 4 == 2
)
def test_refine_sads_pitched_dispatch(meta_launches, tbw, nbx, block, r, general,
                                      kernel):
    t, fh = 2, 3 * block
    mfh, mfw = 3, tbw * nbx // block
    y8 = _meta_u8(tbw, t + 1, fh, nbx)
    mv = torch.zeros((t, mfh, mfw, 2), dtype=torch.int32, device="meta")
    out = motion.refine_sads_pitched(y8, mv, r, block, block, general=general)
    assert out.dtype == torch.int32
    assert tuple(out.shape) == (t, (2 * r + 1) ** 2, mfh, mfw)
    ((name, args),) = meta_launches
    assert name == kernel
    assert len(args) == len(build.kernels()[name].argtypes)
    if name == "refine_sads_pitched":
        assert args[3:6] == (t, fh, nbx)
    else:
        assert args[3:10] == (tbw, t, fh, nbx, block, block, r)


def test_hbma_stack_pitched_base_takes_the_specialised_k8(meta_launches):
    # the pitched frontend's motion path at 1080p: levels 1-3 from the
    # subplanes in one fused K8 launch; the top-level EBMA on the 2x2 K9,
    # levels 2 and 1 on the specialised K3, level 0 on the specialised K8
    # refine
    y8 = _meta_u8(8, 9, 1088, 240)
    pyr = pyramid.pyr_down_pitched_levels(y8, 3)
    assert [tuple(p.shape) for p in pyr] == [(9, 1088 >> l, 1920 >> l) for l in (1, 2, 3)]
    mv, mm = motion.hbma_stack([y8] + pyr, 8, 16, 16, base_pitched=y8)
    assert tuple(mv.shape) == (8, 68, 120, 2) and tuple(mm.shape) == (8, 68, 120)
    assert [name for name, _ in meta_launches] == [
        "pyr_down_pitched_levels", "candidate_sads", "refine_sads", "refine_sads",
        "refine_sads_pitched"]


@pytest.mark.parametrize("tbw,nbx", [(8, 240), (4, 480), (8, 67)])
@pytest.mark.parametrize("halvings", [1, 2, 3])
def test_pyr_down_pitched_levels_dispatch(meta_launches, tbw, nbx, halvings):
    # one launch for every depth, aligned subplane rows or not (the kernel
    # takes byte loads on unaligned rows)
    y8 = _meta_u8(tbw, 9, 1088, nbx)
    outs = pyramid.pyr_down_pitched_levels(y8, halvings)
    w = tbw * nbx
    assert [tuple(o.shape) for o in outs] == [
        (9, -(-1088 // 2 ** l), -(-w // 2 ** l)) for l in range(1, halvings + 1)]
    ((name, args),) = meta_launches
    assert name == "pyr_down_pitched_levels"
    assert len(args) == len(pyramid.PYR_DOWN_PITCHED_LEVELS.argtypes)
    assert args[1 + halvings:4] == (0,) * (3 - halvings)  # unused outputs
    assert args[4:9] == (tbw, 9, 1088, nbx, halvings)


@pytest.mark.parametrize("tbw,general", [(8, True), (4, True), (2, False), (16, False)])
def test_pyr_down_pitched_levels_general_chain(meta_launches, tbw, general):
    # general=True, and subplane counts the fused kernel does not take, run
    # the general K8 level and the single-level K4: the three-launch
    # yardstick
    y8 = _meta_u8(tbw, 9, 1088, 1920 // tbw)
    pyramid.pyr_down_pitched_levels(y8, 3, general=general)
    assert [name for name, _ in meta_launches] == (
        ["pyr_down_pitched_general"] + ["pyr_down_u8"] * 2)


@pytest.mark.parametrize("general,kernel", [(False, "pyr_down_pitched_levels"),
                                            (True, "pyr_down_pitched_general")])
def test_pyr_down_pitched_dispatch(meta_launches, general, kernel):
    out = pyramid.pyr_down_pitched(_meta_u8(8, 9, 1088, 240), general=general)
    assert tuple(out.shape) == (9, 544, 960)
    ((name, args),) = meta_launches
    assert name == kernel
    if name == "pyr_down_pitched_levels":
        assert args[4:9] == (8, 9, 1088, 240, 1)


def test_pyr_down_pitched_levels_rejects_bad_halvings():
    y8 = pyramid.to_pitched(torch.zeros((1, 8, 16), dtype=torch.uint8), 8)
    for halvings in (0, 4):
        with pytest.raises(ValueError, match="halvings"):
            pyramid.pyr_down_pitched_levels(y8, halvings)


# ---------------------------------------------------------------------------
# The K8 refine's staging and reads, replayed on the CPU
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel):
    """``__byte_perm(x, y, sel)`` for selectors of bytes 0-7."""
    pool = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    out = np.zeros_like(pool)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((pool >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out


def _transpose4(w0, w1, w2, w3):
    """``transpose4`` of csrc/planes.cuh."""
    a = _byte_perm(w0, w1, 0x5140)
    b = _byte_perm(w0, w1, 0x7362)
    c = _byte_perm(w2, w3, 0x5140)
    d = _byte_perm(w2, w3, 0x7362)
    return (_byte_perm(a, c, 0x5410), _byte_perm(a, c, 0x7632),
            _byte_perm(b, d, 0x5410), _byte_perm(b, d, 0x7632))


def _word(flat, a):
    """Little-endian 32-bit words of the flat byte buffer at offsets ``a``."""
    return (flat[a] | (flat[a + 1] << np.uint64(8)) | (flat[a + 2] << np.uint64(16))
            | (flat[a + 3] << np.uint64(24)))


def _to_words(b):
    b = np.asarray(b, np.uint64).reshape(b.shape[:-1] + (-1, 4))
    return (b * (np.uint64(1) << (np.uint64(8) * np.arange(4, dtype=np.uint64)))).sum(-1)


def _stage(flat, sub, f, fh, nbx, y_first, rows, lane_first, runs, stride, rng):
    """A staged region (rows x stride bytes): run k of region row r is the
    un-pitched word at subplane lane ``lane_first + 4k`` of each subplane,
    frame row ``y_first + r``; 0 outside the frame, noise in the padding."""
    region = rng.integers(0, 256, (rows, stride)).astype(np.uint8)
    ry, q = np.meshgrid(np.arange(rows), np.arange(runs), indexing="ij")
    y, lane = y_first + ry, lane_first + 4 * q
    inside = (y >= 0) & (y < fh) & (lane >= 0) & (lane < nbx)
    base = (f * fh + np.where(inside, y, 0)) * nbx + np.where(inside, lane, 0)
    assert (base % 4 == 0).all()  # aligned 4-byte loads
    w = [np.where(inside, _word(flat, base + j * sub), 0) for j in range(_TBW)]
    lo, hi = _transpose4(*w[:4]), _transpose4(*w[4:])
    words = np.stack([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], lo[3], hi[3]], -1)
    run_bytes = (words[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
    region[:, : runs * _RUN] = run_bytes.astype(np.uint8).reshape(rows, runs * _RUN)
    return region


def _align(w, s):
    """``align_window_row<16>``: 5 words from byte ``s`` of 9 words ``w``."""
    q = s >> 2
    v = [w[q + j] for j in range(6)]
    sh = np.uint64(8 * (s & 3))
    return np.array([((v[j + 1] << np.uint64(32)) | v[j]) >> sh & _M32 for j in range(5)],
                    np.uint64)


def _vsadu4(a, b):
    return sum(np.abs(((a >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.int64)
                      - ((b >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.int64))
               for k in range(4))


def _sad_rows(al, a):
    """``sad_row<16>`` over the block's 16 lanes: al (16, 5), a (16, 4)."""
    acc = np.zeros((3, al.shape[0]), np.int64)
    for ox in range(3):
        for j in range(4):
            c = al[:, j] if ox == 0 else (
                ((al[:, j + 1] << np.uint64(32)) | al[:, j]) >> np.uint64(8 * ox) & _M32)
            acc[ox] += _vsadu4(c, a[:, j])
    return acc


def _replay_k8_refine(y8, mv, rng):
    """SADs of ``(8, T+1, fh, nbx)`` subplanes as csrc/refine_sads_pitched.cu
    computes them, and where each block's window rows came from."""
    tbw, tp1, fh, nbx = y8.shape
    assert tbw == _TBW and nbx % 4 == 0 and fh % _B == 0
    fw = tbw * nbx
    t_count, mfh, mfw = tp1 - 1, fh // _B, fw // _B
    flat = y8.reshape(-1).astype(np.uint64)
    sub = tp1 * fh * nbx
    spatial = y8.transpose(1, 2, 3, 0).reshape(tp1, fh, fw)
    pad = 64
    framed = np.pad(spatial, ((0, 0), (pad, pad), (pad, pad)))  # 0 outside
    out = np.zeros((t_count, 9, mfh, mfw), np.int64)
    source = np.empty((t_count, mfh, mfw), object)
    lane = np.arange(_B)
    for t in range(t_count):
        for by in range(mfh):
            for cx in range(-(-mfw // _BLOCKS)):
                lane0 = cx * (_CTA_COLS // _TBW)
                anc = _stage(flat, sub, t + 1, fh, nbx, by * _B, _B, lane0, _ANC_RUNS,
                             _ANC_STRIDE, rng)
                band = _stage(flat, sub, t, fh, nbx, by * _B - _REACH - 1, _BAND_ROWS,
                              lane0 - _LEAD // _TBW, _BAND_RUNS, _BAND_STRIDE, rng)
                for blk in range(_BLOCKS):
                    bx = cx * _BLOCKS + blk
                    if bx >= mfw:
                        break
                    mvx, mvy = (int(v) for v in mv[t, by, bx])
                    a = _to_words(anc[:, _B * blk : _B * blk + _B])  # (16 lanes, 4)
                    x0 = bx * _B + mvx - 1
                    rows = []  # window rows 0..17, 5 words each
                    if abs(mvx) <= _REACH and abs(mvy) <= _REACH:
                        source[t, by, bx] = "band"
                        c = _LEAD + _B * blk + mvx - 1
                        cb, s = c & ~15, c & 15
                        assert 0 <= cb and cb + 36 <= _BAND_STRIDE
                        assert c + _B + 2 <= _BAND_RUNS * _RUN  # staged bytes only
                        for k in range(_B + 2):
                            row = mvy + _REACH + k
                            assert 0 <= row < _BAND_ROWS
                            al = _align(_to_words(band[row, cb : cb + 36]), s)
                            got = ((al[:, None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64)))
                                   & np.uint64(0xFF)).reshape(-1)[: _B + 2]
                            y = by * _B + mvy - 1 + k
                            want = framed[t, pad + y, pad + x0 : pad + x0 + _B + 2]
                            np.testing.assert_array_equal(got, want)
                            rows.append(al)
                    else:
                        source[t, by, bx] = "global"
                        for k in range(_B + 2):
                            y = by * _B + mvy - 1 + k
                            x = x0 + np.arange(4 * 5)
                            ok = (0 <= y < fh) & (x >= 0) & (x < fw)
                            xs = np.where(ok, x, 0)
                            idx = (xs % _TBW) * sub + (t * fh + (y if 0 <= y < fh else 0)) * nbx + xs // _TBW
                            b = np.where(ok, flat[idx], 0)
                            rows.append(_to_words(b[None])[0])
                    rows = np.array(rows)  # (18, 5)
                    # block_sads: lane i's row at oy = 0 is window row i;
                    # lanes 14, 15 hold rows 16, 17 in ext; shuffles within
                    # the 16-lane group
                    r0 = rows[:_B]
                    ext = np.zeros_like(r0)
                    ext[_B - 2 :] = rows[_B:]
                    down1 = r0[np.minimum(lane + 1, _B - 1)]
                    down1[_B - 1] = r0[_B - 1]
                    down2 = np.where((lane + 2 < _B)[:, None], r0[np.minimum(lane + 2, _B - 1)], r0)
                    up1 = np.where((lane >= 1)[:, None], ext[np.maximum(lane - 1, 0)], ext)
                    r1 = np.where((lane == _B - 1)[:, None], up1, down1)
                    r2 = np.where((lane >= _B - 2)[:, None], ext, down2)
                    for oy, r in enumerate((r0, r1, r2)):
                        out[t, 3 * oy : 3 * oy + 3, by, bx] = _sad_rows(r, a).sum(axis=1)
    return out, source


def _pitched_mvs(rng, kind, shape):
    if kind == "path":  # svc_tpu's level-0 MVs: even, within 14
        return 2 * rng.integers(-7, 8, shape)
    if kind == "wide":  # within +-40: blocks inside and outside the band
        return rng.integers(-40, 41, shape)
    if kind == "edge":  # odd MVs past every frame edge, all in the band
        return 2 * rng.integers(-7, 8, shape) + 1
    # the band's own edge and far past the frame
    return rng.choice(np.array([-200, -16, -15, 15, 16, 200]), shape)


@pytest.mark.parametrize(
    "t,fh,nbx,kind",
    [(2, 48, 64, "path"),    # two whole CTAs a block row
     (1, 32, 44, "wide"),    # CIF width: nbx % 16 == 12, a ragged CTA
     (2, 32, 24, "edge"),    # one ragged CTA (12 of 16 blocks)
     (1, 48, 36, "reach"),   # |mv| at kReach and one past it
     (1, 16, 4, "wide")],    # a 1x2 field
)
def test_k8_refine_replay_equals_plain(t, fh, nbx, kind):
    rng = np.random.default_rng(fh * nbx + t)
    y8 = rng.integers(0, 256, (_TBW, t + 1, fh, nbx)).astype(np.uint8)
    mfh, mfw = fh // _B, _TBW * nbx // _B
    mv = _pitched_mvs(rng, kind, (t, mfh, mfw, 2)).astype(np.int32)
    got, source = _replay_k8_refine(y8, mv, rng)
    ref = motion.refine_sads_pitched_plain(torch.from_numpy(y8), torch.from_numpy(mv),
                                           1, _B, _B)
    np.testing.assert_array_equal(got, ref.numpy())
    fits = (np.abs(mv) <= _REACH).all(axis=-1)
    np.testing.assert_array_equal(source == "band", fits)
    if kind in ("wide", "reach") and mfw > 2:
        assert fits.any() and not fits.all()  # both routes ran


def test_k8_refine_shared_memory_and_ctas_per_sm():
    band = _BAND_ROWS * _BAND_STRIDE
    smem = band + _B * _ANC_STRIDE + 9 * _BLOCKS * 4
    assert band == 16128 and smem == 21056
    assert smem <= _SMEM_LIMIT
    # an H100 SM: 233,472 bytes of shared memory with 1,024 reserved a CTA,
    # 2,048 threads; shared memory allows more CTAs than the threads do
    assert 233472 // (smem + 1024) >= 2048 // _THREADS
    # the band covers every window of a block whose MV lies within kReach,
    # svc_tpu's level-0 bound (bound_in 14) plus r
    assert _REACH >= 14 + 1


def test_k8_refine_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "refine_sads_pitched.cu").read_text()
    for line in ("constexpr int kB = 16;", "constexpr int kTbw = 8;",
                 "constexpr int kReach = 15;", "constexpr int kRun = 4 * kTbw;",
                 "constexpr int kLead = kRun;",
                 "constexpr int kBandRows = kB + 2 * (kReach + 1);",
                 "constexpr int kBandRuns = (kCtaCols + 2 * kLead) / kRun;",
                 "constexpr int kBandStride = kBandRuns * kRun + 16;",
                 "constexpr int kAncStride = kCtaCols + 16;"):
        assert line in src, line
    assert (motion._K8_TBW, motion._K8_BLOCK) == (_TBW, _B)
    rows = (build.CSRC_DIR / "refine_rows.cuh").read_text()
    assert "constexpr int kThreads = 256;" in rows
    assert "constexpr int kCand = 9;" in rows  # r = 1 only
    planes = (build.CSRC_DIR / "planes.cuh").read_text()
    body = planes[planes.index("void transpose4("):]
    assert re.findall(r"__byte_perm\((\w+), (\w+), (0x[0-9a-f]+)\)", body)[:8] == [
        ("w0", "w1", "0x5140"), ("w0", "w1", "0x7362"), ("w2", "w3", "0x5140"),
        ("w2", "w3", "0x7362"), ("a", "c", "0x5410"), ("a", "c", "0x7632"),
        ("b", "d", "0x5410"), ("b", "d", "0x7632")]


# ---------------------------------------------------------------------------
# The fused pitched pyramid's level-0 loader, replayed on the CPU
# ---------------------------------------------------------------------------


def _pitched_level0(y8):
    """``PitchedLevel0::chunk`` of csrc/pyr_down_pitched_levels.cu as a
    level-0 reader for ``_replay_levels``: bytes of rows ``y`` and columns
    ``x`` (inside the frame) of plane ``z``, read as whole 16-byte chunks
    from ``(tbw, n, h, nbx)`` subplanes."""
    tbw, n, h, nbx = y8.shape
    w = tbw * nbx
    flat = y8.reshape(-1).astype(np.uint64)
    sub = n * h * nbx
    share = 16 // tbw  # bytes of one subplane's share of a chunk
    vec = nbx % share == 0

    def read(z, y, x):
        bases = np.arange(x.min() // 16 * 16, x.max() + 1, 16)
        rows = ((z * h + y) * nbx)[:, None]  # subplane-0 row offsets
        out = np.zeros((len(y), 16 * len(bases)), np.uint64)
        for k, xb in enumerate(bases):
            if vec and xb >= 0 and xb + 16 <= w:
                a = rows + xb // tbw
                assert (a % share == 0).all() and sub % share == 0  # aligned loads
                if tbw == 8:
                    half = [flat[a + j * sub] | (flat[a + j * sub + 1] << np.uint64(8))
                            for j in range(8)]
                    lo, hi = _transpose4(*half[:4]), _transpose4(*half[4:])
                    words = [lo[0], hi[0], lo[1], hi[1]]
                else:
                    words = list(_transpose4(*(_word(flat, a + j * sub) for j in range(4))))
                chunk = np.concatenate(
                    [(wd >> (np.uint64(8) * np.arange(4, dtype=np.uint64))) & np.uint64(0xFF)
                     for wd in words], axis=1)
            else:  # byte loads through the pitched layout, 0 outside [0, w)
                xx = xb + np.arange(16)
                ok = (xx >= 0) & (xx < w)
                xs = np.where(ok, xx, 0)
                chunk = np.where(ok, flat[(xs % tbw) * sub + rows + xs // tbw], 0)
            out[:, 16 * k : 16 * k + 16] = chunk
        return out[:, x - bases[0]].astype(np.uint8)

    return read


@pytest.mark.parametrize(
    "shape",  # test_fused_tile_walk_equals_chained_plain's, widths to multiples of 8
    [(1, 1, 8), (1, 1, 16), (2, 9, 8), (1, 5, 8), (3, 5, 8), (1, 2, 8),
     (1, 384, 688), (1, 1087, 1920), (2, 70, 536), (1, 130, 72)],
)
@pytest.mark.parametrize("tbw", [4, 8])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_pitched_tile_walk_equals_chained_plain(shape, tbw, d):
    rng = np.random.default_rng(sum(shape) * 10 + d + tbw)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    y8 = pyramid.to_pitched(torch.from_numpy(img), tbw).numpy()
    got, writes = _replay_levels(img, d, rng, level0=_pitched_level0(y8))
    ref = [torch.from_numpy(img)]
    for _ in range(d):
        ref.append(pyramid.pyr_down_plain(ref[-1]))
    for lvl, (g, w_) in enumerate(zip(got, writes), start=1):
        assert (w_ == 1).all(), f"level {lvl}: some output written {w_.min()}-{w_.max()} times"
        np.testing.assert_array_equal(g, ref[lvl].numpy(), err_msg=f"level {lvl}")


def test_pitched_levels_host_constants_match_the_kernel_source():
    src = (build.CSRC_DIR / "pyr_down_pitched_levels.cu").read_text()
    cases = set(map(int, re.findall(r"case (\d+): return launch_pitched<", src)))
    assert cases == set(pyramid._K8_PYR_TBW)
    assert "constexpr int kAlign = 16 / Tbw;" in src
    assert '#include "pyr_down_levels.cuh"' in src
    # K4 and the K8 pyramid run one kernel after level 0
    dense = (build.CSRC_DIR / "pyr_down_levels.cu").read_text()
    assert '#include "pyr_down_levels.cuh"' in dense and "__global__" not in dense
