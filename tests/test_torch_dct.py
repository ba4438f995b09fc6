"""Port vs svc_tpu: forward DCT into wire layout (K2), dequantization, and
the decoder's display path on every route — width-aligned (K1) and general
(K6, width excess) — through the kernels' plain versions, plus the host
tables that cut the display kernels' tiles."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu import config as j_config
from svc_tpu.io import bitstream as j_bitstream
from svc_tpu.ops import dct as j_dct
from svc_tpu.ops import dct_pallas as j_dctp
from svc_tpu.ops import interleave as j_inter
from svc_tpu.ops import quant as j_quant
from svc_tpu.ops import resize as j_resize
from svc_tpu.ops.pad import pad_frame as j_pad_frame
from svc_tpu_torch import config
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.ops import dct, quant, resize

COEFF_GATE = 2.5e-4  # max |err| of wire coefficients (BASELINE.md DCT gate)


def _packed(t1, h, w, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (t1, h, w, 3), dtype=np.uint8)
    frames[:, : h // 3] = 255  # saturated blocks: largest DC coefficients
    return frames.reshape(t1, h, w * 3)


def test_dct_matrix_equal():
    np.testing.assert_array_equal(dct.dct_matrix(8), j_dct.dct_matrix(8))
    np.testing.assert_array_equal(dct.dct_matrix(4), j_dct.dct_matrix(4))


@pytest.mark.parametrize("w,h", [(128, 120), (128, 128)])
def test_forward_dct_matches_jsplit_kernel(w, h):
    ph = -(-h // 16) * 16
    packed = _packed(3, h, w, seed=w + h)
    p = j_inter.deinterleave_rows_jsplit(jnp.asarray(packed), 3, 8)
    p = jnp.pad(p, ((0, 0), (0, 0), (0, 0), (0, ph - h), (0, 0)))
    want = np.asarray(
        j_dctp.dct2_jsplit_to_wire_pallas(p, 8, 8, frame_offset=1, padded_h=ph)
    )
    got = dct.dct8x8_to_wire(torch.from_numpy(packed), 1, 2, ph, w).numpy()
    assert got.shape == want.shape == (2, ph // 8, w // 8, 192)
    assert np.abs(got - want).max() <= COEFF_GATE


# svc_tpu's planes kernel sums a bf16 three-term split of the weights in
# float32, and its error grows with the largest coefficient (255 * B, a
# saturated block's DC): at 16x16, twice 8x8's, the gate scales by 16 / 8
PALLAS_16_GATE = COEFF_GATE * 16 / 8

# the rectangular transform blocks (rows x columns) the config accepts
# beside the squares: each side divides the 16x16 MV block
RECT_BLOCKS = ["4x8", "8x4", "4x16", "16x4", "8x16", "16x8"]
# and those with a side of 2 (K2's and K1's templated kernels take them)
THIN_RECT_BLOCKS = ["2x4", "4x2", "2x8", "8x2", "2x16", "16x2"]
# and those with a side of 1 (K2's and K1's templated kernels since they
# took 1x1 too)
SIDE_1_RECT_BLOCKS = ["1x2", "2x1", "1x4", "4x1", "1x8", "8x1", "1x16", "16x1"]


def _hw(block):
    """``(block_h, block_w)`` of a test's block: ``B`` for a square, or
    ``"BHxBW"``."""
    if isinstance(block, int):
        return block, block
    return tuple(int(v) for v in block.split("x"))


@pytest.mark.parametrize("block,ref,gate", [
    pytest.param(8, "pallas", COEFF_GATE, id="8"),
    pytest.param(4, "pallas", COEFF_GATE, id="4"),
    pytest.param(16, "einsum", COEFF_GATE, id="16"),
    pytest.param(16, "pallas", PALLAS_16_GATE, id="16-pallas"),
] + [pytest.param(b, "pallas", COEFF_GATE, id=b)
      for b in RECT_BLOCKS + ["2x2"] + THIN_RECT_BLOCKS + ["1x1"]
      + SIDE_1_RECT_BLOCKS] + [
    pytest.param(b, "einsum", COEFF_GATE, id=f"{b}-einsum")
    for b in RECT_BLOCKS + THIN_RECT_BLOCKS if "16" in b
])
def test_forward_dct_matches_planes_kernel(block, ref, gate):
    # width 192 is not lane-aligned: svc_tpu's encoder takes the planes
    # kernel, whose shape gate (pallas_wire_dct_supported) accepts every
    # block here; 4x4 and 16x16 are the square transform blocks users pick
    # beside 8x8, the rectangles the blocks whose sides they set apart.
    # At 16x16 that kernel sits 3.71e-4 from the port on this input
    # (ROADMAP Queue 3), past the gate set at 8x8, while the port is the
    # exact transform rounded once: there the port is held to the kernel
    # at the scaled gate, and to svc_tpu's float32 einsum of the same
    # function (ops/dct.py dct2_planes_to_wire) at the gate. The
    # rectangles sit within the gate of both on this input (at most
    # 2.44e-4, one ulp at 2048-4096, at 8x4, 8x16, 16x8 and 2x16), those
    # with a side of 16 held to both; 2x2 and the blocks with a side of 2
    # (2.44e-4 at 2x16, 1.22e-4 at 8x2 and 16x2, 6.1e-5 at the others),
    # 1x1 and the blocks with a side of 1 at the gate of the kernel
    bh, bw = _hw(block)
    w, h = 192, 136
    ph, pw = 144, 192
    packed = _packed(3, h, w, seed=11)
    planes = jnp.stack([jnp.asarray(packed)[:, :, c::3] for c in range(3)])
    planes = j_pad_frame(planes, pw, ph)
    # svc_tpu takes (block_w, block_h)
    assert j_dctp.pallas_wire_dct_supported(3, ph, pw, bw, bh)
    if ref == "einsum":
        want = np.asarray(j_dct.dct2_planes_to_wire(planes[:, 1:], bw, bh))
    else:
        want = np.asarray(j_dctp.dct2_planes_to_wire_pallas(
            planes, bw, bh, frame_offset=1))
    got = dct.dct8x8_to_wire(torch.from_numpy(packed), 1, 2, ph, pw, bh,
                             bw).numpy()
    assert got.shape == want.shape == (2, ph // bh, pw // bw, 3 * bh * bw)
    assert np.abs(got - want).max() <= gate


def test_forward_dct_zero_pads_width():
    # columns past frame_w read as zero, like svc_tpu's pad_frame
    packed = _packed(2, 16, 20, seed=12)
    planes = j_pad_frame(
        jnp.stack([jnp.asarray(packed)[:, :, c::3] for c in range(3)]), 32, 16
    )
    want = np.asarray(j_dct.dct2_planes_to_wire(planes[:, 1:], 8, 8))
    got = dct.dct8x8_to_wire(torch.from_numpy(packed), 1, 1, 16, 32).numpy()
    assert np.abs(got - want).max() <= COEFF_GATE


def test_dequantize_matches_svc_tpu():
    rng = np.random.default_rng(13)
    steps = rng.choice([1.0, 3.0, 640.0], size=(4, 5, 1)).astype(np.float32)
    c = (rng.normal(size=(4, 5, 64)) * 900).astype(np.float32)
    c[0, 0, :8] = np.float32([0.5, -0.5, 1.5, -2.5, 320.0, -960.0, 0.0, -0.0])
    want = np.asarray(j_quant.quantize(jnp.asarray(c), jnp.asarray(steps)))
    got = quant.dequantize(torch.from_numpy(c), torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_quant_steps_match():
    rng = np.random.default_rng(14)
    types = rng.integers(0, 4, (6, 7)).astype(np.uint32)
    gazed = rng.random((6, 7)) < 0.3
    want = np.asarray(
        j_quant.block_quant_steps(jnp.asarray(types), jnp.asarray(gazed), 2, 640)
    )
    got = quant.block_quant_steps(
        torch.from_numpy(types.astype(np.int64)), torch.from_numpy(gazed), 2, 640
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_n,in_n", [(1080, 1088), (120, 128), (64, 64), (7, 16)])
def test_bilinear_axis_weights_copy_matches(out_n, in_n):
    a = resize.bilinear_axis_weights(out_n, in_n)
    b = j_resize.bilinear_axis_weights(out_n, in_n)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def _decode_inputs(w, h, ew, eh, seed, block=8):
    bh, bw = _hw(block)
    hdr = bitstream.Header(2, w, h, ew, eh, bw, bh, 3)
    nby, nbx = hdr.padded_frame_h // bh, hdr.padded_frame_w // bw
    rng = np.random.default_rng(seed)
    coeffs = (rng.normal(size=(2, nby, nbx, 3 * bh * bw)) * 90).astype(
        np.float32)
    btypes = rng.integers(0, 3, (2, nby, nbx)).astype(np.uint32)
    rects = np.tile(np.array([[w // 4, h // 4, 64, 32]], np.int32), (2, 1))
    return hdr, coeffs, btypes, rects


# (w, h, excess w, excess h): row resample (the 1080p class), zero excess
# (identity rows), multi-band resample, width excess (general route), both
# excesses (general route, both axes blended), the 854x480 class (width
# excess 10, identity rows) at a small height
DECODE_GEOMETRIES = [
    (128, 120, 0, 8),
    (128, 128, 0, 0),
    (256, 248, 0, 8),
    (120, 64, 8, 0),
    (200, 120, 8, 8),
    (854, 48, 10, 0),
]


# 2x2, 4x4 and 16x16 transform blocks and the rectangles (those with a
# side of 2 too) at the width-aligned geometries (a 16x16 block divides
# them): row resample, identity rows, multi-band resample; 4x4, 16x16 and
# the rectangles of sides 4, 8 and 16 and those with a side of 2 also at
# the width-excess ones (K6's templated kernels and the general K6); the
# rectangles with a side of 1 at one width-aligned and one width-excess
# geometry each, those with a side of 2 at one width-excess geometry each,
# taken in turn so that every geometry meets several shapes (each case
# compiles svc_tpu's decoder anew: about 2 s; 1x1 is held off its exact
# ties below)
DECODE_CASES = [pytest.param(*g, 8, id="-".join(map(str, g)))
                for g in DECODE_GEOMETRIES] + [
    pytest.param(*g, b, id="-".join(map(str, g)) + f"-b{b}")
    for b in (2, 4, 16, *RECT_BLOCKS, *THIN_RECT_BLOCKS)
    for g in DECODE_GEOMETRIES[:3]] + [
    pytest.param(*g, b, id="-".join(map(str, g)) + f"-b{b}")
    for b in (4, 16, *RECT_BLOCKS) for g in DECODE_GEOMETRIES[3:]] + [
    pytest.param(*g, b, id="-".join(map(str, g)) + f"-b{b}")
    for i, b in enumerate(THIN_RECT_BLOCKS)
    for g in (DECODE_GEOMETRIES[3 + i % 3],)] + [
    pytest.param(*g, b, id="-".join(map(str, g)) + f"-b{b}")
    for i, b in enumerate(SIDE_1_RECT_BLOCKS)
    for g in (DECODE_GEOMETRIES[i % 3], DECODE_GEOMETRIES[3 + i % 3])]


@pytest.mark.parametrize("w,h,ew,eh,block", DECODE_CASES)
def test_display_bytes_match_svc_tpu_decoder(w, h, ew, eh, block):
    from svc_tpu.models.decoder import Decoder as JDecoder
    from svc_tpu_torch.models.decoder import Decoder

    hdr, coeffs, btypes, rects = _decode_inputs(w, h, ew, eh, seed=w * h,
                                                block=block)
    j_cfg = j_config.DecoderConfig()
    j_hdr = j_bitstream.Header(*dataclasses.astuple(hdr))
    want = JDecoder.packed_bytes(
        JDecoder(j_cfg, j_hdr, batch_size=2)._decode_batch(coeffs, btypes, rects)
    )
    cfg = config.from_dict(config.DecoderConfig, dataclasses.asdict(j_cfg))
    got = Decoder(cfg, hdr, batch_size=2, device="cpu").decode_batch(
        coeffs, btypes, rects
    )
    assert got.dtype == torch.uint8
    got = got.numpy()
    assert got.shape == want.shape == (2, h, w * 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("block", [2, 4, 16])
def test_plain_display_differs_from_the_exact_decode_only_on_ties(block):
    # the display bytes are the float64 decode rounded, but where it sits on
    # a half: ~17% of the bytes at 2x2 (integer dequantized coefficients
    # over two), a few in ten thousand at 4x4 and 16x16, which the decode
    # gates' 1e-3 share of bytes allows
    from svc_tpu_torch.tools import display_ties

    w, h = 96, 64
    header, payloads, gazes = display_ties.wire_payloads(w, h, block, 3, seed=block)
    coeffs, steps = display_ties.decode_inputs(header, payloads, gazes)
    exact = display_ties.exact_display(coeffs, steps, h, 3, block, block)
    ties = display_ties.tie_mask(exact)
    got = dct.idct_display(coeffs, steps, h, 3, block, block).numpy()
    d = np.abs(got.astype(np.int16) - display_ties.rounded(exact))
    assert d.max() <= 1 and not d[~ties].any()
    if block == 2:
        assert ties.mean() > 0.1
    else:
        assert ties.mean() < 1e-3


@pytest.mark.parametrize("w,h,ew,eh", DECODE_GEOMETRIES[3:])
def test_width_excess_2x2_differs_from_svc_tpu_only_on_ties(w, h, ew, eh):
    # 2x2 blocks on the width-excess route: the port's decoder and
    # svc_tpu's differ by 1 on some bytes (1.15e-3 of them at 120x64, over
    # the decode gate's 1e-3), every one a byte whose exact value (the
    # float64 decode through both resamples) sits on a half, and neither
    # differs from the exact value rounded anywhere else
    from svc_tpu.models.decoder import Decoder as JDecoder
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.tools import display_ties

    hdr, coeffs, btypes, rects = _decode_inputs(w, h, ew, eh, seed=w * h,
                                                block=2)
    j_cfg = j_config.DecoderConfig()
    j_hdr = j_bitstream.Header(*dataclasses.astuple(hdr))
    want = JDecoder.packed_bytes(
        JDecoder(j_cfg, j_hdr, batch_size=2)._decode_batch(coeffs, btypes, rects)
    )
    cfg = config.from_dict(config.DecoderConfig, dataclasses.asdict(j_cfg))
    dec = Decoder(cfg, hdr, batch_size=2, device="cpu")
    got = dec.decode_batch(coeffs, btypes, rects).numpy()
    steps = dec._steps(torch.from_numpy(btypes.astype(np.int64)),
                       torch.from_numpy(rects))
    exact = display_ties.exact_display(torch.from_numpy(coeffs), steps, h, 3,
                                       2, 2, out_w=w)
    ties = display_ties.tie_mask(exact).reshape(got.shape)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).any()
    assert not d[~ties].any()
    for out in (got, want):
        off = np.abs(out.astype(np.int16) - display_ties.rounded(exact).reshape(
            got.shape))
        assert off.max() <= 1 and not off[~ties].any()


@pytest.mark.parametrize("w,h,ew,eh", [DECODE_GEOMETRIES[0],
                                       DECODE_GEOMETRIES[3]])
def test_1x1_differs_from_svc_tpu_only_on_ties(w, h, ew, eh):
    # 1x1 blocks: the inverse DCT leaves the dequantized integers as they
    # are, so a row or column blend lands on halves. The port's decoder
    # and svc_tpu's differ by 1 on some bytes (1.03e-3 of them at 128x120,
    # 1.74e-3 at 120x64, over the decode gate's 1e-3), every one a byte
    # whose exact value (the float64 decode through the resamples) sits on
    # a half, and neither differs from the exact value rounded anywhere
    # else (the rows resampled at 128x120, K1's route; the columns at
    # 120x64, K6's)
    from svc_tpu.models.decoder import Decoder as JDecoder
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.tools import display_ties

    hdr, coeffs, btypes, rects = _decode_inputs(w, h, ew, eh, seed=w * h,
                                                block=1)
    j_cfg = j_config.DecoderConfig()
    j_hdr = j_bitstream.Header(*dataclasses.astuple(hdr))
    want = JDecoder.packed_bytes(
        JDecoder(j_cfg, j_hdr, batch_size=2)._decode_batch(coeffs, btypes, rects)
    )
    cfg = config.from_dict(config.DecoderConfig, dataclasses.asdict(j_cfg))
    dec = Decoder(cfg, hdr, batch_size=2, device="cpu")
    got = dec.decode_batch(coeffs, btypes, rects).numpy()
    steps = dec._steps(torch.from_numpy(btypes.astype(np.int64)),
                       torch.from_numpy(rects))
    exact = display_ties.exact_display(
        torch.from_numpy(coeffs), steps, h, 3, 1, 1,
        out_w=w if ew else None)
    ties = display_ties.tie_mask(exact).reshape(got.shape)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() > 1e-3
    assert not d[~ties].any()
    for out in (got, want):
        off = np.abs(out.astype(np.int16) - display_ties.rounded(exact).reshape(
            got.shape))
        assert off.max() <= 1 and not off[~ties].any()


def test_general_route_dispatches_to_k6(monkeypatch):
    # on a non-CPU device the general route launches K6, the kernel
    # specialised for 8x8 blocks of 3 channels (a meta device stands in
    # for the card: shapes and dtypes flow, nothing computes)
    from svc_tpu_torch.models import decoder as dec_mod

    launched = []
    monkeypatch.setattr(dec_mod, "resolve_device", lambda d: torch.device("meta"))
    monkeypatch.setattr(dct, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(dct, "stream_handle", lambda t: 0)
    monkeypatch.setattr(dct, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(dct.IDCT_RESIZE, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(dct.IDCT_RESIZE_GENERAL, "launch",
                        lambda *a: pytest.fail("general K6"))
    monkeypatch.setattr(dct.IDCT_DISPLAY, "launch", lambda *a: pytest.fail("K1"))
    hdr, coeffs, btypes, rects = _decode_inputs(200, 120, 8, 8, seed=3)
    out = dec_mod.Decoder(config.DecoderConfig(), hdr, device="cuda").decode_batch(
        coeffs, btypes, rects
    )
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 120, 600)
    (args,) = launched
    assert len(args) == len(dct.IDCT_RESIZE.argtypes)
    # t, out_h, out_w, nby, nbx, band_rows, n_bands follow the 12 pointers
    t, out_h, out_w, nby, nbx, band_rows, n_bands = args[12:19]
    assert (t, out_h, out_w, nby, nbx) == (2, 120, 200, 16, 26)
    assert n_bands == -(-120 // band_rows)


@pytest.mark.parametrize("block", [4, 16, *RECT_BLOCKS, "2x4", "4x2"])
def test_general_route_dispatches_to_square_k6(monkeypatch, block):
    # on a non-CPU device the general route at blocks of 3 channels with
    # both sides in {4, 8, 16} (the squares and the rectangles) launches
    # K6's templated kernel of that shape once, with dh and dw by value and
    # its geometry in block rows of BH and strips of 64 / BW block columns;
    # the general K6, the 8x8 K6, every other K6 and every K1 never; a side
    # of 2 still takes the general K6 (a meta device stands in for the
    # card)
    from svc_tpu_torch.models import decoder as dec_mod

    launched = []
    bh, bw = _hw(block)
    want = dct.IDCT_RESIZE_SQ.get((bh, bw), dct.IDCT_RESIZE_GENERAL)
    monkeypatch.setattr(dec_mod, "resolve_device", lambda d: torch.device("meta"))
    monkeypatch.setattr(dct, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(dct, "stream_handle", lambda t: 0)
    monkeypatch.setattr(dct, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (dct.IDCT_RESIZE_GENERAL, dct.IDCT_RESIZE, dct.IDCT_DISPLAY,
              dct.IDCT_DISPLAY_GENERAL, *dct.IDCT_DISPLAY_SQ.values(),
              *dct.IDCT_RESIZE_SQ.values()):
        monkeypatch.setattr(k, "launch", lambda *a, _k=k: (
            launched.append(a) if _k is want else pytest.fail(_k.name)))
    hdr, coeffs, btypes, rects = _decode_inputs(200, 120, 8, 8, seed=3,
                                                block=block)
    out = dec_mod.Decoder(config.DecoderConfig(), hdr, device="cuda").decode_batch(
        coeffs, btypes, rects
    )
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 120, 600)
    (args,) = launched
    assert len(args) == len(want.argtypes)
    nby, nbx = 128 // bh, 208 // bw
    if want is dct.IDCT_RESIZE_GENERAL:
        # t, out_h, out_w, nby, nbx, channels, bh, bw follow the 13 pointers
        assert args[13:21] == (2, 120, 200, nby, nbx, 3, bh, bw)
        return
    assert args[2:4] == (dct.dct_matrix(bh).ctypes.data,
                         dct.dct_matrix(bw).ctypes.data)
    # t, out_h, out_w, nby, nbx, band_rows, n_bands follow the 13 pointers
    t, out_h, out_w, k_nby, k_nbx, band_rows, n_bands = args[13:20]
    assert (t, out_h, out_w, k_nby, k_nbx) == (2, 120, 200, nby, nbx)
    *_, band_b, want_rows = dct._band_tables(
        120, 128, nbx, 2, 132, dct._K6_SQ_GEOM[bh, bw][5], bh, 64 // bw)
    assert band_rows == want_rows and n_bands == len(band_b)
    assert n_bands == -(-120 // band_rows)


@pytest.mark.parametrize(
    "out_n,in_n", [(1080, 1088), (768, 768), (1366, 1376), (120, 128),
                   (200, 208), (854, 864), (7, 16)],
)
@pytest.mark.parametrize("tile", [8, 16, 64])
def test_span_tables_cover_every_read(out_n, in_n, tile):
    # every source pixel a display kernel's tile reads lies inside the
    # blocks the host tables give that tile
    i0, i1, frac, first, n_blk = dct._span_tables(out_n, in_n, 8, tile)
    for t, start in enumerate(range(0, out_n, tile)):
        sl = slice(start, start + tile)
        reads = np.concatenate([i0[sl], i1[sl][frac[sl] != 0]])
        assert reads.min() // 8 >= first[t]
        assert reads.max() // 8 < first[t] + n_blk


@pytest.mark.parametrize("w,kernel", [(96, "idct_display_plain"),
                                      (120, "idct_resize_display_plain")])
def test_display_ties_tool_takes_the_decoders_route(monkeypatch, capsys, w,
                                                    kernel):
    # the tool decodes a width that is not a multiple of 16 as the decoder
    # does (K6, both axes resampled) and holds it to the exact decode
    # through the column resample: the CPU plain version differs from it
    # only on ties
    import json

    from svc_tpu_torch.tools import display_ties

    called = []
    real = getattr(dct, kernel)
    monkeypatch.setattr(dct, kernel,
                        lambda *a, **k: called.append(kernel) or real(*a, **k))
    assert display_ties.main(["--device", "cpu", "--width", str(w),
                              "--height", "64", "--block", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert called == [kernel]
    assert out["shape"] == [w, 64, 2, 7] and out["ties"] > 0.01
    assert out["cpu_plain_vs_exact"]["off_ties"] == 0
    assert out["cpu_plain_vs_exact"]["max"] <= 1
