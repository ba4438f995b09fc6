"""The DCT wrappers' dispatch by shape (8x8 blocks of 3 channels to the
specialised kernels K1 / K2 / K6; the other blocks of 3 channels with both
sides in {1, 2, 4, 8, 16} to K2's, K1's and K6's templated kernels; every
other shape to the general ones) and the band and strip geometry of K1's
and K6's specialised, templated and square-block kernels, on the CPU.

A meta device stands in for the card in the dispatch tests: shapes and
dtypes flow through the wrappers, the launch is replaced, nothing computes.
The geometry tests replay the kernel's walk over its host tables in numpy.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import dct

SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SMEM_BYTES = 228 * 1024  # shared memory of one SM
CTA_SMEM_BYTES = 227 * 1024  # the most one CTA may ask for (with the opt-in)


@pytest.fixture
def meta_launches(monkeypatch):
    """Route the wrappers' CUDA path to a meta device; record each launch
    as ``(kernel name, args)``."""
    launched = []
    monkeypatch.setattr(dct, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(dct, "stream_handle", lambda t: 0)
    monkeypatch.setattr(dct, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (dct.DCT_WIRE, dct.DCT_WIRE_GENERAL, dct.IDCT_DISPLAY,
              dct.IDCT_DISPLAY_GENERAL, dct.IDCT_RESIZE,
              dct.IDCT_RESIZE_GENERAL, *dct.DCT_WIRE_SQ.values(),
              *dct.IDCT_DISPLAY_SQ.values(), *dct.IDCT_RESIZE_SQ.values()):
        monkeypatch.setattr(k, "launch",
                            lambda *a, _k=k: launched.append((_k.name, a)))
    return launched


def _all_kernels():
    return {k.name: k for k in (
        dct.DCT_WIRE, dct.DCT_WIRE_GENERAL, dct.IDCT_DISPLAY,
        dct.IDCT_DISPLAY_GENERAL, dct.IDCT_RESIZE, dct.IDCT_RESIZE_GENERAL,
        *dct.DCT_WIRE_SQ.values(), *dct.IDCT_DISPLAY_SQ.values(),
        *dct.IDCT_RESIZE_SQ.values())}


@pytest.mark.parametrize(
    "block,channels,general,kernel",
    [(8, 3, False, "dct8x8_to_wire"), (8, 3, True, "dct_to_wire_general"),
     (4, 3, False, "dct4x4_to_wire"), (16, 3, False, "dct16x16_to_wire"),
     (4, 3, True, "dct_to_wire_general"), (16, 3, True, "dct_to_wire_general"),
     (2, 3, False, "dct2x2_to_wire"), (1, 3, True, "dct_to_wire_general"),
     (2, 3, True, "dct_to_wire_general"), (8, 1, False, "dct_to_wire_general"),
     (16, 1, False, "dct_to_wire_general"), (1, 3, False, "dct1x1_to_wire"),
     (1, 1, False, "dct_to_wire_general")],
)
def test_dct_to_wire_dispatch(meta_launches, block, channels, general, kernel):
    packed = torch.zeros((3, 16, 32 * channels), dtype=torch.uint8, device="meta")
    out = dct.dct8x8_to_wire(packed, 1, 2, 16, 32, block, block, channels,
                             general=general)
    n = channels * block * block
    assert tuple(out.shape) == (2, 16 // block, 32 // block, n)
    ((name, args),) = meta_launches
    assert name == kernel
    assert len(args) == len(_all_kernels()[kernel].argtypes)
    if kernel != "dct_to_wire_general":
        # the DCT matrices travel as host pointers, read by value: one for
        # the 8x8 kernel, dh and dw for the templated ones
        mats = 1 if kernel == "dct8x8_to_wire" else 2
        assert args[1:1 + mats] == (dct.dct_matrix(block).ctypes.data,) * mats
        # t_count, frame_offset, frame_h, frame_w, nby, nbx follow the
        # pointers
        assert args[2 + mats:8 + mats] == (2, 1, 16, 32, 16 // block, 32 // block)


@pytest.mark.parametrize(
    "block,channels,general,kernel",
    [(8, 3, False, "idct_display"), (8, 3, True, "idct_display_general"),
     (4, 3, False, "idct4x4_display"), (16, 3, False, "idct16x16_display"),
     (4, 3, True, "idct_display_general"), (16, 3, True, "idct_display_general"),
     (2, 3, False, "idct2x2_display"), (1, 3, True, "idct_display_general"),
     (2, 3, True, "idct_display_general"), (8, 1, False, "idct_display_general"),
     (16, 1, False, "idct_display_general"), (1, 3, False, "idct1x1_display"),
     (1, 1, False, "idct_display_general")],
)
def test_idct_display_dispatch(meta_launches, block, channels, general, kernel):
    n = channels * block * block
    coeffs = torch.zeros((2, 136 * 8 // block, 240 * 8 // block, n), device="meta")
    steps = torch.ones(coeffs.shape[:3], device="meta")
    out = dct.idct_display(coeffs, steps, 1080, channels, block, block,
                           general=general)
    assert out.dtype == torch.uint8
    assert tuple(out.shape) == (2, 1080, 1920 * channels)
    ((name, args),) = meta_launches
    assert name == kernel
    assert len(args) == len(_all_kernels()[kernel].argtypes)
    if kernel != "idct_display_general":
        # the DCT matrices travel as host pointers, read by value: one for
        # the 8x8 kernel, dh and dw for the templated ones
        mats = 1 if kernel == "idct_display" else 2
        assert args[2:2 + mats] == (dct.dct_matrix(block).ctypes.data,) * mats
        # t, out_h, nby, nbx, band_rows, n_bands follow the pointers
        t, out_h, nby, nbx, band_rows, n_bands = args[8 + mats:14 + mats]
        assert (t, out_h, nby, nbx) == (2, 1080, 1088 // block, 1920 // block)
        assert n_bands == -(-1080 // band_rows)


def _both_legs(block_h, block_w, channels, general):
    """K2 on 9 packed 1080p frames and K1 on 8 frames of their padded
    1088 rows to 1080, at ``block_h`` x ``block_w`` blocks: the outputs'
    shapes, and each launch as ``(name, args)`` (``meta_launches``)."""
    packed = torch.zeros((9, 1080, 1920 * channels), dtype=torch.uint8,
                         device="meta")
    wire = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, block_h, block_w,
                              channels, general=general)
    nby, nbx = 1088 // block_h, 1920 // block_w
    coeffs = torch.zeros((8, nby, nbx, channels * block_h * block_w),
                         device="meta")
    steps = torch.ones(coeffs.shape[:3], device="meta")
    shown = dct.idct_display(coeffs, steps, 1080, channels, block_h, block_w,
                             general=general)
    return tuple(wire.shape), tuple(shown.shape)


@pytest.mark.parametrize(
    "block_h,block_w,channels,general",
    [(1, 2, 1, False), (2, 1, 3, True), (1, 8, 3, True), (8, 16, 1, False),
     (4, 8, 3, True), (16, 8, 3, True)],
)
def test_rectangular_blocks_take_the_general_kernels(meta_launches, block_h,
                                                     block_w, channels, general):
    # one channel, or general=True: both legs go to the general kernels,
    # whose dh and dw are their own matrices
    wire, shown = _both_legs(block_h, block_w, channels, general)
    n = channels * block_h * block_w
    assert wire == (8, 1088 // block_h, 1920 // block_w, n)
    assert shown == (8, 1080, 1920 * channels)
    (k2, k2_args), (k1, k1_args) = meta_launches
    assert (k2, k1) == ("dct_to_wire_general", "idct_display_general")
    assert len(k2_args) == len(dct.DCT_WIRE_GENERAL.argtypes)
    assert len(k1_args) == len(dct.IDCT_DISPLAY_GENERAL.argtypes)
    # bh, bw follow channels, nby, nbx
    assert k2_args[8:13] == (channels, 1088 // block_h, 1920 // block_w,
                             block_h, block_w)


@pytest.mark.parametrize("block_h,block_w", [(4, 8), (8, 4), (4, 16), (16, 4),
                                             (8, 16), (16, 8), (2, 2), (2, 4),
                                             (4, 2), (2, 8), (8, 2), (2, 16),
                                             (16, 2), (1, 1), (1, 2), (2, 1),
                                             (1, 4), (4, 1), (1, 8), (8, 1),
                                             (1, 16), (16, 1)])
def test_rectangular_blocks_take_their_templated_kernels(meta_launches,
                                                         block_h, block_w):
    # each rectangle of 3 channels (and 2x2, 1x1) launches its own K2 and
    # K1 instance, named rows first, with dh and dw by value; K1's geometry
    # counts rows in walk steps (block_h, or 8 pixel rows where a side is
    # 1 or 2) and the strip in block_w
    wire, shown = _both_legs(block_h, block_w, 3, False)
    assert wire == (8, 1088 // block_h, 1920 // block_w, 3 * block_h * block_w)
    assert shown == (8, 1080, 5760)
    (k2, k2_args), (k1, k1_args) = meta_launches
    assert (k2, k1) == (f"dct{block_h}x{block_w}_to_wire",
                        f"idct{block_h}x{block_w}_display")
    assert len(k2_args) == len(dct.DCT_WIRE_SQ[block_h, block_w].argtypes) == 11
    assert len(k1_args) == len(dct.IDCT_DISPLAY_SQ[block_h, block_w].argtypes) == 17
    mats = (dct.dct_matrix(block_h).ctypes.data, dct.dct_matrix(block_w).ctypes.data)
    assert k2_args[1:3] == k1_args[2:4] == mats
    nby, nbx = 1088 // block_h, 1920 // block_w
    assert k2_args[4:10] == (8, 1, 1080, 1920, nby, nbx)
    t, out_h, k1_nby, k1_nbx, band_rows, n_bands = k1_args[10:16]
    assert (t, out_h, k1_nby, k1_nbx) == (8, 1080, nby, nbx)
    assert n_bands == -(-1080 // band_rows)
    want = _k1_tables(1080, 1088, nbx, 8, block_h, block_w)
    assert band_rows == want[-1]


@pytest.mark.parametrize(
    "block,channels,out_w,general,kernel",
    [(8, 3, 1366, False, "idct_resize_display"),
     (8, 3, 1366, True, "idct_resize_display_general"),
     (4, 3, 1366, False, "idct4x4_resize_display"),
     (16, 3, 1366, False, "idct16x16_resize_display"),
     (4, 3, 1366, True, "idct_resize_display_general"),
     (16, 3, 1366, True, "idct_resize_display_general"),
     (2, 3, 1366, False, "idct2x2_resize_display"),
     (1, 3, 1366, False, "idct1x1_resize_display"),
     (2, 3, 1366, True, "idct_resize_display_general"),
     (1, 3, 1366, True, "idct_resize_display_general"),
     (2, 1, 1366, False, "idct_resize_display_general"),
     (1, 2, 1366, False, "idct_resize_display_general"),
     (8, 1, 1366, False, "idct_resize_display_general"),
     (4, 1, 1366, False, "idct_resize_display_general"),
     (16, 1, 1366, False, "idct_resize_display_general"),
     (8, 3, 1400, False, "idct_resize_display_general"),  # columns upsampled
     (4, 3, 1400, False, "idct_resize_display_general"),
     (16, 3, 1400, False, "idct_resize_display_general"),
     (2, 3, 1400, False, "idct_resize_display_general"),
     (1, 3, 1400, False, "idct_resize_display_general")],
)
def test_idct_resize_display_dispatch(meta_launches, block, channels, out_w,
                                      general, kernel):
    n = channels * block * block
    coeffs = torch.zeros((2, 768 // block, 1376 // block, n), device="meta")
    steps = torch.ones(coeffs.shape[:3], device="meta")
    out = dct.idct_resize_display(coeffs, steps, 768, out_w, channels, block,
                                  block, general=general)
    assert out.dtype == torch.uint8
    assert tuple(out.shape) == (2, 768, out_w * channels)
    ((name, args),) = meta_launches
    assert name == kernel
    if kernel != "idct_resize_display_general":
        assert len(args) == len(_all_kernels()[kernel].argtypes)
        # the DCT matrices travel as host pointers, read by value: one for
        # the 8x8 kernel, dh and dw for the templated ones
        mats = 1 if kernel == "idct_resize_display" else 2
        assert args[2:2 + mats] == (dct.dct_matrix(block).ctypes.data,) * mats
        # t, out_h, out_w, nby, nbx, band_rows, n_bands follow the pointers
        t, out_h, w, nby, nbx, band_rows, n_bands = args[11 + mats:18 + mats]
        assert (t, out_h, w, nby, nbx) == (2, 768, out_w, 768 // block,
                                           1376 // block)
        assert n_bands == -(-768 // band_rows)
    else:
        assert len(args) == len(dct.IDCT_RESIZE_GENERAL.argtypes)
        assert args[13:21] == (2, 768, out_w, 768 // block, 1376 // block,
                               channels, block, block)


def test_k6_keeps_its_nine_shapes():
    # the nine shapes of sides 4, 8 and 16 stay K6's: the eight templated
    # ones in its template, 8x8 its specialised kernel
    assert set(dct._SQ_SHAPES) <= set(dct.IDCT_RESIZE_SQ)
    assert (8, 8) not in dct.IDCT_RESIZE_SQ
    for bh, bw in dct._SQ_SHAPES:
        assert dct._templated(bh, bw, 3) and not dct._specialised(bh, bw, 3)
        assert dct.IDCT_RESIZE_SQ[bh, bw].name == f"idct{bh}x{bw}_resize_display"
    assert dct._specialised(8, 8, 3) and not dct._templated(8, 8, 3)


def test_k6_takes_the_24_shapes():
    # K6's template takes every shape K2's and K1's take: 1x1, 2x2, 4x4,
    # 16x16, the six rectangles of sides 4, 8 and 16, the six with a side
    # of 2 and the eight with a side of 1, of 3 channels only
    assert sorted(dct.IDCT_RESIZE_SQ) == sorted(dct.DCT_WIRE_SQ) == sorted(
        dct.IDCT_DISPLAY_SQ) == sorted(dct._TEMPLATED_SHAPES)
    assert len(dct.IDCT_RESIZE_SQ) == 24
    assert sorted(dct._K6_SQ_GEOM) == sorted(dct._TEMPLATED_SHAPES)
    for bh, bw in dct._TEMPLATED_SHAPES:
        assert dct.IDCT_RESIZE_SQ[bh, bw].source == (
            "svc_tpu_torch/csrc/idct_resize_sq.cu")
        assert dct._templated(bh, bw, 3)
        assert not any(dct._templated(bh, bw, c) for c in (1, 2, 4))


@pytest.mark.parametrize("block_h,block_w", [(2, 2), (2, 4), (4, 2), (2, 8),
                                             (8, 2), (2, 16), (16, 2)])
def test_side_2_width_excess_takes_the_general_k6(meta_launches, block_h,
                                                  block_w):
    # a width-excess decode (1376 padded columns to 1366) at a side of 2
    # takes the general K6 only where the templated one does not serve:
    # general=True, channels other than 3, or upsampled columns (1400 of
    # 1376)
    for channels, out_w, general in ((3, 1366, True), (1, 1366, False),
                                     (4, 1366, False), (3, 1400, False)):
        n = channels * block_h * block_w
        coeffs = torch.zeros((2, 768 // block_h, 1376 // block_w, n),
                             device="meta")
        steps = torch.ones(coeffs.shape[:3], device="meta")
        out = dct.idct_resize_display(coeffs, steps, 768, out_w, channels,
                                      block_h, block_w, general=general)
        assert tuple(out.shape) == (2, 768, out_w * channels)
        ((k6, k6_args),) = meta_launches
        assert k6 == "idct_resize_display_general"
        assert len(k6_args) == len(dct.IDCT_RESIZE_GENERAL.argtypes)
        assert k6_args[13:21] == (2, 768, out_w, 768 // block_h,
                                  1376 // block_w, channels, block_h, block_w)
        meta_launches.clear()


@pytest.mark.parametrize("block_h,block_w",
                         dct._THIN_SHAPES + dct._SIDE_1_SHAPES)
def test_side_1_or_2_width_excess_takes_its_templated_k6(meta_launches, block_h,
                                                         block_w):
    # a width-excess decode (1376 padded columns to 1366) at a side of 1 or
    # 2 launches its templated K6, with its walk step's tables (rows in
    # steps of 8 pixel rows, 16 at 16x2 and 16x1), and the width-aligned
    # decode of the same blocks its templated K1
    n = 3 * block_h * block_w
    coeffs = torch.zeros((2, 768 // block_h, 1376 // block_w, n), device="meta")
    steps = torch.ones(coeffs.shape[:3], device="meta")
    out = dct.idct_resize_display(coeffs, steps, 768, 1366, 3, block_h, block_w)
    assert tuple(out.shape) == (2, 768, 1366 * 3)
    dct.idct_display(coeffs, steps, 766, 3, block_h, block_w)
    (k6, k6_args), (k1, _) = meta_launches
    assert (k6, k1) == (f"idct{block_h}x{block_w}_resize_display",
                        f"idct{block_h}x{block_w}_display")
    assert len(k6_args) == len(dct.IDCT_RESIZE_SQ[block_h, block_w].argtypes)
    assert k6_args[2:4] == (dct.dct_matrix(block_h).ctypes.data,
                            dct.dct_matrix(block_w).ctypes.data)
    t, out_h, w, nby, nbx, band_rows, n_bands = k6_args[13:20]
    assert (t, out_h, w, nby, nbx) == (2, 768, 1366, 768 // block_h,
                                       1376 // block_w)
    step_rows = max(block_h, 8)
    assert dct._k1_sq_step_rows(block_h, block_w) == step_rows
    *_, band_b, rows = dct._band_tables(
        768, 768, 1376 // block_w, 2, SMS, dct._K6_SQ_GEOM[block_h, block_w][5],
        step_rows, 64 // block_w)
    assert (band_rows, n_bands) == (rows, len(band_b))
    assert band_b.max() < 768 // step_rows


@pytest.mark.parametrize("general", [False, True])
def test_display_wrappers_copy_tables_once(meta_launches, monkeypatch, general):
    # a second call of the same geometry makes no host-to-device copy: its
    # tables and matrices come from the per-(device, geometry) cache, so the
    # wrapper can be captured in a CUDA graph
    coeffs = torch.zeros((2, 16, 26, 192), device="meta")
    steps = torch.ones(coeffs.shape[:3], device="meta")
    packed = torch.zeros((3, 120, 600), dtype=torch.uint8, device="meta")
    sq = {b: (torch.zeros((2, 128 // b, 208 // b, 3 * b * b), device="meta"),
              torch.ones((2, 128 // b, 208 // b), device="meta")) for b in (4, 16)}
    calls = [
        lambda: dct.idct_resize_display(coeffs, steps, 120, 200, general=general),
        lambda: dct.idct_display(coeffs, steps, 120, general=general),
        lambda: dct.dct8x8_to_wire(packed, 1, 2, 128, 208, general=general),
    ] + [
        call for b, (c, s) in sq.items() for call in (
            lambda b=b, c=c, s=s: dct.idct_display(c, s, 120, 3, b, b,
                                                   general=general),
            lambda b=b, c=c, s=s: dct.idct_resize_display(
                c, s, 120, 200, 3, b, b, general=general),
            lambda b=b: dct.dct8x8_to_wire(packed, 1, 2, 128, 208, b, b,
                                           general=general))
    ]
    for call in calls:
        call()
    copies = []
    as_tensor, tensor = torch.as_tensor, torch.tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, **k: copies.append(a) or as_tensor(*a, **k))
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **k: copies.append(a) or tensor(*a, **k))
    for call in calls:
        call()
    assert copies == []
    assert len(meta_launches) == 2 * len(calls)


def _tensors(tables):
    """The tensors of a cached table entry, in order."""
    if isinstance(tables, torch.Tensor):
        return [tables]
    if isinstance(tables, (list, tuple)):
        return [t for x in tables for t in _tensors(x)]
    return []


@pytest.mark.parametrize("cache", ["span", "band", "strip"])
def test_device_tables_survive_twenty_geometries(monkeypatch, cache):
    # a CUDA graph that captured a display kernel reads its tables through
    # raw pointers: the device-table caches never evict, so the first
    # geometry's tensors outlive 19 more geometries, the same objects at
    # the same addresses
    monkeypatch.setattr(dct, "_sm_count", lambda dev: SMS)
    dev = torch.device("cpu")
    build_tables = {
        "span": lambda g: dct._span_tables_on(dev, 40 + g, 48, 8, 8),
        "band": lambda g: dct._band_tables_on(dev, 40 + g, 48, 6, 2),
        "strip": lambda g: dct._strip_tables_on(dev, 40 + g, 48),
    }[cache]
    first = _tensors(build_tables(0))
    assert first
    ptrs = [t.data_ptr() for t in first]
    for g in range(1, 20):
        build_tables(g)
    again = _tensors(build_tables(0))
    assert len(again) == len(first)
    assert all(a is b for a, b in zip(again, first))
    assert [t.data_ptr() for t in again] == ptrs


def test_decoder_width_aligned_route_takes_specialised_k1(meta_launches,
                                                          monkeypatch):
    from svc_tpu_torch import config
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.models import decoder as dec_mod

    monkeypatch.setattr(dec_mod, "resolve_device", lambda d: torch.device("meta"))
    hdr = bitstream.Header(2, 128, 120, 0, 8, 8, 8, 3)
    rng = np.random.default_rng(5)
    coeffs = rng.normal(size=(2, 16, 16, 192)).astype(np.float32)
    btypes = rng.integers(0, 3, (2, 16, 16)).astype(np.uint32)
    rects = np.tile(np.array([[32, 30, 64, 32]], np.int32), (2, 1))
    out = dec_mod.Decoder(config.DecoderConfig(), hdr, device="cuda").decode_batch(
        coeffs, btypes, rects
    )
    assert tuple(out.shape) == (2, 120, 384)
    assert [name for name, _ in meta_launches] == ["idct_display"]


# (display height, padded height, padded width): 1080p resample, 1080p
# identity, 4K identity, 1366x768's padded width with identity rows, CIF
K1_GEOMETRIES = [(1080, 1088, 1920), (1080, 1080, 1920), (2160, 2160, 3840),
                 (768, 768, 1376), (288, 288, 352)]


def _k1_step_rows(block, block_w=None):
    """The pixel rows of a walk step of K1's kernel for ``block`` x
    ``block_w`` blocks: the block height, but a step of several block rows
    (8 pixel rows) where a side of the templated kernel's block is 2."""
    block_w = block if block_w is None else block_w
    if (block, block_w) == (8, 8):
        return 8
    return block * dct._K1_SQ_GEOM[block, block_w][3]


def _k1_tables(out_h, in_h, nbx, t, block=8, block_w=None):
    """K1's band tables for ``block`` x ``block_w`` blocks (``block_w``
    defaults to ``block``): the 8x8 kernel's, or the templated kernel's
    strip (``block_w``) and CTAs per SM; rows in walk steps
    (:func:`_k1_step_rows`)."""
    block_w = block if block_w is None else block_w
    if (block, block_w) == (8, 8):
        return dct._band_tables(out_h, in_h, nbx, t, SMS)
    return dct._band_tables(out_h, in_h, nbx, t, SMS,
                            dct._K1_SQ_GEOM[block, block_w][2],
                            _k1_step_rows(block, block_w),
                            dct._K1_SQ_STRIP_PIXELS // block_w)


def _hw(block):
    """``(block_h, block_w)`` of a test's block: ``B`` for a square,
    ``"BHxBW"`` or ``(BH, BW)``."""
    if isinstance(block, int):
        return block, block
    if isinstance(block, tuple):
        return block
    return tuple(int(v) for v in block.split("x"))


def _walk(out_h, in_h, nbx, t, block=8, block_w=None):
    """Replay the kernel's walk: per band, the walk steps (block rows, or
    several where a side is 2) it transforms and the output rows it emits
    after each, with the source rows the ring holds at that moment (the
    current and the previous step)."""
    y0, y1, fy, row_lo, band_b, band_rows = _k1_tables(out_h, in_h, nbx, t,
                                                       block, block_w)
    step = _k1_step_rows(block, block_w)
    for band, (b_first, b_last) in enumerate(band_b):
        yb0, yb1 = band * band_rows, min(out_h, (band + 1) * band_rows)
        for b in range(b_first, b_last + 1):
            ring = set(range(max(step * b_first, step * (b - 1)),
                             min(in_h, step * b + step)))
            rows = range(max(yb0, row_lo[b]), min(yb1, row_lo[b + 1]))
            yield band, b, rows, ring


@pytest.mark.parametrize("out_h,in_h,pw", K1_GEOMETRIES)
def test_k1_band_walk_reads_inside_its_window(out_h, in_h, pw):
    # every y0 / y1 an output row reads is in the ring when the row is
    # emitted, each row is emitted once by its own band, and a band walks
    # its own block rows plus at most one halo block row
    y0, y1, fy, row_lo, band_b, band_rows = dct._band_tables(
        out_h, in_h, pw // 8, 8, SMS)
    emitted = np.zeros(out_h, np.int64)
    for band, b, rows, ring in _walk(out_h, in_h, pw // 8, 8):
        for yo in rows:
            assert band * band_rows <= yo < (band + 1) * band_rows
            assert y0[yo] in ring
            if fy[yo] != 0:
                assert y1[yo] in ring
            emitted[yo] += 1
    assert (emitted == 1).all()
    walked = band_b[:, 1] - band_b[:, 0] + 1
    assert walked.max() <= band_rows // 8 + 2
    # the walk transforms about (1 + 8 / band_rows) of the frame's block rows
    assert walked.sum() <= (in_h // 8) * (1 + 8 / band_rows) + len(band_b)


@pytest.mark.parametrize("out_h,in_h,pw", K1_GEOMETRIES)
def test_k1_grid_fills_the_card(out_h, in_h, pw):
    # at T = 8: at least 2 CTAs per SM, and two waves at the CTAs per SM
    # that the kernel's shared memory allows; one CTA's shared memory fits
    _, _, _, _, band_b, band_rows = dct._band_tables(out_h, in_h, pw // 8, 8, SMS)
    ctas = 8 * -(-(pw // 8) // dct._K1_STRIP) * len(band_b)
    assert ctas >= 2 * SMS
    assert dct._K1_SMEM_BYTES <= CTA_SMEM_BYTES
    assert dct._K1_CTAS_PER_SM * (dct._K1_SMEM_BYTES + 1024) <= SM_SMEM_BYTES
    if band_rows != dct._K1_BAND_ROWS[-1]:
        assert ctas >= 2 * dct._K1_CTAS_PER_SM * SMS
    assert band_rows in dct._K1_BAND_ROWS


def test_k1_host_geometry_matches_the_kernel_source():
    # the strip width, tallest band, CTAs per SM and shared memory that the
    # wrapper plans with are those csrc/idct_display.cu is compiled with
    # (its coefficient slot layout from the shared idct8x8.cuh)
    src = (build.CSRC_DIR / "idct_display.cu").read_text()
    shared = (build.CSRC_DIR / "idct8x8.cuh").read_text()
    k = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                          src + shared)}
    assert k["kStrip"] == dct._K1_STRIP
    assert k["kMaxBandRows"] == max(dct._K1_BAND_ROWS)
    (ctas,) = re.findall(r"__launch_bounds__\(kThreads, (\d+)\)", src)
    assert int(ctas) == dct._K1_CTAS_PER_SM
    slot = k["kStrip"] * 3 * k["kCoefGroup"]
    ring_pitch = k["kStrip"] * 24 // 16 * 20 + 4
    assert dct._K1_SMEM_BYTES == 4 * (
        2 * slot + k["kRingRows"] * ring_pitch + 2 * k["kStrip"]
        + 3 * k["kMaxBandRows"])


@pytest.mark.parametrize("out_h,in_h,nbx,t", [(120, 128, 16, 2), (128, 128, 16, 2),
                                              (37, 40, 3, 1), (248, 256, 35, 1)])
def test_k1_band_walk_reproduces_plain_bytes(out_h, in_h, nbx, t):
    # the kernel's walk, replayed on the plain version's planes with the
    # kernel's per-element blend, gives the plain version's bytes
    rng = np.random.default_rng(out_h + nbx)
    coeffs = torch.from_numpy(
        (rng.normal(size=(t, in_h // 8, nbx, 192)) * 90).astype(np.float32))
    steps = torch.from_numpy(
        rng.choice([1.0, 640.0], size=(t, in_h // 8, nbx)).astype(np.float32))
    planes = dct.idct_planes_plain(coeffs, steps, 3, 8, 8)
    y0, y1, fy, _, _, _ = dct._band_tables(out_h, in_h, nbx, t, SMS)
    rows = torch.full((t, 3, out_h, nbx * 8), float("nan"))
    for _, _, emit, _ in _walk(out_h, in_h, nbx, t):
        for yo in emit:
            v = planes[:, :, y0[yo]]
            if fy[yo] != 0:
                f = torch.tensor(fy[yo])
                v = v * (1 - f) + planes[:, :, y1[yo]] * f
            rows[:, :, yo] = v
    got = dct.display_bytes(rows)
    want = dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8)
    assert torch.equal(got, want)


def _band_tables_before(out_h, in_h, nbx, t, sm_count, ctas_per_sm=6):
    """``_band_tables`` as it was before it took the block size and the
    strip (blocks of 8 rows, strips of 8 block columns): K1's and K6's
    8x8 tables must stay exactly these."""
    y0, y1, fy, _ = dct.bilinear_axis_weights(out_h, in_h)
    hi = np.where(fy != 0, y1, y0)
    row_lo = np.searchsorted(hi // 8, np.arange(in_h // 8 + 1)).astype(np.int32)
    strips = -(-nbx // 8)
    for band_rows in (128, 64, 32, 16, 8):
        if t * strips * -(-out_h // band_rows) >= 2 * ctas_per_sm * sm_count:
            break
    starts = np.arange(0, out_h, band_rows)
    ends = np.minimum(starts + band_rows, out_h) - 1
    band_b = np.stack([y0[starts] // 8, hi[ends] // 8], axis=1).astype(np.int32)
    return y0, y1, fy, row_lo, band_b, band_rows


@pytest.mark.parametrize("ctas", [dct._K1_CTAS_PER_SM, dct._K6_CTAS_PER_SM])
@pytest.mark.parametrize("out_h,in_h,nbx,t", [(1080, 1088, 240, 8), (1080, 1080, 240, 8),
                                              (768, 768, 172, 8), (288, 288, 44, 8),
                                              (714, 720, 160, 1), (37, 40, 3, 1)])
def test_band_tables_at_block_8_unchanged(out_h, in_h, nbx, t, ctas):
    # K1's and K6's 8x8 tables are exactly those before the block size and
    # the strip became parameters, by default and given explicitly
    want = _band_tables_before(out_h, in_h, nbx, t, SMS, ctas)
    for got in (dct._band_tables(out_h, in_h, nbx, t, SMS, ctas),
                dct._band_tables(out_h, in_h, nbx, t, SMS, ctas, 8, 8)):
        assert got[-1] == want[-1]
        for a, b in zip(got[:-1], want[:-1]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# K1's templated kernels: (block: B or "BHxBW", display height, padded
# height, padded width): 1080p resample, identity rows, CIF, 1366x768's
# padded width (a ragged last strip), 4K, and a small ragged frame; every
# rectangle at 1080p resample, CIF and 1366x768's padded width
K1_SQ_GEOMETRIES = [
    (4, 1080, 1088, 1920), (4, 1080, 1080, 1920), (4, 288, 288, 352),
    (4, 768, 768, 1376), (4, 2160, 2160, 3840), (4, 37, 40, 12),
    (16, 1080, 1088, 1920), (16, 1072, 1072, 1920), (16, 288, 288, 352),
    (16, 768, 768, 1376), (16, 2160, 2160, 3840), (16, 37, 48, 48),
] + [(shape, *g) for shape in ("4x8", "8x4", "4x16", "16x4", "8x16", "16x8",
                                "2x2", "2x4", "4x2", "2x8", "8x2", "2x16",
                                "16x2", "1x1", "1x2", "2x1", "1x4", "4x1",
                                "1x8", "8x1", "1x16", "16x1")
     for g in ((1080, 1088, 1920), (288, 288, 352), (766, 768, 1376))] + [
    ("16x4", 37, 48, 12), ("4x16", 37, 40, 48),
    # a side of 1 or 2: a last walk step of fewer block rows than the
    # others
    ("2x2", 37, 42, 12), ("4x2", 37, 44, 12), ("2x16", 35, 38, 48),
    ("1x1", 37, 45, 12), ("2x1", 37, 42, 12), ("4x1", 37, 44, 12),
    ("1x16", 35, 37, 48)]


@pytest.mark.parametrize("block,out_h,in_h,pw", K1_SQ_GEOMETRIES)
def test_k1_sq_band_walk_reads_inside_its_window(block, out_h, in_h, pw):
    # every y0 / y1 an output row reads is in the ring of the last two
    # walk steps (2 BH rows, or 16 where a side is 2) when the row is
    # emitted, each row is emitted once by its own band, and a band walks
    # its own steps plus at most one halo step
    bh, bw = _hw(block)
    step = _k1_step_rows(bh, bw)
    nbx = pw // bw
    y0, y1, fy, row_lo, band_b, band_rows = _k1_tables(out_h, in_h, nbx, 8,
                                                       bh, bw)
    assert band_rows <= 128  # the kernel's kMaxBandRows
    emitted = np.zeros(out_h, np.int64)
    for band, b, rows, ring in _walk(out_h, in_h, nbx, 8, bh, bw):
        assert 0 <= b < -(-in_h // step)
        for yo in rows:
            assert band * band_rows <= yo < (band + 1) * band_rows
            assert y0[yo] in ring
            if fy[yo] != 0:
                assert y1[yo] in ring
            emitted[yo] += 1
    assert (emitted == 1).all()
    walked = band_b[:, 1] - band_b[:, 0] + 1
    assert walked.max() <= -(-band_rows // step) + 2


@pytest.mark.parametrize("block,out_h,in_h,pw", K1_SQ_GEOMETRIES)
def test_k1_sq_writes_every_output_byte_once(block, out_h, in_h, pw):
    # the emit loop (per block row: 16-byte runs q of each emitted row,
    # bytes q * 16 + n below the strip's valid bytes, strip s at byte
    # 192 * s of the row) writes every byte of the frame exactly once
    bh, bw = _hw(block)
    nbx = pw // bw
    strip = dct._K1_SQ_STRIP_PIXELS // bw
    row_bytes = nbx * bw * 3
    *_, band_b, band_rows = _k1_tables(out_h, in_h, nbx, 1, bh, bw)
    written = np.zeros((out_h, row_bytes), np.int64)
    n_strips = -(-nbx // strip)
    for _, _, rows, _ in _walk(out_h, in_h, nbx, 1, bh, bw):
        for s in range(n_strips):
            valid = min(strip, nbx - s * strip) * bw * 3
            for q in range(12):
                if q * 16 >= valid:
                    continue
                k = 192 * s + q * 16 + np.arange(min(16, valid - q * 16))
                for yo in rows:
                    written[yo, k] += 1
    assert (written == 1).all()


SQ_BLOCKS = [4, 16, "4x8", "8x4", "4x16", "16x4", "8x16", "16x8"]
# K2's and K1's templated kernels also take the blocks with a side of 2
# and those with a side of 1
SIDE_1_BLOCKS = [1, "1x2", "2x1", "1x4", "4x1", "1x8", "8x1", "1x16", "16x1"]
K12_BLOCKS = SQ_BLOCKS + [2, "2x4", "4x2", "2x8", "8x2", "2x16",
                          "16x2"] + SIDE_1_BLOCKS


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_k1_sq_grid_fills_the_card(block):
    # at T = 8 at 1080p: two waves at the CTAs per SM that the kernel's
    # shared memory allows; one CTA's shared memory fits (with the opt-in)
    bh, bw = _hw(block)
    nbx = 1920 // bw
    _, _, _, _, band_b, band_rows = _k1_tables(1080, 1088, nbx, 8, bh, bw)
    strips = -(-nbx // (dct._K1_SQ_STRIP_PIXELS // bw))
    ctas_per_sm = dct._K1_SQ_GEOM[bh, bw][2]
    assert 8 * strips * len(band_b) >= 2 * ctas_per_sm * SMS
    smem = dct._k1_sq_smem_bytes(bh, bw)
    assert smem <= CTA_SMEM_BYTES
    assert ctas_per_sm * (smem + 1024) <= SM_SMEM_BYTES


def _geom(path):
    """``{key: {name: value}}`` of a templated kernel source's SqGeom
    specialisations (key ``B`` of ``SqGeom<B>``, ``(BH, BW)`` of
    ``SqGeom<BH, BW>``), and its file-scope ``constexpr int`` constants."""
    src = (build.CSRC_DIR / path).read_text()
    geom = {(int(b) if not bw else (int(b), int(bw))):
            dict((n, int(v)) for n, v in re.findall(r"(k\w+) = (\d+)", body))
            for b, bw, body in re.findall(
                r"struct SqGeom<(\d+)(?:, (\d+))?> \{([^}]*)\}", src)}
    consts = {n: int(v) for n, v in re.findall(r"^constexpr int (k\w+) = (\d+);",
                                               src, re.M)}
    return geom, consts, src


def test_sq_host_geometry_matches_the_kernel_sources():
    # the strips, paddings, walk steps, CTAs per SM and shared memory that
    # the wrappers plan with are those csrc/dct_wire_sq.cu and
    # csrc/idct_display_sq.cu are compiled with, at every (BH, BW) key
    geom, k, src = _geom("idct_display_sq.cu")
    assert sorted(geom) == sorted(dct._TEMPLATED_SHAPES) == sorted(dct._K1_SQ_GEOM)
    assert k["kStripPixels"] == dct._K1_SQ_STRIP_PIXELS
    assert k["kMaxBandRows"] == max(dct._K1_BAND_ROWS)
    ring_pitch = k["kStripPixels"] * 3 // 16 * 20 + 4
    for (bh, bw), g in geom.items():
        assert f"SVC_IDCT_SQ_ENTRY({bh}, {bw})" in src
        assert (g["kCoefPitch"], g["kCoefGroup"], g["kMinCtas"],
                g["kStep"]) == dct._K1_SQ_GEOM[bh, bw]
        # a step of one block row, or 8 pixel rows where a side is 1 or 2
        # (16 at 16x2 and 16x1)
        rows = bh * g["kStep"]
        assert rows == (max(bh, 8) if {1, 2} & {bh, bw} else bh)
        strip = k["kStripPixels"] // bw
        assert strip * 3 * bw == k["kThreads"]
        assert g["kCoefGroup"] >= rows * g["kCoefPitch"]
        if bw == 1:
            # a pair's S rows are one contiguous slot column, read at once:
            # as float4s at a pair stride of an odd multiple of 4 (a
            # quarter-warp's 8 pairs on 8 bank groups), else as floats at
            # an odd one (a warp's 32 pairs on 32 banks)
            assert g["kCoefPitch"] == 1
            assert g["kCoefGroup"] % 2 == 1 or g["kCoefGroup"] % 8 == 4
        else:
            # 16-byte rows: cp.async chunks and the row stage's float4
            # loads; at BW = 2 a chunk is two rows, so the rows are
            # contiguous (and at 1x2 the float2 loads of a row aligned)
            assert g["kCoefPitch"] % 4 == 0 or g["kCoefPitch"] == bw == 2
            assert g["kCoefGroup"] % 4 == 0
        smem = dct._k1_sq_smem_bytes(bh, bw)
        assert smem == 4 * (
            2 * strip * 3 * g["kCoefGroup"] + 2 * rows * ring_pitch
            + 2 * g["kStep"] * strip + 3 * k["kMaxBandRows"])
        assert g["kMinCtas"] * (smem + 1024) <= SM_SMEM_BYTES
    geom, k, src = _geom("dct_wire_sq.cu")
    assert sorted(geom) == sorted(dct._TEMPLATED_SHAPES) == sorted(dct._K2_SQ_GEOM)
    assert k["kStripPixels"] == dct._K2_SQ_STRIP_PIXELS
    for (bh, bw), g in geom.items():
        assert f"SVC_DCT_SQ_ENTRY({bh}, {bw})" in src
        assert (g["kAPitch"], g["kAGroup"], g["kStep"]) == dct._K2_SQ_GEOM[bh, bw]
        # a CTA takes the block rows of K1's walk step
        assert g["kStep"] == dct._K1_SQ_GEOM[bh, bw][3]
        rows = bh * g["kStep"]
        groups = k["kStripPixels"] // bw * 3
        assert groups * bw == k["kThreads"]
        assert g["kAGroup"] >= rows * g["kAPitch"]
        assert dct._k2_sq_smem_bytes(bh, bw) == (
            groups * g["kAGroup"] * 8 + rows * k["kStripPixels"] * 3)
        # with the opt-in, the CTAs per SM the launch bounds ask for fit
        assert g["kMinCtas"] * (dct._k2_sq_smem_bytes(bh, bw) + 1024) <= SM_SMEM_BYTES


def _row_stage(bh, bw, lanes, rows=None):
    """Per step s of a templated kernel's row stage (K2's stage 2, K1's
    rows), the pair, row and first column each lane of ``lanes`` (a
    CTA's threads) transforms, over a pair's ``rows`` rows (``bh``; a
    CTA's or a walk step's pixel rows where a side is 2): at rows >= BW
    rows q + s * BW of pair g (lane = g * BW + q), all columns; at rows <
    BW, the threads in BW / rows parts, lane u of part p columns [p *
    rows, p * rows + rows) of row u % rows of pair u // rows."""
    rows = bh if rows is None else rows
    if rows >= bw:
        g, q = lanes // bw, lanes % bw
        return [(g, q + s * bw, 0 * lanes) for s in range(rows // bw)]
    part = len(lanes) // (bw // rows)
    p, u = lanes // part, lanes % part
    return [(u // rows, u % rows, p * rows)]


def _worst_conflict(addr, phase, banks):
    """The most distinct addresses of one phase (``phase`` lanes) that
    share a bank (of ``banks``); 1 is conflict-free (equal addresses
    broadcast)."""
    worst = 1
    for h in range(0, len(addr), phase):
        distinct = np.unique(addr[h:h + phase])
        worst = max(worst, int(np.bincount(distinct % banks).max()))
    return worst


# the layouts with a conflict: K1 at 16x4 trades one for occupancy, 2-way
# on its row stage's float4 loads (3 CTAs an SM instead of 2); at 4x8 no
# padding frees both stages, and the row stage's loads (K2's stage 2, K1's
# float4 loads) keep a 2-way conflict; at BW = 2 K1's 16-byte chunks span
# two rows, so its pair stride is a multiple of 4 and the column stage's
# 16 pairs a warp fall on 8 bank offsets, 2-way
K1_ROW_CONFLICTS = {(16, 4): 2, (4, 8): 2}
K1_COLUMN_CONFLICTS = {(2, 2): 2, (4, 2): 2, (8, 2): 2, (16, 2): 2, (1, 2): 2}
K2_ROW_CONFLICTS = {(4, 8): 2}


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_sq_layouts_avoid_bank_conflicts(block):
    # shared memory has 32 banks of 4 bytes; a warp's 8-byte accesses go in
    # half-warps, its 16-byte ones in quarter-warps, and a phase is free of
    # conflicts when its distinct addresses fall on distinct banks; a CTA's
    # (K2) or a walk step's (K1) block rows stand as the rows of one block
    # of their pixel rows
    bh, bw = _hw(block)
    lanes = np.arange(384)
    group, r = lanes // bw, lanes % bw
    a_pitch, a_group, step = dct._K2_SQ_GEOM[bh, bw]
    for fixed in range(bh * step):  # K2, doubles: stage 1 stores
        addr = group * a_group + fixed * a_pitch + r
        assert _worst_conflict(addr, 16, 16) == 1
    for pair, row, _ in _row_stage(bh, bw, lanes, bh * step):  # stage 2
        for j in range(bw):
            addr = pair * a_group + row * a_pitch + j
            assert _worst_conflict(addr, 16, 16) == K2_ROW_CONFLICTS.get((bh, bw), 1)
    lanes = np.arange(192)
    group, r = lanes // bw, lanes % bw
    pitch, c_group, _, step = dct._K1_SQ_GEOM[bh, bw]
    if bw == 1:
        # both stages read and write a pair's column at once: float4s in
        # quarter-warps, or floats a warp at once
        for i in range(0, bh * step, 4 if c_group % 4 == 0 else 1):
            if c_group % 4 == 0:
                assert _worst_conflict((group * c_group + i) // 4, 8, 8) == 1
            else:
                assert _worst_conflict(group * c_group + i, 32, 32) == 1
        return
    for fixed in range(bh * step):  # K1, floats: the column stage
        addr = group * c_group + fixed * pitch + r
        assert _worst_conflict(addr, 32, 32) == K1_COLUMN_CONFLICTS.get((bh, bw), 1)
    for pair, row, _ in _row_stage(bh, bw, lanes, bh * step):  # K1: rows
        if bw == 2:  # float2s, in half-warps
            addr = (pair * c_group + row * pitch) // 2
            assert _worst_conflict(addr, 16, 16) == 1
        for q in range(bw // 4):  # float4s
            addr = (pair * c_group + row * pitch + 4 * q) // 4
            assert _worst_conflict(addr, 8, 8) == K1_ROW_CONFLICTS.get((bh, bw), 1)


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_sq_row_stage_covers_every_coefficient_once(block):
    # K2's stage 2 (384 threads) and K1's row stage (192): the threads'
    # outputs each cover every (pair, row, column) of the strip's block
    # rows (those of a CTA or a walk step) once; at fewer rows than BW a
    # part is whole warps (K2; K1 but at 4x16, where two warps hold two
    # parts), so its columns are the same across a warp
    bh, bw = _hw(block)
    for threads, step in ((384, dct._K2_SQ_GEOM[bh, bw][2]),
                          (192, dct._K1_SQ_GEOM[bh, bw][3])):
        lanes = np.arange(threads)
        rows = bh * step
        hits = np.zeros((threads // bw, rows, bw), np.int64)
        for pair, row, col0 in _row_stage(bh, bw, lanes, rows):
            for m in range(min(rows, bw)):
                np.add.at(hits, (pair, row, col0 + m), 1)
            warps = col0.reshape(-1, 32)
            uniform = (warps == warps[:, :1]).all(axis=1)
            if threads == 384 or (bh, bw) != (4, 16):
                assert uniform.all()
            else:
                assert uniform.sum() == 4
        assert (hits == 1).all()


@pytest.mark.parametrize("block", SIDE_1_BLOCKS)
def test_k2_side_1_stores_write_every_coefficient_once(block):
    # K2's stage 2 at a side of 1 stores in place from registers: thread
    # (g, r) holds rows r + s * BW of its pair (kRowsCta >= BW; BW floats
    # each), and its s-th piece of kN floats (BH at BW = 1, BW at BH = 1)
    # lands at float g * BH * BW of block row m's run (m = s at BW = 1,
    # r + s * BW at BH = 1); at 1x16 (8 rows < 16 columns) lane u of part
    # p holds columns [8 p, 8 p + 8) of row u % 8 of pair u // 8, stored
    # at block row u % 8. Every coefficient of the CTA's block rows is
    # written once, at its wire place, each piece aligned for its
    # float4 / float2 / float store
    bh, bw = _hw(block)
    _, _, step = dct._K2_SQ_GEOM[bh, bw]
    rows = bh * step
    lanes = np.arange(384)
    pairs = 384 // bw
    run = pairs * bh * bw  # floats of a block row's run

    def wire(pair, i, col):  # (pair, CTA row i, column) -> run place
        return (i // bh) * run + pair * bh * bw + (i % bh) * bw + col

    hits = np.zeros(step * run, np.int64)
    if rows >= bw:
        g, r = lanes // bw, lanes % bw
        n_piece = bh if bw == 1 else bw
        for s in range(rows // n_piece):
            m = s if bw == 1 else r + s * bw
            start = m * run + g * bh * bw
            assert (start % min(n_piece, 4) == 0).all()
            for n in range(n_piece):
                j = s * n_piece + n  # z[j]: row r + (j // bw) * bw, col j % bw
                want = wire(g, r + (j // bw) * bw, j % bw)
                np.testing.assert_array_equal(start + n, want)
                np.add.at(hits, start + n, 1)
    else:
        cols = rows
        part = 384 // (bw // rows)
        p, u = lanes // part, lanes % part
        g2, i = u // rows, u % rows
        start = wire(g2, i, p * cols)
        assert (start % 4 == 0).all()
        for n in range(cols):
            np.add.at(hits, start + n, 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("block", SIDE_1_BLOCKS)
def test_k1_side_1_fetch_fills_the_slot(block):
    # at a side of 1, K1's slot fetch (fetch_side_1) copies a walk step's
    # runs in one pass, kW floats a copy (:func:`_side_1_fetch_hits`):
    # every float of the step's runs lands once, at the slot place of its
    # (pair, row, column) that the column and row stages read, inside its
    # pair's group; copies are aligned to their size, and a copy
    # instruction's phase meets a bank at most twice
    bh, bw = _hw(block)
    pitch, group, _, step = dct._K1_SQ_GEOM[bh, bw]
    pairs = 192 // bw  # a strip's 64 / BW blocks x 3 channels
    seen = _side_1_fetch_hits(bh, bw, pitch, group, step, pairs)
    assert seen.max() == 1 and seen.sum() == step * pairs * bh * bw


@pytest.mark.parametrize("block,out_h,in_h,nbx,t", [
    (4, 120, 128, 20, 2), (4, 128, 128, 16, 1), (4, 37, 40, 3, 1),
    (16, 120, 128, 5, 2), (16, 112, 112, 4, 1), (16, 37, 48, 3, 1),
    ("4x8", 120, 128, 10, 2), ("8x4", 120, 128, 20, 1),
    ("4x16", 37, 40, 3, 1), ("16x4", 120, 128, 20, 2),
    ("8x16", 112, 112, 5, 1), ("16x8", 37, 48, 9, 1),
    (2, 120, 128, 40, 2), (2, 37, 42, 9, 1), ("2x4", 120, 128, 20, 1),
    ("4x2", 37, 44, 41, 1), ("2x8", 112, 112, 10, 1), ("8x2", 120, 128, 40, 2),
    ("2x16", 35, 38, 3, 1), ("16x2", 37, 48, 33, 1),
    (1, 120, 128, 40, 2), (1, 37, 45, 9, 1), ("1x2", 120, 128, 20, 1),
    ("2x1", 37, 42, 41, 1), ("1x4", 112, 112, 10, 1), ("4x1", 37, 44, 33, 1),
    ("1x8", 120, 128, 5, 2), ("8x1", 120, 128, 40, 1), ("1x16", 35, 37, 3, 1),
    ("16x1", 37, 48, 33, 1)])
def test_k1_sq_band_walk_reproduces_plain_bytes(block, out_h, in_h, nbx, t):
    # the templated kernel's walk, replayed on the plain version's planes
    # with the kernel's per-element blend, gives the plain bytes
    bh, bw = _hw(block)
    rng = np.random.default_rng(out_h + nbx + bh + bw)
    n = 3 * bh * bw
    coeffs = torch.from_numpy(
        (rng.normal(size=(t, in_h // bh, nbx, n)) * 90).astype(np.float32))
    steps = torch.from_numpy(
        rng.choice([1.0, 640.0], size=(t, in_h // bh, nbx)).astype(np.float32))
    planes = dct.idct_planes_plain(coeffs, steps, 3, bh, bw)
    y0, y1, fy, *_ = _k1_tables(out_h, in_h, nbx, t, bh, bw)
    rows = torch.full((t, 3, out_h, nbx * bw), float("nan"))
    for _, _, emit, _ in _walk(out_h, in_h, nbx, t, bh, bw):
        for yo in emit:
            v = planes[:, :, y0[yo]]
            if fy[yo] != 0:
                f = torch.tensor(fy[yo])
                v = v * (1 - f) + planes[:, :, y1[yo]] * f
            rows[:, :, yo] = v
    got = dct.display_bytes(rows)
    want = dct.idct_display_plain(coeffs, steps, out_h, 3, bh, bw)
    assert torch.equal(got, want)


# (display width, display height, padded width, padded height): 1366x768
# and 854x480 (width excess, identity rows), 1270x714 (both axes
# resampled), and two small frames
K6_GEOMETRIES = [(1366, 768, 1376, 768), (854, 480, 864, 480),
                 (1270, 714, 1280, 720), (120, 64, 128, 64), (200, 120, 208, 128)]
K6_RING_WIDTH = 9 * 24  # floats of a ring row: 8 blocks and the halo


def _k6_walk(out_w, out_h, pw, ph, t):
    """Replay K6's walk: per (band, strip), the block rows it transforms
    and, after each, the output rows and the bytes of its strip it emits,
    with the ring rows held at that moment."""
    *_, band_b, band_rows = dct._band_tables(out_h, ph, pw // 8, t, SMS,
                                             dct._K6_CTAS_PER_SM)
    row_lo = dct._band_tables(out_h, ph, pw // 8, t, SMS, dct._K6_CTAS_PER_SM)[3]
    strip_lo = dct._strip_tables(out_w, pw)[2]
    for band, (b_first, b_last) in enumerate(band_b):
        yb0, yb1 = band * band_rows, min(out_h, (band + 1) * band_rows)
        for s in range(len(strip_lo) - 1):
            for b in range(b_first, b_last + 1):
                ring = set(range(max(8 * b_first, 8 * (b - 1)), 8 * b + 8))
                rows = range(max(yb0, row_lo[b]), min(yb1, row_lo[b + 1]))
                yield band, s, b, rows, ring


@pytest.mark.parametrize("out_w,out_h,pw,ph", K6_GEOMETRIES)
def test_k6_walk_reads_inside_its_ring_and_window(out_w, out_h, pw, ph):
    # every y0 / y1 an output row reads is in the ring when the row is
    # emitted; every x0 / x1 an output byte reads lies in the strip's 9
    # transformed block columns, at the ring position the tables give
    y0, y1, fy, *_ = dct._band_tables(out_h, ph, pw // 8, 8, SMS,
                                      dct._K6_CTAS_PER_SM)
    x0, x1, fx, _ = dct.bilinear_axis_weights(out_w, pw)
    col_e, col_f, strip_lo = dct._strip_tables(out_w, pw)
    for _, _, _, rows, ring in _k6_walk(out_w, out_h, pw, ph, 8):
        for yo in rows:
            assert y0[yo] in ring
            if fy[yo] != 0:
                assert y1[yo] in ring
    nbx = pw // 8
    for s in range(len(strip_lo) - 1):
        blocks = range(8 * s, min(nbx, 8 * s + 9))  # those the CTA transforms
        for byte in range(strip_lo[s], strip_lo[s + 1]):
            xo, c = divmod(byte, 3)
            assert x0[xo] // 8 in blocks and x0[xo] // 64 == s
            assert col_e[byte] == 3 * (x0[xo] - 64 * s) + c
            assert col_f[byte] == fx[xo]
            if fx[xo] != 0:
                assert x1[xo] == x0[xo] + 1 and x1[xo] // 8 in blocks
                assert col_e[byte] + 3 < K6_RING_WIDTH


@pytest.mark.parametrize("out_w,out_h,pw,ph", K6_GEOMETRIES)
def test_k6_every_output_byte_written_once(out_w, out_h, pw, ph):
    # the strips split each display row into runs of at most 192 bytes, and
    # the walk's emit loop (per block row: thread k < nbytes writes byte k
    # of the strip's run in rows [ya, yz)) writes every byte of the frame
    # exactly once
    _, _, strip_lo = dct._strip_tables(out_w, pw)
    assert strip_lo[0] == 0 and strip_lo[-1] == 3 * out_w
    assert (np.diff(strip_lo) >= 0).all()
    assert np.diff(strip_lo).max() <= dct._K6_STRIP_BYTES
    assert len(strip_lo) - 1 == -(-(pw // 8) // dct._K6_STRIP)
    row_bytes = 3 * out_w
    written = np.zeros(out_h * row_bytes, np.int64)
    for _, s, _, rows, _ in _k6_walk(out_w, out_h, pw, ph, 1):
        k = np.arange(strip_lo[s], strip_lo[s + 1])
        for yo in rows:
            written[yo * row_bytes + k] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("out_w,out_h,pw,ph", K6_GEOMETRIES)
def test_k6_grid_fills_the_card(out_w, out_h, pw, ph):
    # at T = 8: at least 2 CTAs per SM, and two waves at the CTAs per SM
    # that the kernel's shared memory allows; one CTA's shared memory fits
    # without the opt-in
    *_, band_b, band_rows = dct._band_tables(out_h, ph, pw // 8, 8, SMS,
                                             dct._K6_CTAS_PER_SM)
    ctas = 8 * -(-(pw // 8) // dct._K6_STRIP) * len(band_b)
    if out_w >= 854:
        assert ctas >= 2 * SMS
    assert dct._K6_SMEM_BYTES <= 48 * 1024
    assert dct._K6_CTAS_PER_SM * (dct._K6_SMEM_BYTES + 1024) <= SM_SMEM_BYTES
    assert (dct._K6_CTAS_PER_SM + 1) * (dct._K6_SMEM_BYTES + 1024) > SM_SMEM_BYTES
    if band_rows != dct._K1_BAND_ROWS[-1]:
        assert ctas >= 2 * dct._K6_CTAS_PER_SM * SMS


def test_k6_host_geometry_matches_the_kernel_source():
    # the strip width, tallest band, strip bytes, CTAs per SM and shared
    # memory that the wrapper plans with are those csrc/idct_resize.cu is
    # compiled with
    src = (build.CSRC_DIR / "idct_resize.cu").read_text()
    shared = (build.CSRC_DIR / "idct8x8.cuh").read_text()
    k = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                          src + shared)}
    assert k["kStrip"] == dct._K6_STRIP
    assert k["kMaxBandRows"] == max(dct._K1_BAND_ROWS)
    (threads, ctas) = re.findall(r"constexpr int kThreads = (\d+);.*?"
                                 r"__launch_bounds__\(kThreads, (\d+)\)", src,
                                 re.S)[0]
    assert int(ctas) == dct._K6_CTAS_PER_SM
    blocks = k["kStrip"] + 1
    assert int(threads) >= blocks * 3 * 8
    ring_pitch = blocks * 24 + 4
    assert dct._K6_STRIP_BYTES == k["kStrip"] * 8 * 3
    assert dct._K6_STRIP_BYTES <= int(threads)  # a thread per byte
    assert dct._K6_SMEM_BYTES == 4 * (
        2 * blocks * 3 * k["kCoefGroup"] + k["kRingRows"] * ring_pitch
        + 2 * blocks + 3 * k["kMaxBandRows"])


@pytest.mark.parametrize("out_w,out_h,pw,ph,t", [(120, 64, 128, 64, 2),
                                                 (200, 120, 208, 128, 1),
                                                 (854, 40, 864, 48, 1),
                                                 (61, 37, 64, 40, 1)])
def test_k6_walk_reproduces_plain_bytes(out_w, out_h, pw, ph, t):
    # the kernel's walk, replayed on the plain version's planes through a
    # 16-row ring of 9 blocks a strip, with the tables' ring positions and
    # the kernel's per-element blends, gives the plain version's bytes
    rng = np.random.default_rng(out_w + out_h)
    nby, nbx = ph // 8, pw // 8
    coeffs = torch.from_numpy(
        (rng.normal(size=(t, nby, nbx, 192)) * 90).astype(np.float32))
    steps = torch.from_numpy(
        rng.choice([1.0, 640.0], size=(t, nby, nbx)).astype(np.float32))
    planes = dct.idct_planes_plain(coeffs, steps, 3, 8, 8)
    # interleaved pixels, 9 blocks past each strip's start (zero past nbx)
    pix = torch.nn.functional.pad(planes.permute(0, 2, 3, 1), (0, 0, 0, 72))
    y0, y1, fy, *_ = dct._band_tables(out_h, ph, nbx, t, SMS, dct._K6_CTAS_PER_SM)
    col_e, col_f, strip_lo = dct._strip_tables(out_w, pw)
    out = torch.full((t, out_h, 3 * out_w), float("nan"))
    ring = torch.full((t, 16, K6_RING_WIDTH), float("nan"))
    for _, s, b, rows, _ in _k6_walk(out_w, out_h, pw, ph, t):
        ring[:, (8 * b) % 16:(8 * b) % 16 + 8] = pix[
            :, 8 * b:8 * b + 8, 64 * s:64 * s + 72].reshape(t, 8, -1)
        k = torch.arange(strip_lo[s], strip_lo[s + 1])
        e = torch.from_numpy(col_e[k.numpy()]).long()
        g = torch.from_numpy(col_f[k.numpy()])
        for yo in rows:
            top, bot, f = ring[:, y0[yo] % 16], ring[:, y1[yo] % 16], fy[yo]
            v, w = top[:, e], top[:, (e + 3).clamp(max=K6_RING_WIDTH - 1)]
            if f != 0:
                f = torch.tensor(f)
                v = v * (1 - f) + bot[:, e] * f
                w = w * (1 - f) + bot[:, (e + 3).clamp(max=K6_RING_WIDTH - 1)] * f
            out[:, yo, k] = torch.where(g != 0, v * (1 - g) + w * g, v)
    got = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    want = dct.idct_resize_display_plain(coeffs, steps, out_h, out_w, 3, 8, 8)
    assert torch.equal(got, want)


def _strip_tables_before(out_w, in_w):
    """``_strip_tables`` as it was before it took the block size and the
    strip (strips of 8 block columns of 8 pixels): K6's 8x8 tables must
    stay exactly these."""
    x0, _, fx, _ = dct.bilinear_axis_weights(out_w, in_w)
    strip = x0 // 64
    lo = np.searchsorted(strip, np.arange(-(-in_w // 64) + 1))
    byte = np.arange(3 * out_w)
    col_e = 3 * (x0[byte // 3] - 64 * strip[byte // 3]) + byte % 3
    return (col_e.astype(np.int32), fx[byte // 3].astype(np.float32),
            (3 * lo).astype(np.int32))


@pytest.mark.parametrize("out_w,out_h,pw,ph", K6_GEOMETRIES + [(61, 37, 64, 40)])
def test_strip_tables_at_block_8_unchanged(out_w, out_h, pw, ph):
    # K6's 8x8 strip tables are exactly those before the block size and the
    # strip became parameters, by default and given explicitly; every
    # square-block kernel's strip spans the same 64 pixels, so its tables
    # are these too
    want = _strip_tables_before(out_w, pw)
    for got in (dct._strip_tables(out_w, pw), dct._strip_tables(out_w, pw, 8, 8),
                dct._strip_tables(out_w, pw, 4, 16),
                dct._strip_tables(out_w, pw, 16, 4)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# K6's templated kernels: every K6 geometry at each block shape (1376
# pixels are 21.5 strips of 64: the last strip's block columns end
# mid-strip, without its halo block; 714 rows end a step of 8 mid-step)
K6_SQ_CASES = [(b, *g) for b in K12_BLOCKS for g in K6_GEOMETRIES]


def _k6_step_rows(block):
    """The pixel rows of a walk step of K6's templated kernel: K1's, the
    block height or 8 where a side is 1 or 2 (16 at 16x2 and 16x1)."""
    return dct._k1_sq_step_rows(*_hw(block))


def _k6_sq_tables(block, out_w, out_h, pw, ph, t):
    """K6's templated kernel's band tables (rows in walk steps) and strip
    tables (block columns of BW pixels) for ``block``."""
    bh, bw = _hw(block)
    strip = dct._K6_SQ_STRIP_PIXELS // bw
    rows = dct._band_tables(out_h, ph, pw // bw, t, SMS,
                            dct._K6_SQ_GEOM[bh, bw][5], _k6_step_rows(block),
                            strip)
    return rows, dct._strip_tables(out_w, pw, bw, strip)


def _k6_sq_ring_width(block):
    """Floats of the pixels of a ring row: the strip's 64 pixel columns and
    the halo block's first columns (all BW at BW = 1, 2, 4 and 8, column 0
    at BW = 16), interleaved."""
    return (dct._K6_SQ_STRIP_PIXELS + dct._K6_SQ_GEOM[_hw(block)][2]) * 3


def _k6_sq_walk(block, out_w, out_h, pw, ph, t):
    """Replay the templated K6's walk: per (band, strip), the walk steps
    (S pixel rows each) it transforms and, after each, the output rows it
    emits, with the source rows its ring of S + 1 rows holds at that
    moment (the current step and the previous one's last row)."""
    step = _k6_step_rows(block)
    (*_, row_lo, band_b, band_rows), (_, _, strip_lo) = _k6_sq_tables(
        block, out_w, out_h, pw, ph, t)
    for band, (b_first, b_last) in enumerate(band_b):
        yb0, yb1 = band * band_rows, min(out_h, (band + 1) * band_rows)
        for s in range(len(strip_lo) - 1):
            for b in range(b_first, b_last + 1):
                ring = set(range(max(step * b_first, step * b - 1),
                                 min(ph, step * b + step)))
                rows = range(max(yb0, row_lo[b]), min(yb1, row_lo[b + 1]))
                yield band, s, b, rows, ring


@pytest.mark.parametrize("block,out_w,out_h,pw,ph", K6_SQ_CASES)
def test_k6_sq_walk_reads_inside_its_ring_and_window(block, out_w, out_h, pw,
                                                     ph):
    # every y0 / y1 an output row reads is in the ring of S + 1 rows (S a
    # walk step's) when the row is emitted, each row once per strip by its
    # own band, and a band walks its own steps plus at most one halo step;
    # every x0 / x1 an output byte reads lies in the strip's block columns
    # or column 0 of its halo block, at the ring position the tables give
    bh, bw = _hw(block)
    step = _k6_step_rows(block)
    (y0, y1, fy, _, band_b, band_rows), (col_e, col_f, strip_lo) = (
        _k6_sq_tables(block, out_w, out_h, pw, ph, 8))
    assert band_rows <= 128  # the kernel's kMaxBandRows
    emitted = np.zeros(out_h, np.int64)
    for band, s, b, rows, ring in _k6_sq_walk(block, out_w, out_h, pw, ph, 8):
        assert 0 <= b < -(-ph // step)
        for yo in rows:
            assert band * band_rows <= yo < (band + 1) * band_rows
            assert y0[yo] in ring
            if fy[yo] != 0:
                assert y1[yo] in ring
            emitted[yo] += s == 0
    assert (emitted == 1).all()
    walked = band_b[:, 1] - band_b[:, 0] + 1
    assert walked.max() <= -(-band_rows // step) + 2
    x0, x1, fx, _ = dct.bilinear_axis_weights(out_w, pw)
    strip, nbx = dct._K6_SQ_STRIP_PIXELS // bw, pw // bw
    for s in range(len(strip_lo) - 1):
        blocks = range(strip * s, min(nbx, strip * s + strip + 1))
        for byte in range(strip_lo[s], strip_lo[s + 1]):
            xo, c = divmod(byte, 3)
            assert x0[xo] // bw in blocks and x0[xo] // 64 == s
            assert col_e[byte] == 3 * (x0[xo] - 64 * s) + c
            assert col_f[byte] == fx[xo]
            if fx[xo] != 0:
                assert x1[xo] == x0[xo] + 1 and x1[xo] // bw in blocks
                # in the ring: the halo block is read at its column 0 only
                assert x1[xo] - 64 * s <= 64
                assert col_e[byte] + 3 < _k6_sq_ring_width(block)


@pytest.mark.parametrize("block,out_w,out_h,pw,ph", K6_SQ_CASES)
def test_k6_sq_every_output_byte_written_once(block, out_w, out_h, pw, ph):
    # the strips split each display row into runs of at most 192 bytes (a
    # thread each), one strip per CTA column of the grid, and the walk's
    # emit loop writes every byte of the frame exactly once
    _, bw = _hw(block)
    _, (_, _, strip_lo) = _k6_sq_tables(block, out_w, out_h, pw, ph, 1)
    assert strip_lo[0] == 0 and strip_lo[-1] == 3 * out_w
    assert (np.diff(strip_lo) >= 0).all()
    assert np.diff(strip_lo).max() <= dct._K6_SQ_STRIP_PIXELS * 3
    strip = dct._K6_SQ_STRIP_PIXELS // bw
    assert len(strip_lo) - 1 == -(-(pw // bw) // strip)  # the grid's x
    row_bytes = 3 * out_w
    written = np.zeros(out_h * row_bytes, np.int64)
    for _, s, _, rows, _ in _k6_sq_walk(block, out_w, out_h, pw, ph, 1):
        k = np.arange(strip_lo[s], strip_lo[s + 1])
        for yo in rows:
            written[yo * row_bytes + k] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("block", K12_BLOCKS)
@pytest.mark.parametrize("out_w,out_h,pw,ph", K6_GEOMETRIES[:3])
def test_k6_sq_grid_fills_the_card(block, out_w, out_h, pw, ph):
    # at T = 8: at least 2 CTAs per SM, and two waves at the CTAs per SM
    # that the kernel's shared memory and threads allow; one CTA's shared
    # memory fits (with the opt-in past 48 KB)
    bh, bw = _hw(block)
    (*_, band_b, band_rows), _ = _k6_sq_tables(block, out_w, out_h, pw, ph, 8)
    strip = dct._K6_SQ_STRIP_PIXELS // bw
    ctas = 8 * -(-(pw // bw) // strip) * len(band_b)
    *_, threads, ctas_per_sm = dct._K6_SQ_GEOM[bh, bw]
    assert ctas >= 2 * SMS
    if band_rows != dct._K1_BAND_ROWS[-1]:
        assert ctas >= 2 * ctas_per_sm * SMS
    smem = dct._k6_sq_smem_bytes(bh, bw)
    assert smem <= CTA_SMEM_BYTES
    assert ctas_per_sm * (smem + 1024) <= SM_SMEM_BYTES
    assert ctas_per_sm * threads <= 2048


def _k6_row_stage(bh, bw, threads):
    """Per step s of the templated K6's row stage over a walk step's S
    rows of a pair, the pair (-1 where the lane forms no row), row and
    first column of each of the CTA's ``threads`` lanes: at S >= BW rows q
    + s * BW of pair g (lane = g * BW + q), all columns (at BW = 1 lane g
    its pair's S rows); at S < BW the lanes in BW / S parts of whole warps
    (kPart lanes: the pairs' rows rounded up to warps), lane u of part p
    columns [p * S, p * S + S) of row u % S of pair u // S."""
    groups = (dct._K6_SQ_STRIP_PIXELS // bw + 1) * 3
    rows = dct._k1_sq_step_rows(bh, bw)
    lanes = np.arange(threads)
    if rows >= bw:
        g = np.where(lanes // bw < groups, lanes // bw, -1)
        return [(g, lanes % bw + s * bw, 0 * lanes) for s in range(rows // bw)]
    part = -(-groups * rows // 32) * 32
    p, u = lanes // part, lanes % part
    g = np.where((u // rows < groups) & (p < bw // rows), u // rows, -1)
    return [(g, u % rows, p * rows)]


def test_k6_sq_host_geometry_matches_the_kernel_source():
    # the strip, tallest band, slot padding, halo columns, ring pitch,
    # threads, CTAs per SM, walk steps and shared memory that the wrapper
    # plans with are those csrc/idct_resize_sq.cu is compiled with, at
    # every (BH, BW) key; its slots and steps are K1's at each shape
    geom, k, src = _geom("idct_resize_sq.cu")
    assert sorted(geom) == sorted(dct._TEMPLATED_SHAPES) == sorted(
        dct._K6_SQ_GEOM)
    assert k["kStripPixels"] == dct._K6_SQ_STRIP_PIXELS
    assert k["kMaxBandRows"] == max(dct._K1_BAND_ROWS)
    assert re.search(r"__launch_bounds__\(SqGeom<BH, BW>::kThreads,\s+"
                     r"SqGeom<BH, BW>::kMinCtas\)", src)
    assert re.search(r"kRingRows = kRowsStep \+ 1;", src)
    assert re.search(r"kRowsStep = kStep \* BH;", src)
    assert re.search(r"kSlot =\s+\(kGroups \* SqGeom<BH, BW>::kCoefGroup \+ 3\) "
                     r"/ 4 \* 4;", src)
    for (bh, bw), g in geom.items():
        assert f"SVC_IDCT_SQ_RESIZE_ENTRY({bh}, {bw})" in src
        assert (g["kCoefPitch"], g["kCoefGroup"], g["kHaloColumns"],
                g["kRingPitch"], g["kThreads"], g["kMinCtas"]) == (
                    dct._K6_SQ_GEOM[bh, bw])
        # K1's slot layout, but 16x1's pairs packed at 16 floats (5 CTAs
        # an SM where K1's 20 allow 4)
        if (bh, bw) == (16, 1):
            assert (g["kCoefPitch"], g["kCoefGroup"]) == (1, 16)
        else:
            assert dct._K6_SQ_GEOM[bh, bw][:2] == dct._K1_SQ_GEOM[bh, bw][:2]
        assert g["kStep"] == dct._K1_SQ_GEOM[bh, bw][3]
        rows = bh * g["kStep"]  # a walk step's pixel rows
        assert rows == _k6_step_rows((bh, bw))
        # the whole halo block at BW = 1, 2, 4 and 8, its column 0 at 16
        assert g["kHaloColumns"] == (1 if bw == 16 else bw)
        assert g["kRingPitch"] >= _k6_sq_ring_width((bh, bw))
        blocks = k["kStripPixels"] // bw + 1
        assert blocks * 3 * bw <= g["kThreads"]  # a thread per pair column
        stage = _k6_row_stage(bh, bw, g["kThreads"])
        assert all(len(pair) == g["kThreads"] for pair, _, _ in stage)
        assert k["kStripPixels"] * 3 <= g["kThreads"]  # a thread per byte
        assert g["kThreads"] % 32 == 0
        # the least whole warps that hold the column stage and the parts
        assert g["kThreads"] - 32 < max(
            blocks * 3 * bw, bw // min(rows, bw) * -(-blocks * 3 * min(rows, bw)
                                                    // 32) * 32)
        assert g["kCoefGroup"] >= rows * g["kCoefPitch"]
        slot = -(-blocks * 3 * g["kCoefGroup"] // 4) * 4  # whole 16 bytes
        smem = dct._k6_sq_smem_bytes(bh, bw)
        assert smem == 4 * (2 * (slot + g["kStep"] * blocks)
                            + (rows + 1) * g["kRingPitch"]
                            + 3 * k["kMaxBandRows"])
        assert g["kMinCtas"] * (smem + 1024) <= SM_SMEM_BYTES


# K6's own conflict: 16x1 packs its pairs at 16 floats (K1's 20 pad them)
K6_COLUMN_CONFLICTS = {(16, 1): 4}


@pytest.mark.parametrize("block", K12_BLOCKS)
def test_k6_sq_layouts_avoid_bank_conflicts(block):
    # shared memory has 32 banks of 4 bytes; a warp's 8-byte accesses go in
    # half-warps, its 16-byte ones in quarter-warps. The column stage (lanes
    # along l) is free of conflicts over the strip's pairs and the halo's
    # (2-way at BW = 2, as in K1), the row stage's float4 loads as free as
    # K1's at that shape (2-way at 4x8 and 16x4), its float2 loads at BW =
    # 2 free; at BW = 1 both stages read a pair's slot column at once, free;
    # the row stage's ring stores (of a halo block only the columns the
    # ring keeps) conflict at most two-way. A walk step's rows stand as
    # those of one S x BW block
    bh, bw = _hw(block)
    pitch, c_group, halo_cols, ring_pitch, threads, _ = dct._K6_SQ_GEOM[bh, bw]
    rows = _k6_step_rows(block)
    blocks = dct._K6_SQ_STRIP_PIXELS // bw + 1
    lanes = np.arange(blocks * 3 * bw)
    group, r = lanes // bw, lanes % bw
    if bw == 1:
        # both stages: float4s in quarter-warps at a pair stride of an odd
        # multiple of 4 (16x1's 16 floats: 4-way, for a fifth CTA an SM),
        # else floats a warp at once at an odd stride
        for i in range(0, rows, 4 if c_group % 4 == 0 else 1):
            if c_group % 4 == 0:
                assert _worst_conflict((group * c_group + i) // 4, 8, 8) == (
                    K6_COLUMN_CONFLICTS.get((bh, bw), 1))
            else:
                assert _worst_conflict(group * c_group + i, 32, 32) == 1
    else:
        for fixed in range(rows):  # the column stage
            addr = group * c_group + fixed * pitch + r
            assert _worst_conflict(addr, 32, 32) == K1_COLUMN_CONFLICTS.get(
                (bh, bw), 1)
    stage = _k6_row_stage(bh, bw, threads)
    for pair, row, col0 in stage:
        live = pair >= 0
        if bw == 2:  # the row stage's float2 loads, in half-warps
            addr = (pair * c_group + row * pitch) // 2
            for h in range(0, threads, 16):
                a = addr[h:h + 16][live[h:h + 16]]
                if len(a):
                    assert int(np.bincount(np.unique(a) % 16).max()) == 1
        for q in range(bw // 4):  # the row stage's float4 loads
            addr = (pair * c_group + row * pitch + 4 * q) // 4
            for h in range(0, threads, 8):
                a = addr[h:h + 8][live[h:h + 8]]
                if len(a):
                    worst = int(np.bincount(np.unique(a) % 8).max())
                    assert worst <= K1_ROW_CONFLICTS.get((bh, bw), 1)
        blk, c = pair // 3, pair % 3
        for jj in range(min(rows, bw)):  # the row stage's ring stores
            j = col0 + jj
            col = (blk * bw + j) * 3 + c
            addr = (row % (rows + 1)) * ring_pitch + col
            kept = live & ((blk < blocks - 1) | (j < halo_cols))
            assert col[kept].max() < _k6_sq_ring_width(block)
            for w in range(0, threads, 32):
                a = addr[w:w + 32][kept[w:w + 32]] % 32
                if len(a):
                    assert np.bincount(a).max() <= 2
        # every (pair, row, column) of the strip and its halo once
    hits = np.zeros((blocks * 3, rows, bw), np.int64)
    for pair, row, col0 in stage:
        live = pair >= 0
        for m in range(min(rows, bw)):
            np.add.at(hits, (pair[live], row[live], col0[live] + m), 1)
        warps = col0.reshape(-1, 32)
        assert (warps == warps[:, :1]).all()  # a part's columns: whole warps
    assert (hits == 1).all()


def _side_1_fetch_hits(bh, bw, pitch, group, step, pairs):
    """Replay fetch_side_1 (csrc/idct_sq.cuh) for a slot of ``pairs``
    pairs at (``pitch``, ``group``) over a walk step of ``step`` block
    rows: copy e of block row m's run, at float w0 = e * kW of it, pair g =
    w0 // (BH * BW), goes to g * kGroup + (m * BH + w // BW) * kPitch + w %
    BW (w its place in the pair), kW = 4 floats where a pair is whole
    4-float chunks, else the pair's 1 or 2. Checks that each float lands at
    the slot place of its (pair, row, column), inside its pair's group,
    every copy aligned to its size and a copy instruction's phase (a warp
    at 4 bytes, half at 8, a quarter at 16) on a bank at most twice; returns
    the count of copies that landed on each slot float."""
    pair = bh * bw
    kw = min(pair, 4)
    e = np.arange(pairs * pair // kw)
    w0 = e * kw
    g, w = w0 // pair, w0 % pair
    phase = {1: 32, 2: 16, 4: 8}[kw]
    seen = np.zeros(pairs * group, np.int64)
    for m in range(step):
        dst = g * group + (m * bh + w // bw) * pitch + w % bw
        assert (dst % kw == 0).all()
        assert (((m * bh + w // bw) * pitch + w % bw + kw - 1) < group).all()
        assert _worst_conflict(dst // kw, phase, 32 // kw) <= 2
        for n in range(kw):  # float n of the copy: (row, column) of w + n
            row, col = m * bh + (w + n) // bw, (w + n) % bw
            np.testing.assert_array_equal(dst + n, g * group + row * pitch + col)
            np.add.at(seen, dst + n, 1)
    # a run's copies start kW-aligned in the wire (its blocks are 3 pairs)
    assert (3 * pair) % kw == 0
    return seen


@pytest.mark.parametrize("block", SIDE_1_BLOCKS)
def test_k6_side_1_fetch_fills_the_slot(block):
    # at a side of 1, K6 fetches a walk step's runs with K1's one-pass
    # fetch (fetch_side_1), over the strip's blocks and its halo block:
    # every float of the step's runs lands once, where the two stages read
    # it
    bh, bw = _hw(block)
    pitch, group, *_ = dct._K6_SQ_GEOM[bh, bw]
    step = dct._K1_SQ_GEOM[bh, bw][3]
    pairs = (dct._K6_SQ_STRIP_PIXELS // bw + 1) * 3
    seen = _side_1_fetch_hits(bh, bw, pitch, group, step, pairs)
    assert seen.max() == 1 and seen.sum() == step * pairs * bh * bw


@pytest.mark.parametrize("block,out_w,out_h,pw,ph,t", [
    (4, 120, 64, 128, 64, 2), (4, 200, 120, 208, 128, 1),
    (4, 854, 40, 864, 48, 1), (4, 61, 37, 64, 40, 1),
    (16, 120, 64, 128, 64, 2), (16, 200, 120, 208, 128, 1),
    (16, 854, 40, 864, 48, 1), (16, 61, 37, 64, 48, 1),
    ("4x8", 120, 64, 128, 64, 2), ("4x8", 854, 40, 864, 48, 1),
    ("8x4", 200, 120, 208, 128, 1), ("8x4", 61, 37, 64, 40, 1),
    ("4x16", 200, 120, 208, 128, 1), ("4x16", 854, 40, 864, 48, 1),
    ("16x4", 120, 64, 128, 64, 2), ("16x4", 61, 37, 64, 48, 1),
    ("8x16", 854, 40, 864, 48, 1), ("8x16", 61, 37, 64, 40, 1),
    ("16x8", 200, 120, 208, 128, 1), ("16x8", 120, 64, 128, 64, 2),
    # a side of 1 or 2 (some with a last walk step of fewer block rows
    # than the others: padded heights of 42, 44, 45, 36 and 37)
    (2, 61, 37, 64, 42, 1), ("2x4", 120, 64, 128, 64, 2),
    ("4x2", 854, 40, 864, 44, 1), ("2x8", 200, 120, 208, 128, 1),
    ("8x2", 61, 37, 64, 40, 1), ("2x16", 100, 34, 112, 36, 1),
    ("16x2", 120, 64, 128, 64, 2), (1, 61, 37, 64, 45, 1),
    (1, 200, 120, 208, 128, 1), ("1x2", 854, 40, 864, 48, 1),
    ("2x1", 59, 42, 64, 42, 1), ("1x4", 120, 64, 128, 64, 2),
    ("4x1", 61, 37, 64, 44, 1), ("1x8", 200, 120, 208, 128, 1),
    ("8x1", 854, 40, 864, 48, 1), ("1x16", 61, 35, 64, 37, 1),
    ("16x1", 61, 37, 64, 48, 1)])
def test_k6_sq_walk_reproduces_plain_bytes(block, out_w, out_h, pw, ph, t):
    # the templated kernel's walk, replayed on the plain version's planes
    # through a ring of S + 1 rows (S a walk step's pixel rows; row y at y
    # % (S + 1)) of the strip's pixels and the halo's kept columns, with
    # the tables' ring positions and the kernel's per-element blends, gives
    # the plain version's bytes
    bh, bw = _hw(block)
    rng = np.random.default_rng(out_w + out_h + bh + 3 * bw)
    nby, nbx = ph // bh, pw // bw
    n = 3 * bh * bw
    coeffs = torch.from_numpy(
        (rng.normal(size=(t, nby, nbx, n)) * 90).astype(np.float32))
    steps = torch.from_numpy(
        rng.choice([1.0, 640.0], size=(t, nby, nbx)).astype(np.float32))
    planes = dct.idct_planes_plain(coeffs, steps, 3, bh, bw)
    width = _k6_sq_ring_width(block)
    cols = width // 3  # the strip's 64 pixel columns and the halo's kept
    # interleaved pixels, the halo's columns past each strip's end (zero
    # past nbx), rows past the frame (a partial last step) NaN
    step = _k6_step_rows(block)
    pix = torch.nn.functional.pad(planes.permute(0, 2, 3, 1), (0, 0, 0, cols))
    pix = torch.nn.functional.pad(pix, (0, 0, 0, 0, 0, -ph % step),
                                  value=float("nan"))
    (y0, y1, fy, *_), (col_e, col_f, strip_lo) = _k6_sq_tables(
        block, out_w, out_h, pw, ph, t)
    rows_n = step + 1
    out = torch.full((t, out_h, 3 * out_w), float("nan"))
    ring = torch.full((t, rows_n, width), float("nan"))
    for _, s, b, rows, _ in _k6_sq_walk(block, out_w, out_h, pw, ph, t):
        for i in range(step):
            ring[:, (step * b + i) % rows_n] = pix[
                :, step * b + i, 64 * s:64 * s + cols].reshape(t, -1)
        k = torch.arange(strip_lo[s], strip_lo[s + 1])
        e = torch.from_numpy(col_e[k.numpy()]).long()
        g = torch.from_numpy(col_f[k.numpy()])
        e3 = (e + 3).clamp(max=width - 1)
        for yo in rows:
            top, bot = ring[:, y0[yo] % rows_n], ring[:, y1[yo] % rows_n]
            v, w = top[:, e], top[:, e3]
            if fy[yo] != 0:
                f = torch.tensor(fy[yo])
                v = v * (1 - f) + bot[:, e] * f
                w = w * (1 - f) + bot[:, e3] * f
            out[:, yo, k] = torch.where(g != 0, v * (1 - g) + w * g, v)
    got = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    want = dct.idct_resize_display_plain(coeffs, steps, out_h, out_w, 3, bh,
                                         bw)
    assert torch.equal(got, want)
