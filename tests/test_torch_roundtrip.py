"""The slice as a whole: svc_tpu and svc_tpu_torch encode the same clip to
the same stream (header and block types byte-equal, coefficients within
the DCT gate), under the default config and under reference-compat, and
each package's decoder turns the streams into the same display bytes (max
|diff| <= 1 in < 1e-3 of the bytes) on every display route."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.clips import make_clip
from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream as j_bitstream
from svc_tpu.models import decoder as j_dec
from svc_tpu.models import encoder as j_enc
from svc_tpu_torch import config
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.models import decoder as t_dec
from svc_tpu_torch.models import encoder as t_enc

COEFF_GATE = 2.5e-4
N_FRAMES = 6  # batch 2: two full batches and a padded last one
BATCH = 2
# 128x120: 8 rows of frame excess like 1080p (row-resample display route,
# j-split DCT); 128x128: zero excess (identity display route); 120x64: 8
# columns of width excess (general display route, both axes resampled)
GEOMETRIES = [(128, 120), (128, 128), (120, 64)]
CASES = [(w, h, compat) for compat in (True, False) for w, h in GEOMETRIES]


@pytest.fixture(
    scope="module", params=CASES,
    ids=lambda c: f"{c[0]}x{c[1]}-{'compat' if c[2] else 'default'}",
)
def encoded(request):
    """One JAX encode per geometry and config (the expensive compile), shared."""
    w, h, compat = request.param
    clip = make_clip(w, h, N_FRAMES, seed=w + h)
    cfg = EncoderConfig(reference_compat=compat)
    props = VideoProperties(w, h, N_FRAMES)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    jb = {k: np.array(v) for k, v in jenc.encode_batch(clip[: BATCH + 1], 0).items()}
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    return dict(clip=clip, js=js, ts=ts, jb=jb, tb=tb, w=w, h=h)


def _port(*configs):
    """svc_tpu configs carried across to the port's (``config.from_dict``)."""
    return [config.from_dict(getattr(config, type(c).__name__),
                             dataclasses.asdict(c)) for c in configs]


def _payloads(stream):
    header = bitstream.Header.unpack(stream[0])
    return header, [bitstream.deserialize_frame_blocks(p, header) for p in stream[1:]]


def test_headers_and_block_types_equal(encoded):
    assert encoded["ts"][0] == encoded["js"][0]
    assert len(encoded["ts"]) == len(encoded["js"]) == N_FRAMES
    _, jp = _payloads(encoded["js"])
    _, tp = _payloads(encoded["ts"])
    for (jt, _), (tt, _) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
    assert any((tt > 0).any() for tt, _ in tp)  # foreground was found


def test_coefficients_within_gate(encoded):
    _, jp = _payloads(encoded["js"])
    _, tp = _payloads(encoded["ts"])
    for (_, jc), (_, tc) in zip(jp, tp):
        assert np.abs(tc - jc).max() <= COEFF_GATE


def test_batch_intermediates_equal(encoded):
    jb, tb = encoded["jb"], encoded["tb"]
    for key in (
        "mv_field", "foreground_mask_raw", "foreground_mask",
        "cluster_labels", "global_motion",
    ):
        np.testing.assert_array_equal(tb[key].numpy(), jb[key], err_msg=key)
    np.testing.assert_array_equal(
        tb["block_types"].numpy().astype(np.uint32), jb["block_types"]
    )


def _decode(module, stream, gaze, **kw):
    if module is j_dec:
        cfg, header = DecoderConfig(), j_bitstream.Header.unpack(stream[0])
    else:
        (cfg,) = _port(DecoderConfig())
        header = bitstream.Header.unpack(stream[0])
    dec = module.Decoder(cfg, header, batch_size=BATCH, **kw)
    n = len(stream) - 1
    return np.stack(list(dec.decode_frames(iter(stream[1:]), iter([gaze] * n))))


def _assert_display_close(a, b):
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_each_decoder_on_the_jax_stream(encoded):
    gaze = (encoded["w"] // 2, encoded["h"] // 3)
    want = _decode(j_dec, encoded["js"], gaze)
    got = _decode(t_dec, encoded["js"], gaze, device="cpu")
    assert got.shape == (N_FRAMES - 1, encoded["h"], encoded["w"], 3)
    _assert_display_close(got, want)


def test_each_decoder_on_the_port_stream(encoded):
    # the wire contract holds both ways: svc_tpu decodes the port's stream.
    # (Decodes of the two streams are not compared with each other: a
    # 1e-4 coefficient difference at a step-640 rounding boundary moves a
    # whole quantization level.)
    want = _decode(j_dec, encoded["ts"], None)
    got = _decode(t_dec, encoded["ts"], None, device="cpu")
    _assert_display_close(got, want)


def test_default_config_round_trip():
    # EncoderConfig() through both packages on a clip whose 48 rows pad to
    # 64: the same stream, and the port decodes it like svc_tpu
    w, h, n = 64, 48, 5
    clip = make_clip(w, h, n, seed=9)
    props = VideoProperties(w, h, n)
    js = list(j_enc.Encoder(EncoderConfig(), props, batch_size=BATCH).encode_video(iter(clip)))
    ts = list(t_enc.Encoder(*_port(EncoderConfig(), props), batch_size=BATCH,
                            device="cpu").encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    gaze = (w // 2, h // 2)
    _assert_display_close(_decode(t_dec, js, gaze, device="cpu"),
                          _decode(j_dec, js, gaze))


def test_search_range_16_round_trip():
    # --mv-search-range 16 (top radius 2 at 16x16 MV blocks and 4 levels)
    # through both packages on the smallest frame the default test clip
    # keeps four levels at: the same header, MV fields and block types,
    # coefficients within the gate
    w, h, n = 64, 48, 5
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(mv_search_range=16)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: BATCH + 1], 0)
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found


@pytest.mark.parametrize(
    "settings", [dict(mv_block_w=8, mv_block_h=8), dict(pyr_lvl_count=3)],
    ids=["8x8-mv-blocks", "3-levels"])
def test_motion_configs_round_trip(settings):
    # --mv-block-w/-h 8 (1x1 blocks at the top level, 2x2 below it) and
    # --pyr-lvl-count 3 (4x4 at the top, radius 2) through both packages:
    # the same header, MV fields and block types, coefficients within the
    # gate
    w, h, n = 64, 48, 5
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(**settings)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: BATCH + 1], 0)
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    assert tb["mv_field"].shape == (BATCH, h // cfg.mv_block_h, w // cfg.mv_block_w, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found


def test_rect_mv_blocks_round_trip():
    # --mv-block-w 16 --mv-block-h 8 at 4 levels (2x1 blocks at the top
    # level, 4x2, 8x4 and 16x8 below it) through both packages on a frame
    # whose MV field has an odd count of block rows (56 rows: 7, as the
    # 1080 rows of 1080p give 135): the same header, MV fields and block
    # types, coefficients within the gate
    w, h, n = 64, 56, 5
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(mv_block_w=16, mv_block_h=8)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: BATCH + 1], 0)
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    assert tb["mv_field"].shape == (BATCH, 7, 4, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found


def test_wide_mv_blocks_round_trip():
    # --mv-block-w 32 --mv-block-h 32 --pyr-lvl-count 2 (16x16 blocks at
    # the top level, radius 4, and 32x32 below it) through both packages on
    # 256x64 (8 block columns: svc_tpu's search takes its Pallas stack
    # refine): the same header, MV fields and block types, coefficients
    # within the gate
    w, h, n = 256, 64, 4
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(mv_block_w=32, mv_block_h=32, pyr_lvl_count=2)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: BATCH + 1], 0)
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    assert tb["mv_field"].shape == (BATCH, 2, 8, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found


# ratio-4 MV blocks through both packages (width, height, levels, frame
# width, frame height, transform block side): 32x8 at 4 and 2 levels (5
# block rows, odd as 1080p's 135, 8 block columns: svc_tpu's search takes
# its Pallas stack refine), 8x32 at 4 and 3, and 16x4 at 3 levels, which
# needs 4x4 transform blocks (transform block height <= MV block height)
RATIO4_ENCODES = [(32, 8, 4, 256, 40, 8), (32, 8, 2, 256, 40, 8), (8, 32, 4, 64, 96, 8),
                  (8, 32, 3, 64, 96, 8), (16, 4, 3, 128, 20, 4)]


@pytest.mark.parametrize("bw,bh,levels,w,h,tb", RATIO4_ENCODES)
def test_ratio4_mv_blocks_round_trip(bw, bh, levels, w, h, tb):
    # the same header, MV fields and block types, coefficients within the
    # gate
    n = 4
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(mv_block_w=bw, mv_block_h=bh, pyr_lvl_count=levels,
                        transform_block_w=tb, transform_block_h=tb)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: BATCH + 1], 0)
    tb_ = tenc.encode_batch(clip[: BATCH + 1], 0)
    assert tb_["mv_field"].shape == (BATCH, h // bh, w // bw, 2)
    np.testing.assert_array_equal(tb_["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb_["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb_["mv_field"].numpy()).max() > 0  # motion was found


# 16x16 MV blocks past r = 4 through both packages (levels, range): one
# level at range 8 (the whole search an EBMA at r = 8, no pyramid) and two
# levels at range 16 (r = 8 at the top and at level 0; 8 block columns:
# svc_tpu's search takes its Pallas stack refine)
FAR_ENCODES = [(1, 8), (2, 16)]


@pytest.mark.parametrize("levels,search_range", FAR_ENCODES)
def test_far_radius_round_trip(levels, search_range):
    # the same header, MV fields and block types, coefficients within the
    # gate; one batch of 2 anchors (svc_tpu's interpret-mode refine costs
    # tens of seconds a call at r = 8)
    w, h, n, batch = 128, 48, 3, 2
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(pyr_lvl_count=levels, mv_search_range=search_range)
    props = VideoProperties(w, h, n)
    jenc = j_enc.Encoder(cfg, props, batch_size=batch)
    tenc = t_enc.Encoder(*_port(cfg, props), batch_size=batch, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    assert ts[0] == js[0]
    _, jp = _payloads(js)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    jb = jenc.encode_batch(clip[: batch + 1], 0)
    tb = tenc.encode_batch(clip[: batch + 1], 0)
    assert tb["mv_field"].shape == (batch, h // 16, w // 16, 2)
    np.testing.assert_array_equal(tb["mv_field"].numpy(), np.array(jb["mv_field"]))
    np.testing.assert_array_equal(tb["block_types"].numpy().astype(np.uint32),
                                  np.array(jb["block_types"]))
    assert np.abs(tb["mv_field"].numpy()).max() > 0  # motion was found


def test_stream_resume_from_anchor_index():
    # the codec state of anchor t is frame t-1 only, so encoding from an
    # overlap frame with first_anchor_index reproduces the tail payloads
    clip = make_clip(64, 48, 5, seed=3)
    cfg = config.EncoderConfig(reference_compat=True)
    enc = t_enc.Encoder(cfg, config.VideoProperties(64, 48, 5), batch_size=2,
                        device="cpu")
    full = list(enc.encode_video(iter(clip)))
    tail = list(enc.encode_video(iter(clip[2:]), emit_header=False,
                                 first_anchor_index=2))
    assert tail == full[3:]
    assert isinstance(enc.encode_batch(clip[:3], 0)["coeffs"], torch.Tensor)


@pytest.mark.parametrize("block_h,block_w", [(8, 16), (8, 4)])
def test_rectangular_blocks_round_trip(block_h, block_w):
    # transform blocks with sides set apart (8 rows and 16 or 4 columns)
    # through both packages on a seeded clip: the same header and block
    # types, coefficients within the gate, and the port decodes svc_tpu's
    # stream like svc_tpu does
    w, h, n = 64, 48, 5
    clip = make_clip(w, h, n, seed=9)
    cfg = EncoderConfig(transform_block_h=block_h, transform_block_w=block_w)
    props = VideoProperties(w, h, n)
    js = list(j_enc.Encoder(cfg, props, batch_size=BATCH).encode_video(iter(clip)))
    ts = list(t_enc.Encoder(*_port(cfg, props), batch_size=BATCH,
                            device="cpu").encode_video(iter(clip)))
    assert ts[0] == js[0]
    header, jp = _payloads(js)
    assert (header.transform_block_h, header.transform_block_w) == (block_h, block_w)
    _, tp = _payloads(ts)
    assert len(tp) == len(jp) == n - 1
    for (jt, jc), (tt, tc) in zip(jp, tp):
        np.testing.assert_array_equal(tt, jt)
        assert jc.shape == tc.shape == (48 // block_h, 64 // block_w, 3,
                                        block_h, block_w)
        assert np.abs(tc - jc).max() <= COEFF_GATE
    assert any((tt > 0).any() for tt, _ in tp)  # foreground was found
    gaze = (w // 2, h // 2)
    _assert_display_close(_decode(t_dec, js, gaze, device="cpu"),
                          _decode(j_dec, js, gaze))
