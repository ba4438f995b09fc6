"""The slice as a whole: svc_tpu and svc_tpu_torch encode the same clip to
the same stream (header and block types byte-equal, coefficients within
the DCT gate), and each package's decoder turns the streams into the same
display bytes (max |diff| <= 1 in < 1e-3 of the bytes)."""

import numpy as np
import pytest
import torch

from benchmarks.clips import make_clip
from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu.models import decoder as j_dec
from svc_tpu.models import encoder as j_enc
from svc_tpu_torch.models import decoder as t_dec
from svc_tpu_torch.models import encoder as t_enc

COEFF_GATE = 2.5e-4
N_FRAMES = 6  # batch 2: two full batches and a padded last one
BATCH = 2
# 128x120: 8 rows of frame excess like 1080p (row-resample display route,
# j-split DCT); 128x128: zero excess (identity display route)
GEOMETRIES = [(128, 120), (128, 128)]


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def encoded(request):
    """One JAX encode per geometry (the expensive compile), shared."""
    w, h = request.param
    clip = make_clip(w, h, N_FRAMES, seed=w + h)
    cfg = EncoderConfig(reference_compat=True)
    props = VideoProperties(w, h, N_FRAMES)
    jenc = j_enc.Encoder(cfg, props, batch_size=BATCH)
    tenc = t_enc.Encoder(cfg, props, batch_size=BATCH, device="cpu")
    js = list(jenc.encode_video(iter(clip)))
    ts = list(tenc.encode_video(iter(clip)))
    jb = {k: np.array(v) for k, v in jenc.encode_batch(clip[: BATCH + 1], 0).items()}
    tb = tenc.encode_batch(clip[: BATCH + 1], 0)
    return dict(clip=clip, js=js, ts=ts, jb=jb, tb=tb, w=w, h=h)


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
    header = bitstream.Header.unpack(stream[0])
    dec = module.Decoder(DecoderConfig(), header, batch_size=BATCH, **kw)
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


def test_default_config_needs_unported_k5():
    with pytest.raises(NotImplementedError, match="K5"):
        t_enc.Encoder(EncoderConfig(), VideoProperties(64, 64, 3), device="cpu")


def test_stream_resume_from_anchor_index():
    # the codec state of anchor t is frame t-1 only, so encoding from an
    # overlap frame with first_anchor_index reproduces the tail payloads
    clip = make_clip(64, 48, 5, seed=3)
    cfg = EncoderConfig(reference_compat=True)
    enc = t_enc.Encoder(cfg, VideoProperties(64, 48, 5), batch_size=2, device="cpu")
    full = list(enc.encode_video(iter(clip)))
    tail = list(enc.encode_video(iter(clip[2:]), emit_header=False,
                                 first_anchor_index=2))
    assert tail == full[3:]
    assert isinstance(enc.encode_batch(clip[:3], 0)["coeffs"], torch.Tensor)
