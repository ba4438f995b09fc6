"""Port vs svc_tpu: forward DCT into wire layout (K2), dequantization, and
the decoder's display path (K1) on every width-aligned route, plus the
general route's plain-PyTorch CPU path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svc_tpu.config import DecoderConfig
from svc_tpu.io import bitstream
from svc_tpu.ops import dct as j_dct
from svc_tpu.ops import dct_pallas as j_dctp
from svc_tpu.ops import interleave as j_inter
from svc_tpu.ops import quant as j_quant
from svc_tpu.ops import resize as j_resize
from svc_tpu.ops.pad import pad_frame as j_pad_frame
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


def test_forward_dct_matches_planes_kernel():
    # width 192 is not lane-aligned: svc_tpu takes the planes kernel
    w, h = 192, 136
    ph, pw = 144, 192
    packed = _packed(3, h, w, seed=11)
    planes = jnp.stack([jnp.asarray(packed)[:, :, c::3] for c in range(3)])
    planes = j_pad_frame(planes, pw, ph)
    want = np.asarray(j_dctp.dct2_planes_to_wire_pallas(planes, 8, 8, frame_offset=1))
    got = dct.dct8x8_to_wire(torch.from_numpy(packed), 1, 2, ph, pw).numpy()
    assert np.abs(got - want).max() <= COEFF_GATE


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


def _decode_inputs(w, h, ew, eh, seed):
    hdr = bitstream.Header(2, w, h, ew, eh, 8, 8, 3)
    nby, nbx = hdr.padded_frame_h // 8, hdr.padded_frame_w // 8
    rng = np.random.default_rng(seed)
    coeffs = (rng.normal(size=(2, nby, nbx, 192)) * 90).astype(np.float32)
    btypes = rng.integers(0, 3, (2, nby, nbx)).astype(np.uint32)
    rects = np.tile(np.array([[w // 4, h // 4, 64, 32]], np.int32), (2, 1))
    return hdr, coeffs, btypes, rects


# (w, h, excess w, excess h): row resample (the 1080p class), zero excess
# (identity rows), multi-band resample, width excess (general route)
DECODE_GEOMETRIES = [
    (128, 120, 0, 8),
    (128, 128, 0, 0),
    (256, 248, 0, 8),
    (120, 64, 8, 0),
]


@pytest.mark.parametrize("w,h,ew,eh", DECODE_GEOMETRIES)
def test_display_bytes_match_svc_tpu_decoder(w, h, ew, eh):
    from svc_tpu.models.decoder import Decoder as JDecoder
    from svc_tpu_torch.models.decoder import Decoder

    hdr, coeffs, btypes, rects = _decode_inputs(w, h, ew, eh, seed=w * h)
    want = JDecoder.packed_bytes(
        JDecoder(DecoderConfig(), hdr, batch_size=2)._decode_batch(
            coeffs, btypes, rects
        )
    )
    got = Decoder(DecoderConfig(), hdr, batch_size=2, device="cpu").decode_batch(
        coeffs, btypes, rects
    )
    assert got.dtype == torch.uint8
    got = got.numpy()
    assert got.shape == want.shape == (2, h, w * 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_general_route_refuses_cuda(monkeypatch):
    from svc_tpu_torch.models import decoder as dec_mod

    monkeypatch.setattr(
        dec_mod, "resolve_device", lambda d: torch.device("cuda", 0)
    )
    hdr = bitstream.Header(2, 120, 64, 8, 0, 8, 8, 3)
    with pytest.raises(NotImplementedError, match="K6"):
        dec_mod.Decoder(DecoderConfig(), hdr, device="cuda")

