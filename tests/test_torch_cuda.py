"""Card-only tests: each CUDA kernel against its plain PyTorch version at
small and odd shapes, and the whole port on the card against the port on
the CPU. They skip where ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it runs on a card machine without it:

  python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from benchmarks.clips import make_clip
from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu_torch.kernels import build
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.ops import dct, motion, pyramid

pytestmark = pytest.mark.cuda

COEFF_GATE = 2.5e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _u8(gen, shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).cuda()


@pytest.mark.parametrize(
    "shape", [(3, 64, 128), (2, 37, 51), (1, 2, 3), (2, 1, 9), (1, 130, 66)]
)
def test_pyr_down_bit_equal(gen, shape):
    x = _u8(gen, shape)
    before = pyramid.PYR_DOWN.launches
    got = pyramid.pyr_down(x)
    assert pyramid.PYR_DOWN.launches == before + 1
    assert torch.equal(got, pyramid.pyr_down_plain(x))


@pytest.mark.parametrize("block,r,bound", [(4, 1, 2), (8, 1, 6), (16, 1, 14),
                                           (8, 2, 12), (16, 3, 30)])
def test_refine_sads_bit_equal(gen, block, r, bound):
    # MVs reach past the frame edge: windows outside read zeros on both
    # sides, so every entry (valid or not) must agree
    stack = _u8(gen, (3, 4 * block, 6 * block))
    mv = torch.randint(-bound, bound + 1, (2, 4, 6, 2), generator=gen,
                       dtype=torch.int32).cuda()
    assert torch.equal(
        motion.refine_sads(stack, mv, r, block, block),
        motion.refine_sads_plain(stack, mv, r, block, block),
    )


@pytest.mark.parametrize(
    "h,w,ph,pw,block",
    [(120, 128, 128, 128, 8), (16, 20, 16, 32, 8), (136, 192, 144, 192, 8),
     (30, 36, 32, 40, 4)],
)
def test_dct_to_wire_matches_plain(gen, h, w, ph, pw, block):
    packed = _u8(gen, (3, h, w * 3))
    got = dct.dct8x8_to_wire(packed, 1, 2, ph, pw, block, block)
    ref = dct.dct8x8_to_wire_plain(packed, 1, 2, ph, pw, block, block)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= COEFF_GATE


@pytest.mark.parametrize(
    "nby,nbx,out_h,block",
    [(16, 16, 120, 8), (16, 16, 128, 8), (31, 32, 248, 8), (2, 3, 9, 8),
     (10, 12, 37, 4)],
)
def test_idct_display_matches_plain(gen, nby, nbx, out_h, block):
    n = block * block
    coeffs = (torch.randn((2, nby, nbx, 3 * n), generator=gen) * 90).cuda()
    steps = torch.where(
        torch.rand((2, nby, nbx), generator=gen) < 0.5, 640.0, 1.0
    ).cuda()
    got = dct.idct_display(coeffs, steps, out_h, 3, block, block)
    ref = dct.idct_display_plain(coeffs, steps, out_h, 3, block, block)
    assert got.shape == (2, out_h, nbx * block * 3)
    d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    assert d.max().item() <= 1
    assert (d > 0).double().mean().item() < 1e-3


def test_wrappers_reject_bad_inputs(gen):
    with pytest.raises(TypeError):
        pyramid.pyr_down(torch.zeros((2, 8, 8), dtype=torch.int32, device="cuda"))
    stack = _u8(gen, (3, 32, 32))
    with pytest.raises(TypeError):
        motion.refine_sads(stack, torch.zeros((2, 2, 2, 2), device="cuda"), 1, 16, 16)
    with pytest.raises(TypeError):
        dct.idct_display(torch.zeros((1, 2, 2, 192), device="cuda"),
                         torch.ones((1, 2, 3), device="cuda"), 16)


@pytest.mark.parametrize("w,h", [(128, 120), (128, 128), (96, 72)])
def test_port_on_card_matches_port_on_cpu(gen, w, h):
    clip = make_clip(w, h, 6, seed=w + h)
    cfg = EncoderConfig(reference_compat=True)
    props = VideoProperties(w, h, len(clip))
    build.reset_launch_counts()
    cuda_stream = list(Encoder(cfg, props, 2, device="cuda").encode_video(iter(clip)))
    counts = build.launch_counts()
    assert counts["pyr_down_u8"] > 0 and counts["refine_sads"] > 0
    assert counts["dct8x8_to_wire"] > 0
    cpu_stream = list(Encoder(cfg, props, 2, device="cpu").encode_video(iter(clip)))
    assert cuda_stream[0] == cpu_stream[0]
    header = bitstream.Header.unpack(cuda_stream[0])
    for a, b in zip(cuda_stream[1:], cpu_stream[1:]):
        ta, ca = bitstream.deserialize_frame_blocks(a, header)
        tb, cb = bitstream.deserialize_frame_blocks(b, header)
        np.testing.assert_array_equal(ta, tb)
        assert np.abs(ca - cb).max() <= COEFF_GATE
    gaze = [(w // 2, h // 2)] * (len(clip) - 1)
    frames = {}
    for device in ("cuda", "cpu"):
        dec = Decoder(DecoderConfig(), header, batch_size=2, device=device)
        frames[device] = np.stack(
            list(dec.decode_frames(iter(cpu_stream[1:]), iter(gaze)))
        )
    assert build.launch_counts()["idct_display"] > 0
    d = np.abs(frames["cuda"].astype(np.int16) - frames["cpu"].astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
