#!/usr/bin/env python3
"""Smoke test of svc_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card and nvcc (the kernels are built from ``svc_tpu_torch/csrc`` at
first use), and exits non-zero on any failure, printing no result. Phases,
one line each:

1. card — name and power limit (``nvidia-smi``);
2. build — compile the kernels, with the build time;
3. kernel parity — each kernel against its plain PyTorch version on the
   card at the 1080p shapes of the encode/decode path (K4 and K3
   bit-equal; K2 within 2.5e-4; K1 within 1 with under 1e-3 of the bytes
   differing), with both times;
4. end to end — a 17-frame 1080p clip through ``stream_encode`` with
   ``EncoderConfig(reference_compat=True)`` on ``cuda``, read back through
   ``svc_tpu.io.bitstream`` and decoded with a gaze; the launch counters
   must show every kernel ran;
5. card against CPU — the first 3 frames encoded on both devices;
6. timings — 1080p encode and decode frames per second.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK_TYPE_TOL = 0.01  # phase 5: share of blocks allowed to differ


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_parity(dev):
    """Each kernel against its plain version at the 1080p path shapes."""
    from svc_tpu_torch.ops import dct, motion, pyramid, quant
    from svc_tpu_torch.ops.resize import bilinear_axis_weights

    g = torch.Generator(device="cpu").manual_seed(1234)
    results = {}

    # K4: the three pyramid levels of a 9-frame 1088x1920 luma stack, plus
    # an odd size
    y = torch.randint(0, 256, (9, 1088, 1920), generator=g, dtype=torch.uint8).to(dev)
    level, ms, plain_ms, err4 = y, 0.0, 0.0, 0
    for _ in range(3):
        got = pyramid.pyr_down(level)
        ref = pyramid.pyr_down_plain(level)
        err4 = max(err4, (got.int() - ref.int()).abs().max().item())
        if not torch.equal(got, ref):
            fail(f"K4 pyr_down_u8 differs at {tuple(level.shape)}")
        ms += cuda_ms(lambda: pyramid.pyr_down(level))
        plain_ms += cuda_ms(lambda: pyramid.pyr_down_plain(level))
        level = got
    odd = y[:2, :1087, :1919]
    if not torch.equal(pyramid.pyr_down(odd), pyramid.pyr_down_plain(odd)):
        fail("K4 pyr_down_u8 differs on an odd size")
    results["pyr_down_u8"] = (pyramid.PYR_DOWN, float(err4), ms, plain_ms)
    print(f"parity K4 pyr_down_u8: bit-equal on levels 1-3 + odd size; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (3 levels, T+1=9)")

    # K3: refine SADs at levels 2, 1, 0 (blocks 4, 8, 16; r = 1) with the
    # even propagated MVs those levels receive
    levels = [y]
    for _ in range(2):
        levels.append(pyramid.pyr_down(levels[-1]))
    ms = plain_ms = 0.0
    err3 = 0
    for lvl, bound in ((2, 2), (1, 6), (0, 14)):
        stack = levels[lvl]
        b = 16 >> lvl
        mfh, mfw = stack.shape[1] // b, stack.shape[2] // b
        mv = 2 * torch.randint(
            -bound // 2, bound // 2 + 1, (8, mfh, mfw, 2), generator=g,
            dtype=torch.int32,
        ).to(dev)
        got = motion.refine_sads(stack, mv, 1, b, b)
        ref = motion.refine_sads_plain(stack, mv, 1, b, b)
        fh, fw = stack.shape[1:]
        by = torch.arange(mfh, device=dev)[:, None] * b
        bx = torch.arange(mfw, device=dev)[None, :] * b
        for i, (ey, ex) in enumerate(motion.candidate_offsets(1)):
            py = by + mv[..., 1] + int(ey)
            px = bx + mv[..., 0] + int(ex)
            valid = (py >= 0) & (py <= fh - b) & (px >= 0) & (px <= fw - b)
            d = (got[:, i][valid] - ref[:, i][valid]).abs()
            err3 = max(err3, d.max().item() if d.numel() else 0)
            if not torch.equal(got[:, i][valid], ref[:, i][valid]):
                fail(f"K3 refine_sads differs at level {lvl}, candidate {i}")
        ms += cuda_ms(lambda: motion.refine_sads(stack, mv, 1, b, b))
        plain_ms += cuda_ms(lambda: motion.refine_sads_plain(stack, mv, 1, b, b),
                            iters=5)
    results["refine_sads"] = (motion.REFINE_SADS, float(err3), ms, plain_ms)
    print(f"parity K3 refine_sads: bit-equal on valid candidates, levels "
          f"2-0; {ms:.4f} ms vs plain {plain_ms:.4f} ms (3 levels, T=8)")

    # K2: forward DCT of 8 anchor frames from 9 packed 1080p frames
    packed = torch.randint(0, 256, (9, 1080, 5760), generator=g,
                           dtype=torch.uint8).to(dev)
    got = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920)
    ref = dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, 8, 8)
    err = (got - ref).abs().max().item()
    exact = (got == ref).double().mean().item()
    if not err <= 2.5e-4:
        fail(f"K2 dct8x8_to_wire max |err| {err} > 2.5e-4")
    ms = cuda_ms(lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920))
    plain_ms = cuda_ms(
        lambda: dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, 8, 8), iters=5
    )
    results["dct8x8_to_wire"] = (dct.DCT_WIRE, err, ms, plain_ms)
    print(f"parity K2 dct8x8_to_wire: max |err| {err:.3e} <= 2.5e-4, "
          f"bit-exact fraction {exact:.6f}; {ms:.4f} ms vs plain {plain_ms:.4f} ms")

    # K1: display path of 8 frames, 1088 padded rows -> 1080 display rows,
    # then the zero-excess (identity rows) mode
    worst, modes = 0.0, []
    for nby, out_h in ((136, 1080), (135, 1080)):
        coeffs = (torch.randn((8, nby, 240, 192), generator=g) * 90).to(dev)
        btypes = torch.randint(0, 3, (8, nby, 240), generator=g).to(dev)
        gazed = torch.zeros((8, nby, 240), dtype=torch.bool, device=dev)
        gazed[:, 60:68, 110:118] = True
        steps = quant.block_quant_steps(btypes, gazed, 1, 640)
        got = dct.idct_display(coeffs, steps, out_h)
        ref = dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8)
        diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        frac = (diff > 0).double().mean().item()
        if diff.max().item() > 1 or not frac < 1e-3:
            fail(f"K1 idct_display: max diff {diff.max().item()}, "
                 f"{frac:.2e} of bytes differ (nby={nby})")
        worst = max(worst, float(diff.max().item()))
        _, _, _, ident = bilinear_axis_weights(out_h, nby * 8)
        modes.append(f"{'identity' if ident else 'resample'} rows "
                     f"{nby * 8}->{out_h}: max diff {diff.max().item()}, "
                     f"{frac:.2e} of bytes differ")
        if nby == 136:
            ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, out_h))
            plain_ms = cuda_ms(
                lambda: dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8),
                iters=5,
            )
    results["idct_display"] = (dct.IDCT_DISPLAY, worst, ms, plain_ms)
    print(f"parity K1 idct_display: {'; '.join(modes)}; {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms (1088->1080 rows, T=8)")
    return results


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "svc_tpu_torch")):
        fail("svc_tpu_torch/ not found beside chip_smoke.py; run it from the "
             "root of a checkout")
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    dev = torch.device("cuda", 0)

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)

    # 2. build
    from svc_tpu_torch.kernels import build

    t0 = time.perf_counter()
    res = build.build()
    build.library()  # load: a link error fails here, not mid-run
    print(f"build: {res.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {res.seconds:.2f} s; 0 = already built)")

    # 3. kernel parity
    results = phase_parity(dev)

    # 4. end to end through the public entry points
    from benchmarks.clips import make_clip
    from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu.io import bitstream
    from svc_tpu.metrics import psnr
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder, stream_encode
    from svc_tpu_torch.ops import dct

    w, h, n_frames = 1920, 1080, 17
    clip = make_clip(w, h, n_frames)
    cfg = EncoderConfig(reference_compat=True)
    props = VideoProperties(w, h, n_frames)
    enc = Encoder(cfg, props, batch_size=8, device="cuda")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    stream = b"".join(stream_encode(enc, iter(clip)))
    header = bitstream.Header.unpack(stream)
    header.validate()
    reader = io.BytesIO(stream[bitstream.HEADER_SIZE:])
    payloads = list(bitstream.read_frames(reader, header))
    if len(payloads) != n_frames - 1 or reader.read(1):
        fail(f"expected {n_frames - 1} payloads, got {len(payloads)}")
    fg_blocks = sum(
        int((bitstream.deserialize_frame_blocks(p, header)[0] > 0).sum())
        for p in payloads
    )
    if fg_blocks == 0:
        fail("no foreground block in any payload")
    dec = Decoder(DecoderConfig(), header, batch_size=8, device="cuda")
    gaze = (w // 2, h // 2)
    frames = np.stack(list(dec.decode_frames(iter(payloads), iter([gaze] * 16))))
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = build.launch_counts()
    if frames.shape != (n_frames - 1, h, w, 3) or frames.dtype != np.uint8:
        fail(f"decoded frames {frames.shape} {frames.dtype}")
    quality = psnr(frames, clip[1:])
    # background blocks decode at step 640 (DecoderConfig default), so the
    # whole-frame PSNR of this textured clip is low by design; phase 5
    # checks the bytes against the CPU decode
    if not 5.0 < quality < 99.0:
        fail(f"PSNR {quality:.2f} dB outside (5, 99)")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    print(f"end to end: {len(payloads)} payloads, {len(stream)} bytes, "
          f"{fg_blocks} foreground transform blocks, PSNR {quality:.3f} dB "
          f"(gaze {gaze}), {e2e_s:.2f} s incl. first calls; launches {counts}")

    # 5. card against CPU on the first 3 frames
    cpu_enc = Encoder(cfg, props, batch_size=2, device="cpu")
    gpu_enc = Encoder(cfg, props, batch_size=2, device="cuda")
    if cpu_enc.header().pack() != gpu_enc.header().pack():
        fail("headers differ between cuda and cpu")
    o_gpu = gpu_enc.encode_batch(clip[:3], 0)
    o_cpu = cpu_enc.encode_batch(clip[:3], 0)
    for key in ("mv_field", "foreground_mask_raw"):
        if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
            fail(f"{key} differs between cuda and cpu")
    cerr = (o_gpu["coeffs"].cpu() - o_cpu["coeffs"]).abs().max().item()
    if not cerr <= 2.5e-4:
        fail(f"coefficients differ by {cerr} > 2.5e-4 between cuda and cpu")
    bt_diff = o_gpu["block_types"].cpu() != o_cpu["block_types"]
    share = bt_diff.double().mean().item()
    first = bt_diff.nonzero()[0].tolist() if bool(bt_diff.any()) else None
    if share > BLOCK_TYPE_TOL:
        fail(f"block types differ on {share:.3%} of blocks (first at {first})")
    cpu_dec = Decoder(DecoderConfig(), header, batch_size=2, device="cpu")
    ref_frames = np.stack(list(cpu_dec.decode_frames(iter(payloads[:2]),
                                                     iter([gaze] * 2))))
    ddiff = np.abs(frames[:2].astype(np.int16) - ref_frames.astype(np.int16))
    dfrac = float((ddiff > 0).mean())
    if ddiff.max() > 1 or not dfrac < 1e-3:
        fail(f"decoded bytes differ from the cpu decode: max {ddiff.max()}, "
             f"{dfrac:.2e} of bytes")
    print(f"card vs cpu (3 frames): header, MV fields and inliers equal; "
          f"coefficients max |err| {cerr:.3e}; block types differ on "
          f"{share:.4%} of blocks (first mismatch {first}); decoded bytes "
          f"max diff {ddiff.max()}, {dfrac:.2e} differ")

    # 6. timings (warm: every kernel is built and loaded)
    t0 = time.perf_counter()
    stream2 = b"".join(stream_encode(enc, iter(clip)))
    enc_s = time.perf_counter() - t0
    if stream2 != stream:
        fail("a second encode of the same clip gave other bytes")
    t0 = time.perf_counter()
    n_dec = sum(1 for _ in dec.decode_frames(iter(payloads), iter([gaze] * 16)))
    dec_s = time.perf_counter() - t0
    packed = torch.as_tensor(clip[:9]).reshape(9, h, w * 3).to(dev)
    enc_ms = cuda_ms(lambda: enc.encode_packed(packed, 0), iters=5, warmup=1)
    coeffs = torch.as_tensor(
        np.stack([bitstream.deserialize_frame_blocks(p, header)[1] for p in payloads[:8]])
    ).reshape(8, 136, 240, 192).to(dev)
    steps = torch.full((8, 136, 240), 640.0, device=dev)
    dec_ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, h), iters=20)
    print(f"timings 1080p batch 8 [{card}]: encode {16 / enc_s:.2f} fps "
          f"end to end (host clip -> bytes), {8000.0 / enc_ms:.2f} fps "
          f"device batch ({enc_ms:.2f} ms / 8 frames); decode "
          f"{n_dec / dec_s:.2f} fps end to end (bytes -> host frames), "
          f"{8000.0 / dec_ms:.2f} fps device ({dec_ms:.3f} ms / 8 frames)")

    if "jax" in sys.modules:
        fail("jax was imported")
    kernels = []
    for name, (k, err, ms, plain_ms) in results.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": counts[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
