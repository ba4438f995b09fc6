"""Where the time goes in one 1080p encode batch and one decode batch.

Runs the port's encode (``Encoder.encode_packed``) and decode
(``Decoder.decode_batch``) on one CUDA card under ``torch.profiler`` after a
warm-up. It prints what ptxas reported for each kernel (registers, shared
memory, spills) when the library is built in this process, then per batch:
wall time, device busy time (the union of kernel intervals) and idle
share, and the device time by kernel name. The Chrome traces go to
``--out`` (default ``build/profile/``).

  python -m svc_tpu_torch.tools.profile_slice
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.clips import make_clip
from svc_tpu.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu_torch.kernels import build
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder


def _busy_us(prof) -> float:
    """Union of device kernel / memcpy intervals, in microseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _report(name: str, fn, out_dir: str, rows: int) -> None:
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = _busy_us(prof)
    print(f"== {name}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--rows", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip())
    for line in build.build().log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(line.strip())

    w, h = 1920, 1080
    clip = make_clip(w, h, 9)
    enc = Encoder(EncoderConfig(reference_compat=True), VideoProperties(w, h, 9),
                  batch_size=8, device="cuda")
    packed = torch.as_tensor(clip).reshape(9, h, w * 3).cuda()
    _report("encode_batch8", lambda: enc.encode_packed(packed, 0), args.out,
            args.rows)

    out = enc.encode_packed(packed, 0)
    dec = Decoder(DecoderConfig(), enc.header(8), batch_size=8, device="cuda")
    coeffs = out["coeffs"]
    nby, nbx = coeffs.shape[1:3]
    types = np.repeat(np.repeat(out["block_types"].cpu().numpy(), 2, 1), 2, 2)
    rects = np.tile(np.array([[928, 512, 64, 64]], np.int64), (8, 1))
    _report("decode_batch8",
            lambda: dec.decode_batch(coeffs, types[:, :nby, :nbx], rects),
            args.out, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
