"""Where the time goes in one 1080p encode batch, one decode batch and one
per-frame motion search.

Runs the port's encode (``Encoder.encode_packed``, with the default
``EncoderConfig()`` that users run; as its CUDA graph replay and eagerly,
``graph=False``), decode (``Decoder.decode_batch``: eagerly, as a replay
fed a device tensor, and as a replay whose coefficients the stager copied
from the host straight into the graph's input) and per-frame
``ops.motion.hbma`` of one padded 1080p frame pair on one CUDA card under
``torch.profiler`` after a warm-up. It prints what ptxas reported for each
kernel (registers, shared memory, spills) when the library is built in
this process, then per batch: wall time, device busy time (the union of
kernel and copy intervals; beside it that of the kernels alone) and idle
share, the launches (:func:`batch_launches`: the host's launch calls and
the operations the device ran), the device's copies with their bytes
(:func:`device_copies`), and the device time by kernel name. The Chrome
traces go to ``--out`` (default ``build/profile/``).

  python -m svc_tpu_torch.tools.profile_slice
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from svc_tpu_torch.tools.clips import make_clip
from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.kernels import build
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder
from svc_tpu_torch.ops import motion
from svc_tpu_torch.ops.color import bgr_planes_to_y
from svc_tpu_torch.ops.pad import pad_frame
from svc_tpu_torch.ops.pyramid import build_pyramid


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_us(prof, kernels_only: bool = False) -> float:
    """Union of the device's kernel and copy intervals (``kernels_only``:
    kernels alone), in microseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not (kernels_only and _is_copy(e.name))
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


#: CUDA API calls (``cuda*`` and the lower-level ``cu*``) that put work on
#: a stream: kernel launches (the port's kernels go through the runtime
#: linked into their library), graph launches, copies and fills
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _launches(prof) -> Dict[str, int]:
    host = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name in LAUNCH_CALLS)
    device = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"host_launch_calls": host, "device_ops": device}


def device_copies(prof, trace_path: str) -> List[Dict]:
    """Each copy the device ran (``name``, ``bytes``, ``us``), from the
    Chrome trace exported to ``trace_path`` (once a profile), where the
    profiler writes a copy's bytes; ``bytes`` is None where it wrote none."""
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [{"name": e["name"], "bytes": e.get("args", {}).get("bytes"),
             "us": float(e.get("dur", 0.0))}
            for e in events if e.get("cat") == "gpu_memcpy"]


def profile_once(fn):
    """``torch.profiler`` over one call of ``fn`` after two warm-up calls
    (so each graph of a ``GraphPair`` has replayed once before); returns
    the profile and the wall time in microseconds."""
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def batch_launches(fn) -> Dict[str, int]:
    """Launches of one call of ``fn`` after two warm-up calls, under
    ``torch.profiler``: the host's launch calls (``LAUNCH_CALLS``; a graph
    replay is one) and the operations the device ran (kernels, copies,
    fills; a replay's nodes each count)."""
    return _launches(profile_once(fn)[0])


def staged_decode_profile(seed: int = 0) -> Dict:
    """One 1080p decode batch of 8 (seeded coefficients and block types)
    staged as ``decode_frames``' stager stages it, the coefficients into
    the next replay's static input, and replayed, under ``torch.profiler``
    after a warm-up: the device's copies (:func:`device_copies`), the
    coefficients' bytes, device busy time with and without the copies,
    wall time and launches. ``chip_smoke.py`` runs it in a process of its
    own, whose profiler has traced nothing before."""
    header = bitstream.Header(8, 1920, 1080, 0, 8, 8, 8, 3)
    dec = Decoder(DecoderConfig(), header, batch_size=8, device="cuda")
    rng = np.random.default_rng(seed)
    coeffs = (rng.normal(size=(8, 136, 240, 192)) * 90).astype(np.float32)
    types = rng.integers(0, 3, (8, 136, 240)).astype(np.uint32)
    rects = np.tile(np.array([[928, 512, 64, 64]], np.int64), (8, 1))
    prof, wall_us = profile_once(
        lambda: dec.decode_batch(*dec._stage_batch((coeffs, types, rects))))
    with tempfile.TemporaryDirectory() as tmp:
        copies = device_copies(prof, os.path.join(tmp, "trace.json"))
    return {"copies": copies, "coeff_bytes": coeffs.nbytes,
            "busy_ms": busy_us(prof) / 1e3,
            "kernels_busy_ms": busy_us(prof, True) / 1e3,
            "wall_ms": wall_us / 1e3, **_launches(prof)}


def _report(name: str, fn, out_dir: str, rows: int) -> None:
    prof, wall_us = profile_once(fn)
    busy = busy_us(prof)
    launches = _launches(prof)
    copies = "; ".join(
        f"{c['name']} {c['bytes']} B {c['us']:.1f} us"
        for c in device_copies(prof, os.path.join(out_dir, f"trace_{name}.json")))
    print(f"== {name}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms (kernels {busy_us(prof, True) / 1e3:.3f}), "
          f"idle share {1 - busy / wall_us:.3f}; "
          f"{launches['host_launch_calls']} host launch calls, "
          f"{launches['device_ops']} device operations; copies: "
          f"{copies or 'none'}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=rows))


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
    enc = Encoder(EncoderConfig(), VideoProperties(w, h, 9), batch_size=8,
                  device="cuda")
    eager = Encoder(EncoderConfig(), VideoProperties(w, h, 9), batch_size=8,
                    device="cuda", graph=False)
    packed = torch.as_tensor(clip).reshape(9, h, w * 3).cuda()
    _report("encode_batch8_graph", lambda: enc.encode_packed(packed, 0),
            args.out, args.rows)
    _report("encode_batch8_eager", lambda: eager.encode_packed(packed, 0),
            args.out, args.rows)

    out = enc.encode_packed(packed, 0)
    dec = Decoder(DecoderConfig(), enc.header(8), batch_size=8, device="cuda")
    eager_dec = Decoder(DecoderConfig(), enc.header(8), batch_size=8,
                        device="cuda", graph=False)
    coeffs = out["coeffs"].clone()
    host_coeffs = coeffs.cpu().numpy()
    nby, nbx = coeffs.shape[1:3]
    types = np.repeat(np.repeat(out["block_types"].cpu().numpy(), 2, 1), 2,
                      2)[:, :nby, :nbx]
    rects = np.tile(np.array([[928, 512, 64, 64]], np.int64), (8, 1))
    _report("decode_batch8", lambda: eager_dec.decode_batch(coeffs, types, rects),
            args.out, args.rows)
    _report("decode_batch8_graph", lambda: dec.decode_batch(coeffs, types, rects),
            args.out, args.rows)
    # staged as decode_frames' stager stages a batch
    _report("decode_batch8_graph_staged",
            lambda: dec.decode_batch(*dec._stage_batch((host_coeffs, types, rects))),
            args.out, args.rows)

    # frames 0 and 1 of the clip, as the encoder's frontend pads their luma
    px = packed[:2].reshape(2, h, w, 3)
    luma = pad_frame(bgr_planes_to_y(px[..., 0], px[..., 1], px[..., 2]),
                     enc.padded_w, enc.padded_h)
    pyr = build_pyramid(luma, 4)
    tracked, anchor = [p[0] for p in pyr], [p[1] for p in pyr]
    _report("hbma_pair", lambda: motion.hbma(tracked, anchor, 8, 16, 16),
            args.out, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
