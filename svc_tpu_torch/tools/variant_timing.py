"""Time a kernel of this checkout's library against a variant library built
from a copy of ``csrc/`` with text edits, in turns, in one process on one
CUDA card.

  python -m svc_tpu_torch.tools.variant_timing \\
      --edit pyr_down_levels.cuh '__launch_bounds__(kLvThreads, 6)' \\
      '__launch_bounds__(kLvThreads)'

(the fused pyramid kernels with and without their minimum of 6 CTAs per
SM), with ``--target display``, K1's square-block kernels (e.g. ``--edit
idct_display_sq.cu 'kMinCtas = 3;' 'kMinCtas = 2;'``), with ``--target
resize``, K6's square-block kernels (e.g. the whole halo block in the
4x4 ring: ``--edit idct_resize_sq.cu 'kHaloColumns = 4, kRingPitch = 206'
'kHaloColumns = 1, kRingPitch = 198'``), or, with
``--target ccl``, K10's cluster kernel, e.g. on clusters of
16 CTAs (``--edit`` may be given more than once; each old text must occur
exactly once):

  python -m svc_tpu_torch.tools.variant_timing --target ccl \\
      --edit ccl_converge.cu 'kCluster = 8;' 'kCluster = 16;' \\
      --edit ccl_converge.cu '  // set on every call:' \\
      $'  cudaFuncSetAttribute(ccl_cluster_kernel, \\
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\\n  // set on every call:'

``--unchecked`` times a variant whose outputs may differ: a probe of
what a piece of the kernel's work costs (e.g. the display target's
dequantizing division as a multiplication), never a candidate; its
times are printed beside how far its outputs are from the base build's.

The variant's sources go to ``build/variant/csrc`` and its library to
``build/variant/lib`` (both gitignored). Both builds compile one nvcc
process per source; the script prints what ptxas reported for the
target's kernels in each (registers, spill stores), then times them on
each library: 20 calls captured in one CUDA graph, replayed 5 times, the
median replay over 20. The turns go base, variant, variant, base, twice.
The pyramid target times K4's ``pyr_down_levels`` and the K8 pyramid's
``pyr_down_pitched_levels`` (levels 1-3 of a 9x1088x1920 uint8 stack, the
pitched one as 8 subplanes); the ccl target times ``converge_labels`` on
the 1080p path shape (8 frames of 68x120 cells in 8x8 blobs of 10
clusters, a tenth background, 4-connectivity), ``tools/ccl_cases.py``'s
spiral, 8 frames of 135x240 and 2 of 270x480 blobs; the display target
times ``idct_display`` at 4x4 and 16x16 blocks (8 frames of 1088 padded
rows to 1080, steps 1 and 640 at random); the resize target
``idct_resize_display`` there (8 frames of 1376x768 to 1366x768 and of
864x480 to 854x480). The two libraries' outputs must be equal bit for
bit (K10's also to its plain version).
Nothing of the checkout's sources changes.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys

import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import ccl, dct, pyramid
from svc_tpu_torch.tools import ccl_cases

VARIANT_DIR = build.BUILD_DIR.parent / "variant"
# the ptxas entries reported for each target
KERNEL = {"pyramid": "pyr_down_levels_kernel", "ccl": "ccl_cluster_kernel",
          "display": "idct_sq_display_kernel",
          "resize": "idct_sq_resize_kernel"}


def build_variant(edits) -> build.BuildResult:
    """Build the library from a copy of ``csrc/`` with each ``(path, old,
    new)`` of ``edits`` applied in turn (``old`` exactly once)."""
    csrc = VARIANT_DIR / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, csrc)
    for path, old, new in edits:
        src = csrc / path
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant_timing: {old!r} occurs {text.count(old)} "
                             f"times in {path}, not once")
        src.write_text(text.replace(old, new))
    saved = build.CSRC_DIR, build.BUILD_DIR, build._build_result
    build.CSRC_DIR, build.BUILD_DIR = csrc, VARIANT_DIR / "lib"
    build._build_result = None
    try:
        return build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR, build._build_result = saved


def ptxas_lines(log: str, kernel: str):
    """``[(mangled name, registers, spill store bytes)]`` of the entry
    functions whose name holds ``kernel``."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            name, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if kernel in name:
                out.append((name, int(m.group(1)), spill))
            name = None
    return out


def bind(kernels, lib) -> None:
    """Point each kernel's launches at ``lib``'s entry point."""
    for k in kernels:
        fn = getattr(lib, k.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = k.argtypes
        k._fn = fn


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Median device ms of one call: ``iters`` calls in one CUDA graph,
    ``replays`` timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def pyramid_work():
    """The kernels, the calls timed and the plain reference (none) of the
    pyramid target."""
    g = torch.Generator().manual_seed(0)
    y = torch.randint(0, 256, (9, 1088, 1920), generator=g,
                      dtype=torch.uint8).cuda()
    y8 = pyramid.to_pitched(y, 8)
    work = {
        "K4 pyr_down_levels": lambda: pyramid.pyr_down_levels(y, 3),
        "K8 pyr_down_pitched_levels": lambda: pyramid.pyr_down_pitched_levels(y8, 3),
    }
    return [pyramid.PYR_DOWN_LEVELS, pyramid.PYR_DOWN_PITCHED_LEVELS], work, {}


def ccl_work():
    """The kernel, the calls timed and their plain results for the ccl
    target."""
    g = torch.Generator().manual_seed(0)
    inputs = {"K10 path blobs 8x68x120": ccl_cases.blobs(g, 8, 68, 120, 10),
              "K10 spiral 68x120": ccl_cases.spiral(),
              "K10 blobs 8x135x240": ccl_cases.blobs(g, 8, 135, 240, 10),
              "K10 blobs 2x270x480": ccl_cases.blobs(g, 2, 270, 480, 10)}
    work, want = {}, {}
    for name, lab in inputs.items():
        x = lab.cuda()
        work[name] = lambda x=x: ccl.converge_labels(x, 4)
        want[name] = ccl.converge_labels_plain(lab, 4)
    return [ccl.CCL_CONVERGE], work, want


def display_work():
    """The kernels, the calls timed and the plain reference (none) of the
    display target."""
    g = torch.Generator().manual_seed(0)
    work = {}
    for b, k in dct.IDCT_DISPLAY_SQ.items():
        shape = (8, 1088 // b, 1920 // b)
        coeffs = (torch.randn(shape + (3 * b * b,), generator=g) * 90).cuda()
        steps = torch.where(torch.rand(shape, generator=g) < 0.5, 640.0,
                            1.0).cuda()
        work[f"K1 {k.name} 8x1088->1080"] = (
            lambda c=coeffs, s=steps, b=b: dct.idct_display(c, s, 1080, 3, b, b))
    return list(dct.IDCT_DISPLAY_SQ.values()), work, {}


def resize_work():
    """The kernels, the calls timed and the plain reference (none) of the
    resize target."""
    g = torch.Generator().manual_seed(0)
    work = {}
    for b, k in dct.IDCT_RESIZE_SQ.items():
        for w, h, pw in ((1366, 768, 1376), (854, 480, 864)):
            shape = (8, h // b, pw // b)
            coeffs = (torch.randn(shape + (3 * b * b,), generator=g) * 90).cuda()
            steps = torch.where(torch.rand(shape, generator=g) < 0.5, 640.0,
                                1.0).cuda()
            work[f"K6 {k.name} 8x{pw}x{h}->{w}x{h}"] = (
                lambda c=coeffs, s=steps, b=b, w=w, h=h:
                dct.idct_resize_display(c, s, h, w, 3, b, b))
    return list(dct.IDCT_RESIZE_SQ.values()), work, {}


WORK = {"pyramid": pyramid_work, "ccl": ccl_work, "display": display_work,
        "resize": resize_work}


def diff(a, b) -> str:
    """How far a probe's outputs ``b`` are from the base build's ``a``."""
    pairs = [(a, b)] if isinstance(a, torch.Tensor) else list(zip(a, b))
    d = [(x.double() - y.double()).abs() for x, y in pairs]
    worst = max(float(t.max()) for t in d)
    share = sum(int((t > 0).sum()) for t in d) / sum(t.numel() for t in d)
    return f"outputs differ, max |diff| {worst:g} on {share:.4%} of elements"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edit", nargs=3, action="append", required=True,
                    metavar=("FILE", "OLD", "NEW"),
                    help="csrc file and the text replaced once in it "
                         "(repeatable)")
    ap.add_argument("--target", choices=sorted(KERNEL), default="pyramid",
                    help="the kernels timed (default: pyramid)")
    ap.add_argument("--unchecked", action="store_true",
                    help="time the variant even where its outputs differ "
                         "(a cost probe, not a candidate)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variant_timing: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "card: ?")

    base = build.build()
    variant = build_variant(args.edit)
    libs = {"base": build.library(), "variant": ctypes.CDLL(str(variant.path))}
    for name, res in (("base", base), ("variant", variant)):
        rows = ptxas_lines(res.log, KERNEL[args.target]) or "not reported (already built)"
        print(f"ptxas {name}: {rows}")

    kernels, work, want = WORK[args.target]()
    outs = {}
    for name, lib in libs.items():
        bind(kernels, lib)
        outs[name] = {w: fn() for w, fn in work.items()}
    verdict = {}
    for w in work:
        a, b = outs["base"][w], outs["variant"][w]
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        if w in want:
            same = same and torch.equal(a.cpu(), want[w])
        if not same and not args.unchecked:
            print(f"variant_timing: {w} differs between the two builds or from "
                  f"its plain version", file=sys.stderr)
            return 1
        verdict[w] = "bit-equal" if same else f"unchecked probe: {diff(a, b)}"
    order = ["base", "variant", "variant", "base"] * 2
    for w, fn in work.items():
        turns = []
        for name in order:
            bind(kernels, libs[name])
            turns.append(graph_ms(fn))
        mean = {n: statistics.mean(t for o, t in zip(order, turns) if o == n)
                for n in ("base", "variant")}
        print(f"{w}: base {mean['base']:.4f} ms, variant {mean['variant']:.4f} "
              f"ms (in turns {', '.join(f'{o} {t:.4f}' for o, t in zip(order, turns))}); "
              f"{verdict[w]}")
    bind(kernels, libs["base"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
