"""Time a kernel of this checkout's library against a variant library built
from a copy of ``csrc/`` with text edits, in turns, in one process on one
CUDA card.

  python -m svc_tpu_torch.tools.variant_timing \\
      --edit pyr_down_levels.cuh '__launch_bounds__(kLvThreads, 6)' \\
      '__launch_bounds__(kLvThreads)'

(the fused pyramid kernels with and without their minimum of 6 CTAs per
SM), or, with ``--target ccl``, K10's cluster kernel, e.g. on clusters of
16 CTAs (``--edit`` may be given more than once; each old text must occur
exactly once):

  python -m svc_tpu_torch.tools.variant_timing --target ccl \\
      --edit ccl_converge.cu 'kCluster = 8;' 'kCluster = 16;' \\
      --edit ccl_converge.cu '  // set on every call:' \\
      $'  cudaFuncSetAttribute(ccl_cluster_kernel, \\
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\\n  // set on every call:'

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
spiral, 8 frames of 135x240 and 2 of 270x480 blobs. The two libraries'
outputs must be equal bit for bit (K10's also to its plain version).
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
from svc_tpu_torch.ops import ccl, pyramid
from svc_tpu_torch.tools import ccl_cases

VARIANT_DIR = build.BUILD_DIR.parent / "variant"
# the ptxas entries reported for each target
KERNEL = {"pyramid": "pyr_down_levels_kernel", "ccl": "ccl_cluster_kernel"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edit", nargs=3, action="append", required=True,
                    metavar=("FILE", "OLD", "NEW"),
                    help="csrc file and the text replaced once in it "
                         "(repeatable)")
    ap.add_argument("--target", choices=sorted(KERNEL), default="pyramid",
                    help="the kernels timed (default: pyramid)")
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

    kernels, work, want = (ccl_work if args.target == "ccl" else pyramid_work)()
    outs = {}
    for name, lib in libs.items():
        bind(kernels, lib)
        outs[name] = {w: fn() for w, fn in work.items()}
    for w in work:
        a, b = outs["base"][w], outs["variant"][w]
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        if w in want:
            same = same and torch.equal(a.cpu(), want[w])
        if not same:
            print(f"variant_timing: {w} differs between the two builds or from "
                  f"its plain version", file=sys.stderr)
            return 1
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
              f"bit-equal")
    bind(kernels, libs["base"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
