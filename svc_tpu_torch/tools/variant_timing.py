"""Time a kernel of this checkout's library against a variant library built
from a copy of ``csrc/`` with text edits, in turns, in one process on one
CUDA card.

  python -m svc_tpu_torch.tools.variant_timing \\
      --edit pyr_down_levels.cuh '__launch_bounds__(kLvThreads, 6)' \\
      '__launch_bounds__(kLvThreads)'

(the fused pyramid kernels with and without their minimum of 6 CTAs per
SM), with ``--target display``, K1's templated kernels (e.g. ``--edit
idct_display_sq.cu 'kCoefGroup = 336, kMinCtas = 3,' 'kCoefGroup = 336,
kMinCtas = 2,'``), with ``--target wire``, K2's (``dct_wire_sq.cu``),
with ``--target
resize``, K6's templated kernels (e.g. column 0 alone of the halo
block in the 4x4 ring: ``--edit idct_resize_sq.cu
'kCoefGroup = 36, kHaloColumns = 4' 'kCoefGroup = 36, kHaloColumns = 1'``),
with ``--target motion``, the specialised K3 (its instances at every
radius both wrapper modules take), K9 and the K8 refine, which shares
K3's row arithmetic (e.g. K3's split kernel at 16x16 blocks and R >= 2
with 8 lanes of 2 anchor rows a block, not 4 of 4: ``--edit
refine_sads.cu 'constexpr int kSplitRows = 4;' 'constexpr int kSplitRows
= 2;'``), or, with
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

``--against DIR`` builds the variant from another checkout's sources
(``DIR/svc_tpu_torch/csrc``, e.g. the parent commit unpacked with ``git
archive`` into a git-ignored directory) and calls it through that
checkout's wrapper module (``ops/dct.py`` for the display, wire and
resize targets, ``ops/motion.py`` for the motion target), so its kernels
keep their own C signatures; ``--edit`` is then optional. Only the shapes
(and radii) both wrapper modules have a templated kernel for are timed:

  python -m svc_tpu_torch.tools.variant_timing --target wire \\
      --against build/parent

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
times ``idct_display`` at the blocks of K1's templated kernel (8 frames
of 1088 padded rows to 1080, steps 1 and 640 at random); the wire target
``dct8x8_to_wire`` at K2's (8 anchor frames of 9 packed 1080p frames);
the resize target ``idct_resize_display`` at the blocks of K6's
templated kernel (8 frames of 1376x768 to 1366x768 and of 864x480 to
854x480); the motion target ``refine_sads`` at levels 2, 1, 0 of that
stack (blocks whose longer side is 4, 8, 16, and 2x2 on level 2, 32 on
level 0; the ratio-4 blocks on the levels of 32x8 and 8x32 MV blocks,
32x8's on 1080 rows; even MVs within the level's reach), ``refine_mads``
on frames 0 and 1 of each level and ``candidate_sads`` at the level each
block is the top of (1x1, 2x2, 2x1 and 1x2 on the 136x240 one, 4x4, 4x2
and 2x4 on 272x480, 8x8, 8x4, 4x8, 16x16, 16x8 and 8x16 on 544x960; the
ratio-4 blocks of 32x8 MV blocks on 1080 rows, 4x1 on 135x240, 8x2 on
270x480, 16x4 on 540x960, those of 8x32 on 1088; 2x2 also on 96x172 and
36x44, the tops of 1376x768 and 352x288; zero MVs, T = 8) at each radius
(the blocks and radii both wrapper modules specialise); past the near
radii (``_FAR_RADII``, R = 5-8) ``refine_sads`` and ``refine_mads`` at
32x32 and 16x16 on level 0, 8x8 on level 1, 4x4 and 2x2 on level 2 (even
MVs within +-2R) and ``candidate_sads`` at 16x16 on level 0, 8x8 on level
1, 4x4 on level 2 and 2x2 and 1x1 on level 3 (zero MVs); and
``refine_sads_pitched`` at
level 0 (8 subplanes, r = 1). ``--only REGEX`` times only the calls
whose names match (e.g. ``--only ', [5-8]>'``). The two
libraries' outputs must be equal bit for bit (K10's also to its plain
version).
Nothing of the checkout's sources changes.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import shutil
import statistics
import subprocess
import sys

import torch

from pathlib import Path

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import ccl, dct, motion, pyramid
from svc_tpu_torch.tools import ccl_cases

VARIANT_DIR = build.BUILD_DIR.parent / "variant"
# the ptxas entries reported for each target
KERNEL = {"pyramid": "pyr_down_levels_kernel", "ccl": "ccl_cluster_kernel",
          "display": "idct_sq_display_kernel", "wire": "dct_sq_wire_kernel",
          "resize": "idct_sq_resize_kernel", "motion": "sads"}
# the wrapper module each target calls
MODULE = {"pyramid": pyramid, "ccl": ccl, "display": dct, "wire": dct,
          "resize": dct, "motion": motion}


def build_variant(edits, csrc_from=None) -> build.BuildResult:
    """Build the library from a copy of ``csrc_from`` (this checkout's
    ``csrc/`` by default) with each ``(path, old, new)`` of ``edits``
    applied in turn (``old`` exactly once)."""
    csrc = VARIANT_DIR / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from or build.CSRC_DIR, csrc)
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


def load_wrappers(checkout, module):
    """Another checkout's copy of the wrapper module ``module`` (its
    ``Kernel`` objects carry that checkout's C signatures). Its kernels do
    not enter this process's registry of launch counts."""
    name = module.__name__.rsplit(".", 1)[1]
    path = Path(checkout) / "svc_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"variant_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = dict(build._REGISTRY)
    try:
        spec.loader.exec_module(mod)
    finally:
        build._REGISTRY.clear()
        build._REGISTRY.update(saved)
    return mod


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


# Each target's work takes the wrapper modules of the two libraries and
# returns the kernels of a module to bind, the calls timed (each given the
# module to call through) and their plain results where they are checked.


def pyramid_work(mods):
    """The kernels, the calls timed and the plain reference (none) of the
    pyramid target."""
    g = torch.Generator().manual_seed(0)
    y = torch.randint(0, 256, (9, 1088, 1920), generator=g,
                      dtype=torch.uint8).cuda()
    y8 = pyramid.to_pitched(y, 8)
    work = {
        "K4 pyr_down_levels": lambda m: m.pyr_down_levels(y, 3),
        "K8 pyr_down_pitched_levels": lambda m: m.pyr_down_pitched_levels(y8, 3),
    }
    return (lambda m: [m.PYR_DOWN_LEVELS, m.PYR_DOWN_PITCHED_LEVELS]), work, {}


def ccl_work(mods):
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
        work[name] = lambda m, x=x: m.converge_labels(x, 4)
        want[name] = ccl.converge_labels_plain(lab, 4)
    return (lambda m: [m.CCL_CONVERGE]), work, want


def templated_shapes(mods, table):
    """The (rows, columns) block shapes every module's templated-kernel
    table ``table`` has (keyed by B for squares or by (BH, BW))."""
    return sorted(set.intersection(*(
        {k if isinstance(k, tuple) else (k, k) for k in getattr(m, table)}
        for m in mods)))


def display_work(mods):
    """The kernels, the calls timed and the plain reference (none) of the
    display target."""
    g = torch.Generator().manual_seed(0)
    work = {}
    for bh, bw in templated_shapes(mods, "IDCT_DISPLAY_SQ"):
        shape = (8, 1088 // bh, 1920 // bw)
        coeffs = (torch.randn(shape + (3 * bh * bw,), generator=g) * 90).cuda()
        steps = torch.where(torch.rand(shape, generator=g) < 0.5, 640.0,
                            1.0).cuda()
        work[f"K1 idct{bh}x{bw}_display 8x1088->1080"] = (
            lambda m, c=coeffs, s=steps, bh=bh, bw=bw:
            m.idct_display(c, s, 1080, 3, bh, bw))
    return (lambda m: list(m.IDCT_DISPLAY_SQ.values())), work, {}


def wire_work(mods):
    """The kernels, the calls timed and the plain reference (none) of the
    wire target."""
    g = torch.Generator().manual_seed(0)
    packed = torch.randint(0, 256, (9, 1080, 5760), generator=g,
                           dtype=torch.uint8).cuda()
    work = {}
    for bh, bw in templated_shapes(mods, "DCT_WIRE_SQ"):
        work[f"K2 dct{bh}x{bw}_to_wire 8x1080p"] = (
            lambda m, bh=bh, bw=bw: m.dct8x8_to_wire(packed, 1, 8, 1088, 1920,
                                                     bh, bw))
    return (lambda m: list(m.DCT_WIRE_SQ.values())), work, {}


def resize_work(mods):
    """The kernels, the calls timed and the plain reference (none) of the
    resize target."""
    g = torch.Generator().manual_seed(0)
    work = {}
    for bh, bw in templated_shapes(mods, "IDCT_RESIZE_SQ"):
        for w, h, pw in ((1366, 768, 1376), (854, 480, 864)):
            shape = (8, h // bh, pw // bw)
            coeffs = (torch.randn(shape + (3 * bh * bw,), generator=g) * 90).cuda()
            steps = torch.where(torch.rand(shape, generator=g) < 0.5, 640.0,
                                1.0).cuda()
            work[f"K6 idct{bh}x{bw}_resize_display 8x{pw}x{h}->{w}x{h}"] = (
                lambda m, c=coeffs, s=steps, bh=bh, bw=bw, w=w, h=h:
                m.idct_resize_display(c, s, h, w, 3, bh, bw))
    return (lambda m: list(m.IDCT_RESIZE_SQ.values())), work, {}


def motion_work(mods):
    """The kernels, the calls timed and the plain reference (none) of the
    motion target: the specialised K3 and K7 at each block of every
    module's ``_K3_BLOCKS`` (4, 8, 16 without it) and each radius of every
    ``_SAD_RADII`` (r = 1 without it), K9 at each block of every
    ``_K9_BLOCKS`` (2 without it) and the same radii, and the K8 refine.
    A block is (width, height); a module whose sets hold sides names
    square blocks."""
    g = torch.Generator().manual_seed(0)
    y = torch.randint(0, 256, (9, 1088, 1920), generator=g,
                      dtype=torch.uint8).cuda()
    chain = pyramid.build_pyramid(y, 4)
    # 32x8 MV blocks' levels: 1080 rows, as the encoder pads them
    chain1080 = pyramid.build_pyramid(y[:, :1080].contiguous(), 4)

    def common(name, default):
        sets = [{(b, b) if isinstance(b, int) else b for b in getattr(m, name, default)}
                for m in mods]
        return sorted(set.intersection(*sets))

    radii = sorted(set.intersection(*(set(getattr(m, "_SAD_RADII", (1,))) for m in mods)))
    work = {}
    for r in radii:
        # K3 / K7 on levels 2, 1, 0 (longer sides 4, 8, 16 and 32; 2x2 on
        # level 2 where both modules specialise it: 8x8 MV blocks; the
        # ratio-4 blocks on the levels of 32x8 and 8x32 MV blocks, 32x8's on
        # 1080 rows)
        for bw, bh in common("_K3_BLOCKS", (4, 8, 16)):
            ratio4 = max(bw, bh) == 4 * min(bw, bh)
            if ratio4:
                lvl = {32: 0, 16: 1, 8: 2}[max(bw, bh)]
            else:
                lvl = {2: 2, 4: 2, 8: 1, 16: 0, 32: 0}[max(bw, bh)]
            levels = chain1080 if ratio4 and bw > bh else chain
            shape = (8, levels[lvl].shape[1] // bh, (1920 >> lvl) // bw, 2)
            reach = (2 * r) << (2 - lvl)
            mv = (2 * torch.randint(-reach // 2, reach // 2 + 1, shape,
                                    generator=g, dtype=torch.int32)).cuda()
            label = f"<{bw}, {r}>" if bw == bh else f"<{bw}x{bh}, {r}>"
            work[f"K3 refine_sads{label} level {lvl}"] = (
                lambda m, s=levels[lvl], mv=mv, bw=bw, bh=bh, r=r:
                m.refine_sads(s, mv, r, bw, bh))
            work[f"K7 refine_mads{label} level {lvl} (one pair)"] = (
                lambda m, s=levels[lvl], mv=mv[0], bw=bw, bh=bh, r=r:
                m.refine_mads(s[0], s[1], mv, r, bw, bh))
        # K9 at the top level each block is the top of (1x1, 2x2, 2x1, 1x2
        # on level 3, 4x4, 4x2, 2x4 on 2, 8x8, 8x4, 4x8 on 1, and 16x16,
        # 16x8, 8x16 on 1, the top of 2 levels of 32-pixel MV blocks; 4x1,
        # 1x4 on 3, 8x2, 2x8 on 2, 16x4, 4x16 on 1, 32x8's on 1080 rows),
        # zero MVs
        for bw, bh in common("_K9_BLOCKS", (2,)):
            ratio4 = max(bw, bh) == 4 * min(bw, bh)
            if ratio4:
                lvl = {4: 3, 8: 2, 16: 1}[max(bw, bh)]
            else:
                lvl = {1: 3, 2: 3, 4: 2, 8: 1, 16: 1}[max(bw, bh)]
            top = (chain1080 if ratio4 and bw > bh else chain)[lvl]
            zero = torch.zeros((8, top.shape[1] // bh, top.shape[2] // bw, 2),
                               dtype=torch.int32).cuda()
            label = f"<{bw}, {r}>" if bw == bh else f"<{bw}x{bh}, {r}>"
            work[f"K9 candidate_sads{label} 8x{top.shape[1]}x{top.shape[2]}"] = (
                lambda m, tr=top[:-1], an=top[1:], z=zero, bw=bw, bh=bh, r=r:
                m.candidate_sads(tr, an, z, r, bw, bh))
        # K9 2x2 on the top levels of 1376x768 and 352x288 (86 and 22 block
        # columns: under a CTA's 128 threads)
        for h, w in ((768, 1376), (288, 352)):
            small = pyramid.build_pyramid(y[:, :h, :w].contiguous(), 4)[3]
            zero = torch.zeros((8, small.shape[1] // 2, small.shape[2] // 2, 2),
                               dtype=torch.int32).cuda()
            work[f"K9 candidate_sads<2, {r}> 8x{small.shape[1]}x{small.shape[2]}"] = (
                lambda m, tr=small[:-1], an=small[1:], z=zero, r=r:
                m.candidate_sads(tr, an, z, r, 2, 2))
    # past the near radii (R = 5-8 where both modules have them): K3 / K7
    # at 32x32 and 16x16 on level 0, 8x8 on 1, 4x4 and 2x2 on 2 (2x2: level
    # 2 of 8x8 MV blocks at 4 levels) with even MVs within +-2R, K9 at 16x16
    # on level 0 (one level's EBMA), 8x8, 4x4, 2x2 and 1x1 on levels 1, 2, 3
    # and 3 (the top of 2, 3 and 4 levels of 16x16 MV blocks, of 4 of 8x8),
    # zero MVs
    far = sorted(set.intersection(*(set(getattr(m, "_FAR_RADII", ())) for m in mods)))
    k3_level = {32: 0, 16: 0, 8: 1, 4: 2, 2: 2}
    level_of = {16: 0, 8: 1, 4: 2, 2: 3, 1: 3}
    for r in far:
        for bw, bh in common("_K3_FAR_BLOCKS", ()):
            lvl = k3_level[max(bw, bh)]
            level = chain[lvl]
            shape = (8, level.shape[1] // bh, level.shape[2] // bw, 2)
            mv = (2 * torch.randint(-r, r + 1, shape, generator=g, dtype=torch.int32)).cuda()
            label = f"<{bw}, {r}>" if bw == bh else f"<{bw}x{bh}, {r}>"
            work[f"K3 refine_sads{label} level {lvl}"] = (
                lambda m, s=level, mv=mv, bw=bw, bh=bh, r=r: m.refine_sads(s, mv, r, bw, bh))
            work[f"K7 refine_mads{label} level {lvl} (one pair)"] = (
                lambda m, s=level, mv=mv[0], bw=bw, bh=bh, r=r:
                m.refine_mads(s[0], s[1], mv, r, bw, bh))
        for bw, bh in common("_K9_FAR_BLOCKS", ()):
            top = chain[level_of[max(bw, bh)]]
            zero = torch.zeros((8, top.shape[1] // bh, top.shape[2] // bw, 2),
                               dtype=torch.int32).cuda()
            label = f"<{bw}, {r}>" if bw == bh else f"<{bw}x{bh}, {r}>"
            work[f"K9 candidate_sads{label} 8x{top.shape[1]}x{top.shape[2]}"] = (
                lambda m, tr=top[:-1], an=top[1:], z=zero, bw=bw, bh=bh, r=r:
                m.candidate_sads(tr, an, z, r, bw, bh))
    y8 = pyramid.to_pitched(y, 8)
    mv0 = (2 * torch.randint(-7, 8, (8, 68, 120, 2), generator=g,
                             dtype=torch.int32)).cuda()
    work["K8 refine_sads_pitched level 0"] = (
        lambda m: m.refine_sads_pitched(y8, mv0, 1, 16, 16))
    return (lambda m: [m.REFINE_SADS, m.REFINE_MADS, m.CANDIDATE_SADS,
                       m.REFINE_SADS_PITCHED]), work, {}


WORK = {"pyramid": pyramid_work, "ccl": ccl_work, "display": display_work,
        "wire": wire_work, "resize": resize_work, "motion": motion_work}


def diff(a, b) -> str:
    """How far a probe's outputs ``b`` are from the base build's ``a``."""
    pairs = [(a, b)] if isinstance(a, torch.Tensor) else list(zip(a, b))
    d = [(x.double() - y.double()).abs() for x, y in pairs]
    worst = max(float(t.max()) for t in d)
    share = sum(int((t > 0).sum()) for t in d) / sum(t.numel() for t in d)
    return f"outputs differ, max |diff| {worst:g} on {share:.4%} of elements"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edit", nargs=3, action="append", default=[],
                    metavar=("FILE", "OLD", "NEW"),
                    help="csrc file and the text replaced once in it "
                         "(repeatable)")
    ap.add_argument("--against", metavar="DIR",
                    help="build the variant from the checkout DIR's sources "
                         "and call it through DIR's wrappers")
    ap.add_argument("--target", choices=sorted(KERNEL), default="pyramid",
                    help="the kernels timed (default: pyramid)")
    ap.add_argument("--only", metavar="REGEX",
                    help="time only the target's calls whose names match")
    ap.add_argument("--unchecked", action="store_true",
                    help="time the variant even where its outputs differ "
                         "(a cost probe, not a candidate)")
    args = ap.parse_args(argv)
    if not (args.edit or args.against):
        ap.error("give --edit, --against or both")
    if not torch.cuda.is_available():
        print("variant_timing: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "card: ?")

    base = build.build()
    module = MODULE[args.target]
    csrc = Path(args.against) / "svc_tpu_torch" / "csrc" if args.against else None
    variant = build_variant(args.edit, csrc)
    libs = {"base": build.library(), "variant": ctypes.CDLL(str(variant.path))}
    mods = {"base": module,
            "variant": load_wrappers(args.against, module) if args.against else module}
    for name, res in (("base", base), ("variant", variant)):
        rows = ptxas_lines(res.log, KERNEL[args.target]) or "not reported (already built)"
        print(f"ptxas {name}: {rows}")

    kernels, work, want = WORK[args.target](list(mods.values()))
    if args.only:
        work = {w: fn for w, fn in work.items() if re.search(args.only, w)}
    outs = {}
    for name, lib in libs.items():
        bind(kernels(mods[name]), lib)
        outs[name] = {w: fn(mods[name]) for w, fn in work.items()}
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
            bind(kernels(mods[name]), libs[name])
            turns.append(graph_ms(lambda: fn(mods[name])))
        mean = {n: statistics.mean(t for o, t in zip(order, turns) if o == n)
                for n in ("base", "variant")}
        print(f"{w}: base {mean['base']:.4f} ms, variant {mean['variant']:.4f} "
              f"ms (in turns {', '.join(f'{o} {t:.4f}' for o, t in zip(order, turns))}); "
              f"{verdict[w]}")
    bind(kernels(mods["base"]), libs["base"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
