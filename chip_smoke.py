#!/usr/bin/env python3
"""Smoke test of svc_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card and nvcc (the kernels are built from ``svc_tpu_torch/csrc`` at
first use), and exits non-zero on any failure, printing no result. It
imports nothing of JAX, ``svc_tpu`` or ``benchmarks``. Phases, one line
each:

1. card — name and power limit (``nvidia-smi``);
2. build — compile the kernels, with the build time, each kernel's
   registers and static shared memory (ptxas), K5's and K10's dynamic
   shared memory and CTAs per SM, K5's static shared memory held to what
   its wrapper plans with, K11's cipher instructions a word counted in the
   built library's SASS (``cuobjdump -sass``), and the card's 32-bit
   integer rate (64 instructions a clock on each SM at its maximum SM
   clock, ``nvidia-smi``);
3. kernel parity — each of the twenty-three kernels against its plain
   PyTorch version on the card at the shapes of its path (K3, K4, K5, K7,
   K8, K9, K10, K11 bit-equal, K5's compactness within rtol 1e-6; K2 within 2.5e-4;
   K1 and K6 within 1 with under 1e-3 of the bytes differing), with the
   kernel's time, its time through the wrapper, the plain version's, the
   one-call PyTorch yardstick's where one exists, and the bound (bytes
   over 3.35 TB/s or operations over 67 T/s, float64 operations over 34
   T/s, integer instructions over the integer rate for K3, K4, K7, K8, K9
   and K11, whichever is larger). A kernel's time is that of CUDA graph
   replays, so that no host time of the wrapper enters (the yardsticks
   too). Every kernel runs on its new kernel (K1 / K2 / K6 8x8 x 3, K3
   and K7 square 4/8/16 blocks at r = 1, K4 and the K8 pyramid levels 1-3
   in one launch, K5 the 8-CTA cluster kernel, the K8 refine 8 subplanes
   with 16x16 blocks at r = 1, K9 2x2 blocks at r = 1), held bit for bit
   against the general (K4: single-level; K8 pyramid: the general pitched
   level, then the single-level K4) kernels on the same inputs and timed
   in turns with them (K3 per level, K5 at 1080p, 1440p and 4K, K6 at
   1366x768 and 1270x714; K7 also against stacking the pair for K3, and
   at odd MVs past the frame edges); K4 also at odd and
   tiny sizes and 2-5 levels, the K8 pyramid at odd subplane widths and
   a small frame, K9 also with random, past-edge and T = 1 MVs, the K8
   refine with MVs past its staged band and past the frame edges; K5 also
   at 1080p with D = 7; the general K1, K2 and K6 also run once at 4x4
   blocks; K10 (the CCL on the device: the 8-CTA cluster kernel and the
   general one, each also with ``general=True`` and the general
   global-memory loop) at the path shape with both connectivities, a
   snake, 4K, 270x480, a grid past the cluster's capacity and
   ``tools/ccl_cases.py``'s spiral, comb, one-cluster, background,
   checkerboard, 1x1, 5x120 and 1x120 frames at both connectivities, 20
   launches of one input bit-equal, the two kernels timed in turns; K11
   (the threefry cipher) on the anchor keys' fold_in and split, the
   seeding draw (timed), uniform and randint;
4. default config — a 17-frame 1080p clip through the staged,
   one-batch-in-flight ``stream_encode`` with ``EncoderConfig()`` on
   ``cuda``, read back through the port's ``io.bitstream`` and decoded by
   the staged ``decode_frames`` with a gaze; K1-K5 and K9 must run (K4
   the fused kernel). Then the staged stream against the direct per-batch
   encode (``encode_batch`` + ``.cpu()`` + serialize) byte for byte at 17
   frames (two full batches) and 13 (a remainder), decode with
   ``stage_h2d`` on and off; and the CLIs in-process on ``cuda``: the
   encoder app's bytes equal the library stream through the native writer
   (where it builds) and the Python writer thread, ``--trace`` holds the
   spans, the ``--profile`` trace names the port's kernels inside the
   encoder's CUDA graph replays (K2, K10's cluster kernel and K11 at
   least; the general K10 never), the decoder
   app's frames equal the library decode and ``--start-frame 4`` gives
   their exact tail;
5. width excess — a 9-frame 1366x768 clip, default config, encoded and
   decoded on ``cuda`` (the 8x8 x 3 K6 must run, and K2 on 2-byte aligned
   rows), the bytes held against the CPU port's decode of the same
   payloads;
6. reference-compat — a 9-frame 1080p clip with
   ``EncoderConfig(reference_compat=True)``, K1-K4 and K9 must run;
   phases 4-6 must not launch a general kernel (K1, K2, K3, K5, K6, K9,
   K10) or the single-level K4;
7. 4x4 transform blocks — a 9-frame CIF clip, default config with 4x4
   transform blocks: the general K1 and K2 must run, the 8x8 x 3 ones
   not; its 16x16 MV blocks run the specialised K3 and the cluster K5,
   the fused K4 and the 2x2 K9 (no general K3, K5, K9, K10, single-level
   K4);
8. card against CPU — the first 3 frames, default config, on both devices;
9. per-frame motion — two consecutive 1080p frames (padded to 1088 rows)
   through ``build_pyramid`` -> ``hbma(., ., 8, 16, 16)`` -> the three
   global-motion estimators on ``cuda`` (K7, the fused K4 and the 2x2 K9
   must run, the general K7 and K9 and the single-level K4 not), held against
   ``hbma_stack`` on the same 2-frame stack and the CPU port;
10. pitched motion — the 9-frame 1080p luma stack as tbw=8 column-pitched
    subplanes through ``pyr_down_pitched_levels`` (levels 1-3 in one
    launch) and ``hbma_stack(..., base_pitched=...)`` (the fused K8
    pyramid, the specialised K8 refine on level 0 and the specialised K3
    on levels 2-1 must run; no general K3 or K8 kernel and no
    single-level K4), held against the spatial pyramid and
    ``hbma_stack``;
11. timings — 1080p encode and decode frames per second, per-frame HBMA;
    then the synchronous-direct and the staged path in turns (S, T, T, S,
    S, T) for encode and decode at batch 8 over 24 payloads, each run with
    its fps and its Tracer split per batch (``parse``,
    ``device_dispatch``, ``device_fetch``, ``serialize``, the rest as
    ``other``), the medians and spreads, and the 56.0 MB frame H2D and
    200.5 MB coefficient D2H from pageable and from pinned memory;
12. RANSAC subsets — the first 3 frames of the 1080p clip encoded with
    3-vector subsets on ``cuda`` and on the CPU (MV fields, inlier masks
    and global motion equal), 8-vector subsets (1177 hypotheses) on one
    frame's field on both, a 9-frame clip streamed at subset 3 (K1-K5 and
    K9 must run, no general kernel), and ``estimate_global_motion_ransac``
    timed per 8-frame batch at subsets 1, 3 and 8;
13. frame-parallel split — ``ShardedEncoder`` and the device-list
    ``Decoder`` over two entries (two cards when there are, else
    ``[cuda:0, cuda:0]``), 4 anchors each: phase 4's 17-frame clip gives
    its stream byte for byte and its decoded frames (K1-K5 and K9 must
    run, no general kernel), then single-device and split fps in turns;
14. compiled batch — the encoder runs each batch as a CUDA graph replay
    (phases 4-8, 11-13 all do); here against ``graph=False``: phase 4's
    17-frame clip through ``stream_encode`` both ways, byte-equal to the
    main run's stream, then in turns (eager, graph, graph, eager) with
    fps and the Tracer split per batch; 13 frames both ways, phase 13's
    split stream against the eager one; per mode the device batch time,
    its dispatch and ``tools/profile_slice.py``'s launches per batch; a
    replay launches K10's cluster kernel once and the general one never.

Phases 4-7 and 12 also need K10 and K11 to run. A graph's kernels count
one launch each on every replay (its warm-up runs them once more). Each
path of phases 4-7, 9, 10, 12 and 13 runs with the launch counters set
to 0 just before it and read just after. The second-to-last line is a JSON
object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK_TYPE_TOL = 0.01  # phase 8: share of blocks allowed to differ
# the bound of a kernel (H100 SXM data sheet):
# each input byte read once and each output byte written once over the
# HBM rate, or the operations over the float32 rate outside the tensor
# cores (a multiply accumulate counts 2; integer work: its instructions
# over the integer rate below), whichever is larger
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # float64 outside the tensor cores (K2's sums)
# 32-bit integer instructions (add, multiply-add, shift, logic, compare) an
# SM issues a clock at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput): the integer kernels' rate is this
# times the SMs times the card's maximum SM clock (nvidia-smi). A SIMD SAD
# of 4 bytes with its accumulate (VABSDIFF4.U8.ACC) is one instruction
INT_OPS_PER_CLOCK = 64


def int_ops_per_s() -> tuple:
    """``(instructions a second, SMs, MHz)``: the card's 32-bit integer
    instruction rate at its maximum SM clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        mhz = float(smi.stdout.split()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no maximum SM clock: {smi.stdout!r} {smi.stderr!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_OPS_PER_CLOCK * sms * mhz * 1e6, sms, mhz


def sass_of(lib_path, kernel: str):
    """The SASS instructions (``"OPCODE operands"``, predicate dropped, with
    their addresses) of the one function of the library whose mangled name
    holds ``kernel``, from ``cuobjdump -sass``."""
    from svc_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300)
    if dump.returncode != 0:
        fail(f"cuobjdump -sass failed: {dump.stderr.strip()[-300:]}")
    funcs = [f for f in re.split(r"\n\s*Function : ", dump.stdout)[1:]
             if kernel in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        fail(f"cuobjdump -sass: {len(funcs)} functions named {kernel}")
    out = []
    for line in funcs[0].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([^;]*);", line)
        if m:
            out.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def cipher_instructions(sass) -> int:
    """The threefry kernel's cipher instructions a word: inside its
    grid-stride loop (from the target of its last backward branch to that
    branch), the rotations (``SHF.L.W``), the xors (``LOP3.LUT`` with the
    truth tables 0x3c and 0x96) and the adds (``IADD3``, ``IMAD.IADD``).
    The loop's index arithmetic, loads, stores and branches are not
    counted."""
    back = [(a, int(m.group(1), 16)) for a, ins in sass
            for m in [re.match(r"BRA (0x[0-9a-f]+)", ins)] if m and int(m.group(1), 16) < a]
    if not back:
        fail("threefry2x32_kernel's SASS has no loop")
    end, head = back[-1]
    body = [ins for a, ins in sass if head <= a <= end]
    rotations = sum(ins.startswith("SHF.L.W") for ins in body)
    if rotations != 20:
        fail(f"threefry2x32_kernel's loop holds {rotations} funnel-shift "
             f"rotations, not the cipher's 20")
    xor = re.compile(r"LOP3\.LUT .*, 0x(3c|96), ")
    return sum(bool(ins.startswith(("SHF.L.W", "IADD3 ", "IMAD.IADD "))
                    or xor.match(ins)) for ins in body)


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn`` with no host time in between:
    ``iters`` calls captured into one CUDA graph, the graph replayed and
    timed with CUDA events. A wrapper whose host work outlasts its kernel
    (a few microseconds of kernel) reads its kernel's time here, where
    ``cuda_ms`` reads the host's."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int = 20):
    """``(graph_ms(fn), cuda_ms(fn))``: the kernel's device time, and its
    time through the wrapper."""
    return graph_ms(fn, iters), cuda_ms(fn, iters)


def ctas_per_sm(regs: int, smem: int, threads: int) -> int:
    """CTAs of ``threads`` threads an H100 SM holds for ``regs`` registers
    a thread and ``smem`` bytes of shared memory a CTA: 65,536 registers
    (256 a warp at a time), 2,048 threads, 233,472 bytes of shared memory
    with 1,024 reserved a CTA, at most 32 CTAs."""
    warp_regs = -(-regs * 32 // 256) * 256
    return min(65536 // (warp_regs * (threads // 32)), 2048 // threads,
               233472 // (smem + 1024), 32)


def ptxas_report(log: str):
    """``[(source file, kernel, registers, static smem bytes)]`` from nvcc's
    ``-Xptxas -v`` report (empty when the library was already built)."""
    out, name = [], None
    for line in log.splitlines():
        # the mangled kernel name holds "<length>_<source stem>_cu_<hash>"
        # then "<length><kernel name>", then "ILi<B>E" for a template
        m = re.search(r"Compiling entry function '[^']*?_\d+_([a-z]\w*?)_cu_"
                      r"[0-9a-f]{8}\d+([A-Za-z]\w*?_kernel)(?:ILi(\d+)E)?", line)
        if m:
            tmpl = f"<{m.group(3)}>" if m.group(3) else ""
            name = (f"{m.group(1)}.cu", f"{m.group(2)}{tmpl}")
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            out.append(name + (int(m.group(1)), int(m.group(2) or 0)))
            name = None
    return out


def k10_occupancy(ccl, kern: str, regs: int) -> str:
    """Dynamic shared memory and CTAs of 1024 threads per SM of a K10
    kernel at the path shape and beyond."""
    if kern == "ccl_cluster_kernel":  # a band of ceil(H / 8) rows a CTA
        bands = ", ".join(
            f"{5 * ccl.band_cells(h, w)} B dynamic smem a CTA at {h}x{w} "
            f"({ctas_per_sm(regs, 5 * ccl.band_cells(h, w), 1024)} CTAs per SM)"
            for h, w in ((68, 120), (135, 240), (270, 480)))
        return f"{bands}; clusters of 8 CTAs, 64 CTAs at batch 8"
    if kern.endswith("<1>"):  # the general kernel, a frame a CTA
        return (f"{5 * 68 * 120} B dynamic smem at 68x120 "
                f"({ctas_per_sm(regs, 5 * 68 * 120, 1024)} CTAs per SM), 8 CTAs "
                f"at batch 8")
    return "over global memory"


def ptxas_summary(report) -> str:
    return "; ".join(f"{src} {kern} {regs} regs, {smem} B static smem"
                     for src, kern, regs, smem in report) or "not reported (already built)"


def in_turns(general, new, timer=cuda_ms):
    """Mean ms of two kernels timed in turns in one call: general, new,
    new, general. Returns ``(general_ms, new_ms, the four readings)``."""
    g1, n1, n2, g2 = (timer(f) for f in (general, new, new, general))
    return (g1 + g2) / 2, (n1 + n2) / 2, (g1, n1, n2, g2)


def bound(nbytes: float, ops: float, ops_per_s: float = CORE_OPS_PER_S):
    """``(ms, "bytes" | "operations")``: the least time the card could take."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def record(results, name, kernel, err, ms, wrapper_ms, plain_ms, nbytes, ops,
           library_ms=None, ops_per_s=CORE_OPS_PER_S):
    b_ms, b_by = bound(nbytes, ops, ops_per_s)
    results[name] = dict(kernel=kernel, err=float(err), ms=ms, wrapper_ms=wrapper_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    return (f"through the wrapper {wrapper_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), one-call PyTorch {lib}")


def even_mvs(g, shape, bound_, dev):
    return 2 * torch.randint(-bound_ // 2, bound_ // 2 + 1, shape, generator=g,
                             dtype=torch.int32).to(dev)


def phase_parity(dev, int_ops_per_s, k11_per_word):
    """Each kernel against its plain version at the 1080p path shapes.
    ``int_ops_per_s`` is the card's 32-bit integer instruction rate, the
    rate of the byte SADs and the cipher; ``k11_per_word`` the cipher's
    instructions a word (phase 2)."""
    from svc_tpu_torch.ops import dct, kmeans, motion, prng, pyramid, quant
    from svc_tpu_torch.ops.resize import bilinear_axis_weights

    g = torch.Generator(device="cpu").manual_seed(1234)
    results = {}

    # K4: levels 1-3 of a 9-frame 1088x1920 luma stack, on the fused kernel
    # (one launch) and on the single-level kernel (three launches), held
    # bit for bit to chained pyr_down_plain and timed in turns; then odd and
    # tiny sizes and level counts 2-5 (5 chains a second fused launch);
    # yardstick: the same 5x5 filter as one reflect-padded float32
    # convolution per level (no integer descale)
    y = torch.randint(0, 256, (9, 1088, 1920), generator=g, dtype=torch.uint8).to(dev)
    taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0])
    conv = torch.nn.Conv2d(1, 1, 5, stride=2, padding=2, padding_mode="reflect",
                           bias=False).to(dev)
    with torch.no_grad():
        conv.weight.copy_((taps[:, None] * taps[None, :] / 256.0).reshape(1, 1, 5, 5))
    chain = [y]
    for _ in range(3):
        chain.append(pyramid.pyr_down_plain(chain[-1]))
    fused = pyramid.pyr_down_levels(y, 3)
    single = pyramid.build_pyramid(y, 4, general=True)[1:]
    for lvl in range(1, 4):
        if not torch.equal(fused[lvl - 1], chain[lvl]):
            fail(f"K4 pyr_down_levels differs from chained pyr_down_plain at level {lvl}")
        if not torch.equal(single[lvl - 1], chain[lvl]):
            fail(f"K4 pyr_down_u8 differs from pyr_down_plain at level {lvl}")
    g_ms, n_ms, turns = in_turns(
        lambda: pyramid.build_pyramid(y, 4, general=True),
        lambda: pyramid.pyr_down_levels(y, 3), graph_ms)
    w_ms = cuda_ms(lambda: pyramid.pyr_down_levels(y, 3))
    gw_ms = cuda_ms(lambda: pyramid.build_pyramid(y, 4, general=True))
    plain_ms = cuda_ms(lambda: [pyramid.pyr_down_plain(chain[i]) for i in range(3)],
                       iters=5)
    lib_ms, conv_l0_ms, per_level = 0.0, None, []
    for lvl in range(3):
        xf = chain[lvl].float()[:, None]
        with torch.no_grad():
            c_ms = graph_ms(lambda: conv(xf))
        conv_l0_ms = c_ms if conv_l0_ms is None else conv_l0_ms
        lib_ms += c_ms
        per_level.append(graph_ms(lambda: pyramid.pyr_down(chain[lvl])))
    outs = sum(t.numel() for t in fused)
    # fused: level 0 read once, levels 1-3 written once; per level: each
    # level read and its next written, so levels 1 and 2 are read back
    fused_bytes = y.numel() + outs
    single_bytes = sum(chain[i].numel() + chain[i + 1].numel() for i in range(3))
    # separable, in integers: 15 multiply-add instructions per output
    ops = 15 * outs
    line = record(results, "pyr_down_levels", pyramid.PYR_DOWN_LEVELS, 0, n_ms, w_ms,
                  plain_ms, fused_bytes, ops, lib_ms, ops_per_s=int_ops_per_s)
    record(results, "pyr_down_u8", pyramid.PYR_DOWN, 0, g_ms, gw_ms, plain_ms,
           single_bytes, ops, lib_ms, ops_per_s=int_ops_per_s)
    checks = []
    for shape, count in (((2, 1087, 1919), 4), ((3, 5, 7), 4), ((1, 1, 1919), 4),
                         ((2, 1087, 1), 4), ((1, 768, 1366), 4), ((2, 70, 530), 2),
                         ((9, 1088, 1920), 3), ((9, 1088, 1920), 5), ((1, 1, 1), 5)):
        x = y[: shape[0], : shape[1], : shape[2]].contiguous()
        before = pyramid.PYR_DOWN_LEVELS.launches
        pyr = pyramid.build_pyramid(x, count)
        want = -(-(count - 1) // 3)
        if pyramid.PYR_DOWN_LEVELS.launches != before + want:
            fail(f"K4 build_pyramid {shape} x {count} did not launch the fused "
                 f"kernel {want} times")
        ref = x
        for lvl in range(1, count):
            ref = pyramid.pyr_down_plain(ref)
            if not torch.equal(pyr[lvl], ref):
                fail(f"K4 pyr_down_levels differs at {shape}, {count} levels, "
                     f"level {lvl}")
        checks.append(f"{'x'.join(map(str, shape))}/{count}")
    print(f"parity K4 pyr_down_levels: levels 1-3 of 9x1088x1920 bit-equal to "
          f"chained pyr_down_plain and to the single-level kernel; fused "
          f"{n_ms:.4f} ms in one launch vs single-level {g_ms:.4f} ms in three "
          f"(levels {', '.join(f'{v:.4f}' for v in per_level)}; in turns single, "
          f"fused, fused, single: {', '.join(f'{v:.4f}' for v in turns)}; "
          f"through the wrappers {w_ms:.4f} / {gw_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms; bound fused {bound(fused_bytes, ops, int_ops_per_s)[0]:.4f} ms "
          f"(level 0 read once), three launches "
          f"{bound(single_bytes, ops, int_ops_per_s)[0]:.4f} ms (levels 1-2 read back); {line}; "
          f"also bit-equal at {', '.join(checks)} (shape/levels)")

    # K3: refine SADs at levels 2, 1, 0 (blocks 4, 8, 16; r = 1) with the
    # even propagated MVs those levels receive (windows reach past the
    # frame edges), on the specialised kernel and on the general one, each
    # held bit for bit to the plain version on every candidate and timed
    # in turns per level
    levels = chain
    ms = gen_ms = plain_ms = wrap_ms = gen_wrap_ms = 0.0
    nbytes, ops = 0, 0
    level_mvs, per_level = {}, []
    for lvl, bnd in ((2, 2), (1, 6), (0, 14)):
        stack = levels[lvl]
        b = 16 >> lvl
        fh, fw = stack.shape[1:]
        mfh, mfw = fh // b, fw // b
        mv = even_mvs(g, (8, mfh, mfw, 2), bnd, dev)
        level_mvs[lvl] = mv
        got = motion.refine_sads(stack, mv, 1, b, b)
        got_g = motion.refine_sads(stack, mv, 1, b, b, general=True)
        ref = motion.refine_sads_plain(stack, mv, 1, b, b)
        if not torch.equal(got, ref):
            fail(f"K3 refine_sads differs from its plain version at level {lvl}")
        if not torch.equal(got_g, ref):
            fail(f"K3 refine_sads_general differs from its plain version at "
                 f"level {lvl}")
        g_ms, n_ms, turns = in_turns(
            lambda: motion.refine_sads(stack, mv, 1, b, b, general=True),
            lambda: motion.refine_sads(stack, mv, 1, b, b), graph_ms)
        w_ms = cuda_ms(lambda: motion.refine_sads(stack, mv, 1, b, b))
        gw_ms = cuda_ms(lambda: motion.refine_sads(stack, mv, 1, b, b, general=True))
        p_ms = cuda_ms(lambda: motion.refine_sads_plain(stack, mv, 1, b, b),
                       iters=5)
        lvl_bytes = stack.numel() + mv.numel() * 4 + got.numel() * 4
        lvl_ops = got.numel() * b * b // 4  # a SIMD SAD of 4 bytes each
        ms, gen_ms, plain_ms = ms + n_ms, gen_ms + g_ms, plain_ms + p_ms
        wrap_ms, gen_wrap_ms = wrap_ms + w_ms, gen_wrap_ms + gw_ms
        nbytes, ops = nbytes + lvl_bytes, ops + lvl_ops
        per_level.append(
            f"level {lvl} ({b}x{b}, {mfh}x{mfw} blocks) {n_ms:.4f} ms "
            f"(general {g_ms:.4f}; in turns {', '.join(f'{x:.4f}' for x in turns)}"
            f"; through the wrapper {w_ms:.4f}; bound "
            f"{bound(lvl_bytes, lvl_ops, int_ops_per_s)[0]:.4f} ms)")
    line = record(results, "refine_sads", motion.REFINE_SADS, 0, ms, wrap_ms,
                  plain_ms, nbytes, ops, ops_per_s=int_ops_per_s)
    record(results, "refine_sads_general", motion.REFINE_SADS_GENERAL, 0, gen_ms,
           gen_wrap_ms, plain_ms, nbytes, ops, ops_per_s=int_ops_per_s)
    print(f"parity K3 refine_sads: the specialised and the general kernel "
          f"bit-equal to the plain version on every candidate, levels 2-0; "
          f"{'; '.join(per_level)}; 3 levels {ms:.4f} ms (general "
          f"{gen_ms:.4f} ms, through the wrapper {gen_wrap_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms (T=8); {line}")

    # K7: levels 2, 1, 0 of one 1088x1920 pair (blocks 4, 8, 16; r = 1)
    # with K3's even MVs of frame 0, then odd MVs past the frame edges, on
    # the specialised kernel (K3's, two bases) and on the general one, each
    # held bit for bit to the plain version on every candidate; timed per
    # level in turns (new, general, stack + K3, stack + K3, general, new),
    # where stack + K3 is torch.stack of the pair, then K3's refine_sads:
    # the cost of reaching K3 without K7's entry (no library call)
    ms = gen_ms = stk_ms = plain_ms = w_ms = gen_w_ms = 0.0
    nbytes, ops = 0, 0
    per_level = []

    def k7_counts():
        return motion.REFINE_MADS.launches, motion.REFINE_MADS_GENERAL.launches

    for lvl, bnd in ((2, 2), (1, 6), (0, 14)):
        tr, an = levels[lvl][0], levels[lvl][1]
        b = 16 >> lvl
        mv = level_mvs[lvl][0].contiguous()
        odd = (2 * torch.randint(-(bnd // 2) - 2, bnd // 2 + 2, mv.shape, generator=g,
                                 dtype=torch.int32) + 1).to(dev)
        for kind, m in (("even", mv), ("odd past the edges", odd)):
            before = k7_counts()
            got = motion.refine_mads(tr, an, m, 1, b, b)
            if k7_counts() != (before[0] + 1, before[1]):
                fail(f"K7 at level {lvl} did not take the specialised kernel")
            got_g = motion.refine_mads(tr, an, m, 1, b, b, general=True)
            ref = motion.refine_mads_plain(tr, an, m, 1, b, b)
            if not torch.equal(got, ref):
                fail(f"K7 refine_mads differs from its plain version at level "
                     f"{lvl} ({kind} MVs)")
            if not torch.equal(got_g, ref):
                fail(f"K7 refine_mads_general differs from its plain version at "
                     f"level {lvl} ({kind} MVs)")
        new = lambda: motion.refine_mads(tr, an, mv, 1, b, b)
        general = lambda: motion.refine_mads(tr, an, mv, 1, b, b, general=True)
        stacked = lambda: motion.refine_sads(torch.stack((tr, an)), mv[None], 1, b, b)
        turns = [graph_ms(f) for f in (new, general, stacked, stacked, general, new)]
        n_ms, g_ms, s_ms = ((turns[i] + turns[5 - i]) / 2 for i in range(3))
        ms, gen_ms, stk_ms = ms + n_ms, gen_ms + g_ms, stk_ms + s_ms
        w_ms, gen_w_ms = w_ms + cuda_ms(new), gen_w_ms + cuda_ms(general)
        plain_ms += cuda_ms(lambda: motion.refine_mads_plain(tr, an, mv, 1, b, b),
                            iters=5)
        lvl_bytes = 2 * tr.numel() + mv.numel() * 4 + got.numel() * 4
        lvl_ops = got.numel() * b * b // 4  # a SIMD SAD of 4 bytes each
        nbytes, ops = nbytes + lvl_bytes, ops + lvl_ops
        per_level.append(
            f"level {lvl} ({b}x{b}) {n_ms:.4f} ms (general {g_ms:.4f}, stack + "
            f"K3 {s_ms:.4f}; in turns {', '.join(f'{x:.4f}' for x in turns)}; "
            f"bound {bound(lvl_bytes, lvl_ops, int_ops_per_s)[0]:.4f} ms)")
    line = record(results, "refine_mads", motion.REFINE_MADS, 0, ms, w_ms,
                  plain_ms, nbytes, ops, ops_per_s=int_ops_per_s)
    record(results, "refine_mads_general", motion.REFINE_MADS_GENERAL, 0, gen_ms,
           gen_w_ms, plain_ms, nbytes, ops, ops_per_s=int_ops_per_s)
    print(f"parity K7 refine_mads: the specialised and the general kernel "
          f"bit-equal to the plain version on every candidate, levels 2-0 of "
          f"one pair, even and odd past-edge MVs; {'; '.join(per_level)}; 3 "
          f"levels {ms:.4f} ms (general {gen_ms:.4f} ms, {gen_ms / ms:.1f}x; "
          f"stack + K3 {stk_ms:.4f} ms; through the wrappers {w_ms:.4f} / "
          f"{gen_w_ms:.4f}) vs plain {plain_ms:.4f} ms; {line}")

    # K9: its path shape (the encoder's top-level EBMA: 136x240, 2x2
    # blocks, r = 1, T = 8, zero MVs) on the 2x2 kernel and on the general
    # one, timed in turns; then random MVs within +-14, odd MVs past every
    # frame edge, and T = 1 (per-frame hbma), each bit-equal to the plain
    # version and the general kernel on every entry; then the general
    # kernel at T = 8, r = 4, 16x16 blocks at 1088x1920 with mv_pad 0
    # (EBMA) and 14, and the refine_sads_static entry at mv_bound 12
    top = levels[3]
    tr, an = top[:-1], top[1:]
    zero = torch.zeros((8, 68, 120, 2), dtype=torch.int32, device=dev)
    cases = {
        "T=8 zero MVs": (tr, an, zero),
        "T=8 MVs within +-14": (tr, an, torch.randint(
            -14, 15, (8, 68, 120, 2), generator=g, dtype=torch.int32).to(dev)),
        "T=8 odd MVs past the edges": (tr, an, (2 * torch.randint(
            -4, 5, (8, 68, 120, 2), generator=g, dtype=torch.int32) + 1).to(dev)),
        "T=1 odd MVs past the edges": (tr[:1], an[:1], (2 * torch.randint(
            -4, 5, (1, 68, 120, 2), generator=g, dtype=torch.int32) + 1).to(dev)),
    }
    for name, (a, b, mv) in cases.items():
        before = motion.CANDIDATE_SADS.launches
        got = motion.candidate_sads(a, b, mv, 1, 2, 2)
        if motion.CANDIDATE_SADS.launches != before + 1:
            fail(f"K9 at the EBMA shape ({name}) did not take the 2x2 kernel")
        if not torch.equal(got, motion.candidate_sads_plain(a, b, mv, 1, 2, 2)):
            fail(f"K9 candidate_sads differs from its plain version ({name})")
        if not torch.equal(got, motion.candidate_sads(a, b, mv, 1, 2, 2, general=True)):
            fail(f"K9 candidate_sads differs from the general kernel ({name})")
    got = motion.candidate_sads(tr, an, zero, 1, 2, 2)
    g_ms, ms, turns = in_turns(
        lambda: motion.candidate_sads(tr, an, zero, 1, 2, 2, general=True),
        lambda: motion.candidate_sads(tr, an, zero, 1, 2, 2), graph_ms)
    w_ms = cuda_ms(lambda: motion.candidate_sads(tr, an, zero, 1, 2, 2))
    gw_ms = cuda_ms(lambda: motion.candidate_sads(tr, an, zero, 1, 2, 2, general=True))
    plain_ms = cuda_ms(lambda: motion.candidate_sads_plain(tr, an, zero, 1, 2, 2),
                       iters=5)
    nbytes = 2 * tr.numel() + zero.numel() * 4 + got.numel() * 4
    # one SIMD SAD of 4 bytes a candidate of a 2x2 block
    line = record(results, "candidate_sads", motion.CANDIDATE_SADS, 0, ms, w_ms,
                  plain_ms, nbytes, got.numel(), ops_per_s=int_ops_per_s)
    record(results, "candidate_sads_general", motion.CANDIDATE_SADS_GENERAL, 0,
           g_ms, gw_ms, plain_ms, nbytes, got.numel(), ops_per_s=int_ops_per_s)
    tr, an = y[:-1], y[1:]
    wide = []
    for pad in (0, 14):
        mv = (torch.randint(-pad, pad + 1, (8, 68, 120, 2), generator=g,
                            dtype=torch.int32).to(dev))
        got = motion.candidate_sads(tr, an, mv, 4, 16, 16, pad)
        if not torch.equal(got, motion.candidate_sads_plain(tr, an, mv, 4, 16, 16)):
            fail(f"K9 candidate_sads_general differs at r=4, mv_pad {pad}")
        k_ms = cuda_ms(lambda: motion.candidate_sads(tr, an, mv, 4, 16, 16, pad),
                       iters=5)
        p_ms = cuda_ms(lambda: motion.candidate_sads_plain(tr, an, mv, 4, 16, 16),
                       iters=2, warmup=1)
        wide.append(f"mv_pad {pad}: {k_ms:.4f} ms vs plain {p_ms:.4f} ms")
    mv = even_mvs(g, (8, 68, 120, 2), 12, dev)
    got = motion.refine_sads_static(tr, an, mv, 4, 16, 16, 12)
    if not torch.equal(got, motion.candidate_sads_plain(tr, an, mv, 4, 16, 16)):
        fail("K9 refine_sads_static differs at mv_bound 12")
    print(f"parity K9 candidate_sads: the 2x2 and the general kernel bit-equal "
          f"to the plain version on every entry at the EBMA path shape "
          f"(136x240, 2x2, r=1) with {', '.join(cases)}; T=8 zero MVs "
          f"{ms:.4f} ms (general {g_ms:.4f}; in turns general, new, new, "
          f"general: {', '.join(f'{v:.4f}' for v in turns)}; through the "
          f"wrappers {w_ms:.4f} / {gw_ms:.4f}) vs plain {plain_ms:.4f} ms; "
          f"{line}; general kernel at T=8, r=4, 16x16, 1088x1920: "
          f"{'; '.join(wide)}; refine_sads_static (mv_bound 12) bit-equal")

    # K8 pyramid: levels 1-3 of the 9-frame 1088x1920 stack as tbw=8
    # column-pitched subplanes in one fused launch, bit-equal to the fused
    # spatial K4's levels, to the general chain (the general K8 level, then
    # the single-level K4 twice) and to the chained plain versions, timed in
    # turns against that chain; then at subplane widths that are not a
    # multiple of 16 (172, odd 67, and 250 at tbw=4) and at a small frame;
    # yardstick: K4's, the reflect-padded float32 convolution per level
    y8 = pyramid.to_pitched(y, 8)

    def k8_pyr_counts():
        return (pyramid.PYR_DOWN_PITCHED_LEVELS.launches,
                pyramid.PYR_DOWN_PITCHED_GENERAL.launches, pyramid.PYR_DOWN.launches)

    before = k8_pyr_counts()
    got = pyramid.pyr_down_pitched_levels(y8, 3)
    if k8_pyr_counts() != (before[0] + 1, before[1], before[2]):
        fail("K8 pyr_down_pitched_levels did not compute levels 1-3 in one launch")
    chain_g = pyramid.pyr_down_pitched_levels(y8, 3, general=True)
    for lvl in range(1, 4):
        if not torch.equal(got[lvl - 1], chain[lvl]):
            fail(f"K8 pyr_down_pitched_levels differs from chained pyr_down_plain "
                 f"at level {lvl}")
        if not (torch.equal(got[lvl - 1], fused[lvl - 1])
                and torch.equal(got[lvl - 1], chain_g[lvl - 1])):
            fail(f"K8 pyr_down_pitched_levels differs from the fused K4 or the "
                 f"general chain at level {lvl}")
    if not torch.equal(got[0], pyramid.pyr_down_pitched_plain(y8)):
        fail("K8 pyr_down_pitched_levels differs from pyr_down_pitched_plain")
    g_ms, n_ms, turns = in_turns(
        lambda: pyramid.pyr_down_pitched_levels(y8, 3, general=True),
        lambda: pyramid.pyr_down_pitched_levels(y8, 3), graph_ms)
    w_ms = cuda_ms(lambda: pyramid.pyr_down_pitched_levels(y8, 3))
    gw_ms = cuda_ms(lambda: pyramid.pyr_down_pitched_levels(y8, 3, general=True))
    g1_ms, g1_w = timed(lambda: pyramid.pyr_down_pitched(y8, general=True))
    plain_ms = cuda_ms(lambda: [pyramid.pyr_down_pitched_plain(y8)]
                       + [pyramid.pyr_down_plain(chain[i]) for i in (1, 2)], iters=5)
    g1_plain = cuda_ms(lambda: pyramid.pyr_down_pitched_plain(y8), iters=5)
    # bytes: the fused kernel reads the subplanes once and writes levels 1-3;
    # the chain reads levels 1 and 2 back
    pyr_bytes = y8.numel() + sum(o.numel() for o in got)
    chain_bytes = pyr_bytes + got[0].numel() + got[1].numel()
    pyr_ops = 15 * sum(o.numel() for o in got)  # integer multiply-adds
    line = record(results, "pyr_down_pitched_levels", pyramid.PYR_DOWN_PITCHED_LEVELS,
                  0, n_ms, w_ms, plain_ms, pyr_bytes, pyr_ops, lib_ms,
                  ops_per_s=int_ops_per_s)
    record(results, "pyr_down_pitched_general", pyramid.PYR_DOWN_PITCHED_GENERAL, 0,
           g1_ms, g1_w, g1_plain, y8.numel() + got[0].numel(), 15 * got[0].numel(),
           conv_l0_ms, ops_per_s=int_ops_per_s)
    checks = []
    for tbw, shape in ((8, (2, 64, 1376)), (8, (2, 40, 536)), (4, (3, 48, 1000)),
                       (8, (1, 8, 16))):
        x = y[: shape[0], : shape[1], : shape[2]].contiguous()
        before = k8_pyr_counts()
        lv = pyramid.pyr_down_pitched_levels(pyramid.to_pitched(x, tbw), 3)
        if k8_pyr_counts() != (before[0] + 1, before[1], before[2]):
            fail(f"K8 pyr_down_pitched_levels at {shape}, tbw={tbw} did not launch "
                 f"the fused kernel once")
        ref = pyramid.pyr_down_levels(x, 3)
        if not all(torch.equal(a, b) for a, b in zip(lv, ref)):
            fail(f"K8 pyr_down_pitched_levels differs from the fused K4 at {shape}, "
                 f"tbw={tbw}")
        checks.append(f"{'x'.join(map(str, shape))}/tbw {tbw} (nbx {shape[2] // tbw})")
    print(f"parity K8 pyr_down_pitched_levels: levels 1-3 of 9x1088x1920 as tbw=8 "
          f"subplanes bit-equal to the fused K4, to the general chain and to "
          f"chained pyr_down_plain; fused {n_ms:.4f} ms in one launch vs the "
          f"general chain {g_ms:.4f} ms in three (in turns chain, fused, fused, "
          f"chain: {', '.join(f'{v:.4f}' for v in turns)}; through the wrappers "
          f"{w_ms:.4f} / {gw_ms:.4f}; the general K8 level alone {g1_ms:.4f} ms, "
          f"through its wrapper {g1_w:.4f}) vs plain {plain_ms:.4f} ms; bound "
          f"fused {bound(pyr_bytes, pyr_ops, int_ops_per_s)[0]:.4f} ms (level 0 read once), "
          f"general chain {bound(chain_bytes, pyr_ops, int_ops_per_s)[0]:.4f} ms; {line}; also "
          f"bit-equal to the fused K4 at {', '.join(checks)}")

    # K8 refine: level 0 (16x16 blocks, r = 1) on the specialised kernel
    # and on the general one, at the path's MVs (even, within 14), at MVs
    # within +-40 (blocks leave the staged band and read global memory) and
    # at odd MVs within +-17 (past every frame edge, some past the band);
    # each bit-equal to the plain version and to K3 on the spatial stack;
    # timed in turns at the path's MVs
    k8_cases = {
        "path MVs": level_mvs[0],
        "MVs within +-40": torch.randint(-40, 41, (8, 68, 120, 2), generator=g,
                                         dtype=torch.int32).to(dev),
        "odd MVs within +-17": (2 * torch.randint(-9, 9, (8, 68, 120, 2), generator=g,
                                                  dtype=torch.int32) + 1).to(dev),
    }
    in_band = []
    for name, mv in k8_cases.items():
        before = (motion.REFINE_SADS_PITCHED.launches,
                  motion.REFINE_SADS_PITCHED_GENERAL.launches)
        got = motion.refine_sads_pitched(y8, mv, 1, 16, 16)
        got_g = motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=True)
        if (motion.REFINE_SADS_PITCHED.launches,
                motion.REFINE_SADS_PITCHED_GENERAL.launches) != (before[0] + 1,
                                                                 before[1] + 1):
            fail(f"K8 refine ({name}) did not take the specialised and the "
                 f"general kernel once each")
        if not torch.equal(got, got_g):
            fail(f"K8 refine_sads_pitched differs from the general kernel ({name})")
        if not torch.equal(got, motion.refine_sads_pitched_plain(y8, mv, 1, 16, 16)):
            fail(f"K8 refine_sads_pitched differs from its plain version ({name})")
        if not torch.equal(got, motion.refine_sads(y, mv, 1, 16, 16)):
            fail(f"K8 refine_sads_pitched differs from K3 on the spatial stack ({name})")
        share = (mv.abs() <= 15).all(dim=-1).double().mean().item()
        in_band.append(f"{name} ({share:.1%} of blocks in the band)")
    mv = level_mvs[0]
    g_ms, ms, turns = in_turns(
        lambda: motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=True),
        lambda: motion.refine_sads_pitched(y8, mv, 1, 16, 16), graph_ms)
    w_ms = cuda_ms(lambda: motion.refine_sads_pitched(y8, mv, 1, 16, 16))
    gw_ms = cuda_ms(lambda: motion.refine_sads_pitched(y8, mv, 1, 16, 16, general=True))
    plain_ms = cuda_ms(lambda: motion.refine_sads_pitched_plain(y8, mv, 1, 16, 16),
                       iters=5)
    nbytes = y8.numel() + mv.numel() * 4 + got.numel() * 4
    # a SIMD SAD of 4 bytes each: 64 a candidate of a 16x16 block
    line = record(results, "refine_sads_pitched", motion.REFINE_SADS_PITCHED, 0,
                  ms, w_ms, plain_ms, nbytes, got.numel() * 64,
                  ops_per_s=int_ops_per_s)
    record(results, "refine_sads_pitched_general", motion.REFINE_SADS_PITCHED_GENERAL,
           0, g_ms, gw_ms, plain_ms, nbytes, got.numel() * 64,
           ops_per_s=int_ops_per_s)
    print(f"parity K8 refine_sads_pitched: the specialised and the general kernel "
          f"bit-equal on every candidate to each other, to the plain version "
          f"and to K3 on the spatial stack at {', '.join(in_band)}; "
          f"{ms:.4f} ms (general {g_ms:.4f}; in turns general, new, new, "
          f"general: {', '.join(f'{v:.4f}' for v in turns)}; through the "
          f"wrappers {w_ms:.4f} / {gw_ms:.4f}) vs plain {plain_ms:.4f} ms "
          f"(level 0, T=8, tbw=8); {line}")

    # K2: forward DCT of 8 anchor frames from 9 packed 1080p frames, on the
    # specialised 8x8 x 3 kernel and on the general one (bit-equal), timed
    # in turns; yardstick: the blockwise DCT of the 24 padded float32
    # planes as one 64-filter stride-8 convolution (no packing, no wire
    # layout). Then the general kernel once at 4x4 blocks.
    packed = torch.randint(0, 256, (9, 1080, 5760), generator=g,
                           dtype=torch.uint8).to(dev)
    got = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920)
    got_g = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, general=True)
    ref = dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, 8, 8)
    err = (got - ref).abs().max().item()
    err_g = (got_g - ref).abs().max().item()
    exact = (got == ref).double().mean().item()
    if not err <= 2.5e-4:
        fail(f"K2 dct8x8_to_wire max |err| {err} > 2.5e-4")
    if not torch.equal(got, got_g):
        fail("K2 dct8x8_to_wire differs from the general kernel")
    gen_ms, ms, turns = in_turns(
        lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, general=True),
        lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920), graph_ms)
    new_w_ms = cuda_ms(lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920))
    gen_w_ms = cuda_ms(
        lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, general=True))
    plain_ms = cuda_ms(
        lambda: dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, 8, 8), iters=5
    )
    c8 = torch.tensor(dct.dct_matrix(8), device=dev)
    basis = (c8[:, None, :, None] * c8[None, :, None, :]).reshape(64, 1, 8, 8)
    planes = torch.zeros((24, 1, 1088, 1920), device=dev)
    planes[:, 0, :1080] = packed[1:].reshape(8, 1080, 1920, 3).permute(
        0, 3, 1, 2).reshape(24, 1080, 1920).float() - 128.0
    lib_ms = graph_ms(lambda: torch.nn.functional.conv2d(planes, basis, stride=8))
    # bytes: each packed byte read once, each coefficient written once;
    # operations: 16 float64 multiply-adds (2 each) per coefficient
    nbytes, ops = 8 * 1080 * 5760 + got.numel() * 4, 32 * got.numel()
    line = record(results, "dct8x8_to_wire", dct.DCT_WIRE, err, ms, new_w_ms,
                  plain_ms, nbytes, ops, lib_ms, FP64_OPS_PER_S)
    record(results, "dct_to_wire_general", dct.DCT_WIRE_GENERAL, err_g, gen_ms,
           gen_w_ms, plain_ms, nbytes, ops, lib_ms, FP64_OPS_PER_S)
    got4 = dct.dct8x8_to_wire(packed[:3], 1, 2, 1080, 1920, 4, 4, 3)
    err4 = (got4 - dct.dct8x8_to_wire_plain(packed[:3], 1, 2, 1080, 1920, 4, 4, 3)
            ).abs().max().item()
    if not err4 <= 2.5e-4:
        fail(f"K2 general at 4x4 blocks: max |err| {err4} > 2.5e-4")
    print(f"parity K2 dct8x8_to_wire: max |err| {err:.3e} <= 2.5e-4, "
          f"bit-exact fraction {exact:.6f}, bit-equal to the general kernel; "
          f"{ms:.4f} ms (general {gen_ms:.4f}; in turns general, new, new, "
          f"general: {', '.join(f'{x:.4f}' for x in turns)}; through the "
          f"wrappers {new_w_ms:.4f} / {gen_w_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms; {line}; general at 4x4 blocks (T=2, 1080p): "
          f"max |err| {err4:.3e}")

    # K1: display path of 8 frames, 1088 padded rows -> 1080 display rows,
    # then the zero-excess (identity rows) mode, on the specialised 8x8 x 3
    # kernel and on the general one (byte-equal), timed in turns at the
    # first; then the general kernel once at 4x4 blocks
    worst, modes = 0.0, []
    for nby, out_h in ((136, 1080), (135, 1080)):
        coeffs = (torch.randn((8, nby, 240, 192), generator=g) * 90).to(dev)
        btypes = torch.randint(0, 3, (8, nby, 240), generator=g).to(dev)
        gazed = torch.zeros((8, nby, 240), dtype=torch.bool, device=dev)
        gazed[:, 60:68, 110:118] = True
        steps = quant.block_quant_steps(btypes, gazed, 1, 640)
        got = dct.idct_display(coeffs, steps, out_h)
        ref = dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8)
        if not torch.equal(got, dct.idct_display(coeffs, steps, out_h, general=True)):
            fail(f"K1 idct_display differs from the general kernel (nby={nby})")
        diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        frac = (diff > 0).double().mean().item()
        if diff.max().item() > 1 or not frac < 1e-3:
            fail(f"K1 idct_display: max diff {diff.max().item()}, "
                 f"{frac:.2e} of bytes differ (nby={nby})")
        worst = max(worst, float(diff.max().item()))
        _, _, _, ident = bilinear_axis_weights(out_h, nby * 8)
        modes.append(f"{'identity' if ident else 'resample'} rows "
                     f"{nby * 8}->{out_h}: max diff {diff.max().item()}, "
                     f"{frac:.2e} of bytes differ, byte-equal to the general "
                     f"kernel")
        if nby == 136:
            gen_ms, ms, turns = in_turns(
                lambda: dct.idct_display(coeffs, steps, out_h, general=True),
                lambda: dct.idct_display(coeffs, steps, out_h), graph_ms)
            new_w_ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, out_h))
            gen_w_ms = cuda_ms(
                lambda: dct.idct_display(coeffs, steps, out_h, general=True))
            plain_ms = cuda_ms(
                lambda: dct.idct_display_plain(coeffs, steps, out_h, 3, 8, 8),
                iters=5,
            )
            # dequantize (3 per coefficient), IDCT (2048 per block and
            # channel), row lerp (3 per output byte)
            nbytes = coeffs.numel() * 4 + steps.numel() * 4 + got.numel()
            ops = 3 * coeffs.numel() + 2048 * coeffs.numel() // 64 + 3 * got.numel()
    line = record(results, "idct_display", dct.IDCT_DISPLAY, worst, ms, new_w_ms,
                  plain_ms, nbytes, ops)
    record(results, "idct_display_general", dct.IDCT_DISPLAY_GENERAL, worst,
           gen_ms, gen_w_ms, plain_ms, nbytes, ops)
    coeffs = (torch.randn((2, 272, 480, 48), generator=g) * 90).to(dev)
    steps = torch.where(torch.rand((2, 272, 480), generator=g) < 0.5, 640.0,
                        1.0).to(dev)
    diff = (dct.idct_display(coeffs, steps, 1080, 3, 4, 4).to(torch.int16)
            - dct.idct_display_plain(coeffs, steps, 1080, 3, 4, 4).to(torch.int16)
            ).abs()
    frac4 = (diff > 0).double().mean().item()
    if diff.max().item() > 1 or not frac4 < 1e-3:
        fail(f"K1 general at 4x4 blocks: max diff {diff.max().item()}, "
             f"{frac4:.2e} of bytes differ")
    print(f"parity K1 idct_display: {'; '.join(modes)}; {ms:.4f} ms (general "
          f"{gen_ms:.4f}; in turns general, new, new, general: "
          f"{', '.join(f'{x:.4f}' for x in turns)}; through the wrappers "
          f"{new_w_ms:.4f} / {gen_w_ms:.4f}) vs plain {plain_ms:.4f} ms "
          f"(1088->1080 rows, T=8); {line}; general at 4x4 blocks (T=2, "
          f"1088->1080): max diff {diff.max().item()}, {frac4:.2e} of bytes "
          f"differ")

    # K5: every Lloyd attempt of an 8-frame batch from the same seeded
    # start, at the 1080p (8160 MV blocks), 1440p (14400) and 4K (32400)
    # field sizes, on the cluster kernel and on the general one (timed in
    # turns), both held bit for bit to the plain version, the cluster
    # kernel run twice. 1080p with D = 7 and 1440p run before 4K: their
    # slices need 48 KB or less of dynamic shared memory, but more than 48
    # KB with the static part, so they fail unless the wrapper opts in on
    # its own and not through a larger launch before it.
    lines, worst, times = [], 0.0, {}
    sizes = (("1080p", 68, 120, 4), ("1080p", 68, 120, 7), ("1440p", 90, 160, 4),
             ("4K", 135, 240, 4))
    for name, mfh, mfw, d in sizes:
        n = mfh * mfw
        mv = torch.randint(-8, 9, (8, 2, n), generator=g).float()
        ys, xs = torch.meshgrid(torch.arange(mfh) * 16.0, torch.arange(mfw) * 16.0,
                                indexing="ij")
        extra = torch.randint(-64, 65, (8, d - 4, n), generator=g).float()
        x = torch.cat([mv, xs.reshape(1, 1, n).expand(8, 1, n),
                       ys.reshape(1, 1, n).expand(8, 1, n), extra], dim=1).to(dev)
        mask = (torch.rand((8, n), generator=g) < 0.3).to(dev)
        mask[0] = False  # a frame without foreground
        keys = prng.split(prng.fold_in(prng.key(7, dev), torch.arange(8, device=dev)), 3)
        init = kmeans._plus_plus_init(keys, x, mask, 10).transpose(0, 1).contiguous()
        before = kmeans.LLOYD.launches
        got = kmeans.lloyd(x, mask, init, 10, 10, 1.0)
        if kmeans.LLOYD.launches != before + 1:
            fail(f"K5 at {name}, D={d} did not take the cluster kernel")
        ref = kmeans.lloyd_plain(x, mask, init, 10, 10, 1.0)
        for kname, out in (("lloyd", got), ("lloyd_general", kmeans.lloyd(
                x, mask, init, 10, 10, 1.0, general=True))):
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                fail(f"K5 {kname} labels or centers differ from lloyd_plain at "
                     f"{name}, D={d}")
            rel = ((out[2] - ref[2]).abs() / ref[2].abs().clamp(min=1e-30)).max().item()
            if not rel <= 1e-6:
                fail(f"K5 {kname} compactness rel err {rel} > 1e-6 at {name}, D={d}")
            worst = max(worst, (out[2] - ref[2]).abs().max().item())
        again = kmeans.lloyd(x, mask, init, 10, 10, 1.0)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K5 lloyd gave other bits on a second run at {name}, D={d}")
        if d != 4:
            lines.append(f"{name} D={d} (N={n}, "
                         f"{kmeans.cluster_smem_bytes(n, d)} B dynamic smem): "
                         f"bit-equal, not timed")
            continue
        iters = kmeans.lloyd_iterations(x, mask, init, 10, 10, 1.0)
        # per iteration and point: k distances of D (3 ops each per dim)
        # and D sums; one more assignment after the loop
        its = int(iters.sum().item())
        ops = (its + iters.numel()) * n * 10 * 3 * 4 + its * n * 4
        nbytes = (x.numel() * 4 + mask.numel() + init.numel() * 4
                  + sum(t.numel() * 4 for t in got))
        g_ms, n_ms, turns = in_turns(
            lambda: kmeans.lloyd(x, mask, init, 10, 10, 1.0, general=True),
            lambda: kmeans.lloyd(x, mask, init, 10, 10, 1.0), graph_ms)
        w_ms = cuda_ms(lambda: kmeans.lloyd(x, mask, init, 10, 10, 1.0))
        gw_ms = cuda_ms(lambda: kmeans.lloyd(x, mask, init, 10, 10, 1.0, general=True))
        p_ms = cuda_ms(lambda: kmeans.lloyd_plain(x, mask, init, 10, 10, 1.0),
                       iters=3)
        times[name] = (n_ms, w_ms, g_ms, gw_ms, p_ms, nbytes, ops)
        lines.append(
            f"{name} (F=8, N={n}, A=3, k=10, D=4, {its} attempt iterations, "
            f"{kmeans.cluster_smem_bytes(n, d)} B dynamic smem): {n_ms:.4f} ms "
            f"(general {g_ms:.4f}; in turns "
            f"{', '.join(f'{v:.4f}' for v in turns)}; through the wrapper "
            f"{w_ms:.4f}, general {gw_ms:.4f}) vs plain {p_ms:.4f} ms, bound "
            f"{bound(nbytes, ops)[0]:.4f} ms")
    n_ms, w_ms, g_ms, gw_ms, p_ms, nbytes, ops = times["1080p"]
    line = record(results, "lloyd", kmeans.LLOYD, worst, n_ms, w_ms, p_ms, nbytes,
                  ops)
    record(results, "lloyd_general", kmeans.LLOYD_GENERAL, worst, g_ms, gw_ms, p_ms,
           nbytes, ops)
    print(f"parity K5 lloyd: the cluster and the general kernel bit-equal to "
          f"lloyd_plain (labels, centers; compactness within rtol 1e-6, max "
          f"|err| {worst:.3e}), the cluster kernel the same bits twice; "
          f"{'; '.join(lines)}; 1080p {line}")

    # K6: the general display route — 1366x768 (padded 1376x768, width
    # excess 10, identity rows), then a geometry with both excesses
    # (1270x714, padded 1280x720), T = 8, on the specialised 8x8 x 3
    # kernel and on the general one (byte-equal), timed in turns at each;
    # then the general kernel once at 4x4 blocks with width excess
    worst, modes = 0.0, []
    for w, h in ((1366, 768), (1270, 714)):
        nby, nbx = -(-h // 16) * 2, -(-w // 16) * 2
        coeffs = (torch.randn((8, nby, nbx, 192), generator=g) * 90).to(dev)
        btypes = torch.randint(0, 3, (8, nby, nbx), generator=g).to(dev)
        gazed = torch.zeros((8, nby, nbx), dtype=torch.bool, device=dev)
        gazed[:, 40:48, 80:88] = True
        steps = quant.block_quant_steps(btypes, gazed, 1, 640)
        before = (dct.IDCT_RESIZE.launches, dct.IDCT_RESIZE_GENERAL.launches)
        got = dct.idct_resize_display(coeffs, steps, h, w)
        got_g = dct.idct_resize_display(coeffs, steps, h, w, general=True)
        if (dct.IDCT_RESIZE.launches, dct.IDCT_RESIZE_GENERAL.launches) != (
                before[0] + 1, before[1] + 1):
            fail(f"K6 at {w}x{h} did not launch the 8x8 x 3 and the general "
                 f"kernel once each")
        if not torch.equal(got, got_g):
            fail(f"K6 idct_resize_display differs from the general kernel at "
                 f"{w}x{h}")
        ref = dct.idct_resize_display_plain(coeffs, steps, h, w, 3, 8, 8)
        gates = []
        for kname, out in (("idct_resize_display", got),
                           ("idct_resize_display_general", got_g)):
            diff = (out.to(torch.int16) - ref.to(torch.int16)).abs()
            frac = (diff > 0).double().mean().item()
            if diff.max().item() > 1 or not frac < 1e-3:
                fail(f"K6 {kname}: max diff {diff.max().item()}, {frac:.2e} of "
                     f"bytes differ at {w}x{h}")
            gates.append(f"max diff {diff.max().item()}, {frac:.2e} of bytes "
                         f"differ")
            worst = max(worst, float(diff.max().item()))
        g_ms, n_ms, turns = in_turns(
            lambda: dct.idct_resize_display(coeffs, steps, h, w, general=True),
            lambda: dct.idct_resize_display(coeffs, steps, h, w), graph_ms)
        w_ms = cuda_ms(lambda: dct.idct_resize_display(coeffs, steps, h, w))
        gw_ms = cuda_ms(
            lambda: dct.idct_resize_display(coeffs, steps, h, w, general=True))
        p_ms = cuda_ms(
            lambda: dct.idct_resize_display_plain(coeffs, steps, h, w, 3, 8, 8),
            iters=5,
        )
        # dequantize (3 per coefficient), IDCT (2048 per block and
        # channel), two lerps (3 each) per output byte
        k_bytes = coeffs.numel() * 4 + steps.numel() * 4 + got.numel()
        k_ops = 3 * coeffs.numel() + 2048 * coeffs.numel() // 64 + 6 * got.numel()
        if w == 1366:
            ms, gen_ms, wrap_ms, gen_w_ms, plain_ms = n_ms, g_ms, w_ms, gw_ms, p_ms
            nbytes, ops = k_bytes, k_ops
        modes.append(
            f"{nbx * 8}x{nby * 8}->{w}x{h}: byte-equal to the general kernel, "
            f"{gates[0]}; {n_ms:.4f} ms (general {g_ms:.4f}; in turns general, "
            f"new, new, general: {', '.join(f'{x:.4f}' for x in turns)}; "
            f"through the wrappers {w_ms:.4f} / {gw_ms:.4f}) vs plain "
            f"{p_ms:.4f} ms, bound {bound(k_bytes, k_ops)[0]:.4f} ms")
    line = record(results, "idct_resize_display", dct.IDCT_RESIZE, worst, ms,
                  wrap_ms, plain_ms, nbytes, ops)
    record(results, "idct_resize_display_general", dct.IDCT_RESIZE_GENERAL,
           worst, gen_ms, gen_w_ms, plain_ms, nbytes, ops)
    coeffs = (torch.randn((2, 192, 344, 48), generator=g) * 90).to(dev)
    steps = torch.where(torch.rand((2, 192, 344), generator=g) < 0.5, 640.0,
                        1.0).to(dev)
    before = dct.IDCT_RESIZE_GENERAL.launches
    got4 = dct.idct_resize_display(coeffs, steps, 768, 1366, 3, 4, 4)
    if dct.IDCT_RESIZE_GENERAL.launches != before + 1:
        fail("K6 at 4x4 blocks did not take the general kernel")
    diff = (got4.to(torch.int16) - dct.idct_resize_display_plain(
        coeffs, steps, 768, 1366, 3, 4, 4).to(torch.int16)).abs()
    frac4 = (diff > 0).double().mean().item()
    if diff.max().item() > 1 or not frac4 < 1e-3:
        fail(f"K6 general at 4x4 blocks: max diff {diff.max().item()}, "
             f"{frac4:.2e} of bytes differ")
    print(f"parity K6 idct_resize_display (T=8): {'; '.join(modes)}; 1366x768 "
          f"{line}; general at 4x4 blocks (T=2, 1376x768->1366x768): max diff "
          f"{diff.max().item()}, {frac4:.2e} of bytes differ")
    compiled_batch_parity(g, dev, results, int_ops_per_s, k11_per_word)
    return results


def compiled_batch_parity(g, dev, results, int_ops_per_s, k11_per_word):
    """Phase 3, the compiled batch's kernels: K10 (the CCL on the device:
    the cluster kernel and the general one) and K11 (the threefry cipher),
    each against its plain version bit for bit at the 1080p path shapes and
    beyond, timed by CUDA graph replay; K10's two kernels in turns."""
    from svc_tpu_torch.ops import ccl, prng
    from svc_tpu_torch.tools import ccl_cases

    # K10 at the path shape (8 frames of 68x120 MV blocks, k = 10), both
    # connectivities, random labels, a 68x120 snake; 4K (135x240) and
    # 270x480 (bands of 17 and 34 rows), a grid past the cluster's
    # capacity (540x960, bands of 65,280 cells: the general kernel over
    # global memory); ccl_cases' spiral, comb, one-cluster, background,
    # checkerboard, 1x1, 5x120 and 1x120 frames at both connectivities.
    # Each runs on the default route and on the general kernel
    # (general=True); the general kernel's global-memory loop once more
    snake = -torch.ones((1, 68, 120), dtype=torch.int32)
    snake[0, ::2, :] = 0
    snake[0, 1::4, -1] = 0
    snake[0, 3::4, 0] = 0
    adversarial = ccl_cases.adversarial()
    cases = [("path blobs, 4-conn", ccl_cases.blobs(g, 8, 68, 120, 10), 4),
             ("path blobs, 8-conn", ccl_cases.blobs(g, 8, 68, 120, 10), 8),
             ("path random, 4-conn", torch.randint(-1, 10, (8, 68, 120), generator=g,
                                                   dtype=torch.int32), 4),
             ("68x120 snake", snake, 4),
             ("4K blobs", ccl_cases.blobs(g, 8, 135, 240, 10), 4),
             ("270x480 blobs", ccl_cases.blobs(g, 2, 270, 480, 10), 8),
             ("540x960 blobs (past the cluster's capacity)",
              ccl_cases.blobs(g, 1, 540, 960, 10), 4)]
    cases += [(f"{name}, {conn}-conn", lab, conn) for name, lab in adversarial.items()
              for conn in (4, 8)]
    for name, lab, conn in cases:
        want = ccl.converge_labels_plain(lab, conn)
        fits = ccl.band_cells(*lab.shape[1:]) <= ccl.K10_BAND_CELLS
        route = ccl.CCL_CONVERGE if fits else ccl.CCL_CONVERGE_GENERAL
        for kernel, kw in ((route, {}), (ccl.CCL_CONVERGE_GENERAL, {"general": True}),
                           (ccl.CCL_CONVERGE_GENERAL, {"global_memory": True})):
            before = kernel.launches
            got = ccl.converge_labels(lab.to(dev), conn, **kw)
            if kernel.launches != before + 1:
                fail(f"K10 {kernel.name} did not launch ({name}, {kw})")
            if not torch.equal(got.cpu(), want):
                fail(f"K10 {kernel.name} differs from its plain version ({name}, {kw})")
    # 20 launches of one input, all bit-equal, on each kernel
    for name in ("68x120 spiral", "68x120 comb", "68x120 checkerboard"):
        lab = adversarial[name].to(dev)
        for conn in (4, 8):
            want = ccl.converge_labels_plain(adversarial[name], conn)
            for general in (False, True):
                outs = [ccl.converge_labels(lab, conn, general=general) for _ in range(20)]
                if not all(torch.equal(o.cpu(), want) for o in outs):
                    fail(f"K10 (general={general}) is not stable over 20 launches "
                         f"({name}, {conn}-conn)")
    lab = cases[0][1].to(dev)
    gen_ms, ms, turns = in_turns(
        lambda: ccl.converge_labels(lab, 4, general=True),
        lambda: ccl.converge_labels(lab, 4), graph_ms)
    w_ms = cuda_ms(lambda: ccl.converge_labels(lab, 4))
    gw_ms = cuda_ms(lambda: ccl.converge_labels(lab, 4, general=True))
    glob_ms = graph_ms(lambda: ccl.converge_labels(lab, 4, global_memory=True))
    plain_ms = cuda_ms(lambda: ccl.converge_labels_plain(lab, 4), iters=3)
    others = []
    for name, x, conn in (("68x120 snake", snake, 4),
                          ("spiral", adversarial["68x120 spiral"], 4),
                          ("comb", adversarial["68x120 comb"], 4),
                          ("one cluster", adversarial["68x120 one cluster"], 4),
                          ("checkerboard 8-conn", adversarial["68x120 checkerboard"], 8),
                          ("4K", cases[4][1], 4), ("270x480", cases[5][1], 8)):
        x = x.to(dev)
        o_gen, o_new, _ = in_turns(
            lambda: ccl.converge_labels(x, conn, general=True),
            lambda: ccl.converge_labels(x, conn), graph_ms)
        others.append(f"{name} {o_new:.4f} (general {o_gen:.4f})")
    nbytes = lab.numel() * 4 * 2
    line = record(results, "ccl_converge", ccl.CCL_CONVERGE, 0, ms, w_ms, plain_ms,
                  nbytes, 0)
    record(results, "ccl_converge_general", ccl.CCL_CONVERGE_GENERAL, 0, gen_ms,
           gw_ms, plain_ms, nbytes, 0)
    print(f"parity K10 ccl_converge (the cluster kernel) and ccl_converge_general "
          f"(also its global-memory loop): bit-equal to the plain loop on "
          f"{', '.join(c[0] for c in cases)}; 20 launches each bit-equal on the "
          f"spiral, comb and checkerboard at both connectivities; path shape "
          f"(8x68x120, blobs, 4-conn) {ms:.4f} ms (general {gen_ms:.4f}, "
          f"{gen_ms / ms:.1f}x; in turns general, cluster, cluster, general: "
          f"{', '.join(f'{v:.4f}' for v in turns)}; the general global-memory "
          f"loop {glob_ms:.4f}; through the wrapper {w_ms:.4f}, general "
          f"{gw_ms:.4f}) vs plain {plain_ms:.4f} ms; one call each, in turns (ms): "
          f"{'; '.join(others)}; {line}")

    # K11 at the path shapes: the k-means++ seeding draw (8 frames x 3
    # attempts x (10, 8160) words), the anchor keys (fold_in of 8
    # indices), their split, RANSAC's randint and the uniform floats
    anchors = prng.fold_in(prng.key(7, dev), torch.arange(8, device=dev))
    base = prng.key(7)
    if not torch.equal(anchors.cpu(), prng.threefry_words_plain(
            base.expand(8, 2), 1, torch.arange(8).reshape(8, 1))[:, 0]):
        fail("K11 fold_in differs from its plain version (8 anchor keys)")
    pair = prng.split(anchors)
    attempts = prng.split(pair[:, 1], 3)
    if not (torch.equal(pair.cpu(), prng.threefry_words_plain(anchors.cpu(), 2))
            and torch.equal(attempts.cpu(),
                            prng.threefry_words_plain(pair[:, 1].cpu(), 3))):
        fail("K11 split differs from its plain version")
    bits = prng.random_bits(attempts, (10, 8160))
    plain = prng.threefry_words_plain(attempts, 10 * 8160, both=False)
    if not torch.equal(bits.reshape(plain.shape), plain):
        fail("K11 random_bits differs from its plain version (the seeding draw)")
    for what, a, b in (
            ("uniform", prng.uniform(attempts, (10, 8160), 1e-12, 1.0),
             prng.uniform(attempts.cpu(), (10, 8160), 1e-12, 1.0)),
            ("randint", prng.randint(pair[:, 0], (7, 1), 0, 8160),
             prng.randint(pair[:, 0].cpu(), (7, 1), 0, 8160))):
        if not torch.equal(a.cpu(), b):
            fail(f"K11 {what} on the card differs from the CPU")
    ms = graph_ms(lambda: prng.random_bits(attempts, (10, 8160)))
    w_ms = cuda_ms(lambda: prng.random_bits(attempts, (10, 8160)))
    plain_ms = cuda_ms(lambda: prng.threefry_words_plain(attempts, 10 * 8160,
                                                         both=False), iters=3)
    small_ms = graph_ms(lambda: prng.split(anchors))
    # bytes: 24 keys in, 1.96M int64 words out; operations: the cipher's
    # integer instructions a word in the built kernel's SASS (phase 2)
    line = record(results, "threefry2x32", prng.THREEFRY, 0, ms, w_ms, plain_ms,
                  attempts.numel() * 8 + bits.numel() * 8,
                  k11_per_word * bits.numel(), ops_per_s=int_ops_per_s)
    print(f"parity K11 threefry2x32: fold_in (8 anchor keys), split, "
          f"random_bits (the seeding draw, 8x3 keys x 81,600 words), uniform "
          f"and randint bit-equal to the plain int64 cipher; seeding draw "
          f"{ms:.4f} ms (split of the 8 anchor keys {small_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms; {k11_per_word} integer instructions a word "
          f"(SASS); {line}")


def round_trip(cfg, w: int, h: int, n_frames: int, required, forbidden=()):
    """One path through the public entry points on ``cuda``: ``make_clip``
    -> ``stream_encode`` -> bytes -> ``read_frames`` -> ``decode_frames``
    with a gaze. The launch counters are set to 0 just before and read just
    after; every kernel in ``required`` must have run, none in
    ``forbidden``."""
    from svc_tpu_torch.config import DecoderConfig, VideoProperties
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.metrics import psnr
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder, stream_encode
    from svc_tpu_torch.tools.clips import make_clip

    clip = make_clip(w, h, n_frames)
    enc = Encoder(cfg, VideoProperties(w, h, n_frames), batch_size=8, device="cuda")
    gaze = (w // 2, h // 2)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    stream = b"".join(stream_encode(enc, iter(clip)))
    header = bitstream.Header.unpack(stream)
    header.validate()
    reader = io.BytesIO(stream[bitstream.HEADER_SIZE:])
    payloads = list(bitstream.read_frames(reader, header))
    if len(payloads) != n_frames - 1 or reader.read(1):
        fail(f"{w}x{h}: expected {n_frames - 1} payloads, got {len(payloads)}")
    dec = Decoder(DecoderConfig(), header, batch_size=8, device="cuda")
    frames = np.stack(list(dec.decode_frames(iter(payloads),
                                             iter([gaze] * len(payloads)))))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = build.launch_counts()
    fg_blocks = sum(
        int((bitstream.deserialize_frame_blocks(p, header)[0] > 0).sum())
        for p in payloads
    )
    if fg_blocks == 0:
        fail(f"{w}x{h}: no foreground block in any payload")
    if frames.shape != (n_frames - 1, h, w, 3) or frames.dtype != np.uint8:
        fail(f"{w}x{h}: decoded frames {frames.shape} {frames.dtype}")
    quality = psnr(frames, clip[1:])
    # background blocks decode at step 640 (DecoderConfig default), so the
    # whole-frame PSNR of this textured clip is low by design; the decoded
    # bytes are held against the CPU decode
    if not 5.0 < quality < 99.0:
        fail(f"{w}x{h}: PSNR {quality:.2f} dB outside (5, 99)")
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        fail(f"{w}x{h}: kernels never launched on this path: {missing}")
    stray = [k for k in forbidden if counts[k] != 0]
    if stray:
        fail(f"{w}x{h}: kernels launched that this path's shapes do not ask "
             f"for: {stray}")
    print(f"  {len(payloads)} payloads, {len(stream)} bytes, {fg_blocks} "
          f"foreground transform blocks, PSNR {quality:.3f} dB (gaze {gaze}), "
          f"{seconds:.2f} s incl. first calls; launches {counts}")
    return dict(clip=clip, enc=enc, dec=dec, stream=stream, header=header,
                payloads=payloads, frames=frames, gaze=gaze, counts=counts)


def direct_stream(enc, clip, tracer=None):
    """The synchronous path: the header, then per batch ``encode_batch``
    (pageable H2D), ``.cpu()`` of the outputs and serialization before the
    next batch starts; no stager, nothing in flight. Spans as svc_tpu's."""
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.runtime.tracing import span

    yield enc.header(len(clip) - 1).pack()
    cfg, t, i = enc.cfg, enc.batch_size, 0
    while i + 1 < len(clip):
        n_valid = min(t, len(clip) - 1 - i)
        window = clip[i:i + n_valid + 1]
        if n_valid < t:
            window = np.concatenate([window, np.repeat(window[-1:], t - n_valid, 0)])
        with span(tracer, "device_dispatch", frames=n_valid):
            out = enc.encode_batch(window, i)
        with span(tracer, "device_fetch", frames=n_valid):
            c = out["coeffs"].cpu().numpy()
            btypes = out["block_types"].cpu().numpy().astype(np.uint32)
        c = c.reshape(c.shape[0], c.shape[1], c.shape[2], -1,
                      cfg.transform_block_h, cfg.transform_block_w)
        for k in range(n_valid):
            with span(tracer, "serialize"):
                payload = bitstream.serialize_frame_blocks(
                    c[k], btypes[k], cfg.mv_block_w, cfg.mv_block_h)
            yield payload
        i += n_valid


def direct_decode(dec, payloads, gazes, tracer=None):
    """The synchronous decode: per batch parse, ``decode_batch`` (pageable
    H2D) and ``.cpu()`` before the next batch starts."""
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.runtime.tracing import span

    h = dec.header
    for s in range(0, len(payloads), dec.batch_size):
        coeffs, types = [], []
        for p in payloads[s:s + dec.batch_size]:
            with span(tracer, "parse"):
                t_, c_ = bitstream.deserialize_frame_blocks(p, h)
            coeffs.append(c_.reshape(c_.shape[0], c_.shape[1], -1))
            types.append(t_)
        rects = [dec.padded_gaze_rect(g) for g in gazes[s:s + len(coeffs)]]
        with span(tracer, "device_dispatch", frames=len(coeffs)):
            out = dec.decode_batch(np.stack(coeffs), np.stack(types), rects)
        with span(tracer, "device_fetch", frames=len(coeffs)):
            rows = out.cpu().numpy()
        yield from rows.reshape(len(coeffs), h.frame_h, h.frame_w, -1)


def staged_against_direct(main_run, dev):
    """Phase 4, continued: the staged, one-batch-in-flight stream against
    the direct per-batch path, byte for byte, at 17 frames (two full
    batches) and 13 (a remainder); decode with and without H2D staging."""
    from svc_tpu_torch.config import EncoderConfig, VideoProperties
    from svc_tpu_torch.models.encoder import Encoder

    clip, enc, dec = main_run["clip"], main_run["enc"], main_run["dec"]
    checks = []
    for n in (17, 13):
        part = clip[:n]
        if n == 17:
            e, staged = enc, main_run["stream"]
        else:
            h, w = clip.shape[1:3]
            e = Encoder(EncoderConfig(), VideoProperties(w, h, n), 8, device=dev)
            staged = b"".join(e.encode_video(iter(part)))
        direct = b"".join(direct_stream(e, part))
        if staged != direct:
            fail(f"staged stream of {n} frames differs from the direct per-batch "
                 f"encode ({len(staged)} against {len(direct)} bytes)")
        checks.append(f"{n} frames {len(staged)} bytes")
    gazes = [main_run["gaze"]] * len(main_run["payloads"])
    plain = np.stack(list(dec.decode_frames(iter(main_run["payloads"]), iter(gazes),
                                            stage_h2d=False)))
    if not np.array_equal(plain, main_run["frames"]):
        fail("decode with stage_h2d=False differs from the staged decode")
    print(f"  staged stream_encode equals the direct per-batch encode byte for "
          f"byte: {', '.join(checks)}; decode_frames stage_h2d on and off give "
          f"identical frames ({len(plain)})")


def cli_checks(main_run, tmp: str) -> str:
    """Phase 4, continued: the CLIs on ``cuda``, in-process."""
    from svc_tpu_torch.apps import decoder_app, encoder_app
    from svc_tpu_torch.runtime import native
    from svc_tpu_torch.runtime.tracing import TRACE_FILE

    clip_path = os.path.join(tmp, "clip.npy")
    np.save(clip_path, main_run["clip"])
    flags = ["enc", "--device", "cuda", "--verbose", "0"]

    def encode(name, *extra):
        path = os.path.join(tmp, name)
        if encoder_app.main([*flags, *extra, "--output", path, clip_path]) != 0:
            fail(f"encoder_app {' '.join(extra)} failed")
        with open(path, "rb") as f:
            data = f.read()
        if data != main_run["stream"]:
            fail(f"encoder_app {' '.join(extra)} wrote other bytes than the library")
        return data

    lines = []
    has_native = native.available()
    if has_native:
        encode("native.svc")
        lines.append("native writer bytes equal to the library stream")
    available = native.available
    native.available = lambda: False
    try:
        encode("python.svc")
    finally:
        native.available = available
    lines.append("Python writer thread bytes equal" + ("" if has_native else
                 " (native writer unavailable on this machine)"))
    trace = os.path.join(tmp, "enc.json")
    prof = os.path.join(tmp, "prof")
    encode("traced.svc", "--trace", trace, "--profile", prof)
    with open(trace) as f:
        stats = json.load(f)["stats"]
    if set(stats) != {"device_dispatch", "device_fetch", "serialize"}:
        fail(f"encoder_app --trace spans {sorted(stats)}")
    with open(os.path.join(prof, TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    # the encoder runs as CUDA graph replays: the trace must still name
    # the kernels inside them
    seen = sorted({k for k in ("dct8x8_wire_kernel", "idct8x8_display_kernel",
                               "pyr_down_levels_kernel", "refine_sads_kernel",
                               "lloyd_cluster_kernel", "candidate_sads_kernel",
                               "ccl_cluster_kernel", "threefry2x32_kernel")
                   if any(k in n for n in names)})
    missing = {"dct8x8_wire_kernel", "ccl_cluster_kernel",
               "threefry2x32_kernel"} - set(seen)
    if missing:
        fail(f"encoder_app --profile trace does not name {sorted(missing)} "
             f"({len(names)} event names)")
    if any("ccl_converge_kernel" in n for n in names):
        fail("encoder_app --profile trace names the general K10 kernel")
    lines.append(f"--trace spans {sorted(stats)}; --profile trace names {seen}")
    svc = os.path.join(tmp, "native.svc" if has_native else "python.svc")
    gaze = ",".join(map(str, main_run["gaze"]))
    dflags = ["dec", "--device", "cuda", "--gaze", gaze, "--input", svc]
    full, tail = os.path.join(tmp, "full.npy"), os.path.join(tmp, "tail.npy")
    dtrace = os.path.join(tmp, "dec.json")
    if decoder_app.main([*dflags, "--output", full, "--trace", dtrace]) != 0:
        fail("decoder_app failed")
    if decoder_app.main([*dflags, "--start-frame", "4", "--output", tail]) != 0:
        fail("decoder_app --start-frame 4 failed")
    full_f, tail_f = np.load(full), np.load(tail)
    if not np.array_equal(full_f, main_run["frames"]):
        fail("decoder_app frames differ from the library decode")
    if not np.array_equal(tail_f, full_f[4:]):
        fail("decoder_app --start-frame 4 is not the tail of the full decode")
    with open(dtrace) as f:
        dstats = json.load(f)["stats"]
    if set(dstats) != {"parse", "device_dispatch", "device_fetch"}:
        fail(f"decoder_app --trace spans {sorted(dstats)}")
    lines.append(f"decoder_app frames equal to the library decode, --start-frame "
                 f"4 the exact tail ({len(tail_f)} frames), --trace spans "
                 f"{sorted(dstats)}")
    return "; ".join(lines)


def transfer_ms(src: torch.Tensor, dst: torch.Tensor, reps: int = 5) -> float:
    """Median ms of ``dst.copy_(src)`` through to the host's return after
    the copy is complete (a pageable copy is synchronous; a pinned one is
    waited for)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def phase_overlap(main_run, card: str, dev) -> str:
    """Phase 11 (split): the synchronous-direct and the staged path in
    turns, three runs each, encode and decode at 1080p batch 8, with the
    Tracer split per batch and the measured H2D and D2H rates."""
    from svc_tpu_torch.runtime.tracing import Tracer

    clip, enc, dec = main_run["clip"], main_run["enc"], main_run["dec"]
    t = enc.batch_size
    clip = np.concatenate([clip, clip[-2::-1]])[:3 * t + 1]  # forth and back
    payloads = [p for p in enc.encode_video(iter(clip))][1:]
    gazes = [main_run["gaze"]] * len(payloads)
    batches = -(-len(payloads) // t)

    rates = {}
    n, h, w, _ = clip[:t + 1].shape
    frames = torch.from_numpy(np.ascontiguousarray(clip[:t + 1])).reshape(n, h, w * 3)
    hd = dec.header
    wire = hd.channel_count * hd.transform_block_h * hd.transform_block_w
    coeffs = torch.empty((t, hd.padded_frame_h // hd.transform_block_h,
                          hd.padded_frame_w // hd.transform_block_w, wire),
                         dtype=torch.float32, device=dev)
    for what, host, on_dev in (
            ("H2D", frames, torch.empty_like(frames, device=dev)),
            ("D2H", torch.empty_like(coeffs, device="cpu"), coeffs)):
        mb = host.numel() * host.element_size() / 1e6
        for mem, hst in (("pageable", host), ("pinned", host.pin_memory())):
            src, dst = (hst, on_dev) if what == "H2D" else (on_dev, hst)
            ms = transfer_ms(src, dst)
            rates[f"{what} {mb:.1f} MB {mem}"] = (ms, mb / ms)  # MB/ms = GB/s
    del coeffs

    def run(kind: str, leg: str):
        tr = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if leg == "encode":
            it = direct_stream(enc, clip, tr) if kind == "sync" else enc.encode_video(
                iter(clip), tracer=tr)
            n = sum(1 for _ in it) - 1
        else:
            it = (direct_decode(dec, payloads, gazes, tr) if kind == "sync"
                  else dec.decode_frames(iter(payloads), iter(gazes), tracer=tr))
            n = sum(1 for _ in it)
        wall = time.perf_counter() - t0
        if n != len(payloads):
            fail(f"phase 11 {leg} {kind}: {n} frames of {len(payloads)}")
        split = {k: v["total_s"] * 1e3 / batches for k, v in tr.stats().items()}
        split["other"] = wall * 1e3 / batches - sum(split.values())
        return n / wall, split

    lines, fps = [], {}
    for leg in ("encode", "decode"):
        for kind in ("sync", "staged", "staged", "sync", "sync", "staged"):
            f, split = run(kind, leg)
            fps.setdefault((leg, kind), []).append(f)
            parts = ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            print(f"  {leg} {kind}: {f:.2f} fps; per batch of 8 (ms): {parts}")
    for (leg, kind), v in fps.items():
        lines.append(f"{leg} {kind} median {np.median(v):.2f} fps (runs "
                     f"{', '.join(f'{x:.2f}' for x in v)}; spread "
                     f"{max(v) - min(v):.2f})")
    xfer = "; ".join(f"{k} {ms:.2f} ms ({gbs:.2f} GB/s)" for k, (ms, gbs) in rates.items())
    return (f"split batch {t}, {len(payloads)} payloads in {batches} batches "
            f"[{card}]: {'; '.join(lines)}; transfers: {xfer}")


def display_gate(a: np.ndarray, b: np.ndarray, what: str) -> str:
    """Max |diff| <= 1 on under 1e-3 of the bytes, or fail."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    frac = float((diff > 0).mean())
    if a.shape != b.shape or diff.max() > 1 or not frac < 1e-3:
        fail(f"{what}: max diff {diff.max()}, {frac:.2e} of bytes differ")
    return f"max diff {diff.max()}, {frac:.2e} of bytes differ"


def padded_luma(clip: np.ndarray, dev) -> torch.Tensor:
    """``(n, ph, pw)`` uint8 luma of BGR frames, padded as the default
    config's encoder pads them (1080p: 1088 rows)."""
    from svc_tpu_torch.ops.color import bgr_planes_to_y
    from svc_tpu_torch.ops.pad import pad_frame, padded_dims

    px = torch.as_tensor(clip).to(dev)
    y = bgr_planes_to_y(px[..., 0], px[..., 1], px[..., 2])
    pw, ph = padded_dims(clip.shape[2], clip.shape[1], 16, 16, 4)
    return pad_frame(y, pw, ph)


def per_frame_motion(clip: np.ndarray, dev):
    """Phase 9: ``build_pyramid`` -> ``hbma`` -> the three global-motion
    estimators on one 1080p frame pair, on ``cuda``."""
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.ops import motion
    from svc_tpu_torch.ops.pyramid import build_pyramid

    y = padded_luma(clip[:2], dev)
    mfh, mfw = y.shape[1] // 16, y.shape[2] // 16
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pyr = build_pyramid(y, 4)
    tracked, anchor = [p[0] for p in pyr], [p[1] for p in pyr]
    mv, mm = motion.hbma(tracked, anchor, 8, 16, 16)
    gm_avg = motion.estimate_global_motion_avg(mv)
    gm_ex, mad_ex = motion.estimate_global_motion_exhaustive(tracked[0], anchor[0], 8)
    gm_h = motion.estimate_global_motion_hierarchical(tracked, anchor, 8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = build.launch_counts()
    missing = [k for k in ("pyr_down_levels", "candidate_sads", "refine_mads")
               if counts[k] <= 0]
    if missing:
        fail(f"per-frame motion: kernels never launched on this path: {missing}")
    stray = [k for k in ("pyr_down_u8", "candidate_sads_general",
                         "refine_mads_general", "refine_sads_pitched_general",
                         "pyr_down_pitched_general")
             if counts[k]]
    if stray:
        fail(f"per-frame motion: launched {stray}, which the fused K4, the "
             f"2x2 K9 and the specialised K7 replace on this path (and no "
             f"pitched refine runs)")
    if tuple(mv.shape) != (mfh, mfw, 2) or not bool(torch.isfinite(mm).all()):
        fail(f"per-frame motion: MV field {tuple(mv.shape)}, finite "
             f"min-MADs {bool(torch.isfinite(mm).all())}")
    mv_s, mm_s = motion.hbma_stack(pyr, 8, 16, 16)
    if not (torch.equal(mv, mv_s[0]) and torch.equal(mm, mm_s[0])):
        fail("per-frame motion: hbma differs from hbma_stack on the same stack")
    cpu = [p.cpu() for p in pyr]
    ct, ca = [p[0] for p in cpu], [p[1] for p in cpu]
    mv_c, mm_c = motion.hbma(ct, ca, 8, 16, 16)
    if not (torch.equal(mv.cpu(), mv_c) and torch.equal(mm.cpu(), mm_c)):
        fail("per-frame motion: hbma on cuda differs from the CPU port")
    gms = {
        "avg": (gm_avg, motion.estimate_global_motion_avg(mv_c)),
        "exhaustive": (gm_ex, motion.estimate_global_motion_exhaustive(ct[0], ca[0], 8)[0]),
        "hierarchical": (gm_h, motion.estimate_global_motion_hierarchical(ct, ca, 8)),
    }
    for name, (a, b) in gms.items():
        if not (bool(torch.isfinite(a).all()) and torch.equal(a.cpu(), b)):
            fail(f"per-frame motion: global motion ({name}) {a.tolist()} on "
                 f"cuda vs {b.tolist()} on the CPU")
    moved = int((mv != 0).any(dim=-1).sum().item())
    print(f"  MV field {mfh}x{mfw} equal to hbma_stack and to the CPU port, "
          f"{moved} blocks moved; global motion (x, y) avg "
          f"{gm_avg.tolist()}, exhaustive {gm_ex.tolist()} (MAD "
          f"{mad_ex.item():.4f}), hierarchical {gm_h.tolist()}, each equal "
          f"to the CPU port; {seconds:.2f} s incl. first calls; launches "
          f"{counts}")
    return dict(pyr=pyr, counts=counts)


def pitched_motion(clip: np.ndarray, dev):
    """Phase 10: the 9-frame luma stack as tbw=8 column-pitched subplanes
    through ``pyr_down_pitched_levels`` and ``hbma_stack(...,
    base_pitched=)``."""
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.ops import motion
    from svc_tpu_torch.ops.pyramid import (build_pyramid, pyr_down_pitched_levels,
                                           to_pitched)

    y = padded_luma(clip[:9], dev)
    y8 = to_pitched(y, 8)
    build.reset_launch_counts()
    pyr = pyr_down_pitched_levels(y8, 3)
    mv, mm = motion.hbma_stack([y8] + pyr, 8, 16, 16, base_pitched=y8)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    missing = [k for k in ("pyr_down_pitched_levels", "refine_sads_pitched",
                           "candidate_sads", "refine_sads")
               if counts[k] <= 0]
    if missing:
        fail(f"pitched motion: kernels never launched on this path: {missing}")
    stray = [k for k in ("refine_sads_general", "refine_sads_pitched_general",
                         "pyr_down_u8", "pyr_down_pitched_general") if counts[k]]
    if stray:
        fail(f"pitched motion: launched {stray}, which the fused K8 pyramid "
             f"(levels 1-3), the specialised K3 (levels 2-1) and K8 refine "
             f"(level 0) replace on this path")
    ref = build_pyramid(y, 4)
    mv_s, mm_s = motion.hbma_stack(ref, 8, 16, 16)
    if not (all(torch.equal(a, b) for a, b in zip(pyr, ref[1:]))
            and torch.equal(mv, mv_s) and torch.equal(mm, mm_s)):
        fail("pitched motion: differs from the spatial pyramid and hbma_stack")
    print(f"  levels 1-3 equal to the spatial pyramid, MV fields "
          f"{tuple(mv.shape[:3])} and min-MADs equal to hbma_stack on the "
          f"spatial stack; launches "
          f"{counts}")
    return dict(counts=counts)


def ransac_subsets(main_run, card: str, dev, required, forbidden):
    """Phase 12: RANSAC with 3-vector subsets at 1080p on ``cuda``. The
    first 3 frames against the CPU port (MV fields, inlier masks, global
    motion equal); subset 8 (1177 hypotheses) on one frame's field against
    the CPU port; a 9-frame clip streamed at subset 3 with phase 4's launch
    check; ``estimate_global_motion_ransac``'s time per 8-frame batch at
    subsets 1, 3 and 8."""
    from svc_tpu_torch.config import EncoderConfig, RansacParams, VideoProperties
    from svc_tpu_torch.models.encoder import Encoder
    from svc_tpu_torch.ops import prng, ransac

    clip = main_run["clip"]
    h, w = clip.shape[1:3]
    cfg3 = EncoderConfig(ransac=RansacParams(subset_sz=3))
    props = VideoProperties(w, h, len(clip))
    o_gpu = Encoder(cfg3, props, batch_size=2, device=dev).encode_batch(clip[:3], 0)
    o_cpu = Encoder(cfg3, props, batch_size=2, device="cpu").encode_batch(clip[:3], 0)
    for key in ("mv_field", "foreground_mask_raw", "global_motion"):
        if not torch.equal(o_gpu[key].cpu(), o_cpu[key]):
            fail(f"phase 12: subset 3 {key} differs between cuda and cpu")
    if not torch.allclose(o_gpu["ransac_rmse"].cpu(), o_cpu["ransac_rmse"], rtol=1e-6):
        fail("phase 12: subset 3 RMSE differs between cuda and cpu beyond rtol 1e-6")

    run = round_trip(cfg3, w, h, 9, required, forbidden)

    enc = main_run["enc"]
    packed = torch.as_tensor(clip[:9]).reshape(9, h, w * 3).to(dev)
    mv = enc.encode_packed(packed, 0)["mv_field"]  # (8, 68, 120, 2)
    keys = prng.split(enc._keys(0, 8))[:, 0]
    p8 = RansacParams(subset_sz=8)
    one = ransac.estimate_global_motion_ransac(mv[:1], p8, keys[:1])
    ref = ransac.estimate_global_motion_ransac(mv[:1].cpu(), p8, keys[:1].cpu())
    if not (torch.equal(one[0].cpu(), ref[0]) and torch.equal(one[2].cpu(), ref[2])):
        fail("phase 12: subset 8 global motion or inliers differ between cuda and cpu")
    if not torch.allclose(one[1].cpu(), ref[1], rtol=1e-6):
        fail("phase 12: subset 8 RMSE differs between cuda and cpu beyond rtol 1e-6")
    times = []
    for m in (1, 3, 8):
        p = RansacParams(subset_sz=m)
        ms = cuda_ms(lambda: ransac.estimate_global_motion_ransac(mv, p, keys),
                     iters=5, warmup=1)
        times.append(f"subset {m} ({ransac.iter_count(p)} hypotheses) {ms:.3f} ms")
    print(f"  first 3 frames at subset 3: MV fields, inlier masks, global motion "
          f"equal to the CPU port; subset 8 on frame 1 equal to the CPU port; "
          f"estimate_global_motion_ransac per 1080p batch of 8 [{card}]: "
          f"{'; '.join(times)}")
    return run


def sharded_run(main_run, card: str, required, forbidden):
    """Phase 13: the split over two device entries (two cards when there
    are, else ``[cuda:0, cuda:0]``), 4 anchors each: phase 4's 17-frame
    clip through ``stream_encode`` byte-equal to the main run's stream, the
    split decoder's frames equal to its frames, launches checked; then
    single-device and split encode and decode fps in turns."""
    from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import stream_encode
    from svc_tpu_torch.parallel.sharding import ShardedEncoder, make_frame_devices

    if torch.cuda.device_count() >= 2:
        devs = make_frame_devices(2, device="cuda")
    else:
        devs = make_frame_devices(devices=["cuda:0", "cuda:0"])
    clip, payloads = main_run["clip"], main_run["payloads"]
    h, w = clip.shape[1:3]
    gazes = [main_run["gaze"]] * len(payloads)
    enc = ShardedEncoder(EncoderConfig(), VideoProperties(w, h, len(clip)), devs,
                         batch_per_device=4)
    dec = Decoder(DecoderConfig(), main_run["header"], batch_size=8, devices=devs)
    build.reset_launch_counts()
    stream = b"".join(stream_encode(enc, iter(clip)))
    frames = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes))))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    if stream != main_run["stream"]:
        fail(f"phase 13: split stream differs from the single-device stream "
             f"({len(stream)} against {len(main_run['stream'])} bytes)")
    if not np.array_equal(frames, main_run["frames"]):
        fail("phase 13: split decode differs from the single-device decode")
    missing = [k for k in required if counts[k] <= 0]
    stray = [k for k in forbidden if counts[k] != 0]
    if missing or stray:
        fail(f"phase 13: kernels never launched {missing}, launched against "
             f"the shapes {stray}")

    def fps(leg, e, d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if leg == "encode":
            n = sum(1 for _ in stream_encode(e, iter(clip))) - 1
        else:
            n = sum(1 for _ in d.decode_frames(iter(payloads), iter(gazes)))
        return n / (time.perf_counter() - t0)

    single = (main_run["enc"], main_run["dec"])
    lines = []
    for leg in ("encode", "decode"):
        got = {"single": [], "split": []}
        for kind in ("single", "split", "split", "single"):
            e, d = single if kind == "single" else (enc, dec)
            got[kind].append(fps(leg, e, d))
        lines.append(f"{leg} single-device {', '.join(f'{x:.2f}' for x in got['single'])}"
                     f" fps, split {', '.join(f'{x:.2f}' for x in got['split'])} fps")
    print(f"  devices {[str(d) for d in devs]}, 4 anchors each: stream "
          f"byte-equal ({len(stream)} bytes), decoded frames equal; launches "
          f"{counts}")
    print(f"  in turns (single, split, split, single), 16 payloads [{card}]: "
          f"{'; '.join(lines)}")
    return stream


def compiled_batch(main_run, split_stream, card: str, dev):
    """Phase 14: the encode batch as a CUDA graph replay against the eager
    path (``graph=False``). Phase 4's 17-frame clip through ``stream_encode``
    both ways, byte-equal to the main run's stream (phase 4 ran it on
    graphs), then in turns (eager, graph, graph, eager), each run with its
    fps and Tracer split per batch; the 13-frame clip (a padded remainder
    batch) both ways; phase 13's split stream, on graphs, against the
    eager stream; per mode the device batch time and
    ``tools/profile_slice.py``'s launches per batch."""
    from svc_tpu_torch.config import EncoderConfig, VideoProperties
    from svc_tpu_torch.models.encoder import Encoder, stream_encode
    from svc_tpu_torch.runtime.tracing import Tracer
    from svc_tpu_torch.tools.profile_slice import batch_launches

    clip, stream = main_run["clip"], main_run["stream"]
    h, w = clip.shape[1:3]
    props = VideoProperties(w, h, len(clip))
    graph = main_run["enc"]
    eager = Encoder(EncoderConfig(), props, 8, device=dev, graph=False)
    if not graph.graph or eager.graph:
        fail("phase 14: the default encoder does not run as a graph")
    modes = {"eager": eager, "graph": graph}
    # the bytes, untimed (the eager run also makes the eager path's first
    # calls); the timed runs below discard their payloads, as phase 11's do
    for kind, e in modes.items():
        if b"".join(stream_encode(e, iter(clip))) != stream:
            fail(f"phase 14: the {kind} stream differs from the main run's "
                 f"(17 frames)")
    n_payloads = len(clip) - 1
    batches = -(-n_payloads // graph.batch_size)
    fps = {"eager": [], "graph": []}
    for kind in ("eager", "graph", "graph", "eager"):
        tr = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in stream_encode(modes[kind], iter(clip), tracer=tr)) - 1
        wall = time.perf_counter() - t0
        if n != n_payloads:
            fail(f"phase 14: the {kind} run gave {n} payloads of {n_payloads}")
        split = {k: v["total_s"] * 1e3 / batches for k, v in tr.stats().items()}
        split["other"] = wall * 1e3 / batches - sum(split.values())
        fps[kind].append(n_payloads / wall)
        parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        print(f"  {kind}: {n_payloads / wall:.2f} fps; per batch of 8 (ms): {parts}")
    part = clip[:13]
    p13 = VideoProperties(w, h, 13)
    s13 = {kind: b"".join(Encoder(EncoderConfig(), p13, 8, device=dev, graph=kind == "graph")
                          .encode_video(iter(part))) for kind in ("eager", "graph")}
    if s13["eager"] != s13["graph"]:
        fail("phase 14: the graph stream differs from the eager one at 13 frames")
    if split_stream != stream:
        fail("phase 14: the split stream (graphs) differs from the eager stream")
    packed = torch.as_tensor(clip[:9]).reshape(9, h, w * 3).to(dev)
    lines = []
    for kind, e in modes.items():
        ms = cuda_ms(lambda: e.encode_packed(packed, 0), iters=5, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.encode_packed(packed, 0)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        n = batch_launches(lambda: e.encode_packed(packed, 0))
        lines.append(f"{kind} {ms:.3f} ms a batch (its dispatch {dispatch_ms:.3f} ms "
                     f"of host time), {n['host_launch_calls']} host launch calls, "
                     f"{n['device_ops']} device operations")
    replay = graph._graphs[tuple(packed.shape)].launches_per_replay()
    if replay.get("ccl_converge") != 1 or "ccl_converge_general" in replay:
        fail(f"phase 14: a replay does not launch the cluster K10 once and the "
             f"general one never: {replay}")
    print(f"  streams byte-equal: 17 frames eager and graph in turns, 13 frames "
          f"({len(s13['graph'])} bytes), the split over two entries on graphs; "
          f"fps medians eager {np.median(fps['eager']):.2f}, graph "
          f"{np.median(fps['graph']):.2f} [{card}]")
    print(f"  per 1080p batch of 8 [{card}]: {'; '.join(lines)}; the port's "
          f"kernels in one replay {replay}")


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

    from svc_tpu_torch.ops import kmeans

    t0 = time.perf_counter()
    res = build.build()
    build.library()  # load: a link error fails here, not mid-run
    report = ptxas_report(res.log)
    # K5's wrapper plans the cluster kernel's shared memory with
    # _K5_STATIC_SMEM for its static part
    k5 = {kern: (regs, smem) for _, kern, regs, smem in report
          if kern.split("<")[0] == "lloyd_cluster_kernel"}
    if report and not k5:
        fail("ptxas reported no lloyd_cluster_kernel instance")
    for kern, (regs, smem) in k5.items():
        if smem > kmeans._K5_STATIC_SMEM:
            fail(f"{kern} declares {smem} B of static shared memory, more "
                 f"than the {kmeans._K5_STATIC_SMEM} B ops/kmeans.py plans with")
    k5_line = "; ".join(
        f"{kern} at {name} {ctas_per_sm(regs, smem + kmeans.cluster_smem_bytes(n, 4), 512)}"
        f" CTAs per SM" for kern, (regs, smem) in k5.items() if kern.endswith("<4>")
        for name, n in (("1080p", 8160), ("4K", 32400)))
    from svc_tpu_torch.ops import dct

    # the specialised display kernels' dynamic shared memory and threads
    display = {"idct8x8_display_kernel": (dct._K1_SMEM_BYTES, 192),
               "idct8x8_resize_kernel": (dct._K6_SMEM_BYTES, 224)}
    display_line = "; ".join(
        f"{kern} {smem} B dynamic smem, {ctas_per_sm(regs, smem, threads)} CTAs "
        f"of {threads} per SM" for _, kern, regs, _ in report if kern in display
        for smem, threads in [display[kern]])
    # the 256-thread refine and fused pyramid kernels (K3, K4, K8), static
    # shared memory only
    static_line = "; ".join(
        f"{src} {kern} {ctas_per_sm(regs, smem, 256)} CTAs of 256 per SM"
        for src, kern, regs, smem in report
        if kern.split("<")[0] in ("refine_sads_kernel", "refine_sads_pitched_kernel",
                                  "pyr_down_levels_kernel"))
    # K10: the cluster kernel (a band of ceil(H / 8) rows a CTA, 1024
    # threads) and the general one (a frame a CTA)
    from svc_tpu_torch.ops import ccl

    k10_line = "; ".join(f"{kern} {regs} regs, {k10_occupancy(ccl, kern, regs)}"
                         for src, kern, regs, _ in report
                         if src.startswith("ccl_converge"))
    # K11's cipher instructions a word, from the built library's SASS, and
    # the integer rate they run at
    k11_per_word = cipher_instructions(sass_of(res.path, "threefry2x32_kernel"))
    int_rate, sms, mhz = int_ops_per_s()
    print(f"build: {res.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {res.seconds:.2f} s, one process per source; 0 = already "
          f"built); ptxas: {ptxas_summary(report)}; K5 cluster kernel dynamic "
          f"smem per CTA {kmeans.cluster_smem_bytes(8160, 4)} B (1080p), "
          f"{kmeans.cluster_smem_bytes(32400, 4)} B (4K); "
          f"{k5_line or 'K5 static smem not checked (already built)'}; "
          f"{display_line or 'display kernels not reported (already built)'}; "
          f"{static_line or 'refine and pyramid kernels not reported (already built)'}; "
          f"K10 {k10_line or 'not reported (already built)'}; K11 "
          f"threefry2x32_kernel: {k11_per_word} cipher instructions a word in "
          f"its SASS (cuobjdump -sass); integer rate {INT_OPS_PER_CLOCK} x {sms} "
          f"SMs x {mhz:.0f} MHz = {int_rate:.4g} instructions/s")

    # 3. kernel parity
    results = phase_parity(dev, int_rate, k11_per_word)

    from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder, stream_encode
    from svc_tpu_torch.ops import dct, motion

    encode_kernels = ("pyr_down_levels", "candidate_sads", "refine_sads",
                      "dct8x8_to_wire", "ccl_converge", "threefry2x32")
    # 8x8 blocks of 3 channels take the specialised K1 / K2; 16x16 MV
    # blocks at range 8 take the specialised K3 on every level; every
    # frame size here takes K5's cluster kernel
    general_dct = ("dct_to_wire_general", "idct_display_general")
    # the fused K4 and the 2x2 K9 serve the motion path: the single-level
    # K4 and the general K9 run on none of phases 4-7 and 9
    general_k3_k5 = ("refine_sads_general", "lloyd_general",
                     "candidate_sads_general", "pyr_down_u8",
                     "refine_sads_pitched_general", "pyr_down_pitched_general",
                     "ccl_converge_general")
    # 8x8 blocks of 3 channels take the specialised K6 on the width-excess
    # path; the general K6 runs on none of phases 4-6
    general_k6 = ("idct_resize_display_general",)

    # 4. the default config at 1080p: K1-K5, K9
    print("default config 1080p, 17 frames:")
    main_run = round_trip(EncoderConfig(), 1920, 1080, 17,
                          encode_kernels + ("lloyd", "idct_display"),
                          general_dct + general_k3_k5 + general_k6)
    staged_against_direct(main_run, dev)
    with tempfile.TemporaryDirectory(prefix="svc_smoke_") as tmp:
        print(f"  CLIs on cuda: {cli_checks(main_run, tmp)}")

    # 5. width excess: the general decode route, K6; K2 on packed rows of
    # 4098 bytes (row starts only 2-byte aligned)
    print("width excess 1366x768 (padded 1376x768), 9 frames, default config:")
    wide = round_trip(EncoderConfig(), 1366, 768, 9,
                      encode_kernels + ("lloyd", "idct_resize_display"),
                      general_dct + general_k3_k5 + general_k6
                      + ("idct_display",))
    cpu_dec = Decoder(DecoderConfig(), wide["header"], batch_size=8, device="cpu")
    cpu_frames = np.stack(list(cpu_dec.decode_frames(
        iter(wide["payloads"]), iter([wide["gaze"]] * len(wide["payloads"])))))
    print(f"  cuda decode vs cpu decode of the same payloads: "
          f"{display_gate(wide['frames'], cpu_frames, 'width-excess decode')}")

    # 6. reference-compat at 1080p: K1-K4, K9
    print("reference-compat 1080p, 9 frames:")
    round_trip(EncoderConfig(reference_compat=True), 1920, 1080, 9,
               encode_kernels + ("idct_display",),
               general_dct + general_k3_k5 + general_k6)

    # 7. 4x4 transform blocks (the config allows any block dividing the MV
    # block): the general K1 and K2, and not the specialised ones
    print("4x4 transform blocks, CIF 352x288, 9 frames, default config:")
    tb4 = round_trip(EncoderConfig(transform_block_w=4, transform_block_h=4),
                     352, 288, 9, general_dct + ("refine_sads", "lloyd"),
                     ("dct8x8_to_wire", "idct_display") + general_k3_k5)

    # 8. card against CPU on the first 3 frames, default config
    cfg = EncoderConfig()
    clip, w, h = main_run["clip"], 1920, 1080
    props = VideoProperties(w, h, len(clip))
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
    lab_diff = o_gpu["cluster_labels"].cpu() != o_cpu["cluster_labels"]
    lab_share = lab_diff.double().mean().item()
    bt_diff = o_gpu["block_types"].cpu() != o_cpu["block_types"]
    share = bt_diff.double().mean().item()
    first = bt_diff.nonzero()[0].tolist() if bool(bt_diff.any()) else None
    if share > BLOCK_TYPE_TOL:
        fail(f"block types differ on {share:.3%} of blocks (first at {first})")
    gaze, payloads = main_run["gaze"], main_run["payloads"]
    cpu_dec = Decoder(DecoderConfig(), main_run["header"], batch_size=2, device="cpu")
    ref_frames = np.stack(list(cpu_dec.decode_frames(iter(payloads[:2]),
                                                     iter([gaze] * 2))))
    dgate = display_gate(main_run["frames"][:2], ref_frames, "1080p decode")
    print(f"card vs cpu (3 frames, default config): header, MV fields and "
          f"inliers equal; coefficients max |err| {cerr:.3e}; k-means labels "
          f"differ on {int(lab_diff.sum())} blocks ({lab_share:.4%}), block "
          f"types on {int(bt_diff.sum())} ({share:.4%}; first mismatch "
          f"{first}); decoded bytes {dgate}")

    # 9. per-frame motion at 1080p: K7
    print("per-frame motion 1080p (frames 0-1, padded 1920x1088):")
    frame_run = per_frame_motion(clip, dev)

    # 10. pitched motion at 1080p: K8
    print("pitched motion 1080p (frames 0-8, tbw=8):")
    pitched_run = pitched_motion(clip, dev)

    # 11. timings (warm: every kernel is built and loaded), default config
    enc, dec, stream = main_run["enc"], main_run["dec"], main_run["stream"]
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
    compat = Encoder(EncoderConfig(reference_compat=True), props, batch_size=8,
                     device="cuda")
    compat_ms = cuda_ms(lambda: compat.encode_packed(packed, 0), iters=5, warmup=1)
    header = main_run["header"]
    coeffs = torch.as_tensor(
        np.stack([bitstream.deserialize_frame_blocks(p, header)[1] for p in payloads[:8]])
    ).reshape(8, 136, 240, 192).to(dev)
    steps = torch.full((8, 136, 240), 640.0, device=dev)
    dec_ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, h), iters=20)
    pyr = frame_run["pyr"]
    tracked, anchor = [p[0] for p in pyr], [p[1] for p in pyr]
    hbma_ms = cuda_ms(lambda: motion.hbma(tracked, anchor, 8, 16, 16), iters=5,
                      warmup=1)
    print(f"timings 1080p batch 8 [{card}]: default config encode "
          f"{16 / enc_s:.2f} fps end to end (host clip -> bytes), "
          f"{8000.0 / enc_ms:.2f} fps device batch ({enc_ms:.2f} ms / 8 "
          f"frames; reference-compat {compat_ms:.2f} ms); decode "
          f"{n_dec / dec_s:.2f} fps end to end (bytes -> host frames), "
          f"{8000.0 / dec_ms:.2f} fps device ({dec_ms:.3f} ms / 8 frames); "
          f"per-frame hbma {hbma_ms:.3f} ms per 1080p pair")
    print("timings, synchronous-direct against staged, in turns:")
    print(f"  {phase_overlap(main_run, card, dev)}")

    # 12. RANSAC subsets at 1080p: subset 3 on the main path's kernels
    print("RANSAC subsets 1080p (default config, subset 3; 9 frames):")
    ransac_subsets(main_run, card, dev, encode_kernels + ("lloyd", "idct_display"),
                   general_dct + general_k3_k5 + general_k6)

    # 13. the frame-parallel split on the card
    print("frame-parallel split 1080p, 17 frames, default config:")
    split_stream = sharded_run(main_run, card, encode_kernels + ("lloyd", "idct_display"),
                               general_dct + general_k3_k5 + general_k6)

    # 14. the compiled batch: graph replay against the eager path
    print("compiled batch 1080p, default config, eager (graph=False) against "
          "graph, in turns:")
    compiled_batch(main_run, split_stream, card, dev)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "svc_tpu", "benchmarks"))
    if loaded:
        fail(f"modules of JAX, svc_tpu or benchmarks were imported: {loaded[:5]}")
    # where each kernel's launches were counted: the path that runs it
    path_of = {"idct_resize_display": wide, "refine_mads": frame_run,
               "refine_mads_general": frame_run,
               "pyr_down_pitched_levels": pitched_run,
               "pyr_down_pitched_general": pitched_run,
               "refine_sads_pitched": pitched_run,
               "refine_sads_pitched_general": pitched_run,
               "dct_to_wire_general": tb4, "idct_display_general": tb4}
    kernels = []
    for name, r in results.items():
        k = r["kernel"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": path_of.get(name, main_run)["counts"][name],
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "wrapper_ms": r["wrapper_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
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
