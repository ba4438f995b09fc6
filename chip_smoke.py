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
   shared memory and CTAs per SM, the display kernels' and the templated
   K2's spill stores, dynamic shared memory and CTAs per SM, K5's static
   shared memory held to what
   its wrapper plans with, K11's cipher instructions a word counted in the
   built library's SASS (``cuobjdump -sass``), and the card's 32-bit
   integer rate (64 instructions a clock on each SM at its maximum SM
   clock, ``nvidia-smi``);
3. kernel parity — each of the 120 kernels against its plain
   PyTorch version on the card at the shapes of its path (K3, K4, K5, K7,
   K8, K9, K10, K11 bit-equal, K5's compactness within rtol 1e-6; K2 within 2.5e-4;
   K1 and K6 within 1 with under 1e-3 of the bytes differing), with the
   kernel's time, its time through the wrapper, the plain version's, the
   one-call PyTorch yardstick's where one exists, and the bound (bytes
   over 3.35 TB/s or operations over 67 T/s, float64 operations over 67
   T/s, integer instructions over the integer rate for K3, K4, K7, K8, K9
   and K11, whichever is larger). A kernel's time is that of CUDA graph
   replays, so that no host time of the wrapper enters (the yardsticks
   too). Every kernel runs on its new kernel (K1 / K2 / K6 8x8 x 3, K3
   and K7 square 4/8/16 blocks at r = 1, K4 and the K8 pyramid levels 1-3
   in one launch, K5 the 8-CTA cluster kernel, the K8 refine 8 subplanes
   with 16x16 blocks at r = 1, K9 2x2 blocks at r = 1; K3, K7 and K9 also
   at r = 2, 3, 4, each instance on the MVs the encoder's own search gives
   its level of a 1080p clip at ranges 16, 24 and 32, on random MVs and on
   odd MVs past the frame edges, K7 on frames 0-1, K9 at the EBMA shape
   with zero, random and past-edge MVs and T = 1, each timed in turns
   with the general kernel at its shape; K9 at 1x1, 4x4, 8x8, 16x16, 2x1,
   4x2, 8x4, 1x2, 2x4, 4x8, 16x8, 8x16, 4x1, 8x2, 16x4, 1x4, 2x8, 4x16 and
   K3 / K7 at 2x2, 4x2, 8x4, 16x8, 2x4, 4x8, 8x16, 32x32, 32x16, 16x32,
   8x2, 16x4, 32x8, 2x8, 4x16, 8x32 blocks (width x height: the levels of
   8x8 MV blocks, of 2 and 3 levels, of 16x8 and 8x16 MV blocks at 2, 3 or
   4 levels, of 32x32, 32x16 and 16x32 MV blocks at 2 levels, and of 32x8
   and 8x32 MV blocks at 2, 3 or 4 levels, each at the 1080p level shape
   its setting's encoder pads to, ``INSTANCE_SETTINGS``), r = 1-4, T = 8,
   K9 on zero, random, past-edge and saturated MVs and planes, K3 on the
   setting's own search's MVs, random and past-edge ones and a saturated
   stack (anchor 255 against tracked 0 over whole blocks: a block's SAD
   255 BW BH, 261,120 at 32x32, 65,280 at 32x8 and 8x32), K7 on frames
   0-1, each timed in turns with the general kernel; past r = 4 the same
   at r = 5-8 for K9 at 16x16 (one level of 16x16 MV blocks, 8 x
   1088x1920), 8x8, 4x4 and 2x2 (the top of two, three and four levels, 8
   x 544x960, 272x480, 136x240) and K3 / K7 at 16x16, 8x8 and 4x4 (levels
   0, 1 and 2 of two to four levels), K9 at 1x1 (the top of 8x8 MV blocks
   at 4 levels, 8 x 136x240, and of 16x16 at 5, 8 x 68x120), K3 / K7 at
   2x2 (level 2 of 8x8 MV blocks at 4 levels, 272x480, level 3 of 16x16 at
   5, 136x240) and at 32x32 (level 0 of 32x32 MV blocks, 1088x1920; a
   saturated block 261,120), ``FAR_SETTINGS``), held bit for bit
   against the general (K4: single-level; K8 pyramid: the general pitched
   level, then the single-level K4) kernels on the same inputs and timed
   in turns with them (K3 per level, K5 at 1080p, 1440p and 4K, K6 at
   1366x768 and 1270x714; K7 also against stacking the pair for K3, and
   at odd MVs past the frame edges); K4 also at odd and
   tiny sizes and 2-5 levels, the K8 pyramid at odd subplane widths and
   a small frame, K9 also with random, past-edge and T = 1 MVs, the K8
   refine with MVs past its staged band and past the frame edges; K5 also
   at 1080p with D = 7; the templated K6 (4x4, 16x16 and the six
   rectangles of sides 4, 8 and 16, rows x columns, blocks of 3 channels,
   2x2 and the six rectangles with a side of 2, 1x1 and the eight with a
   side of 1) byte-equal to the general K6 at 1366x768, 1270x714 and
   854x480, T = 8, and on a ragged shape (1312 padded pixels: block
   columns ending mid-strip), held to its plain version (at a side of 1
   or 2 off the exact ties of its first frame), timed in turns with it
   at 1366x768 and 854x480; the templated K2 and K1 (the same eight
   shapes, 2x2 and
   the six rectangles with a side of 2, 1x1 and the eight with a side of
   1) at 1080p,
   T = 8, bit-equal (K2) or byte-equal (K1) to the general kernels there
   and on a ragged shape (1366-pixel packed rows, 2-byte aligned; block
   columns ending mid-strip), K1 also with identity rows (at 2x2 and 1x1
   held to its plain version off the exact ties,
   ``tools/display_ties.py``), each timed in turns with the general
   kernel at its shape (the general K2 / K1 timings there), K2 also in
   turns with its (bh*bw)-filter stride-(bh, bw) convolution; K10 (the
   CCL on the
   device: the 8-CTA cluster kernel and the
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
   payloads; then the clip with 4x4, 16x16, 8x16 (rows x columns) and
   2x2 transform blocks, and a 9-frame 854x480 clip with each of the
   other five rectangles of sides 4, 8 and 16, the six with a side of 2,
   1x1 and the eight with a side of 1, on graph replays: the templated K2 and
   K6 of that shape must run, no other K6, no K1 and no general kernel;
   the frames byte-equal to ``graph=False`` and 2 payloads held to the
   CPU port's decode (the display gate; at a side of 1 or 2 within 1 and
   at the gate off the exact ties);
6. reference-compat — a 9-frame 1080p clip with
   ``EncoderConfig(reference_compat=True)``, K1-K4 and K9 must run;
   phases 4-6 must not launch a general kernel (K1, K2, K3, K5, K6, K9,
   K10), the single-level K4 or a templated K1, K2 or K6 (phase 5's
   templated runs: only their own shape's K2 and K6);
7. transform blocks other than 8x8 — a 9-frame CIF clip, default config
   with 4x4 transform blocks: the 4x4 K2 and K1 must run, no other K1 or
   K2 and no K6;
   its 16x16 MV blocks run the specialised K3 and the cluster K5, the
   fused K4 and the 2x2 K9 (no general K3, K5, K9, K10, single-level K4);
   then 9-frame clips on graph replays at 16x16, 8x16 (8 rows, 16
   columns), 2x2 and 1x1 transform blocks at 1080p, and at 4x8, 8x4,
   4x16, 16x4, 16x8, 2x4, 4x2, 2x8, 8x2, 2x16, 16x2, 1x2, 2x1, 1x4, 4x1,
   1x8, 8x1, 1x16 and 16x1 at CIF: each shape's own K2 and K1 must run,
   no other K1, K2 or K6, and no general kernel; each stream and its
   frames byte-equal to ``graph=False``; the first 3 frames encoded on
   the CPU port (header and MV fields equal, coefficients within 2.5e-4,
   block types within 1%) and 2 payloads decoded there (the display
   gate; at 2x2 and 1x1 within 1, and at the gate off the exact ties);
8. card against CPU — the first 3 frames, default config, on both devices;
9. per-frame motion — two consecutive 1080p frames (padded to 1088 rows)
   through ``build_pyramid`` -> ``hbma(., ., 8, 16, 16)`` -> the three
   global-motion estimators on ``cuda``, then ``hbma`` at ranges 16, 24
   and 32 (K7, the fused K4 and the 2x2 K9 must run, every K7 and K9
   instance at r = 1-4, the general K7 and K9 and the single-level K4 not),
   at 8x8 MV blocks, at 3 levels, at 16x8, 32x32, 32x16, 32x8 and 8x32 MV
   blocks (K9's 1x1, 4x4, 2x1, 4x2, 4x1 and 1x4, K7's 2x2, 4x2, 8x4, 16x8,
   32x32, 32x16, 8x2, 16x4, 32x8, 2x8, 4x16 and 8x32 instances) and at 2
   levels, range 16 (K9's 8x8 and K7's 16x16 at r = 8), 4 levels,
   range 64 (K9's 2x2 and K7's 4x4, 8x8 and 16x16 at r = 8), 8x8 MV blocks
   at range 64 (G20: K9's 1x1 and K7's 2x2 at r = 8) and 32x32 MV blocks at
   range 64 (G22: K7's 32x32 at r = 8), each held
   against ``hbma_stack`` on the same 2-frame stack and the CPU port;
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
    K9 must run, no general kernel and no templated K6), and
    ``estimate_global_motion_ransac``
    timed per 8-frame batch at subsets 1, 3 and 8;
13. frame-parallel split — ``ShardedEncoder`` and the device-list
    ``Decoder`` over two entries (two cards when there are, else
    ``[cuda:0, cuda:0]``), 4 anchors each: phase 4's 17-frame clip gives
    its stream byte for byte and its decoded frames (K1-K5 and K9 must
    run, no general kernel and no templated K6), then single-device and
    split fps in turns;
14. compiled batch — the encoder and the decoder run each batch as a
    CUDA graph replay (phases 4-8, 11-13 all do); here against
    ``graph=False``: phase 4's 17-frame clip through ``stream_encode``
    both ways, byte-equal to the main run's stream, then in turns (eager,
    graph, graph, eager) with fps and the Tracer split per batch; 13
    frames both ways, phase 13's split stream against the eager one; per
    mode the device batch time, its dispatch and
    ``tools/profile_slice.py``'s launches per batch; a replay launches
    K10's cluster kernel once and the general one never. The decode the
    same way: phase 4's payloads through ``decode_frames`` eager and
    graph, staged and direct, byte-equal to phase 4's frames; 32 payloads
    in turns with fps and the split; per mode the batch time, dispatch
    and launches; one staged replay's profile (in a child process),
    whose coefficients cross in one H2D copy straight into the graph's
    input with no device-to-device copy of their size; a replay launches
    K1 once and nothing else;
15. search ranges — 9-frame 1080p clips with
    ``EncoderConfig(mv_search_range=16)``, 24 and 32 (top radii 2, 3, 4)
    on graph replays: K9's and K3's instances of that radius must run, no
    other radius's and no general K3 or K9; each stream and its frames
    byte-equal to ``graph=False``, the first 3 frames encoded on the CPU
    port (header and MV fields equal, coefficients within 2.5e-4, block
    types within 1%), 2 payloads decoded there (the display gate); then
    the device batch time of each range's encoder (graph replays) in turns
    with the default range 8;
16. MV blocks and pyramid levels — 9-frame 1080p clips with 8x8 MV blocks
    (``EncoderConfig(mv_block_w=8, mv_block_h=8)``), 3 and 2 levels, 5
    levels at range 16, 16x8 MV blocks (G5), 8x16 at range 16 (G6), 16x8
    at 3 levels (G7), 32x32 at 4 and 2 levels (G8, G9), 32x16 (G10) and
    16x32 at 2 levels (G11), 32x8 (G12) and 8x32 (G13) MV blocks, 32x8 at
    2 levels (G14) and 8x32 at 3 (G15), one level at range 8 (G16), 2
    levels at range 16 (G17), 3 levels at range 32 (G18), 4 levels at
    range 64 (G19), 8x8 MV blocks at range 64 (G20), 5 levels at range 128
    (G21) and 32x32 MV blocks at range 64 (G22) on graph replays: the K9
    and K3
    instances of the setting's blocks and radius must run (K9 at 1x1, 4x4,
    8x8, 1x1, 2x1, 1x2, 4x2, 4x4, 16x16, 4x2, 8x16, 4x1, 1x4, 16x4, 2x8,
    16x16 at r = 8 under G16 (which must launch neither K4 nor K3), 8x8 at
    r = 8 under G17, 4x4 at r = 8 under G18, 2x2 at r = 8 under G19, 1x1
    at r = 8 under G20 and G21, 4x4 at r = 8 under G22;
    K3 at 2x2 under 8x8 MV blocks and 5 levels, at 4x2, 8x4, 16x8 under
    G5, 2x4, 4x8, 8x16 under G6, 8x4, 16x8 under G7, 8x8, 16x16, 32x32
    under G8, 32x32 under G9, 8x4, 16x8, 32x16 under G10, 16x32 under G11,
    8x2, 16x4, 32x8 under G12, 2x8, 4x16, 8x32 under G13, 32x8 under G14,
    4x16, 8x32 under G15, 16x16 at r = 8 under G17, 8x8 and 16x16 at r = 8
    under G18, 4x4, 8x8 and 16x16 at r = 8 under G19, 2x2, 4x4 and 8x8 at r
    = 8 under G20, 2x2 to 16x16 at r = 8 under G21, 8x8, 16x16 and 32x32 at
    r = 8 under G22), no other instance and
    no general K3 or K9; the
    same checks as phase 15, then the device batch time of each setting in
    turns with the default config.

``python3 chip_smoke.py --batch-ms`` runs phase 1 and phase 16's batch
timing alone (``motion_batch_ms``), so that a copy of this script in
another checkout times that checkout's encoders.

Phases 4-7, 12, 15 and 16 also need K10 and K11 to run. A graph's kernels
count one launch each on every replay (its warm-up runs them once more).
Each path of phases 4-7, 9, 10, 12, 13, 15 and 16 runs with the launch
counters set to 0 just before it and read just after; K3's, K7's and K9's
are also counted per template instance (``refine_sads<16, 2>``,
``candidate_sads<1, 4>``). The second-to-last line is a JSON
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
# transform blocks (rows, columns) whose decode puts many display bytes on
# exact halves of the float64 decode (integer dequantized coefficients
# through a 1- or 2-point transform): their decode gates hold the bytes
# off those ties (tools/display_ties.py)
TIE_SHAPES = ((2, 2), (1, 1))
# --mv-search-range values past the default 8 that phases 9 and 15 run: top
# radii 2, 3 and 4 at 16x16 MV blocks and 4 levels
WIDE_RANGES = (16, 24, 32)
# the MV block and pyramid level settings phase 16 runs (--mv-block-w/-h,
# --pyr-lvl-count; range 8 unless set): the top level's blocks S and radius
# r are 1x1 at r = 1, 4x4 at r = 2, 8x8 at r = 4 and 1x1 at r = 1, the
# first and the last with 2x2 refinement blocks; then 16x8 and 8x16 MV
# blocks (width x height): 2x1 at r = 1 under 4x2, 8x4, 16x8 refinement
# blocks, 1x2 at r = 2 under 2x4, 4x8, 8x16, and 4x2 at r = 2 under 8x4,
# 16x8; then MV blocks with a 32-pixel side: 32x32 with 4x4 at r = 1 under
# 8x8, 16x16, 32x32, and at 2 levels 16x16 at r = 4 under 32x32; 32x16
# with 4x2 at r = 1 under 8x4, 16x8, 32x16; 16x32 at 2 levels, 8x16 at r =
# 4 under 16x32; then ratio-4 MV blocks: 32x8 with 4x1 at r = 1 under 8x2,
# 16x4, 32x8 (1080 rows: 135 block rows at every level), 8x32 with 1x4 at
# r = 1 under 2x8, 4x16, 8x32 (1088 rows), 32x8 at 2 levels, 16x4 at r =
# 4 under 32x8, 8x32 at 3 levels, 2x8 at r = 2 under 4x16, 8x32; then
# 16x16 MV blocks past r = 4: one level at range 8 (16x16 at r = 8, the
# whole search on K9: no pyramid level, no K4, no K3), two levels at range
# 16 (8x8 at r = 8 under 16x16), three at range 32 (4x4 at r = 8 under 8x8,
# 16x16) and four at range 64 (2x2 at r = 8 under 4x4, 8x8, 16x16: the
# reference's SSE2 build, which fixes 16x16 MV blocks and 4 levels, at
# --mv-search-range 64); then the other square MV blocks past r = 4: 8x8 at
# 4 levels, range 64 (1x1 at r = 8 under 2x2, 4x4, 8x8), 16x16 at 5
# levels, range 128 (1x1 at r = 8 under 2x2 ... 16x16) and 32x32 at 4
# levels, range 64 (4x4 at r = 8 under 8x8, 16x16, 32x32)
MOTION_CONFIGS = {
    "G1 8x8 MV blocks": dict(mv_block_w=8, mv_block_h=8),
    "G2 3 levels": dict(pyr_lvl_count=3),
    "G3 2 levels": dict(pyr_lvl_count=2),
    "G4 5 levels, range 16": dict(pyr_lvl_count=5, mv_search_range=16),
    "G5 16x8 MV blocks": dict(mv_block_w=16, mv_block_h=8),
    "G6 8x16 MV blocks, range 16": dict(mv_block_w=8, mv_block_h=16, mv_search_range=16),
    "G7 16x8, 3 levels": dict(mv_block_w=16, mv_block_h=8, pyr_lvl_count=3),
    "G8 32x32 MV blocks": dict(mv_block_w=32, mv_block_h=32),
    "G9 32x32, 2 levels": dict(mv_block_w=32, mv_block_h=32, pyr_lvl_count=2),
    "G10 32x16 MV blocks": dict(mv_block_w=32, mv_block_h=16),
    "G11 16x32, 2 levels": dict(mv_block_w=16, mv_block_h=32, pyr_lvl_count=2),
    "G12 32x8 MV blocks": dict(mv_block_w=32, mv_block_h=8),
    "G13 8x32 MV blocks": dict(mv_block_w=8, mv_block_h=32),
    "G14 32x8, 2 levels": dict(mv_block_w=32, mv_block_h=8, pyr_lvl_count=2),
    "G15 8x32, 3 levels": dict(mv_block_w=8, mv_block_h=32, pyr_lvl_count=3),
    "G16 1 level": dict(pyr_lvl_count=1),
    "G17 2 levels, range 16": dict(pyr_lvl_count=2, mv_search_range=16),
    "G18 3 levels, range 32": dict(pyr_lvl_count=3, mv_search_range=32),
    "G19 4 levels, range 64": dict(mv_search_range=64),
    "G20 8x8, range 64": dict(mv_block_w=8, mv_block_h=8, mv_search_range=64),
    "G21 5 levels, range 128": dict(pyr_lvl_count=5, mv_search_range=128),
    "G22 32x32, range 64": dict(mv_block_w=32, mv_block_h=32, mv_search_range=64),
}
# the bound of a kernel (H100 SXM data sheet):
# each input byte read once and each output byte written once over the
# HBM rate, or the operations over the float32 rate outside the tensor
# cores (a multiply accumulate counts 2; integer work: its instructions
# over the integer rate below), whichever is larger
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
FP64_OPS_PER_S = 67e12  # float64 peak, on the tensor cores (K2's sums)
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
    return [entry[:4] for entry in ptxas_entries(log)]


def ptxas_spills(log: str):
    """``{kernel: spill store bytes}`` from nvcc's ``-Xptxas -v`` report."""
    return {entry[1]: entry[4] for entry in ptxas_entries(log)}


def ptxas_entries(log: str):
    """``[(source file, kernel, registers, static smem bytes, spill store
    bytes)]`` from nvcc's ``-Xptxas -v`` report."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        # the mangled kernel name holds "<length>_<source stem>_cu_<hash>"
        # then "<length><kernel name>", then "ILi<B>E" for a template of
        # one int, "ILi<BH>ELi<BW>E" for one of two and so on, with "f" or
        # "i" after them for an output type float or int32_t
        m = re.search(r"Compiling entry function '[^']*?_\d+_([a-z]\w*?)_cu_"
                      r"[0-9a-f]{8}\d+([A-Za-z]\w*?_kernel)"
                      r"(?:I((?:Li\d+E)+)([fi])?)?", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(3) or "") + [
                {"f": "float", "i": "int"}[c] for c in m.group(4) or ""]
            tmpl = f"<{', '.join(args)}>" if args else ""
            name, spill = (f"{m.group(1)}.cu", f"{m.group(2)}{tmpl}"), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            out.append(name + (int(m.group(1)), int(m.group(2) or 0), spill))
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


def search_level_mvs(pyr, search_range: int, block_w: int = 16, block_h: int = 16):
    """The MVs each refinement level of ``hbma_stack(pyr, search_range,
    block_w, block_h)`` receives (its doubled, rounded propagated field), by
    the encoder's own search: ``{level: (T, mfh, mfw, 2) int32}`` and the
    top level's radius."""
    from svc_tpu_torch.ops import motion

    levels = len(pyr)
    r = motion._top_range(levels, search_range, block_w, block_h)
    top = pyr[-1]
    factor = 1 << (levels - 1)
    mv, min_mad = motion.ebma(top[:-1], top[1:], r, block_w // factor,
                              block_h // factor)
    out = {}
    for lvl in range(levels - 2, -1, -1):
        bw, bh = block_w >> lvl, block_h >> lvl
        mv = mv * 2.0
        out[lvl] = torch.round(mv).to(torch.int32)
        stack = pyr[lvl]
        sads = motion.refine_sads(stack, out[lvl], r, bw, bh)
        mv, min_mad = motion._refine_select(motion._mads(sads, bw, bh), mv, min_mad,
                                            r, bw, bh, *stack.shape[1:])
    return out, r


def wide_search_parity(g, dev, results, int_ops_per_s):
    """Phase 3's radii 2-4 (``--mv-search-range`` 16, 24, 32 at 16x16 MV
    blocks and 4 levels): the K3 instances at levels 2, 1, 0 of a 9-frame
    1080p clip's luma pyramid (blocks 4, 8, 16), on the MVs the encoder's
    own search gives each level, on random MVs and on odd MVs past the
    frame edges; K7's on frames 0 and 1 (the search's MVs and odd past-edge
    ones); K9's at the EBMA path shape (136x240, T = 8) with zero, random
    and past-edge MVs and at T = 1. Each bit-equal to the general kernel
    and to the plain version on every entry, timed in turns with the
    general kernel (CUDA graph replays), its bound beside it."""
    from svc_tpu_torch.ops import motion
    from svc_tpu_torch.ops.pyramid import build_pyramid
    from svc_tpu_torch.tools.clips import make_clip

    pyr = build_pyramid(padded_luma(make_clip(1920, 1080, 9), dev), 4)
    lines = []
    for search_range in WIDE_RANGES:
        level_mvs, r = search_level_mvs(pyr, search_range)
        side2 = (2 * r + 1) ** 2
        k3, k7 = [], []
        for lvl in (2, 1, 0):
            b = 16 >> lvl
            stack = pyr[lvl]
            mfh, mfw = stack.shape[1] // b, stack.shape[2] // b
            own = level_mvs[lvl]
            bnd = (4 * r) << (2 - lvl)  # the reach of the search's MVs at this level
            cases = {
                "the search's": own,
                "random": torch.randint(-bnd, bnd + 1, own.shape, generator=g,
                                        dtype=torch.int32).to(dev),
                "odd past the edges": (2 * torch.randint(-b, b + 1, own.shape, generator=g,
                                                         dtype=torch.int32) + 1).to(dev),
            }
            name = f"refine_sads<{b}, {r}>"
            for kind, mv in cases.items():
                before = motion.REFINE_SADS.instance_launches[name]
                got = motion.refine_sads(stack, mv, r, b, b)
                if motion.REFINE_SADS.instance_launches[name] != before + 1:
                    fail(f"K3 at r={r}, level {lvl} did not take {name}")
                ref = motion.refine_sads_plain(stack, mv, r, b, b)
                if not torch.equal(got, ref):
                    fail(f"K3 {name} differs from its plain version ({kind} MVs)")
                if not torch.equal(got, motion.refine_sads(stack, mv, r, b, b, general=True)):
                    fail(f"K3 {name} differs from the general kernel ({kind} MVs)")
            g_ms, n_ms, turns = in_turns(
                lambda: motion.refine_sads(stack, own, r, b, b, general=True),
                lambda: motion.refine_sads(stack, own, r, b, b), graph_ms)
            w_ms = cuda_ms(lambda: motion.refine_sads(stack, own, r, b, b))
            p_ms = cuda_ms(lambda: motion.refine_sads_plain(stack, own, r, b, b), iters=3,
                           warmup=1)
            # bytes: the stack read once, the MVs, each SAD written once;
            # operations: a SIMD SAD of 4 bytes each
            n_out = (stack.shape[0] - 1) * side2 * mfh * mfw
            nbytes = stack.numel() + own.numel() * 4 + n_out * 4
            ops = n_out * b * b // 4
            line = record(results, name, motion.REFINE_SADS, 0, n_ms, w_ms, p_ms, nbytes,
                          ops, ops_per_s=int_ops_per_s)
            k3.append(f"level {lvl} {name} {n_ms:.4f} ms, general {g_ms:.4f} "
                      f"({g_ms / n_ms:.1f}x; in turns {', '.join(f'{x:.4f}' for x in turns)}), "
                      f"plain {p_ms:.4f}; {line}")

            # K7: frames 0 and 1 of the level, the search's MVs of frame 0
            tr, an = stack[0], stack[1]
            name7 = f"refine_mads<{b}, {r}>"
            odd = cases["odd past the edges"][0].contiguous()
            for kind, mv in (("the search's", own[0].contiguous()), ("odd past the edges", odd)):
                before = motion.REFINE_MADS.instance_launches[name7]
                got = motion.refine_mads(tr, an, mv, r, b, b)
                if motion.REFINE_MADS.instance_launches[name7] != before + 1:
                    fail(f"K7 at r={r}, level {lvl} did not take {name7}")
                ref = motion.refine_mads_plain(tr, an, mv, r, b, b)
                if not torch.equal(got, ref):
                    fail(f"K7 {name7} differs from its plain version ({kind} MVs)")
                if not torch.equal(got, motion.refine_mads(tr, an, mv, r, b, b, general=True)):
                    fail(f"K7 {name7} differs from the general kernel ({kind} MVs)")
            mv0 = own[0].contiguous()
            g_ms, n_ms, turns = in_turns(
                lambda: motion.refine_mads(tr, an, mv0, r, b, b, general=True),
                lambda: motion.refine_mads(tr, an, mv0, r, b, b), graph_ms)
            w_ms = cuda_ms(lambda: motion.refine_mads(tr, an, mv0, r, b, b))
            p_ms = cuda_ms(lambda: motion.refine_mads_plain(tr, an, mv0, r, b, b), iters=3,
                           warmup=1)
            nbytes = 2 * tr.numel() + mv0.numel() * 4 + side2 * mfh * mfw * 4
            ops = side2 * mfh * mfw * b * b // 4
            line = record(results, name7, motion.REFINE_MADS, 0, n_ms, w_ms, p_ms, nbytes,
                          ops, ops_per_s=int_ops_per_s)
            k7.append(f"level {lvl} {name7} {n_ms:.4f} ms, general {g_ms:.4f} "
                      f"({g_ms / n_ms:.1f}x; in turns {', '.join(f'{x:.4f}' for x in turns)}); "
                      f"{line}")

        # K9: the top level's EBMA shape
        top = pyr[3]
        tr, an = top[:-1], top[1:]
        zero = torch.zeros((8, 68, 120, 2), dtype=torch.int32, device=dev)
        odd1 = (2 * torch.randint(-4, 5, (1, 68, 120, 2), generator=g, dtype=torch.int32)
                + 1).to(dev)
        cases = {
            "T=8 zero MVs": (tr, an, zero),
            "T=8 MVs within +-14": (tr, an, torch.randint(
                -14, 15, (8, 68, 120, 2), generator=g, dtype=torch.int32).to(dev)),
            "T=8 odd MVs past the edges": (tr, an, (2 * torch.randint(
                -4, 5, (8, 68, 120, 2), generator=g, dtype=torch.int32) + 1).to(dev)),
            "T=1 odd MVs past the edges": (tr[:1], an[:1], odd1),
        }
        name9 = f"candidate_sads<2, {r}>"
        for kind, (a, bb, mv) in cases.items():
            before = motion.CANDIDATE_SADS.instance_launches[name9]
            got = motion.candidate_sads(a, bb, mv, r, 2, 2)
            if motion.CANDIDATE_SADS.instance_launches[name9] != before + 1:
                fail(f"K9 at r={r} ({kind}) did not take {name9}")
            if not torch.equal(got, motion.candidate_sads_plain(a, bb, mv, r, 2, 2)):
                fail(f"K9 {name9} differs from its plain version ({kind})")
            if not torch.equal(got, motion.candidate_sads(a, bb, mv, r, 2, 2, general=True)):
                fail(f"K9 {name9} differs from the general kernel ({kind})")
        g_ms, n_ms, turns = in_turns(
            lambda: motion.candidate_sads(tr, an, zero, r, 2, 2, general=True),
            lambda: motion.candidate_sads(tr, an, zero, r, 2, 2), graph_ms)
        w_ms = cuda_ms(lambda: motion.candidate_sads(tr, an, zero, r, 2, 2))
        p_ms = cuda_ms(lambda: motion.candidate_sads_plain(tr, an, zero, r, 2, 2), iters=3,
                       warmup=1)
        n_out = 8 * side2 * 68 * 120
        # bytes: the level's 9 frames read once (the tracked and the anchor
        # stack are two views of them), the MVs, each SAD written once
        nbytes = top.numel() + zero.numel() * 4 + n_out * 4
        # one SIMD SAD of 4 bytes a candidate of a 2x2 block
        line = record(results, name9, motion.CANDIDATE_SADS, 0, n_ms, w_ms, p_ms, nbytes,
                      n_out, ops_per_s=int_ops_per_s)
        lines.append(
            f"range {search_range} (r={r}): K3 {'; '.join(k3)}; K7 (one pair) "
            f"{'; '.join(k7)}; K9 {name9} {n_ms:.4f} ms, general {g_ms:.4f} "
            f"({g_ms / n_ms:.1f}x; in turns {', '.join(f'{x:.4f}' for x in turns)}), "
            f"plain {p_ms:.4f}; {line}")
    print("parity K3 / K7 / K9 at radii 2-4: every instance bit-equal to the "
          "general kernel and to the plain version on every entry (K3: the "
          "search's, random and odd past-edge MVs, levels 2-0 of a 9-frame 1080p "
          "clip; K7: frames 0-1; K9: the EBMA shape with zero, random and "
          "past-edge MVs, T=8 and 1); timed in turns with the general kernel:")
    for line in lines:
        print(f"  {line}")


def held(kernel, name, new, general, plain, kind):
    """``new()``, which must launch ``kernel``'s instance ``name`` once and
    equal ``plain()`` and ``general()`` bit for bit (``kind``: its MVs)."""
    before = kernel.instance_launches[name]
    got = new()
    if kernel.instance_launches[name] != before + 1:
        fail(f"{name} ({kind}) did not take its instance")
    if not torch.equal(got, plain()):
        fail(f"{name} differs from its plain version ({kind})")
    if not torch.equal(got, general()):
        fail(f"{name} differs from the general kernel ({kind})")
    return got


def timed_against_general(results, int_ops_per_s, kernel, name, new, general, plain,
                          nbytes, ops):
    """An instance timed in turns with the general kernel (20 launches in
    one CUDA graph), through its wrapper and against its plain version,
    recorded in ``results`` with its bound; its report line."""
    g_ms, n_ms, turns = in_turns(general, new, graph_ms)
    w_ms = cuda_ms(new)
    p_ms = cuda_ms(plain, iters=3, warmup=1)
    line = record(results, name, kernel, 0, n_ms, w_ms, p_ms, nbytes, ops,
                  ops_per_s=int_ops_per_s)
    return (f"{name} {n_ms:.4f} ms, general {g_ms:.4f} ({g_ms / n_ms:.1f}x; in turns "
            f"{', '.join(f'{x:.4f}' for x in turns)}), plain {p_ms:.4f}; {line}")


# MV block and level settings past the default whose instances phase 3
# holds (width, height, levels; the default, 16x16 at 4 levels, is held
# above it): 8x8 MV blocks (K9 1x1, K3 2x2), 16x16 at 3 and 2 levels (K9
# 4x4, 8x8), 16x8 and 8x16 at 4, 3 and 2 levels (K9 2x1, 4x2, 8x4, 1x2,
# 2x4, 4x8; K3 4x2, 8x4, 16x8, 2x4, 4x8, 8x16), and 32x32, 32x16 and 16x32
# at 2 levels (K9 16x16, 16x8, 8x16; K3 32x32, 32x16, 16x32: at 3-5 levels
# their blocks are among the others), and 32x8 and 8x32 at 4, 3 and 2
# levels (K9 4x1, 8x2, 16x4, 1x4, 2x8, 4x16; K3 8x2, 16x4, 32x8, 2x8, 4x16,
# 8x32)
INSTANCE_SETTINGS = ((8, 8, 4), (16, 16, 3), (16, 16, 2), (16, 8, 4), (16, 8, 3),
                     (16, 8, 2), (8, 16, 4), (8, 16, 3), (8, 16, 2), (32, 32, 2),
                     (32, 16, 2), (16, 32, 2), (32, 8, 4), (32, 8, 3), (32, 8, 2),
                     (8, 32, 4), (8, 32, 3), (8, 32, 2))


def setting_levels(settings=INSTANCE_SETTINGS):
    """``[((width, height, levels), k9_levels, k3_levels)]``: for each MV
    block setting, its top level where K9's blocks there are new and its
    refinement levels whose K3 blocks are new, top down; new meaning
    neither the default setting (16x16, 4 levels) nor an earlier one of
    ``settings`` has them."""
    k9, k3, plan = set(), set(), []
    for mw, mh, levels in ((16, 16, 4),) + tuple(settings):
        top = [levels - 1] if (mw >> levels - 1, mh >> levels - 1) not in k9 else []
        refine = [lvl for lvl in range(levels - 2, -1, -1) if (mw >> lvl, mh >> lvl) not in k3]
        k9.update((mw >> lvl, mh >> lvl) for lvl in top)
        k3.update((mw >> lvl, mh >> lvl) for lvl in refine)
        plan.append(((mw, mh, levels), top, refine))
    return plan[1:]


# the settings of the instances past the near radii (R = 5-8 at 16x16 MV
# blocks, ``motion._FAR_RADII``), in ``setting_levels``' form: one level
# (K9 16x16 at level 0), two levels (K9 8x8 at the top, K3 / K7 16x16 at
# level 0), three levels (K9 4x4 at the top, K3 / K7 8x8 at level 1), four
# levels (K9 2x2 at the top, K3 / K7 4x4 at level 2); then 8x8 MV blocks
# at four levels (K9 1x1 at the top, 136x240, K3 / K7 2x2 at level 2,
# 272x480), 16x16 at five (K9 1x1 at the top, 68x120, K3 / K7 2x2 at level
# 3, 136x240) and 32x32 at two (K3 / K7 32x32 at level 0; the top's K9
# 16x16 is one level's above)
FAR_SETTINGS = (((16, 16, 1), [0], []), ((16, 16, 2), [1], [0]), ((16, 16, 3), [2], [1]),
                ((16, 16, 4), [3], [2]), ((8, 8, 4), [3], [2]), ((16, 16, 5), [4], [3]),
                ((32, 32, 2), [], [0]))


def setting_instance_parity(g, dev, results, int_ops_per_s, plan=None, radii=None):
    """Phase 3's instances for the MV block and level settings past the
    default (``plan``, ``setting_levels()`` unless given), each at each of
    ``radii`` (``motion._SAD_RADII``, r = 1-4, unless given) at the 1080p level shape
    its setting's encoder gives it (``padded_luma``: 1080 rows at 8x8 and
    16x8 MV blocks, 1088 at 16x16 and 8x16), T = 8: K9 at the top level's
    blocks with zero (the EBMA's), random and past-edge MVs; K3 at the
    refinement levels' blocks with the MVs the setting's own search at
    the top radius r gives each level, random and odd past-edge MVs; K7
    on frames 0-1 of each with the search's and the past-edge MVs; each
    also saturated (anchor 255 over a checkerboard of whole blocks against
    tracked 0: those blocks' SADs 255 BW BH at every candidate, past 2^16
    from 32x16 on). Each bit-equal to the general kernel and to the plain
    version on every entry, timed in turns with the general kernel (20
    launches in one CUDA graph), its bound beside it."""
    from svc_tpu_torch.ops import motion
    from svc_tpu_torch.ops.pyramid import build_pyramid
    from svc_tpu_torch.tools.clips import make_clip

    def ints(lo, hi, shape):
        return torch.randint(lo, hi + 1, shape, generator=g, dtype=torch.int32).to(dev)

    def checkerboard(fh, fw, bw, bh):
        """255 over every other bw x bh block of an fh x fw plane, 0 elsewhere."""
        by = torch.arange(fh, device=dev)[:, None] // bh
        bx = torch.arange(fw, device=dev)[None, :] // bw
        return ((by + bx) % 2 == 0).to(torch.uint8) * 255

    def saturated(got, name, bw, bh):
        if int(got.max()) != 255 * bw * bh:
            fail(f"{name}: the saturated case's largest SAD is {int(got.max())}, "
                 f"not {255 * bw * bh}")

    plan = setting_levels() if plan is None else plan
    radii = radii or motion._SAD_RADII
    clip = make_clip(1920, 1080, 9)
    lines, shapes = [], {"K9": [], "K3 / K7": []}
    for (mw, mh, levels), top_levels, refine_levels in plan:
        pyr = build_pyramid(padded_luma(clip, dev, mw, mh, levels), levels)
        shapes["K9"] += [f"{mw >> lvl}x{mh >> lvl}" for lvl in top_levels]
        shapes["K3 / K7"] += [f"{mw >> lvl}x{mh >> lvl}" for lvl in refine_levels]
        for r in radii:
            for lvl in top_levels:
                bw, bh = mw >> lvl, mh >> lvl
                top = pyr[lvl]
                tr, an = top[:-1], top[1:]
                t, fh, fw = tr.shape
                shape = (t, fh // bh, fw // bw, 2)
                zero = torch.zeros(shape, dtype=torch.int32, device=dev)
                reach = 2 * max(bw, bh) + 2
                name = "candidate_sads" + motion._instance(bw, bh, r)
                for kind, mv in {"zero MVs": zero, "MVs within +-14": ints(-14, 14, shape),
                                 "odd MVs past the edges": 2 * ints(-reach, reach, shape) + 1
                                 }.items():
                    got = held(motion.CANDIDATE_SADS, name,
                               lambda: motion.candidate_sads(tr, an, mv, r, bw, bh),
                               lambda: motion.candidate_sads(tr, an, mv, r, bw, bh,
                                                             general=True),
                               lambda: motion.candidate_sads_plain(tr, an, mv, r, bw, bh),
                               kind)
                dark = torch.zeros_like(tr)
                lit = checkerboard(fh, fw, bw, bh).expand(t, fh, fw).contiguous()
                saturated(held(motion.CANDIDATE_SADS, name,
                               lambda: motion.candidate_sads(dark, lit, zero, r, bw, bh),
                               lambda: motion.candidate_sads(dark, lit, zero, r, bw, bh,
                                                             general=True),
                               lambda: motion.candidate_sads_plain(dark, lit, zero, r, bw, bh),
                               "saturated"), name, bw, bh)
                # bytes: the level's frames read once (the tracked and the
                # anchor stack are two views of them), the MVs, each SAD
                # written once; operations: BW BH / 4 SIMD SADs of 4 bytes
                # a candidate (one at least)
                n_out = got.numel()
                lines.append(timed_against_general(
                    results, int_ops_per_s, motion.CANDIDATE_SADS, name,
                    lambda: motion.candidate_sads(tr, an, zero, r, bw, bh),
                    lambda: motion.candidate_sads(tr, an, zero, r, bw, bh, general=True),
                    lambda: motion.candidate_sads_plain(tr, an, zero, r, bw, bh),
                    top.numel() + zero.numel() * 4 + n_out * 4,
                    n_out * max(1, bw * bh // 4)) + f" ({t}x{fh}x{fw}, zero MVs)")
            if not refine_levels:
                continue
            level_mvs, _ = search_level_mvs(pyr, r << levels - 1, mw, mh)
            for lvl in refine_levels:
                bw, bh = mw >> lvl, mh >> lvl
                stack = pyr[lvl]
                tp1, fh, fw = stack.shape
                own = level_mvs[lvl]
                bnd = (2 * r) << (levels - 1 - lvl)  # the reach of the search's MVs here
                reach = max(bw, bh)
                inst = motion._instance(bw, bh, r)
                name3, name7 = "refine_sads" + inst, "refine_mads" + inst
                tr, an = stack[0], stack[1]
                cases = {"the search's": own, "random": ints(-bnd, bnd, own.shape),
                         "odd past the edges": 2 * ints(-reach, reach, own.shape) + 1}
                for kind, mv in cases.items():
                    got = held(motion.REFINE_SADS, name3,
                               lambda: motion.refine_sads(stack, mv, r, bw, bh),
                               lambda: motion.refine_sads(stack, mv, r, bw, bh, general=True),
                               lambda: motion.refine_sads_plain(stack, mv, r, bw, bh), kind)
                    if kind != "random":
                        m0 = mv[0].contiguous()
                        held(motion.REFINE_MADS, name7,
                             lambda: motion.refine_mads(tr, an, m0, r, bw, bh),
                             lambda: motion.refine_mads(tr, an, m0, r, bw, bh, general=True),
                             lambda: motion.refine_mads_plain(tr, an, m0, r, bw, bh), kind)
                # saturated: frames 1, 3, ... lit, the even ones dark
                sat = torch.zeros_like(stack)
                sat[1::2] = checkerboard(fh, fw, bw, bh)
                saturated(held(motion.REFINE_SADS, name3,
                               lambda: motion.refine_sads(sat, own, r, bw, bh),
                               lambda: motion.refine_sads(sat, own, r, bw, bh, general=True),
                               lambda: motion.refine_sads_plain(sat, own, r, bw, bh),
                               "saturated"), name3, bw, bh)
                s0, s1, m0 = sat[0], sat[1], own[0].contiguous()
                saturated(held(motion.REFINE_MADS, name7,
                               lambda: motion.refine_mads(s0, s1, m0, r, bw, bh),
                               lambda: motion.refine_mads(s0, s1, m0, r, bw, bh, general=True),
                               lambda: motion.refine_mads_plain(s0, s1, m0, r, bw, bh),
                               "saturated"), name7, bw, bh)
                # bytes: the stack (K7: its two frames) read once, the MVs,
                # each SAD written once; operations as K9's
                n_out = got.numel()
                ops = n_out * max(1, bw * bh // 4)
                lines.append(timed_against_general(
                    results, int_ops_per_s, motion.REFINE_SADS, name3,
                    lambda: motion.refine_sads(stack, own, r, bw, bh),
                    lambda: motion.refine_sads(stack, own, r, bw, bh, general=True),
                    lambda: motion.refine_sads_plain(stack, own, r, bw, bh),
                    stack.numel() + own.numel() * 4 + n_out * 4, ops)
                    + f" ({tp1}x{fh}x{fw}, the search's MVs)")
                m0 = own[0].contiguous()
                lines.append(timed_against_general(
                    results, int_ops_per_s, motion.REFINE_MADS, name7,
                    lambda: motion.refine_mads(tr, an, m0, r, bw, bh),
                    lambda: motion.refine_mads(tr, an, m0, r, bw, bh, general=True),
                    lambda: motion.refine_mads_plain(tr, an, m0, r, bw, bh),
                    2 * fh * fw + m0.numel() * 4 + n_out // (tp1 - 1) * 4,
                    ops // (tp1 - 1)) + f" (one {fh}x{fw} pair)")
    print(f"parity K9, K3 and K7 at the MV block and level settings "
          f"{', '.join(f'{w}x{h} at {n} levels' for (w, h, n), _, _ in plan)} "
          f"(K9 {', '.join(shapes['K9'])}; K3 / K7 {', '.join(shapes['K3 / K7'])}), r = "
          f"{min(radii)}-{max(radii)}: every instance bit-equal to the general kernel and "
          f"to the plain version on every entry, a saturated case too (255 BW BH a "
          f"block); timed in turns with the general kernel:")
    for line in lines:
        print(f"  {line}")


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
    # bytes: the level's 9 frames read once (``tr`` and ``an`` are two
    # views of them), the MVs, each SAD written once; one SIMD SAD of 4
    # bytes a candidate of a 2x2 block
    nbytes = top.numel() + zero.numel() * 4 + got.numel() * 4
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

    # K3, K7 and K9 at radii 2-4: their instances against the general
    # kernels at the path shapes of search ranges 16, 24 and 32; then K9's
    # 1x1, 4x4 and 8x8 and K3's / K7's 2x2 instances (phase 16's settings);
    # then the instances of 16x8 and 8x16 MV blocks
    wide_search_parity(g, dev, results, int_ops_per_s)
    setting_instance_parity(g, dev, results, int_ops_per_s)
    # past the near radii: K9 16x16, 8x8, 4x4, 2x2 and 1x1, K3 / K7 32x32,
    # 16x16, 8x8, 4x4 and 2x2 at R = 5-8 (one to five levels of 16x16 MV
    # blocks, ranges 5-143; 8x8 at four, ranges 40-71; 32x32 at two, ranges
    # 10-17)
    setting_instance_parity(g, dev, results, int_ops_per_s, FAR_SETTINGS,
                            motion._FAR_RADII)

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
    print(f"parity K2 dct8x8_to_wire: max |err| {err:.3e} <= 2.5e-4, "
          f"bit-exact fraction {exact:.6f}, bit-equal to the general kernel; "
          f"{ms:.4f} ms (general {gen_ms:.4f}; in turns general, new, new, "
          f"general: {', '.join(f'{x:.4f}' for x in turns)}; through the "
          f"wrappers {new_w_ms:.4f} / {gen_w_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms; {line}")

    # K1: display path of 8 frames, 1088 padded rows -> 1080 display rows,
    # then the zero-excess (identity rows) mode, on the specialised 8x8 x 3
    # kernel and on the general one (byte-equal), timed in turns at the
    # first
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
    print(f"parity K1 idct_display: {'; '.join(modes)}; {ms:.4f} ms (general "
          f"{gen_ms:.4f}; in turns general, new, new, general: "
          f"{', '.join(f'{x:.4f}' for x in turns)}; through the wrappers "
          f"{new_w_ms:.4f} / {gen_w_ms:.4f}) vs plain {plain_ms:.4f} ms "
          f"(1088->1080 rows, T=8); {line}")
    for shape in dct.DCT_WIRE_SQ:
        block_shape_parity(g, dev, results, shape, packed, planes)

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
    print(f"parity K6 idct_resize_display (T=8): {'; '.join(modes)}; 1366x768 "
          f"{line}")
    for shape in dct.IDCT_RESIZE_SQ:
        shape_resize_parity(g, dev, results, shape)
    compiled_batch_parity(g, dev, results, int_ops_per_s, k11_per_word)
    return results


def block_shape_parity(g, dev, results, shape, packed, planes):
    """Phase 3, K2 and K1 for ``shape`` = (rows, columns) transform blocks
    of 3 channels on their templated kernels (1x1, 2x2, 4x4, 16x16, the
    six rectangles of sides 4, 8 and 16, the six with a side of 2 and the
    eight with a side of 1): the templated kernel against the general one
    (bit-equal K2, byte-equal K1) and the plain version (within the gates;
    K1 at 2x2 and 1x1 within 1 and, on the first frame, at the gate off
    the exact ties) at 1080p, T = 8, and
    on a ragged shape; each timed in turns with the general kernel, K2
    also with its one-call yardstick. ``packed`` holds 9 packed 1080p
    frames, ``planes`` their last 8 as 24 zero-padded 1088x1920 float32
    planes (K2's yardstick)."""
    from svc_tpu_torch.ops import dct, quant
    from svc_tpu_torch.tools import display_ties

    bh, bw = shape
    k2, k1 = dct.DCT_WIRE_SQ[shape], dct.IDCT_DISPLAY_SQ[shape]
    tag = f"{bh}x{bw}"

    def counts():
        return (k2.launches, dct.DCT_WIRE_GENERAL.launches, k1.launches,
                dct.IDCT_DISPLAY_GENERAL.launches)

    # K2: 8 anchor frames from 9 packed 1080p frames (frame_offset 1); then
    # 1366-pixel rows (4098 bytes: 2-byte aligned starts) whose block
    # columns end mid-strip; yardsticks: the general kernel, and the
    # (bh*bw)-filter stride-(bh, bw) convolution of the 24 padded float32
    # planes (no packing, no wire layout), each in turns with the kernel
    before = counts()
    got = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, bh, bw)
    got_g = dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, bh, bw, general=True)
    if counts() != (before[0] + 1, before[1] + 1, before[2], before[3]):
        fail(f"K2 at {tag} did not launch the templated and the general "
             f"kernel once each")
    if not torch.equal(got, got_g):
        fail(f"K2 {k2.name} differs from the general kernel at 1080p")
    ref = dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, bh, bw)
    err = (got - ref).abs().max().item()
    if not err <= 2.5e-4:
        fail(f"K2 {k2.name} max |err| {err} > 2.5e-4")
    pw = -(-1366 // 16) * 16
    rag = torch.randint(0, 256, (3, 760, 1366 * 3), generator=g,
                        dtype=torch.uint8).to(dev)
    rag_new = dct.dct8x8_to_wire(rag, 1, 2, 768, pw, bh, bw)
    if not torch.equal(rag_new, dct.dct8x8_to_wire(rag, 1, 2, 768, pw, bh, bw,
                                                   general=True)):
        fail(f"K2 {k2.name} differs from the general kernel at 1366x760")
    rag_err = (rag_new - dct.dct8x8_to_wire_plain(rag, 1, 2, 768, pw, bh, bw)
               ).abs().max().item()
    if not rag_err <= 2.5e-4:
        fail(f"K2 {k2.name} max |err| {rag_err} > 2.5e-4 at 1366x760")

    def new2():
        return dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, bh, bw)

    gen_ms, ms, turns = in_turns(
        lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, bh, bw, general=True),
        new2, graph_ms)
    w_ms = cuda_ms(new2)
    gw_ms = cuda_ms(
        lambda: dct.dct8x8_to_wire(packed, 1, 8, 1088, 1920, bh, bw, general=True))
    plain_ms = cuda_ms(
        lambda: dct.dct8x8_to_wire_plain(packed, 1, 8, 1088, 1920, bh, bw), iters=5)
    ch = torch.tensor(dct.dct_matrix(bh), device=dev)
    cw = torch.tensor(dct.dct_matrix(bw), device=dev)
    basis = (ch[:, None, :, None] * cw[None, :, None, :]).reshape(bh * bw, 1, bh, bw)
    lib_ms, _, turns_c = in_turns(
        lambda: torch.nn.functional.conv2d(planes, basis, stride=(bh, bw)), new2,
        graph_ms)
    # bytes: each packed byte read once, each coefficient written once;
    # operations: bh + bw float64 multiply-adds (2 each) per coefficient
    nbytes, ops = 8 * 1080 * 5760 + got.numel() * 4, 2 * (bh + bw) * got.numel()
    line = record(results, k2.name, k2, err, ms, w_ms, plain_ms, nbytes, ops,
                  lib_ms, FP64_OPS_PER_S)
    print(f"parity K2 {k2.name}: max |err| {err:.3e} <= 2.5e-4, bit-equal to "
          f"the general kernel at 1080p and at 1366x760 ({-(-pw // bw)} block "
          f"columns, strips of {128 // bw}; max |err| {rag_err:.3e}); "
          f"{ms:.4f} ms (general {gen_ms:.4f}, {gen_ms / ms:.1f}x; in turns "
          f"general, new, new, general: {', '.join(f'{x:.4f}' for x in turns)}"
          f"; through the wrappers {w_ms:.4f} / {gw_ms:.4f}) vs plain "
          f"{plain_ms:.4f} ms, one conv {lib_ms:.4f} ms ({lib_ms / ms:.2f}x the "
          f"kernel; in turns conv, new, new, conv: "
          f"{', '.join(f'{x:.4f}' for x in turns_c)}); {line}")

    # K1: 8 frames of 1088 / bh block rows -> 1080 display rows at the
    # decoder's gaze mix of steps 1 and 640, then identity rows, then a
    # ragged shape (block columns ending mid-strip); byte-equal to the
    # general kernel, within the display gate of the plain version; timed
    # in turns at the first
    nbx, worst, modes = 1920 // bw, 0.0, []
    for t, nby, cols, out_h in ((8, 1088 // bh, nbx, 1080),
                                (8, 1080 // 16 * 16 // bh, nbx, 1080 // 16 * 16),
                                (2, 768 // bh, 1376 // bw + 1 - 16 // bw, 766)):
        coeffs = (torch.randn((t, nby, cols, 3 * bh * bw), generator=g) * 90).to(dev)
        btypes = torch.randint(0, 3, (t, nby, cols), generator=g).to(dev)
        gazed = torch.zeros((t, nby, cols), dtype=torch.bool, device=dev)
        gazed[:, nby // 2 - 64 // bh:nby // 2 + 64 // bh,
              cols // 2 - 64 // bw:cols // 2 + 64 // bw] = True
        steps = quant.block_quant_steps(btypes, gazed, 1, 640)
        before = counts()
        out = dct.idct_display(coeffs, steps, out_h, 3, bh, bw)
        out_g = dct.idct_display(coeffs, steps, out_h, 3, bh, bw, general=True)
        if counts() != (before[0], before[1], before[2] + 1, before[3] + 1):
            fail(f"K1 at {tag} did not launch the templated and the general "
                 f"kernel once each")
        if not torch.equal(out, out_g):
            fail(f"K1 {k1.name} differs from the general kernel "
                 f"({nby * bh}->{out_h} rows, {cols} block columns)")
        diff = (out.to(torch.int16) - dct.idct_display_plain(
            coeffs, steps, out_h, 3, bh, bw).to(torch.int16)).abs()
        frac = (diff > 0).double().mean().item()
        tie_note = ""
        if shape in TIE_SHAPES:
            # 2x2 and 1x1 blocks put ~17% and a few % of the bytes on
            # exact halves of the float64 decode, which float32 summing
            # order rounds either way: the gate holds the first frame's
            # other bytes
            ties = display_ties.tie_mask(display_ties.exact_display(
                coeffs[:1], steps[:1], out_h, 3, bh, bw)).reshape(-1)
            frac = (diff[0].reshape(-1).cpu().numpy()[~ties] > 0).mean()
            tie_note = (f" off the exact ties of frame 0 ({ties.mean():.2%} "
                        f"of its bytes)")
        if diff.max().item() > 1 or not frac < 1e-3:
            fail(f"K1 {k1.name}: max diff {diff.max().item()}, {frac:.2e} of "
                 f"bytes differ{tie_note} ({nby * bh}->{out_h} rows)")
        worst = max(worst, float(diff.max().item()))
        modes.append(f"{nby * bh}->{out_h} rows x {cols} block columns "
                     f"(T={t}): max diff {diff.max().item()}, {frac:.2e} of "
                     f"bytes differ{tie_note}, byte-equal to the general "
                     f"kernel")
        if len(modes) == 1:
            timed_in = (coeffs, steps, out_h, out)
    coeffs, steps, out_h, out = timed_in
    gen1_ms, ms1, turns1 = in_turns(
        lambda: dct.idct_display(coeffs, steps, out_h, 3, bh, bw, general=True),
        lambda: dct.idct_display(coeffs, steps, out_h, 3, bh, bw), graph_ms)
    w1_ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, out_h, 3, bh, bw))
    gw1_ms = cuda_ms(lambda: dct.idct_display(coeffs, steps, out_h, 3, bh, bw,
                                              general=True))
    plain1_ms = cuda_ms(
        lambda: dct.idct_display_plain(coeffs, steps, out_h, 3, bh, bw), iters=5)
    # dequantize (3 per coefficient), IDCT (bh + bw multiply-adds per
    # coefficient), row lerp (3 per output byte)
    nbytes = coeffs.numel() * 4 + steps.numel() * 4 + out.numel()
    ops = 3 * coeffs.numel() + 2 * (bh + bw) * coeffs.numel() + 3 * out.numel()
    line = record(results, k1.name, k1, worst, ms1, w1_ms, plain1_ms, nbytes, ops)
    print(f"parity K1 {k1.name}: {'; '.join(modes)}; {ms1:.4f} ms (general "
          f"{gen1_ms:.4f}, {gen1_ms / ms1:.1f}x; in turns general, new, new, "
          f"general: {', '.join(f'{x:.4f}' for x in turns1)}; through the "
          f"wrappers {w1_ms:.4f} / {gw1_ms:.4f}) vs plain {plain1_ms:.4f} ms "
          f"(1088->1080 rows, T=8); {line}")


def shape_resize_parity(g, dev, results, shape):
    """Phase 3, K6 for ``shape`` = (rows, columns) transform blocks of 3
    channels on its templated kernel (1x1, 2x2, 4x4, 16x16, the six
    rectangles of sides 4, 8 and 16, the six with a side of 2 and the
    eight with a side of 1): the templated kernel against the general one
    (byte-equal) and the plain version (within the display gate; at a
    side of 1 or 2 within 1 and, on the first frame, at the gate off the
    bytes that are exact ties of the float64 decode,
    ``tools/display_ties.py``) at 1366x768, 1270x714 and 854x480, T = 8,
    at the decoder's gaze mix of steps 1 and 640, and on a ragged shape
    (1312 padded pixels: the block columns end mid-strip, the last strip
    without its halo; both axes resampled); the two timed in turns at
    1366x768 and 854x480, with each wrapper's time and the plain
    version's."""
    from svc_tpu_torch.ops import dct, quant
    from svc_tpu_torch.tools import display_ties

    bh, bw = shape
    k6 = dct.IDCT_RESIZE_SQ[shape]
    thin = bool({1, 2} & {bh, bw})

    def counts():
        return (k6.launches, dct.IDCT_RESIZE_GENERAL.launches,
                dct.IDCT_RESIZE.launches)

    worst, modes, timed_at = 0.0, [], {}
    for w, h, t in ((1366, 768, 8), (1270, 714, 8), (854, 480, 8),
                    (1300, 766, 2)):
        pw, ph = -(-w // 16) * 16, -(-h // 16) * 16
        nby, nbx = ph // bh, pw // bw
        coeffs = (torch.randn((t, nby, nbx, 3 * bh * bw), generator=g) * 90).to(dev)
        btypes = torch.randint(0, 3, (t, nby, nbx), generator=g).to(dev)
        gazed = torch.zeros((t, nby, nbx), dtype=torch.bool, device=dev)
        gazed[:, nby // 2 - 64 // bh:nby // 2 + 64 // bh,
              nbx // 2 - 64 // bw:nbx // 2 + 64 // bw] = True
        steps = quant.block_quant_steps(btypes, gazed, 1, 640)
        before = counts()
        got = dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw)
        got_g = dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw,
                                        general=True)
        if counts() != (before[0] + 1, before[1] + 1, before[2]):
            fail(f"K6 at {bh}x{bw} and {w}x{h} did not launch the templated "
                 f"and the general kernel once each")
        if not torch.equal(got, got_g):
            fail(f"K6 {k6.name} differs from the general kernel at {w}x{h}")
        ref = dct.idct_resize_display_plain(coeffs, steps, h, w, 3, bh, bw)
        diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        frac = (diff > 0).double().mean().item()
        gated, tie_note = frac, ""
        if thin:
            # a side of 1 or 2 puts display bytes on exact halves of the
            # float64 decode, which float32 summing order rounds either
            # way: the gate holds the first frame's other bytes
            ties = display_ties.tie_mask(display_ties.exact_display(
                coeffs[:1], steps[:1], h, 3, bh, bw, out_w=w)).reshape(-1)
            gated = (diff[0].reshape(-1).cpu().numpy()[~ties] > 0).mean()
            tie_note = (f", {gated:.2e} of frame 0's off its exact ties "
                        f"({ties.mean():.2%} of its bytes)")
        if diff.max().item() > 1 or not gated < 1e-3:
            fail(f"K6 {k6.name}: max diff {diff.max().item()}, {frac:.2e} of "
                 f"bytes differ at {w}x{h}{tie_note}")
        worst = max(worst, float(diff.max().item()))
        mode = (f"{pw}x{ph}->{w}x{h} (T={t}): byte-equal to the general "
                f"kernel, max diff {diff.max().item()}, {frac:.2e} of bytes "
                f"differ from plain{tie_note}")
        if (w, h) in ((1366, 768), (854, 480)):
            gen_ms, ms, turns = in_turns(
                lambda: dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw,
                                                general=True),
                lambda: dct.idct_resize_display(coeffs, steps, h, w, 3, bh, bw),
                graph_ms)
            w_ms = cuda_ms(lambda: dct.idct_resize_display(coeffs, steps, h, w,
                                                           3, bh, bw))
            gw_ms = cuda_ms(lambda: dct.idct_resize_display(
                coeffs, steps, h, w, 3, bh, bw, general=True))
            p_ms = cuda_ms(lambda: dct.idct_resize_display_plain(
                coeffs, steps, h, w, 3, bh, bw), iters=5)
            # dequantize (3 per coefficient), IDCT (bh + bw multiply-adds
            # per coefficient), two lerps (3 each) per output byte
            nbytes = coeffs.numel() * 4 + steps.numel() * 4 + got.numel()
            ops = (3 * coeffs.numel() + 2 * (bh + bw) * coeffs.numel()
                   + 6 * got.numel())
            timed_at[w, h] = (ms, w_ms, p_ms, nbytes, ops)
            mode += (f"; {ms:.4f} ms (general {gen_ms:.4f}, "
                     f"{gen_ms / ms:.1f}x; in turns general, new, new, "
                     f"general: {', '.join(f'{x:.4f}' for x in turns)}; "
                     f"through the wrappers {w_ms:.4f} / {gw_ms:.4f}) vs "
                     f"plain {p_ms:.4f} ms, bound "
                     f"{bound(nbytes, ops)[0]:.4f} ms "
                     f"({bound(nbytes, ops)[1]}; {ms / bound(nbytes, ops)[0]:.1f}x)")
        modes.append(mode)
    ms, w_ms, p_ms, nbytes, ops = timed_at[1366, 768]
    line = record(results, k6.name, k6, worst, ms, w_ms, p_ms, nbytes, ops)
    print(f"parity K6 {k6.name}: {'; '.join(modes)}; 1366x768 {line}")


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


def motion_instances(cfg):
    """The K9 and K3 instances the encoder's search launches at ``cfg``: the
    top level's ``candidate_sads<S, r>`` and each refinement level's
    ``refine_sads<B, r>`` (``<16x8, 1>`` where the blocks are not square),
    r the top radius."""
    from svc_tpu_torch.ops.motion import _instance

    factor = 1 << (cfg.pyr_lvl_count - 1)
    r = cfg.mv_search_range // factor
    bw, bh = cfg.mv_block_w, cfg.mv_block_h
    return (("candidate_sads" + _instance(bw // factor, bh // factor, r),)
            + tuple("refine_sads" + _instance(bw >> lvl, bh >> lvl, r)
                    for lvl in range(cfg.pyr_lvl_count - 2, -1, -1)))


def batch_ms_in_turns(encoders, packed, card: str, prefix: str = ""):
    """Phases 15 and 16: the device batch ms (graph replays) of each of
    ``encoders`` on the 9 packed 1080p frames ``packed``, in turns there
    and back."""
    order = list(encoders) + list(encoders)[::-1]
    batch_ms = {k: [] for k in encoders}
    for k in order:
        batch_ms[k].append(cuda_ms(lambda e=encoders[k]: e.encode_packed(packed, 0),
                                   iters=5, warmup=1))
    print(f"  device batch ms at 1080p, 8 frames, graph replays, in turns "
          f"{', '.join(map(str, order))} [{card}]: " + "; ".join(
              f"{prefix}{k} {np.mean(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
              for k, v in batch_ms.items()))


def motion_batch_ms(card: str):
    """``python3 chip_smoke.py --batch-ms``: phase 16's device batch ms
    alone (the default config and each of ``MOTION_CONFIGS``, 1080p, 8
    frames, graph replays, in turns), on the package beside this script;
    run in two checkouts, one call, it compares their encoders."""
    from svc_tpu_torch.config import EncoderConfig, VideoProperties
    from svc_tpu_torch.models.encoder import Encoder
    from svc_tpu_torch.tools.clips import make_clip

    props = VideoProperties(1920, 1080, 9)
    encoders = {label: Encoder(EncoderConfig(**kw), props, batch_size=8, device="cuda")
                for label, kw in {"default": {}, **MOTION_CONFIGS}.items()}
    packed = torch.as_tensor(make_clip(1920, 1080, 9)).reshape(9, 1080, 1920 * 3)
    batch_ms_in_turns(encoders, packed.to("cuda"), card)


def motion_config_runs(plan, default_enc, card: str):
    """Phase 16: each of ``plan`` = {label: (EncoderConfig, required,
    forbidden)} as a 9-frame 1080p clip through :func:`config_round_trip`
    (graph replays byte-equal to ``graph=False``, 3 frames against the CPU
    port, the launch lists), then the device batch ms of each encoder in
    turns with ``default_enc`` (the default config's)."""
    runs = {}
    for label, (cfg, required, forbidden) in plan.items():
        print(f"{label} (MV blocks {cfg.mv_block_w}x{cfg.mv_block_h}, "
              f"{cfg.pyr_lvl_count} levels, range {cfg.mv_search_range}: "
              f"{', '.join(motion_instances(cfg))}), 1080p, 9 frames, graph replays:")
        runs[label] = config_round_trip(cfg, f"phase 16: the {label} run", label, 1920,
                                        1080, required, forbidden)
    clip = next(iter(runs.values()))["clip"]
    packed = torch.as_tensor(clip[:9]).reshape(9, 1080, 1920 * 3).to("cuda")
    batch_ms_in_turns({"default": default_enc, **{k: r["enc"] for k, r in runs.items()}},
                      packed, card)
    return runs


def block_shape_round_trip(shape, w, h, required, forbidden):
    """Phase 7's runs at ``shape`` = (rows, columns) transform blocks: a
    9-frame ``w`` x ``h`` clip, the default config with those blocks,
    through :func:`config_round_trip` (at 2x2 and 1x1 blocks, where about
    a sixth and a few % of the display bytes are exact ties of the float64
    decode, the CPU decode is held within 1 and at the gate off the
    ties)."""
    from svc_tpu_torch.config import EncoderConfig

    bh, bw = shape
    cfg = EncoderConfig(transform_block_h=bh, transform_block_w=bw)
    return config_round_trip(cfg, f"phase 7: the {bh}x{bw} run at {w}x{h}",
                             f"{bh}x{bw}", w, h, required, forbidden,
                             ties_block=shape if shape in TIE_SHAPES else None)


def config_round_trip(cfg, tag, label, w, h, required, forbidden, ties_block=None):
    """A 9-frame ``w`` x ``h`` clip with ``cfg`` through :func:`round_trip`
    on graph replays (the encoder's and the decoder's default on
    ``cuda``); then the same clip and payloads with ``graph=False``, byte
    for byte; then the first 3 frames encoded on the CPU port (header and
    MV fields equal, coefficients within 2.5e-4, block types within
    ``BLOCK_TYPE_TOL``) and the first 2 payloads decoded there (the display
    gate; off the exact ties of ``ties_block`` = (rows, columns) where
    given)."""
    from svc_tpu_torch.config import DecoderConfig, VideoProperties
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder, stream_encode

    run = round_trip(cfg, w, h, 9, required, forbidden)
    clip, gaze, payloads = run["clip"], run["gaze"], run["payloads"]
    if not (run["enc"].graph and run["dec"].graph):
        fail(f"{tag} did not take graph replays")
    props = VideoProperties(w, h, len(clip))
    eager = Encoder(cfg, props, batch_size=8, device="cuda", graph=False)
    if b"".join(stream_encode(eager, iter(clip))) != run["stream"]:
        fail(f"{tag}: the stream differs between graph and graph=False")
    eager_dec = Decoder(DecoderConfig(), run["header"], batch_size=8,
                        device="cuda", graph=False)
    eager_frames = np.stack(list(eager_dec.decode_frames(
        iter(payloads), iter([gaze] * len(payloads)))))
    if not np.array_equal(eager_frames, run["frames"]):
        fail(f"{tag}: the decode differs between graph and graph=False")
    cpu_enc = Encoder(cfg, props, batch_size=2, device="cpu")
    gpu_enc = Encoder(cfg, props, batch_size=2, device="cuda")
    if cpu_enc.header().pack() != run["header"].pack():
        fail(f"{tag}: the header differs between cuda and cpu")
    o_gpu, o_cpu = gpu_enc.encode_batch(clip[:3], 0), cpu_enc.encode_batch(clip[:3], 0)
    if not torch.equal(o_gpu["mv_field"].cpu(), o_cpu["mv_field"]):
        fail(f"{tag}: MV fields differ between cuda and cpu")
    cerr = (o_gpu["coeffs"].cpu() - o_cpu["coeffs"]).abs().max().item()
    if not cerr <= 2.5e-4:
        fail(f"{tag}: coefficients differ by {cerr} > 2.5e-4 between cuda "
             f"and cpu")
    share = (o_gpu["block_types"].cpu() != o_cpu["block_types"]).double().mean().item()
    if share > BLOCK_TYPE_TOL:
        fail(f"{tag}: block types differ on {share:.3%} of blocks")
    cpu_dec = Decoder(DecoderConfig(), run["header"], batch_size=2, device="cpu")
    ref = np.stack(list(cpu_dec.decode_frames(iter(payloads[:2]), iter([gaze] * 2))))
    ties = None
    if ties_block is not None:
        from svc_tpu_torch.tools import display_ties

        bh, bw = ties_block
        coeffs, steps = display_ties.decode_inputs(run["header"], payloads[:2],
                                                   [gaze] * 2)
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, h, 3, bh, bw)).reshape(ref.shape)
    dgate = display_gate(run["frames"][:2], ref, f"{label} decode", ties)
    moved = int((o_gpu["mv_field"] != 0).any(dim=-1).sum().item())
    print(f"  {label}: graph replays byte-equal to graph=False (stream and "
          f"frames); card vs cpu (3 frames): header and MV fields equal "
          f"({moved} MV blocks moved), coefficients max |err| {cerr:.3e}, block "
          f"types differ on {share:.4%}; decoded bytes {dgate}")
    return run


def wide_shape_round_trip(shape, w, h, required, forbidden):
    """Phase 5's runs at ``shape`` = (rows, columns) transform blocks: a
    9-frame ``w`` x ``h`` clip (a width excess), the default config with
    those blocks, through :func:`round_trip` on graph replays (the
    templated K6 of its shape decodes it, no other K6); then its payloads
    decoded with ``graph=False``, byte for byte, and the first 2 decoded on
    the CPU port (the display gate; at a side of 1 or 2, where bytes sit
    on exact halves of the float64 decode, within 1 and at the gate off
    those ties)."""
    from svc_tpu_torch.config import DecoderConfig, EncoderConfig
    from svc_tpu_torch.models.decoder import Decoder

    bh, bw = shape
    cfg = EncoderConfig(transform_block_h=bh, transform_block_w=bw)
    run = round_trip(cfg, w, h, 9, required, forbidden)
    gaze, payloads = run["gaze"], run["payloads"]
    if not (run["enc"].graph and run["dec"].graph):
        fail(f"phase 5: the {bh}x{bw} run did not take graph replays")
    eager = Decoder(DecoderConfig(), run["header"], batch_size=8,
                    device="cuda", graph=False)
    eager_frames = np.stack(list(eager.decode_frames(
        iter(payloads), iter([gaze] * len(payloads)))))
    if not np.array_equal(eager_frames, run["frames"]):
        fail(f"phase 5: the {bh}x{bw} decode differs between graph and "
             f"graph=False")
    cpu_dec = Decoder(DecoderConfig(), run["header"], batch_size=2, device="cpu")
    ref = np.stack(list(cpu_dec.decode_frames(iter(payloads[:2]), iter([gaze] * 2))))
    ties = None
    if {1, 2} & {bh, bw}:
        from svc_tpu_torch.tools import display_ties

        coeffs, steps = display_ties.decode_inputs(run["header"], payloads[:2],
                                                   [gaze] * 2)
        ties = display_ties.tie_mask(display_ties.exact_display(
            coeffs, steps, h, 3, bh, bw, out_w=w)).reshape(ref.shape)
    dgate = display_gate(run["frames"][:2], ref,
                         f"{bh}x{bw} width-excess decode at {w}x{h}", ties)
    print(f"  {bh}x{bw}: graph replays byte-equal to graph=False "
          f"(frames); cuda decode vs cpu decode of 2 payloads: {dgate}")
    return run


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


def display_gate(a: np.ndarray, b: np.ndarray, what: str, ties=None) -> str:
    """Max |diff| <= 1 on under 1e-3 of the bytes, or fail; with ``ties``
    (a mask of the bytes that are exact ties of the float64 decode, which
    either rounding matches), under 1e-3 of the other bytes."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    frac = float((diff > 0).mean())
    off = frac if ties is None else float((diff[~ties] > 0).mean())
    if a.shape != b.shape or diff.max() > 1 or not off < 1e-3:
        fail(f"{what}: max diff {diff.max()}, {frac:.2e} of bytes differ, "
             f"{off:.2e} off the ties")
    if ties is None:
        return f"max diff {diff.max()}, {frac:.2e} of bytes differ"
    return (f"max diff {diff.max()}, {frac:.2e} of bytes differ, {off:.2e} "
            f"off the exact ties ({ties.mean():.2%} of the bytes)")


def padded_luma(clip: np.ndarray, dev, block_w: int = 16, block_h: int = 16,
                levels: int = 4) -> torch.Tensor:
    """``(n, ph, pw)`` uint8 luma of BGR frames, padded as the encoder pads
    them at ``block_w`` x ``block_h`` MV blocks and ``levels`` levels (the
    default config's 1080p: 1088 rows; at 16x8 MV blocks 1080)."""
    from svc_tpu_torch.ops.color import bgr_planes_to_y
    from svc_tpu_torch.ops.pad import pad_frame, padded_dims

    px = torch.as_tensor(clip).to(dev)
    y = bgr_planes_to_y(px[..., 0], px[..., 1], px[..., 2])
    pw, ph = padded_dims(clip.shape[2], clip.shape[1], block_w, block_h, levels)
    return pad_frame(y, pw, ph)


def per_frame_motion(clip: np.ndarray, dev):
    """Phase 9: ``build_pyramid`` -> ``hbma`` -> the three global-motion
    estimators on one 1080p frame pair, on ``cuda``."""
    from svc_tpu_torch.config import EncoderConfig
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
    # --mv-search-range 16, 24 and 32: K9's and K7's instances at r = 2-4
    wide = {rng: motion.hbma(tracked, anchor, rng, 16, 16) for rng in WIDE_RANGES}
    # phase 16's 8x8 MV blocks, 3 levels and 16x8, 32x32, 32x16, 32x8 and
    # 8x32 MV blocks: K9's 1x1, 4x4, 2x1, 4x2, 4x1 and 1x4 instances, K7's
    # 2x2 ones, its 4x2, 8x4 and 16x8 (on the 1080 rows 16x8 MV blocks pad
    # to), 32x32, 32x16, 8x2, 16x4, 32x8 (1080 rows) and 2x8, 4x16, 8x32
    # and G17's 16x16 at r = 8 (K9's 8x8 and K7's 16x16 past r = 4), G19's
    # 4x4, 8x8 and 16x16 at r = 8 (K9's 2x2), G20's 2x2 (K9's 1x1) and
    # G22's 32x32 at r = 8
    settings = {label: EncoderConfig(**MOTION_CONFIGS[label])
                for label in ("G1 8x8 MV blocks", "G2 3 levels", "G5 16x8 MV blocks",
                              "G8 32x32 MV blocks", "G10 32x16 MV blocks",
                              "G12 32x8 MV blocks", "G13 8x32 MV blocks",
                              "G17 2 levels, range 16", "G19 4 levels, range 64",
                              "G20 8x8, range 64", "G22 32x32, range 64")}
    pyrs = {label: build_pyramid(padded_luma(clip[:2], dev, cfg.mv_block_w, cfg.mv_block_h,
                                             cfg.pyr_lvl_count), cfg.pyr_lvl_count)
            for label, cfg in settings.items()}
    blocks = {label: motion.hbma([p[0] for p in pyrs[label]], [p[1] for p in pyrs[label]],
                                 cfg.mv_search_range, cfg.mv_block_w, cfg.mv_block_h)
              for label, cfg in settings.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = build.launch_counts()
    radius_instances = [f"refine_mads<{b}, {rng // 8}>" for rng in (8,) + WIDE_RANGES
                        for b in (4, 8, 16)]
    radius_instances += [f"candidate_sads<2, {rng // 8}>" for rng in (8,) + WIDE_RANGES]
    radius_instances += [n.replace("refine_sads", "refine_mads") for cfg in settings.values()
                         for n in motion_instances(cfg)]
    missing = [k for k in ("pyr_down_levels", "candidate_sads", "refine_mads",
                           *radius_instances)
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
    wide_moved = []
    for rng, (mv_w, mm_w) in wide.items():
        mv_ws, mm_ws = motion.hbma_stack(pyr, rng, 16, 16)
        if not (torch.equal(mv_w, mv_ws[0]) and torch.equal(mm_w, mm_ws[0])):
            fail(f"per-frame motion: hbma at range {rng} differs from hbma_stack")
        mv_wc, mm_wc = motion.hbma(ct, ca, rng, 16, 16)
        if not (torch.equal(mv_w.cpu(), mv_wc) and torch.equal(mm_w.cpu(), mm_wc)):
            fail(f"per-frame motion: hbma at range {rng} on cuda differs from the "
                 f"CPU port")
        wide_moved.append(f"range {rng}: {int((mv_w != 0).any(dim=-1).sum().item())} "
                          f"blocks moved")
    for label, (mv_b, mm_b) in blocks.items():
        cfg = settings[label]
        bw, bh = cfg.mv_block_w, cfg.mv_block_h
        mv_bs, mm_bs = motion.hbma_stack(pyrs[label], cfg.mv_search_range, bw, bh)
        if not (torch.equal(mv_b, mv_bs[0]) and torch.equal(mm_b, mm_bs[0])):
            fail(f"per-frame motion: hbma at {label} differs from hbma_stack")
        cpu_b = [p.cpu() for p in pyrs[label]]
        mv_bc, mm_bc = motion.hbma([p[0] for p in cpu_b], [p[1] for p in cpu_b],
                                   cfg.mv_search_range, bw, bh)
        if not (torch.equal(mv_b.cpu(), mv_bc) and torch.equal(mm_b.cpu(), mm_bc)):
            fail(f"per-frame motion: hbma at {label} on cuda differs from the CPU port")
        wide_moved.append(f"{label}: {tuple(mv_b.shape[:2])} field, "
                          f"{int((mv_b != 0).any(dim=-1).sum().item())} blocks moved")
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
          f"to the CPU port; at ranges {', '.join(map(str, WIDE_RANGES))} "
          f"(K7's and K9's r = 2-4 instances), at 8x8 MV blocks, at 3 levels and "
          f"at 16x8, 32x32, 32x16, 32x8 and 8x32 MV blocks (K9's 1x1, 4x4, 2x1, "
          f"4x2, 4x1 and 1x4, K7's 2x2, 4x2, 8x4, 16x8, 32x32, 32x16, 8x2, 16x4, "
          f"32x8, 2x8, 4x16, 8x32), at 2 levels, range 16 (K9's 8x8 and K7's "
          f"16x16 at r = 8), at 4 levels, range 64 (K9's 2x2, K7's 4x4, 8x8 "
          f"and 16x16 at r = 8), at 8x8 MV blocks, range 64 (K9's 1x1, K7's 2x2, "
          f"4x4, 8x8 at r = 8) and at 32x32, range 64 (K7's 8x8, 16x16, 32x32 at "
          f"r = 8) "
          f"equal to hbma_stack and to the CPU "
          f"port ({'; '.join(wide_moved)}); {seconds:.2f} s incl. first calls; "
          f"launches {counts}")
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


def compiled_decode(main_run, card: str, dev):
    """Phase 14, the decode: each batch a CUDA graph replay against the
    eager path (``graph=False``). Phase 4's payloads through
    ``decode_frames`` both ways, staged and direct, byte-equal to the main
    run's frames (phase 4 decoded them on graphs); then 32 payloads (the
    16 forth and back) in turns (eager, graph, graph, eager), each run with
    its fps and Tracer split per batch; per mode the device batch time, its
    dispatch and ``tools/profile_slice.py``'s launches per batch; one
    staged replay under ``torch.profiler``, in a process of its own: its
    coefficients cross in one H2D copy and no device-to-device copy of
    their size runs."""
    from svc_tpu_torch.config import DecoderConfig
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.runtime.tracing import Tracer
    from svc_tpu_torch.tools.profile_slice import batch_launches

    payloads, header = main_run["payloads"], main_run["header"]
    graph = main_run["dec"]
    eager = Decoder(DecoderConfig(), header, batch_size=8, device=dev, graph=False)
    if not graph.graph or eager.graph:
        fail("phase 14: the default decoder does not run as a graph")
    modes = {"eager": eager, "graph": graph}
    gazes = [main_run["gaze"]] * len(payloads)
    for kind, d in modes.items():
        for stage_h2d in (True, False):
            got = np.stack(list(d.decode_frames(iter(payloads), iter(gazes),
                                                stage_h2d=stage_h2d)))
            if not np.array_equal(got, main_run["frames"]):
                fail(f"phase 14: the {kind} decode (stage_h2d={stage_h2d}) "
                     f"differs from the main run's frames")
    stream = payloads + payloads[::-1]
    gazes = [main_run["gaze"]] * len(stream)
    batches = -(-len(stream) // graph.batch_size)
    fps = {"eager": [], "graph": []}
    for kind in ("eager", "graph", "graph", "eager"):
        tr = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in modes[kind].decode_frames(iter(stream), iter(gazes),
                                                     tracer=tr))
        wall = time.perf_counter() - t0
        if n != len(stream):
            fail(f"phase 14: the {kind} decode gave {n} frames of {len(stream)}")
        split = {k: v["total_s"] * 1e3 / batches for k, v in tr.stats().items()}
        split["other"] = wall * 1e3 / batches - sum(split.values())
        fps[kind].append(n / wall)
        parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        print(f"  decode {kind}: {n / wall:.2f} fps; per batch of 8 (ms): {parts}")

    parsed = [bitstream.deserialize_frame_blocks(p, header) for p in payloads[:8]]
    host = np.stack([c.reshape(c.shape[0], c.shape[1], -1) for _, c in parsed])
    types = np.stack([t for t, _ in parsed])
    rects = [graph.padded_gaze_rect(main_run["gaze"])] * 8
    coeffs = torch.from_numpy(host).to(dev)
    coeff_bytes = host.nbytes
    lines = []
    for kind, d in modes.items():
        ms = cuda_ms(lambda: d.decode_batch(coeffs, types, rects), iters=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.decode_batch(coeffs, types, rects)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        n = batch_launches(lambda: d.decode_batch(coeffs, types, rects))
        lines.append(f"{kind} direct {ms:.3f} ms a batch (its dispatch "
                     f"{dispatch_ms:.3f} ms of host time), "
                     f"{n['host_launch_calls']} host launch calls, "
                     f"{n['device_ops']} device operations")
    # the staged path, as decode_frames' stager stages a batch: the
    # coefficients into the next replay's static input, the block types
    # and rects beside them
    pair = graph._graphs[(0, 8)]
    claimed = pair._slots[pair._calls % 2].inputs[0]
    staged = graph._stage_batch((host, types, rects))
    if staged[0].tensor is not claimed:
        fail("phase 14: stage_coeffs did not write the next replay's static input")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.decode_batch(*staged)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # one staged replay's profile, in a process of its own: this one's
    # profiler has traced the phases before and has been seen to drop the
    # copy streams' activity from later traces
    code = ("import json; from svc_tpu_torch.tools.profile_slice import "
            "staged_decode_profile; print(json.dumps(staged_decode_profile()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"phase 14: the staged replay's profile failed: {proc.stderr[-2000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    size = prof["coeff_bytes"]
    copies = prof["copies"]
    h2d = [c for c in copies if "HtoD" in c["name"] and c["bytes"] == size]
    d2d = [c for c in copies if "DtoD" in c["name"]
           and (c["bytes"] is None or c["bytes"] >= size)]
    if len(h2d) != 1 or d2d:
        fail(f"phase 14: a staged replay's coefficients do not cross in one "
             f"{size} B H2D copy with no device-to-device copy of their size: "
             f"{copies}")
    lines.append(
        f"graph staged: dispatch {dispatch_ms:.3f} ms of host time; its "
        f"profile (tools/profile_slice.py staged_decode_profile): kernels busy "
        f"{prof['kernels_busy_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} "
        f"ms with its copies, wall {prof['wall_ms']:.3f} ms incl. the host "
        f"staging, {prof['host_launch_calls']} host launch calls, "
        f"{prof['device_ops']} device operations; copies: "
        + "; ".join(f"{c['name']} {c['bytes']} B {c['us']:.1f} us" for c in copies))
    replay = graph._graphs[(0, 8)].launches_per_replay()
    if replay != {"idct_display": 1}:
        fail(f"phase 14: a decode replay does not launch K1 once and nothing "
             f"else: {replay}")
    print(f"  decode byte-equal: phase 4's payloads eager and graph, staged "
          f"and direct; fps medians eager {np.median(fps['eager']):.2f}, graph "
          f"{np.median(fps['graph']):.2f} [{card}]")
    print(f"  per 1080p decode batch of 8 [{card}]: {'; '.join(lines)}; the "
          f"port's kernels in one replay {replay}")


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
    if sys.argv[1:] == ["--batch-ms"]:
        motion_batch_ms(card)
        return 0

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

    # the specialised display kernels', the templated K2 and K1 kernels'
    # and the templated K6 kernels' dynamic shared memory and threads
    display = {"idct8x8_display_kernel": (dct._K1_SMEM_BYTES, 192),
               "idct8x8_resize_kernel": (dct._K6_SMEM_BYTES, 224)}
    for bh, bw in dct.DCT_WIRE_SQ:
        display[f"dct_sq_wire_kernel<{bh}, {bw}>"] = (
            dct._k2_sq_smem_bytes(bh, bw), 384)
        display[f"idct_sq_display_kernel<{bh}, {bw}>"] = (
            dct._k1_sq_smem_bytes(bh, bw), 192)
    for bh, bw in dct.IDCT_RESIZE_SQ:
        display[f"idct_sq_resize_kernel<{bh}, {bw}>"] = (
            dct._k6_sq_smem_bytes(bh, bw), dct._K6_SQ_GEOM[bh, bw][4])
    spills = ptxas_spills(res.log)
    display_line = "; ".join(
        f"{kern} {regs} regs, {spills[kern]} B spill stores, {smem} B dynamic "
        f"smem, {ctas_per_sm(regs, smem, threads)} CTAs of {threads} per SM"
        for _, kern, regs, _ in report if kern in display
        for smem, threads in [display[kern]])
    # the refine, candidate-SAD and fused pyramid kernels (K3 / K7, K4, K8,
    # K9), static shared memory only, at their threads a CTA
    static_threads = {"refine_sads_kernel": 256, "refine_sads_split_kernel": 256,
                      "refine_sads_split_rows_kernel": 256,
                      "refine_sads_pitched_kernel": 256, "pyr_down_levels_kernel": 256,
                      "candidate_sads_kernel": 128, "candidate_sads_1x1_kernel": 128}
    # the SAD instances keep their sums and window rows in registers: none
    # may spill
    spilled = [f"{kern} ({spills[kern]} B)" for _, kern, _, _ in report
               if kern.startswith(("refine_sads", "candidate_sads")) and spills[kern]]
    if spilled:
        fail(f"ptxas: spill stores in {', '.join(spilled)}")
    static_line = "; ".join(
        f"{src} {kern} {ctas_per_sm(regs, smem, n)} CTAs of {n} per SM"
        for src, kern, regs, smem in report
        for n in [static_threads.get(kern.split("<")[0])] if n)
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
    # the other blocks of 3 channels with both sides in {4, 8, 16}, or a
    # side of 2 or 1 and the other in {1, 2, 4, 8, 16}, take their
    # templated K2 / K1 (4x4, 16x16, the six rectangles; 2x2 and six
    # more; 1x1 and eight more)
    square_dct = {shape: (dct.DCT_WIRE_SQ[shape].name,
                          dct.IDCT_DISPLAY_SQ[shape].name)
                  for shape in dct.DCT_WIRE_SQ}
    any_square = tuple(n for names in square_dct.values() for n in names)

    def other_dct(shape):
        """The templated K2 and K1 of every block shape but ``shape``."""
        return tuple(n for other, names in square_dct.items()
                     if other != shape for n in names)

    # the same blocks on the width-excess route take their templated K6
    square_k6 = {shape: (k.name,) for shape, k in dct.IDCT_RESIZE_SQ.items()}
    any_square_k6 = tuple(n for names in square_k6.values() for n in names)
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
                          general_dct + general_k3_k5 + general_k6 + any_square
                          + any_square_k6)
    staged_against_direct(main_run, dev)
    with tempfile.TemporaryDirectory(prefix="svc_smoke_") as tmp:
        print(f"  CLIs on cuda: {cli_checks(main_run, tmp)}")

    # 5. width excess: the general decode route, K6; K2 on packed rows of
    # 4098 bytes (row starts only 2-byte aligned); then 4x4, 16x16, 8x16
    # and 2x2 transform blocks there and the other twenty templated shapes
    # at 854x480, each on its templated K2 and K6 (1x1 blocks at 1366x768
    # decode to 4.93 dB of this clip, under round_trip's 5 dB floor: its
    # background blocks' one coefficient at step 640 is 0)
    print("width excess 1366x768 (padded 1376x768), 9 frames, default config:")
    wide = round_trip(EncoderConfig(), 1366, 768, 9,
                      encode_kernels + ("lloyd", "idct_resize_display"),
                      general_dct + general_k3_k5 + general_k6
                      + ("idct_display",) + any_square + any_square_k6)
    cpu_dec = Decoder(DecoderConfig(), wide["header"], batch_size=8, device="cpu")
    cpu_frames = np.stack(list(cpu_dec.decode_frames(
        iter(wide["payloads"]), iter([wide["gaze"]] * len(wide["payloads"])))))
    print(f"  cuda decode vs cpu decode of the same payloads: "
          f"{display_gate(wide['frames'], cpu_frames, 'width-excess decode')}")
    wide_sq = {}
    for shape, (w, h) in (((4, 4), (1366, 768)), ((16, 16), (1366, 768)),
                          ((8, 16), (1366, 768)), ((4, 8), (854, 480)),
                          ((8, 4), (854, 480)), ((4, 16), (854, 480)),
                          ((16, 4), (854, 480)), ((16, 8), (854, 480)),
                          ((2, 2), (1366, 768)),
                          *((shape, (854, 480)) for shape in (
                              (2, 4), (4, 2), (2, 8), (8, 2), (2, 16), (16, 2),
                              (1, 1), (1, 2), (2, 1), (1, 4), (4, 1), (1, 8),
                              (8, 1), (1, 16), (16, 1)))):
        print(f"width excess {w}x{h}, {shape[0]}x{shape[1]} transform blocks "
              f"(rows x columns), 9 frames, default config, graph replays:")
        wide_sq[shape] = wide_shape_round_trip(
            shape, w, h,
            tuple(k for k in encode_kernels if k != "dct8x8_to_wire")
            + ("lloyd", square_dct[shape][0]) + square_k6[shape],
            ("dct8x8_to_wire", "idct_display", "idct_resize_display")
            + general_dct + general_k3_k5 + general_k6 + other_dct(shape)
            + (square_dct[shape][1],)
            + tuple(n for other, names in square_k6.items() if other != shape
                    for n in names))

    # 6. reference-compat at 1080p: K1-K4, K9
    print("reference-compat 1080p, 9 frames:")
    round_trip(EncoderConfig(reference_compat=True), 1920, 1080, 9,
               encode_kernels + ("idct_display",),
               general_dct + general_k3_k5 + general_k6 + any_square
               + any_square_k6)

    # 7. transform blocks other than 8x8 (the config allows any block
    # whose sides divide the MV block's): 4x4 at CIF, then 16x16 and 8x16
    # (8 rows, 16 columns) at 1080p, then the other five rectangles at CIF,
    # then 2x2 at 1080p and the six rectangles with a side of 2 at CIF,
    # then 1x1 at 1080p and the eight rectangles with a side of 1 at CIF,
    # each on its templated K2 and K1 and on no other K1 or K2
    print("4x4 transform blocks, CIF 352x288, 9 frames, default config:")
    tb4 = round_trip(EncoderConfig(transform_block_w=4, transform_block_h=4),
                     352, 288, 9, square_dct[4, 4] + ("refine_sads", "lloyd"),
                     ("dct8x8_to_wire", "idct_display") + general_dct
                     + other_dct((4, 4)) + general_k3_k5 + general_k6
                     + any_square_k6)
    shape_runs = {}
    for shape, (w, h) in (((16, 16), (1920, 1080)), ((8, 16), (1920, 1080)),
                          ((4, 8), (352, 288)), ((8, 4), (352, 288)),
                          ((4, 16), (352, 288)), ((16, 4), (352, 288)),
                          ((16, 8), (352, 288)), ((2, 2), (1920, 1080)),
                          ((2, 4), (352, 288)), ((4, 2), (352, 288)),
                          ((2, 8), (352, 288)), ((8, 2), (352, 288)),
                          ((2, 16), (352, 288)), ((16, 2), (352, 288)),
                          ((1, 1), (1920, 1080)), ((1, 2), (352, 288)),
                          ((2, 1), (352, 288)), ((1, 4), (352, 288)),
                          ((4, 1), (352, 288)), ((1, 8), (352, 288)),
                          ((8, 1), (352, 288)), ((1, 16), (352, 288)),
                          ((16, 1), (352, 288))):
        print(f"{shape[0]}x{shape[1]} transform blocks (rows x columns), "
              f"{w}x{h}, 9 frames, default config:")
        # the 1080p runs take every encode kernel; CIF at least K3 and K5
        encode = (tuple(k for k in encode_kernels if k != "dct8x8_to_wire")
                  if w == 1920 else ("refine_sads",))
        shape_runs[shape] = block_shape_round_trip(
            shape, w, h, encode + ("lloyd",) + square_dct[shape],
            ("dct8x8_to_wire", "idct_display") + general_dct + other_dct(shape)
            + general_k3_k5 + general_k6 + any_square_k6)

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
                   general_dct + general_k3_k5 + general_k6 + any_square
                   + any_square_k6)

    # 13. the frame-parallel split on the card
    print("frame-parallel split 1080p, 17 frames, default config:")
    split_stream = sharded_run(main_run, card, encode_kernels + ("lloyd", "idct_display"),
                               general_dct + general_k3_k5 + general_k6 + any_square
                               + any_square_k6)

    # 14. the compiled batch: graph replay against the eager path
    print("compiled batch 1080p, default config, eager (graph=False) against "
          "graph, in turns (encode, then decode):")
    compiled_batch(main_run, split_stream, card, dev)
    compiled_decode(main_run, card, dev)

    # 15. search ranges past the default: K9's and K3's r = 2-4 instances
    # (the encoder's search at 16x16 MV blocks and 4 levels), each run on
    # its own radius's instances and on no general K3 or K9
    # every K9 and K3 instance: a config's run takes its own and no other
    all_instances = tuple(
        name + motion._instance(bw, bh, q)
        for name, blocks, radii in (
            ("candidate_sads", motion._K9_BLOCKS, motion._SAD_RADII),
            ("refine_sads", motion._K3_BLOCKS, motion._SAD_RADII),
            ("candidate_sads", motion._K9_FAR_BLOCKS, motion._FAR_RADII),
            ("refine_sads", motion._K3_FAR_BLOCKS, motion._FAR_RADII))
        for bw, bh in sorted(blocks) for q in radii)

    def motion_plan(cfg):
        """``(cfg, required, forbidden)``: the encode kernels and the
        instances of ``cfg``'s search; no general kernel, no other
        instance. One level builds no pyramid and refines nothing: K4 and
        K3 must not run."""
        own = motion_instances(cfg)
        flat = ("pyr_down_levels", "refine_sads") if cfg.pyr_lvl_count == 1 else ()
        return (cfg, tuple(k for k in encode_kernels if k not in flat)
                + ("lloyd", "idct_display") + own,
                general_dct + general_k3_k5 + general_k6 + any_square + any_square_k6
                + flat + tuple(n for n in all_instances if n not in own))

    search_runs = {}
    for rng in WIDE_RANGES:
        print(f"--mv-search-range {rng} (top radius {rng // 8}), 1080p, 9 frames, "
              f"default config otherwise, graph replays:")
        cfg, required, forbidden = motion_plan(EncoderConfig(mv_search_range=rng))
        search_runs[rng] = config_round_trip(cfg, f"phase 15: the range-{rng} run",
                                             f"range {rng}", 1920, 1080, required,
                                             forbidden)
    # the device batch time (graph replays, 8 frames of phase 4's clip) at
    # each range, in turns with the default range 8
    packed = torch.as_tensor(main_run["clip"][:9]).reshape(9, 1080, 1920 * 3).to(dev)
    batch_ms_in_turns({8: main_run["enc"], **{rng: run["enc"] for rng, run in
                                              search_runs.items()}}, packed, card, "range ")

    # 16. MV blocks and pyramid levels: 8x8 MV blocks, 3, 2 and 5 levels,
    # 16x8 and 8x16 MV blocks, each run on its own K9 and K3 instances and
    # on no general K3 or K9
    config_runs = motion_config_runs(
        {label: motion_plan(EncoderConfig(**kw)) for label, kw in MOTION_CONFIGS.items()},
        main_run["enc"], card)

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
               "dct_to_wire_general": tb4, "idct_display_general": tb4,
               **{name: tb4 for name in square_dct[4, 4]},
               **{name: run for shape, run in shape_runs.items()
                  for name in square_dct[shape]},
               **{square_k6[shape][0]: wide_sq[shape] for shape in square_k6},
               # the K3 and K9 instances the default search does not run:
               # where phase 15 or 16 ran them
               **{name: run for run in (*config_runs.values(), *search_runs.values())
                  for name in motion_instances(run["enc"].cfg)
                  if name not in motion_instances(EncoderConfig())},
               **{name: frame_run for name in results if name.startswith("refine_mads<")}}
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
