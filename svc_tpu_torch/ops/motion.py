"""Block-matching motion estimation (``svc_tpu/ops/motion.py``).

* :func:`ebma` — exhaustive block matching with the reference's ``<=``
  (last-wins) tie-break and the flat-region zero-MV reset (quirks Q6/Q8,
  libs/motion.cpp:268-340); its SADs come from :func:`candidate_sads`
  around zero MVs;
* :func:`refine` — one refinement pass around propagated MVs, strict ``<``
  (first-wins) updates with ``min_mad`` carried in (libs/motion.cpp:342-410);
* :func:`hbma` — the per-frame pyramid search (libs/motion.cpp:412-465);
* :func:`hbma_stack` — the same search over a ``(T+1, h, w)`` stack, frame
  ``t`` tracked against anchor ``t+1`` (the encoder's path);
* the global-motion estimators (:func:`estimate_global_motion_avg`,
  ``_exhaustive``, ``_hierarchical``; libs/motion.cpp:45-142), plain torch.

Kernels, each with its plain PyTorch version beside it (CPU tensors take
the plain version; a CUDA tensor launches the kernel or raises):

* K3 :func:`refine_sads` — candidate SADs of one refinement level for a
  frame stack (``hbma_stack``): ``csrc/refine_sads.cu`` for square
  4/8/16/32 blocks and the rectangles 8x4, 4x8, 16x8, 8x16, 32x16, 16x32,
  32x8, 16x4, 8x32, 4x16 (width x height), K9's thread-a-block kernel
  (``csrc/candidate_sads.cu``) for 2x2, 4x2, 2x4, 8x2 and 2x8, at ``1 <= r
  <= 4`` (the encoder's levels at 16x16 MV blocks, 4 levels and search
  ranges 8 to 39, ``r = 1`` the default; at 8x8 MV blocks or 2, 3 or 5
  levels; at 16x8 or 8x16 MV blocks and 2, 3 or 4 levels; at 32x32, 32x16
  or 16x32 MV blocks and 2 to 5 levels; at 32x8 or 8x32 MV blocks and 2, 3
  or 4 levels), and 32x32, 16x16, 8x8, 4x4 and 2x2 at ``5 <= r <= 8``
  (the levels under the top of square MV blocks past top radius 4: 16x16
  MV blocks at 2 to 5 levels, ranges 10 to 143, 8x8 at 4 levels, ranges
  40 to 71, 32x32 at 2 to 5 levels, ranges 10 to 143), the general kernel
  ``csrc/refine_sads_general.cu`` otherwise;
* K7 :func:`refine_mads` — the same for one frame pair (``refine``,
  ``hbma``): K3's specialised kernels with the tracked and anchor planes as
  two bases (``csrc/refine_mads.cu``) for K3's shapes at ``1 <= r <= 4``
  and 32x32, 16x16, 8x8, 4x4, 2x2 at ``5 <= r <= 8`` (the per-frame
  search's levels), the
  general kernel ``csrc/refine_mads_general.cu`` otherwise;
* K8 :func:`refine_sads_pitched` — K3 over column-pitched luma subplanes
  (``hbma_stack(..., base_pitched=...)``): ``csrc/refine_sads_pitched.cu``
  for 8 subplanes, square 16x16 blocks at ``r = 1`` (the pitched
  frontend's level 0), the general kernel
  ``csrc/refine_sads_pitched_general.cu`` otherwise;
* K9 :func:`candidate_sads` / :func:`refine_sads_static` — float32 SADs of
  ``T`` separate plane pairs (``ebma``): ``csrc/candidate_sads.cu`` for
  square 1x1, 2x2, 4x4, 8x8 and 16x16 blocks and the rectangles 2x1, 1x2,
  4x2, 2x4, 8x4, 4x8, 16x8, 8x16, 4x1, 1x4, 8x2, 2x8, 16x4, 4x16 at ``1 <=
  r <= 4`` (the encoder's top level: 2x2 at 16x16 MV blocks, 4 levels and
  ranges 8 to 39; 1x1 at 8x8 MV blocks or 5 levels, 4x4 at 3 levels, 8x8
  at 2; 2x1, 4x2, 8x4 at 16x8 MV blocks and 4, 3, 2 levels, 1x2, 2x4, 4x8
  at 8x16; 16x16, 16x8, 8x16 at 32x32, 32x16, 16x32 MV blocks and 2
  levels; 4x1, 8x2, 16x4 at 32x8 MV blocks and 4, 3, 2 levels, 1x4, 2x8,
  4x16 at 8x32), and 16x16, 8x8, 4x4, 2x2 and 1x1 at ``5 <= r <= 8``
  (16x16 MV blocks at one level, ranges 5 to 8, and at 2 to 5 levels,
  ranges 10 to 143; 1x1 also 8x8 MV blocks at 4 levels, ranges 40 to 71),
  the general kernel ``csrc/candidate_sads_general.cu`` otherwise.

The specialised K3, K7 and K9 kernels are templates over the block and
the radius, an instance for each (past ``r = 4`` the lane-per-anchor-row
kernels work one candidate row at a time and the thread-a-block kernel
streams its window rows: ``_FAR_RADII``); their launch
counts are kept per instance too (``refine_sads<16, 2>``, ``refine_mads<8, 3>``,
``candidate_sads<2, 4>``; width x height where the block is not square:
``refine_sads<16x8, 1>``).

K3's, K7's, K8's and K9's general kernels are one CUDA kernel
(``csrc/window_sads.cuh``) templated on the plane layout and the output
type. The specialised kernels are three: a lane per anchor row
(``csrc/refine_sads.cu``: K3 and K7 where both sides are 4 or more, K9 at
4x4, 8x8, 16x16, 8x4, 4x8, 16x8, 8x16, 16x4 and 4x16 with float32
output), which shares its SAD arithmetic with the specialised K8
(``csrc/refine_rows.cuh``); a thread per block (K9 at 2x2, 2x1, 1x2, 4x2,
2x4, 4x1, 1x4, 8x2 and 2x8, and K3 and K7 at 2x2, 4x2, 2x4, 8x2 and 2x8
with int32 output); a thread per pixel (K9 at 1x1). Every SAD kernel
sums exact integers: bit-equal to its plain version on every entry.
Tracked pixels outside the frame read as zero; candidates whose window
leaves the frame are masked by the callers.

Conventions as in ``svc_tpu``: a motion field is ``(..., mfh, mfw, 2)``
float32 with ``[..., 0] = x`` and ``[..., 1] = y``; MADs are
``float32(sad) / float32(area)`` (true division, like the reference's
``(float)sad / count``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from svc_tpu_torch.kernels.build import INT, PTR, Kernel, stream_handle
from svc_tpu_torch.ops.pyramid import respatialize

_FLT_MAX = float(np.finfo(np.float32).max)
# (width, height) of the MV blocks of K3's / K7's specialised kernels: the
# square ones (32x32 MV blocks' level 0 too), the ratio-2 rectangles of
# 16x8, 8x16, 32x16 and 16x32 MV blocks' levels and the ratio-4 ones of
# 32x8 and 8x32 MV blocks' levels
_K3_BLOCKS = frozenset({(2, 2), (4, 4), (8, 8), (16, 16), (32, 32), (4, 2), (8, 4),
                        (16, 8), (32, 16), (2, 4), (4, 8), (8, 16), (16, 32),
                        (8, 2), (16, 4), (32, 8), (2, 8), (4, 16), (8, 32)})
_SAD_RADII = (1, 2, 3, 4)  # search radii of the specialised K3, K7 and K9
# the radii past them whose instances work one candidate row at a time, and
# the blocks that take them: every level of square MV blocks past top
# radius 4 but one level of 32x32 (16x16 MV blocks at 1-5 levels, ranges
# 5-143; 8x8 at 1-4 levels, ranges 5-71; 32x32 at 2-5 levels, ranges
# 10-143; 4x4 at 3 levels, ranges 20-35): K3's / K7's 32x32 (level 0 of
# 32x32 MV blocks), 16x16, 8x8, 4x4 and 2x2 (the levels below); K9's
# 16x16 (one level of 16x16 MV blocks, the top of 2 of 32x32), 8x8, 4x4,
# 2x2 and 1x1 (the tops of deeper ones: 1x1 at 5 levels of 16x16, 4 of
# 8x8). R >= 9, and the rectangles past R = 4, stay general
_FAR_RADII = (5, 6, 7, 8)
_K3_FAR_BLOCKS = frozenset({(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)})
_K9_FAR_BLOCKS = frozenset({(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)})
# (width, height) of the MV blocks of K9's specialised kernels, and the
# byte alignment of its (tracked, anchor) stacks at each: whole words of
# tracked rows on the thread-a-pixel and thread-a-block kernels (1x1 and
# the blocks with a side of 1 or 2) and their anchor rows' bytes (one load
# a row), 16-byte chunks of both on K3's kernel (both sides 4 or more; 16x16,
# 16x8 and 8x16 the top levels of 32x32, 32x16 and 16x32 MV blocks at 2
# levels; 4x1, 8x2, 16x4 those of 32x8 MV blocks at 4, 3, 2 levels and
# 1x4, 2x8, 4x16 of 8x32)
_K9_ALIGN = {(1, 1): (4, 1), (2, 2): (4, 2), (2, 1): (4, 2), (1, 2): (4, 1),
             (4, 2): (4, 4), (2, 4): (4, 2), (4, 4): (16, 16), (8, 8): (16, 16),
             (8, 4): (16, 16), (4, 8): (16, 16), (16, 16): (16, 16),
             (16, 8): (16, 16), (8, 16): (16, 16), (4, 1): (4, 4), (1, 4): (4, 1),
             (8, 2): (4, 8), (2, 8): (4, 2), (16, 4): (16, 16), (4, 16): (16, 16)}
_K9_BLOCKS = frozenset(_K9_ALIGN)
_K8_TBW, _K8_BLOCK = 8, 16  # subplanes and square MV block of K8's specialised refine


def _instance(block_w: int, block_h: int, r: int) -> str:
    """A SAD instance's launch-count suffix: ``<16, 2>`` for square
    blocks, ``<16x8, 1>`` (width x height) for the others."""
    block = block_w if block_w == block_h else f"{block_w}x{block_h}"
    return f"<{block}, {r}>"


REFINE_SADS = Kernel(
    "refine_sads",
    "svc_refine_sads",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_sads.cu",
    replaces="svc_tpu/ops/motion_pallas.py:887",
    instance=lambda a: _instance(a[6], a[7], a[8]),
)
REFINE_SADS_GENERAL = Kernel(
    "refine_sads_general",
    "svc_refine_sads_general",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_sads_general.cu",
    replaces="svc_tpu/ops/motion_pallas.py:887",
)
REFINE_MADS = Kernel(
    "refine_mads",
    "svc_refine_mads",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_mads.cu",
    replaces="svc_tpu/ops/motion_pallas.py:541",
    instance=lambda a: _instance(a[6], a[7], a[8]),
)
REFINE_MADS_GENERAL = Kernel(
    "refine_mads_general",
    "svc_refine_mads_general",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_mads_general.cu",
    replaces="svc_tpu/ops/motion_pallas.py:541",
)
CANDIDATE_SADS = Kernel(
    "candidate_sads",
    "svc_candidate_sads",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/candidate_sads.cu",
    replaces="svc_tpu/ops/motion_pallas.py:121",
    instance=lambda a: _instance(a[7], a[8], a[9]),
)
CANDIDATE_SADS_GENERAL = Kernel(
    "candidate_sads_general",
    "svc_candidate_sads_general",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/candidate_sads_general.cu",
    replaces="svc_tpu/ops/motion_pallas.py:121",
)
REFINE_SADS_PITCHED = Kernel(
    "refine_sads_pitched",
    "svc_refine_sads_pitched",
    [PTR, PTR, PTR, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_sads_pitched.cu",
    replaces="svc_tpu/ops/motion_pallas.py:994",
)
REFINE_SADS_PITCHED_GENERAL = Kernel(
    "refine_sads_pitched_general",
    "svc_refine_sads_pitched_general",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_sads_pitched_general.cu",
    replaces="svc_tpu/ops/motion_pallas.py:994",
)


def candidate_offsets(search_range: int) -> np.ndarray:
    """All displacements in raster order: y ascending, then x ascending."""
    r = search_range
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    return np.stack([dy.ravel(), dx.ravel()], axis=-1).astype(np.int32)


def _block_origins(mfh: int, mfw: int, block_w: int, block_h: int, device):
    by = torch.arange(mfh, dtype=torch.int32, device=device)[:, None] * block_h
    bx = torch.arange(mfw, dtype=torch.int32, device=device)[None, :] * block_w
    return by, bx


# ---------------------------------------------------------------------------
# Candidate SADs: the plain arithmetic and the four kernel entry points
# ---------------------------------------------------------------------------


def _sads_plain(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
) -> torch.Tensor:
    """``(T, (2r+1)**2, mfh, mfw)`` int32 SADs of ``T`` plane pairs
    ``(T, fh, fw)`` around ``(T, mfh, mfw, 2)`` int32 MVs — the arithmetic
    of every SAD kernel, in plain PyTorch."""
    t, fh, fw = tracked.shape
    bw, bh = block_w, block_h
    mfh, mfw = fh // bh, fw // bw
    dev = tracked.device
    side = 2 * r + 1
    trk = tracked.to(torch.int32)
    anc = (
        anchor.to(torch.int32).reshape(t, mfh, bh, mfw, bw).permute(0, 1, 3, 2, 4)
    )  # (T, mfh, mfw, bh, bw)
    by, bx = _block_origins(mfh, mfw, bw, bh, dev)
    wy = (by + mv[..., 1] - r)[..., None] + torch.arange(bh + 2 * r, device=dev)
    wx = (bx + mv[..., 0] - r)[..., None] + torch.arange(bw + 2 * r, device=dev)
    inside = ((wy >= 0) & (wy < fh))[..., :, None] & (
        (wx >= 0) & (wx < fw)
    )[..., None, :]
    ti = torch.arange(t, device=dev)[:, None, None, None, None]
    win = trk[
        ti, wy.clamp(0, fh - 1)[..., :, None], wx.clamp(0, fw - 1)[..., None, :]
    ]
    win = torch.where(inside, win, torch.zeros((), dtype=win.dtype, device=dev))
    sads = [
        (win[..., oy : oy + bh, ox : ox + bw] - anc).abs().sum(dim=(-2, -1))
        for oy in range(side)
        for ox in range(side)
    ]
    return torch.stack(sads, dim=1).to(torch.int32)


def _check_sad_args(name, planes, mv, lead, fh, fw, block_w, block_h, r):
    """Shared validation of the SAD kernels' inputs (CUDA path)."""
    if planes[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {planes[0].device}")
    for p in planes:
        if p.dtype != torch.uint8 or tuple(p.shape[-2:]) != (fh, fw):
            raise TypeError(f"{name}: planes must be uint8 (..., {fh}, {fw})")
        if p.device != planes[0].device:
            raise ValueError(f"{name}: inputs on different devices")
    if fh % block_h or fw % block_w:
        raise ValueError(f"{name}: frame dims must be block multiples")
    if r < 0:
        raise ValueError(f"{name}: search range must be >= 0")
    mfh, mfw = fh // block_h, fw // block_w
    want = lead + (mfh, mfw, 2)
    if mv.dtype != torch.int32 or tuple(mv.shape) != want:
        raise TypeError(
            f"{name}: mv must be {want} int32, got {tuple(mv.shape)} {mv.dtype}"
        )
    if mv.device != planes[0].device:
        raise ValueError(f"{name}: planes and mv on different devices")
    return mfh, mfw


def refine_sads_plain(
    stack: torch.Tensor, mv: torch.Tensor, r: int, block_w: int, block_h: int
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same contract as :func:`refine_sads`)."""
    return _sads_plain(stack[:-1], stack[1:], mv, r, block_w, block_h)


def _radius_specialised(block, r: int, blocks, far_blocks) -> bool:
    """Whether a kernel has an instance for ``block`` at radius ``r``:
    ``blocks`` at ``_SAD_RADII``, ``far_blocks`` at ``_FAR_RADII`` too."""
    return ((block in blocks and r in _SAD_RADII)
            or (block in far_blocks and r in _FAR_RADII))


def _refine_specialised(block_w: int, block_h: int, r: int, stack) -> bool:
    """K3's specialised kernels take the blocks of ``_K3_BLOCKS`` at 1 <= r
    <= 4 and those of ``_K3_FAR_BLOCKS`` at 5 <= r <= 8, on a 16-byte
    aligned stack; every other case runs the general kernel."""
    return (_radius_specialised((block_w, block_h), r, _K3_BLOCKS, _K3_FAR_BLOCKS)
            and stack.data_ptr() % 16 == 0)


def refine_sads(
    stack: torch.Tensor,
    mv: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
    *,
    general: bool = False,
) -> torch.Tensor:
    """Candidate SADs of one refinement level (kernel K3: the specialised
    kernels for the blocks of ``_K3_BLOCKS`` at ``1 <= r <= 4`` — squares
    of side 2 to 32, the ratio-2 rectangles from 4x2 to 32x16 and 16x32 and
    the ratio-4 ones from 8x2 to 32x8 and 8x32 — and for the squares of
    side 2 to 32 at ``5 <= r <= 8``, the general one otherwise).

    Args:
      stack: ``(T+1, fh, fw)`` uint8 luma planes of one pyramid level;
        frame ``t`` is tracked against anchor ``t+1``.
      mv: ``(T, mfh, mfw, 2)`` int32 rounded propagated MVs, ``(x, y)``.
      r: refinement search radius.
      general: launch the general kernel whatever the shape (the yardstick
        the specialised one is held and timed against).

    Returns ``(T, (2r+1)**2, mfh, mfw)`` int32 SADs in candidate ``(oy, ox)``
    raster order, tracked pixels outside the frame read as zero (entries
    whose window leaves the frame are masked by :func:`_refine_select`).
    """
    if stack.device.type == "cpu":
        return refine_sads_plain(stack, mv, r, block_w, block_h)
    if stack.ndim != 3:
        raise TypeError("refine_sads: stack must be (T+1, fh, fw) uint8")
    tp1, fh, fw = stack.shape
    mfh, mfw = _check_sad_args("refine_sads", [stack], mv, (tp1 - 1,), fh, fw,
                               block_w, block_h, r)
    s = stack.contiguous()
    m = mv.contiguous()
    out = torch.empty(
        (tp1 - 1, (2 * r + 1) ** 2, mfh, mfw), dtype=torch.int32, device=s.device
    )
    if out.numel() == 0:
        return out
    with torch.cuda.device(s.device):
        if _refine_specialised(block_w, block_h, r, s) and not general:
            REFINE_SADS.launch(
                s.data_ptr(), m.data_ptr(), out.data_ptr(),
                tp1 - 1, fh, fw, block_w, block_h, r, stream_handle(s),
            )
        else:
            REFINE_SADS_GENERAL.launch(
                s.data_ptr(), m.data_ptr(), out.data_ptr(),
                tp1 - 1, fh, fw, block_w, block_h, r, stream_handle(s),
            )
    return out


def refine_mads_plain(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
) -> torch.Tensor:
    """Plain PyTorch version of K7 (same contract as :func:`refine_mads`)."""
    return _sads_plain(tracked[None], anchor[None], mv[None], r, block_w,
                       block_h)[0]


def _refine_mads_specialised(block_w: int, block_h: int, r: int, tracked,
                             anchor) -> bool:
    """K7's specialised kernel is K3's: the same shapes, with the anchor
    plane 16-byte aligned too; every other case runs the general kernel."""
    return (_refine_specialised(block_w, block_h, r, tracked)
            and anchor.data_ptr() % 16 == 0)


def refine_mads(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
    *,
    general: bool = False,
) -> torch.Tensor:
    """Candidate SADs of one refinement level for one frame pair (kernel
    K7: K3's specialised kernels for the blocks of ``_K3_BLOCKS`` at ``1 <=
    r <= 4``, 32x32, 32x16, 16x32, 32x8 and 8x32 among them, and for the
    squares of side 2 to 32 at ``5 <= r <= 8``, the general one
    otherwise).

    Args:
      tracked / anchor: ``(fh, fw)`` uint8 luma planes.
      mv: ``(mfh, mfw, 2)`` int32 rounded MVs ``(x, y)``; any values (odd,
        unbounded): each block's window is placed at its own MV.
      general: launch the general kernel whatever the shape (the yardstick
        the specialised one is held and timed against).

    Returns ``((2r+1)**2, mfh, mfw)`` int32 SADs in ``(oy, ox)`` raster
    order — the first ``(2r+1)**2`` rows of svc_tpu's
    ``refine_mads_pallas``, whose ``(mfh, rows_out, mfw)`` layout pads the
    candidate axis to a multiple of 8.
    """
    if tracked.device.type == "cpu":
        return refine_mads_plain(tracked, anchor, mv, r, block_w, block_h)
    if tracked.ndim != 2 or anchor.ndim != 2:
        raise TypeError("refine_mads: tracked and anchor must be (fh, fw) uint8")
    fh, fw = tracked.shape
    mfh, mfw = _check_sad_args("refine_mads", [tracked, anchor], mv, (), fh,
                               fw, block_w, block_h, r)
    tr, an, m = tracked.contiguous(), anchor.contiguous(), mv.contiguous()
    out = torch.empty(((2 * r + 1) ** 2, mfh, mfw), dtype=torch.int32,
                      device=tr.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tr.device):
        specialised = not general and _refine_mads_specialised(
            block_w, block_h, r, tr, an)
        kernel = REFINE_MADS if specialised else REFINE_MADS_GENERAL
        kernel.launch(
            tr.data_ptr(), an.data_ptr(), m.data_ptr(), out.data_ptr(),
            fh, fw, block_w, block_h, r, stream_handle(tr),
        )
    return out


def candidate_sads_plain(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv_round: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
) -> torch.Tensor:
    """Plain PyTorch version of K9 (same contract as :func:`candidate_sads`)."""
    return _sads_plain(tracked, anchor, mv_round, search_range, block_w,
                       block_h).to(torch.float32)


def _candidate_specialised(block_w: int, block_h: int, r: int, tracked,
                           anchor) -> bool:
    """K9's specialised kernels take the blocks of ``_K9_BLOCKS`` at 1 <= r
    <= 4 and those of ``_K9_FAR_BLOCKS`` at 5 <= r <= 8, on stacks aligned
    as ``_K9_ALIGN`` says, planes of a whole number of words; every other
    case runs the general kernel."""
    if not _radius_specialised((block_w, block_h), r, _K9_BLOCKS, _K9_FAR_BLOCKS):
        return False
    t_align, a_align = _K9_ALIGN[block_w, block_h]
    words = tracked.shape[-2] * tracked.shape[-1] % 4 == 0
    return (words and tracked.data_ptr() % t_align == 0
            and anchor.data_ptr() % a_align == 0)


def candidate_sads(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv_round: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
    mv_pad: int = 0,
    *,
    general: bool = False,
) -> torch.Tensor:
    """Per-block SADs of every ``(2r+1)**2`` candidate around each block's
    MV (kernel K9; svc_tpu's ``motion_pallas.candidate_sads``): the
    specialised kernels for the blocks of ``_K9_BLOCKS`` at ``1 <= r <= 4``
    (squares of side 1 to 16, the ratio-2 rectangles from 2x1 to 16x8 and
    8x16 and the ratio-4 ones from 4x1 to 16x4 and 4x16) and for the
    squares of side 1 to 16 at ``5 <= r <= 8``, the general one otherwise.

    Args:
      tracked / anchor: ``(T, H, W)`` uint8 luma planes.
      mv_round: ``(T, mfh, mfw, 2)`` int32 MVs ``(x, y)``; zeros for an
        exhaustive search around the anchor grid.
      search_range: ``r``; offsets scan ``[-r, r]**2`` in raster order.
      mv_pad: svc_tpu's bound on ``|mv_round|`` (its tracked-plane pad).
        The port places each window at its block's own MV, so the SADs are
        svc_tpu's wherever its bound holds and exact elsewhere too.
      general: launch the general kernel whatever the shape (the yardstick
        the specialised one is held and timed against).

    Returns ``(T, (2r+1)**2, mfh, mfw)`` float32 SADs. Entries whose window
    leaves the frame are undefined, as in svc_tpu (here: tracked pixels
    outside the frame count as zero); callers mask them.
    """
    if mv_pad < 0:
        raise ValueError("candidate_sads: mv_pad must be >= 0")
    if tracked.device.type == "cpu":
        return candidate_sads_plain(tracked, anchor, mv_round, search_range,
                                    block_w, block_h)
    if tracked.ndim != 3 or anchor.shape != tracked.shape:
        raise TypeError("candidate_sads: tracked and anchor must be (T, H, W) uint8")
    t, fh, fw = tracked.shape
    r = search_range
    mfh, mfw = _check_sad_args("candidate_sads", [tracked, anchor], mv_round,
                               (t,), fh, fw, block_w, block_h, r)
    tr, an, m = tracked.contiguous(), anchor.contiguous(), mv_round.contiguous()
    out = torch.empty((t, (2 * r + 1) ** 2, mfh, mfw), dtype=torch.float32,
                      device=tr.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tr.device):
        if _candidate_specialised(block_w, block_h, r, tr, an) and not general:
            CANDIDATE_SADS.launch(
                tr.data_ptr(), an.data_ptr(), m.data_ptr(), out.data_ptr(),
                t, fh, fw, block_w, block_h, r, stream_handle(tr),
            )
        else:
            CANDIDATE_SADS_GENERAL.launch(
                tr.data_ptr(), an.data_ptr(), m.data_ptr(), out.data_ptr(),
                t, fh, fw, block_w, block_h, r, stream_handle(tr),
            )
    return out


def refine_sads_static(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    mv_round: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
    mv_bound: int,
) -> torch.Tensor:
    """svc_tpu's ``motion_pallas.refine_sads_static`` on K9: the same
    contract as :func:`candidate_sads`, with that kernel's restrictions —
    ``mv_bound + search_range <= block_h`` and even MVs within
    ``[-mv_bound, mv_bound]`` (hierarchical refinement inputs are doubled
    integer fields). ``ValueError`` outside them (the MV check reads the
    MVs back to the host)."""
    if mv_bound < 0 or mv_bound + search_range > block_h:
        raise ValueError(
            "refine_sads_static: needs 0 <= mv_bound and mv_bound + "
            f"search_range <= block_h (got {mv_bound} + {search_range} > "
            f"{block_h})"
        )
    if bool(((mv_round % 2) != 0).any()) or bool((mv_round.abs() > mv_bound).any()):
        raise ValueError(
            f"refine_sads_static: MVs must be even and within +-{mv_bound}"
        )
    return candidate_sads(tracked, anchor, mv_round, search_range, block_w,
                          block_h, mv_bound)


def _check_pitched_refine(y8: torch.Tensor, block_w: int) -> None:
    if y8.dtype != torch.uint8 or y8.ndim != 4:
        raise TypeError(
            f"refine_sads_pitched: y8 must be (tbw, T+1, fh, fw//tbw) uint8, "
            f"got {tuple(y8.shape)} {y8.dtype}"
        )
    if block_w % y8.shape[0]:
        # svc_tpu's cell builder needs whole subplane phases per block
        # column (motion_pallas.stack_cells_from_pitched)
        raise ValueError(
            f"refine_sads_pitched: block_w={block_w} is not a multiple of "
            f"tbw={y8.shape[0]}"
        )


def refine_sads_pitched_plain(
    y8: torch.Tensor, mv: torch.Tensor, r: int, block_w: int, block_h: int
) -> torch.Tensor:
    """Plain PyTorch version of K8's refine: :func:`refine_sads_plain` of
    the respatialized stack."""
    _check_pitched_refine(y8, block_w)
    return refine_sads_plain(respatialize(y8), mv, r, block_w, block_h)


def _check_pitched_args(y8: torch.Tensor, mv: torch.Tensor, block_w: int,
                        block_h: int) -> Tuple[int, int]:
    """Validation of K8's refine inputs (CUDA path); ``(mfh, mfw)``."""
    if y8.device.type != "cuda":
        raise ValueError(f"refine_sads_pitched: unsupported device {y8.device}")
    tbw, tp1, fh, nbx = y8.shape
    if fh % block_h or (tbw * nbx) % block_w:
        raise ValueError("refine_sads_pitched: frame dims must be block multiples")
    mfh, mfw = fh // block_h, tbw * nbx // block_w
    want = (tp1 - 1, mfh, mfw, 2)
    if mv.dtype != torch.int32 or tuple(mv.shape) != want or mv.device != y8.device:
        raise TypeError(f"refine_sads_pitched: mv must be {want} int32 on {y8.device}")
    return mfh, mfw


def _pitched_specialised(tbw: int, nbx: int, block_w: int, block_h: int,
                         r: int, y8) -> bool:
    """K8's specialised refine takes 8 subplanes, square 16x16 blocks at
    r = 1, and subplane rows of whole 4-byte words (``nbx % 4 == 0`` on a
    4-byte aligned stack); every other case runs the general kernel."""
    return (tbw == _K8_TBW and block_w == block_h == _K8_BLOCK and r == 1
            and nbx % 4 == 0 and y8.data_ptr() % 4 == 0)


def refine_sads_pitched(
    y8: torch.Tensor,
    mv: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
    *,
    general: bool = False,
) -> torch.Tensor:
    """:func:`refine_sads` over column-pitched luma subplanes (kernel K8;
    svc_tpu's ``refine_mads_stack_pitched_pallas``): the specialised kernel
    for 8 subplanes and square 16x16 blocks at ``r = 1``, the general one
    otherwise.

    Args:
      y8: ``(tbw, T+1, fh, fw // tbw)`` uint8 subplanes (spatial column
        ``x`` is lane ``x // tbw`` of subplane ``x % tbw``); ``block_w``
        must be a multiple of ``tbw``.
      mv: ``(T, mfh, mfw, 2)`` int32 MVs ``(x, y)``; any values: each
        block's window is placed at its own MV.
      general: launch the general kernel whatever the shape (the yardstick
        the specialised one is held and timed against).

    Returns what :func:`refine_sads` returns for the respatialized stack,
    bit for bit.
    """
    if y8.device.type == "cpu":
        return refine_sads_pitched_plain(y8, mv, r, block_w, block_h)
    _check_pitched_refine(y8, block_w)
    mfh, mfw = _check_pitched_args(y8, mv, block_w, block_h)
    tbw, tp1, fh, nbx = y8.shape
    x, m = y8.contiguous(), mv.contiguous()
    out = torch.empty((tp1 - 1, (2 * r + 1) ** 2, mfh, mfw), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        if _pitched_specialised(tbw, nbx, block_w, block_h, r, x) and not general:
            REFINE_SADS_PITCHED.launch(
                x.data_ptr(), m.data_ptr(), out.data_ptr(), tp1 - 1, fh, nbx,
                stream_handle(x),
            )
        else:
            REFINE_SADS_PITCHED_GENERAL.launch(
                x.data_ptr(), m.data_ptr(), out.data_ptr(), tbw, tp1 - 1, fh,
                nbx, block_w, block_h, r, stream_handle(x),
            )
    return out


# ---------------------------------------------------------------------------
# Block matching
# ---------------------------------------------------------------------------


def ebma(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive block matching of ``(..., fh, fw)`` uint8 planes.

    The SADs of every displacement come from K9 (:func:`candidate_sads`
    around zero MVs). Returns ``(mv_field, min_mad)``: ``<=`` updates over
    the raster-order candidates whose tracked block lies inside the frame,
    then the flat rule — a block whose every valid candidate updated the
    running minimum gets a zero MV (its min-MAD is kept).
    """
    fh, fw = tracked.shape[-2:]
    if fh % block_h or fw % block_w:
        raise ValueError("frame dims must be multiples of the block dims")
    mfh, mfw = fh // block_h, fw // block_w
    r = search_range
    dev = tracked.device
    lead = tuple(tracked.shape[:-2])
    zero_mv = torch.zeros((int(np.prod(lead)), mfh, mfw, 2), dtype=torch.int32,
                          device=dev)
    sads = candidate_sads(
        tracked.reshape(-1, fh, fw), anchor.reshape(-1, fh, fw), zero_mv, r,
        block_w, block_h,
    ).reshape(lead + ((2 * r + 1) ** 2, mfh, mfw))
    area = _area(block_w, block_h, dev)
    by, bx = _block_origins(mfh, mfw, block_w, block_h, dev)

    mv_x = torch.zeros(lead + (mfh, mfw), dtype=torch.float32, device=dev)
    mv_y = torch.zeros_like(mv_x)
    min_mad = torch.full(lead + (mfh, mfw), _FLT_MAX, dtype=torch.float32,
                         device=dev)
    update_count = torch.zeros(lead + (mfh, mfw), dtype=torch.int32, device=dev)
    valid_count = torch.zeros_like(update_count)
    for i, (dy, dx) in enumerate(candidate_offsets(r)):
        dy, dx = int(dy), int(dx)
        mad = sads[..., i, :, :] / area
        valid = (
            (by + dy >= 0)
            & (by + dy <= fh - block_h)
            & (bx + dx >= 0)
            & (bx + dx <= fw - block_w)
        )
        update = valid & (mad <= min_mad)
        # Python scalars: no per-candidate host copy
        mv_x = torch.where(update, float(dx), mv_x)
        mv_y = torch.where(update, float(dy), mv_y)
        min_mad = torch.where(update, mad, min_mad)
        update_count += update.to(torch.int32)
        valid_count += valid.to(torch.int32)
    flat = update_count == valid_count
    mv = torch.stack([mv_x, mv_y], dim=-1)
    mv = torch.where(flat[..., None], torch.zeros((), device=dev), mv)
    return mv, min_mad


def _refine_select(
    mads: torch.Tensor,
    mv_field: torch.Tensor,
    min_mad: torch.Tensor,
    r: int,
    block_w: int,
    block_h: int,
    fh: int,
    fw: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay the sequential strict-``<`` selection over per-candidate MADs
    ``(..., ncand, mfh, mfw)`` in raster offset order; candidates whose
    tracked block leaves the frame never update."""
    mfh, mfw = mv_field.shape[-3:-1]
    by, bx = _block_origins(mfh, mfw, block_w, block_h, mv_field.device)
    mv_round = torch.round(mv_field).to(torch.int32)
    py = by + mv_round[..., 1]
    px = bx + mv_round[..., 0]
    mv, best = mv_field, min_mad
    for i, (ey, ex) in enumerate(candidate_offsets(r)):
        ey, ex = int(ey), int(ex)
        mad = mads[..., i, :, :]
        valid = (
            (py + ey >= 0)
            & (py + ey <= fh - block_h)
            & (px + ex >= 0)
            & (px + ex <= fw - block_w)
        )
        update = valid & (mad < best)
        new_mv = torch.stack(
            [(px + ex - bx).to(torch.float32), (py + ey - by).to(torch.float32)],
            dim=-1,
        )
        mv = torch.where(update[..., None], new_mv, mv)
        best = torch.where(update, mad, best)
    return mv, best


def _area(block_w: int, block_h: int, dev) -> torch.Tensor:
    """A block's pixel count as a float32 tensor on ``dev``: divided by as
    a tensor (CUDA divides by a host scalar through its reciprocal), and
    filled on the device (a copy from pageable memory would sync the
    stream and keep the search out of a CUDA graph)."""
    return torch.full((), float(block_w * block_h), dtype=torch.float32,
                      device=dev)


def _mads(sads: torch.Tensor, block_w: int, block_h: int) -> torch.Tensor:
    return sads.to(torch.float32) / _area(block_w, block_h, sads.device)


def refine(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
    mv_field: torch.Tensor,
    min_mad: torch.Tensor,
    mv_bound: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hierarchical refinement pass around propagated MVs.

    Searches ``+-search_range`` around each block's rounded MV on
    ``(fh, fw)`` planes, updating only on a strictly smaller MAD and
    carrying ``min_mad`` in from the previous pyramid level
    (``RefineHierMotionEst``, libs/motion.cpp:342-410). SADs come from K7
    (:func:`refine_mads`), which places each window at its block's own MV,
    so any MV field works.

    ``mv_bound``: svc_tpu's static bound on ``|mv| + search_range``, which
    picks its dense-table path (``> 0``) or its gather path (``0``). The
    two give the same result whenever the bound holds, and so does this
    one path; the argument is accepted for the same signature.
    """
    if mv_bound < 0:
        raise ValueError("mv_bound must be >= 0")
    fh, fw = tracked.shape
    if fh % block_h or fw % block_w:
        raise ValueError("frame dims must be multiples of the block dims")
    mv_round = torch.round(mv_field).to(torch.int32)
    sads = refine_mads(tracked, anchor, mv_round, search_range, block_w, block_h)
    return _refine_select(_mads(sads, block_w, block_h), mv_field, min_mad,
                          search_range, block_w, block_h, fh, fw)


def _top_range(level_count: int, search_range: int, block_w: int,
               block_h: int) -> int:
    """The top level's search range, with svc_tpu's validation errors."""
    factor = 1 << (level_count - 1)
    if search_range < factor:
        raise ValueError(
            "search range must be >= the top level reduction factor"
        )
    if block_w % factor or block_h % factor:
        # the reference truncates the per-level block dims and then
        # corrupts its MV field when the doubled dims no longer match
        raise ValueError(
            "block dims must be divisible by the top level reduction factor"
        )
    return search_range // factor


def hbma(
    tracked_pyramid: Sequence[torch.Tensor],
    anchor_pyramid: Sequence[torch.Tensor],
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical block matching of one frame pair over Gaussian pyramids
    (``EstimateMotionHierarchical``, libs/motion.cpp:412-465).

    The top level runs :func:`ebma` with range ``search_range // 2**(L-1)``
    on ``2**(L-1)``-times-smaller blocks; every lower level doubles the MVs
    and :func:`refine` s around them with the same top range (K7 on CUDA).

    Args:
      tracked_pyramid / anchor_pyramid: ``(h_l, w_l)`` uint8 planes, level
        0 the base.
      block_w / block_h: base-level block dims.

    Returns ``(mv_field (mfh, mfw, 2), min_mad (mfh, mfw))``.
    """
    levels = len(tracked_pyramid)
    r = _top_range(levels, search_range, block_w, block_h)
    factor = 1 << (levels - 1)
    mv, min_mad = ebma(tracked_pyramid[-1], anchor_pyramid[-1], r,
                       block_w // factor, block_h // factor)
    for lvl in range(levels - 2, -1, -1):
        scale = 1 << lvl
        mv, min_mad = refine(tracked_pyramid[lvl], anchor_pyramid[lvl], r,
                             block_w // scale, block_h // scale, mv * 2.0,
                             min_mad)
    return mv, min_mad


def hbma_stack(
    pyramid_stack: Sequence[torch.Tensor],
    search_range: int,
    block_w: int,
    block_h: int,
    base_pitched: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical block matching over a frame-stack pyramid.

    Each level is a ``(T+1, h_l, w_l)`` uint8 stack; frame ``t`` is tracked
    against anchor ``t+1``. The top level runs :func:`ebma` with range
    ``search_range // 2**(L-1)`` on ``2**(L-1)``-times-smaller blocks; every
    lower level doubles the MVs and refines around them with the same top
    range through K3, keeping the carried min-MAD. Equal to :func:`hbma`
    per frame pair.

    ``base_pitched``: the base level as column-pitched subplanes ``(tbw,
    T+1, fh, fw // tbw)``, ``block_w`` a multiple of ``tbw`` (svc_tpu's
    extension of the same name). When given, level 0 runs K8
    (:func:`refine_sads_pitched`) on it and ``pyramid_stack[0]`` is not
    read; the result is the same as from the spatial base level.

    Returns ``(mv (T, mfh, mfw, 2), min_mad (T, mfh, mfw))``.
    """
    levels = len(pyramid_stack)
    r = _top_range(levels, search_range, block_w, block_h)
    factor = 1 << (levels - 1)
    top = pyramid_stack[-1]
    mv, min_mad = ebma(top[:-1], top[1:], r, block_w // factor,
                       block_h // factor)
    for lvl in range(levels - 2, -1, -1):
        scale = 1 << lvl
        mv = mv * 2.0
        bw, bh = block_w // scale, block_h // scale
        mv_round = torch.round(mv).to(torch.int32)
        if lvl == 0 and base_pitched is not None:
            tbw, _, fh, nbx = base_pitched.shape
            fw = tbw * nbx
            sads = refine_sads_pitched(base_pitched, mv_round, r, bw, bh)
        else:
            stack = pyramid_stack[lvl]
            fh, fw = stack.shape[1:]
            sads = refine_sads(stack, mv_round, r, bw, bh)
        mv, min_mad = _refine_select(_mads(sads, bw, bh), mv, min_mad, r, bw,
                                     bh, fh, fw)
    return mv, min_mad


# ---------------------------------------------------------------------------
# Global-motion estimators (public in the reference, unused by its apps;
# RANSAC — the one the encoder uses — lives in ops/ransac.py)
# ---------------------------------------------------------------------------


def estimate_global_motion_avg(motion_field: torch.Tensor) -> torch.Tensor:
    """Mean MV of the field (``EstimateGlobalMotionAvg``,
    libs/motion.cpp:45-53): the float32 sum over blocks divided by their
    count, as ``jnp.mean``. Bit-equal to svc_tpu for integer fields (the
    hierarchical search's output), whose float32 sums are exact. The count
    is a tensor on the field's device: CUDA divides by a host scalar
    through its reciprocal, which can differ in the last bit."""
    field = motion_field.reshape(-1, 2)
    count = torch.tensor(float(field.shape[0]), dtype=torch.float32,
                         device=field.device)
    return field.sum(dim=0) / count


def estimate_global_motion_exhaustive(
    tracked: torch.Tensor, anchor: torch.Tensor, search_range: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-frame EBMA over the clipped overlap of ``(fh, fw)`` planes.

    For each displacement ``(dy, dx)`` in raster order the MAD is the mean
    ``|tracked[y + dy, x + dx] - anchor[y, x]|`` over the anchor pixels
    whose displaced position lies in the frame; strict ``<`` keeps the
    first minimum (``EstimateGlobalMotionExhaustiveSearch``,
    libs/motion.cpp:55-99).

    Deliberate divergence from the reference (svc_tpu's quirk E9): its
    loops compare a signed index against the unsigned search range, so for
    any ``search_range >= 1`` they never run and it returns zero motion
    and FLT_MAX. This function (like svc_tpu's) performs the documented
    search.

    Returns ``(global_motion (2,) float32 (x, y), min_mad () float32)``.
    """
    fh, fw = tracked.shape
    dev = tracked.device
    t = tracked.to(torch.int32)
    a = anchor.to(torch.int32)
    gm = torch.zeros(2, dtype=torch.float32, device=dev)
    best = torch.tensor(_FLT_MAX, dtype=torch.float32, device=dev)
    for dy, dx in candidate_offsets(search_range):
        dy, dx = int(dy), int(dx)
        # anchor rows [y0, y1), cols [x0, x1) see tracked rows/cols + d
        y0, y1 = max(0, -dy), fh - max(0, dy)
        x0, x1 = max(0, -dx), fw - max(0, dx)
        count = max(y1 - y0, 0) * max(x1 - x0, 0)
        if count:
            sad = (t[y0 + dy : y1 + dy, x0 + dx : x1 + dx]
                   - a[y0:y1, x0:x1]).abs().sum()
        else:  # no overlap: 0 / 0 = NaN never updates, as in svc_tpu
            sad = torch.zeros((), dtype=torch.int64, device=dev)
        mad = sad.to(torch.float32) / torch.tensor(
            float(count), dtype=torch.float32, device=dev
        )
        update = mad < best
        gm = torch.where(
            update, torch.tensor([dx, dy], dtype=torch.float32, device=dev), gm
        )
        best = torch.where(update, mad, best)
    return gm, best


def estimate_global_motion_hierarchical(
    tracked_pyramid: Sequence[torch.Tensor],
    anchor_pyramid: Sequence[torch.Tensor],
    base_search_range: int,
) -> torch.Tensor:
    """Pyramid global-motion search (``EstimateGlobalMotionHierarchical``,
    libs/motion.cpp:101-142): the top level searched at
    ``base_search_range // 2**(L-1)``, each lower level doubles the
    estimate and adds a +-1 corrective search centred at zero displacement
    (not at the propagated estimate — the reference's behaviour)."""
    levels = len(tracked_pyramid)
    factor = 1 << (levels - 1)
    gm, _ = estimate_global_motion_exhaustive(
        tracked_pyramid[-1], anchor_pyramid[-1], base_search_range // factor
    )
    for lvl in range(levels - 2, -1, -1):
        corrective, _ = estimate_global_motion_exhaustive(
            tracked_pyramid[lvl], anchor_pyramid[lvl], 1
        )
        gm = 2.0 * gm + corrective
    return gm
