"""Hierarchical block-matching motion estimation (``svc_tpu/ops/motion.py``).

* :func:`ebma` — exhaustive block matching on the top pyramid level, with
  the reference's ``<=`` (last-wins) tie-break and the flat-region zero-MV
  reset (quirks Q6/Q8, libs/motion.cpp:268-340);
* :func:`refine_sads` — kernel K3 (``csrc/refine_sads.cu``): the candidate
  SADs of one refinement level for the whole frame stack;
* :func:`_refine_select` — the reference's sequential strict-``<``
  (first-wins) replay over those SADs, carrying min-MAD across levels
  (libs/motion.cpp:342-410, 443-463);
* :func:`hbma_stack` — the full pyramid search over a ``(T+1, h, w)``
  stack, frame ``t`` tracked against anchor ``t+1``.

Conventions as in ``svc_tpu``: a motion field is ``(..., mfh, mfw, 2)``
float32 with ``[..., 0] = x`` and ``[..., 1] = y``; MADs are
``float32(sad) / float32(area)`` (true division, like the reference's
``(float)sad / count``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svc_tpu_torch.kernels.build import INT, PTR, Kernel, stream_handle

_FLT_MAX = float(np.finfo(np.float32).max)

REFINE_SADS = Kernel(
    "refine_sads",
    "svc_refine_sads",
    [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR],
    source="svc_tpu_torch/csrc/refine_sads.cu",
    replaces="svc_tpu/ops/motion_pallas.py:887",
)


def candidate_offsets(search_range: int) -> np.ndarray:
    """All displacements in raster order: y ascending, then x ascending."""
    r = search_range
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    return np.stack([dy.ravel(), dx.ravel()], axis=-1).astype(np.int32)


def _block_sums(x: torch.Tensor, block_w: int, block_h: int) -> torch.Tensor:
    *lead, h, w = x.shape
    return x.reshape(*lead, h // block_h, block_h, w // block_w, block_w).sum(
        dim=(-3, -1)
    )


def _block_origins(mfh: int, mfw: int, block_w: int, block_h: int, device):
    by = torch.arange(mfh, dtype=torch.int32, device=device)[:, None] * block_h
    bx = torch.arange(mfw, dtype=torch.int32, device=device)[None, :] * block_w
    return by, bx


def ebma(
    tracked: torch.Tensor,
    anchor: torch.Tensor,
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exhaustive block matching of ``(..., fh, fw)`` uint8 planes.

    Returns ``(mv_field, min_mad)``: ``<=`` updates over the raster-order
    candidates whose tracked block lies inside the frame, then the flat
    rule — a block whose every valid candidate updated the running minimum
    gets a zero MV (its min-MAD is kept).
    """
    fh, fw = tracked.shape[-2:]
    if fh % block_h or fw % block_w:
        raise ValueError("frame dims must be multiples of the block dims")
    mfh, mfw = fh // block_h, fw // block_w
    r = search_range
    dev = tracked.device
    area = torch.tensor(float(block_w * block_h), dtype=torch.float32, device=dev)
    tp = F.pad(tracked.to(torch.int32), (r, r, r, r))
    a = anchor.to(torch.int32)
    by, bx = _block_origins(mfh, mfw, block_w, block_h, dev)
    lead = tuple(tracked.shape[:-2])

    mv = torch.zeros(lead + (mfh, mfw, 2), dtype=torch.float32, device=dev)
    min_mad = torch.full(lead + (mfh, mfw), _FLT_MAX, dtype=torch.float32,
                         device=dev)
    update_count = torch.zeros(lead + (mfh, mfw), dtype=torch.int32, device=dev)
    valid_count = torch.zeros_like(update_count)
    for dy, dx in candidate_offsets(r):
        dy, dx = int(dy), int(dx)
        cand = tp[..., r + dy : r + dy + fh, r + dx : r + dx + fw]
        sad = _block_sums((cand - a).abs(), block_w, block_h)
        mad = sad.to(torch.float32) / area
        valid = (
            (by + dy >= 0)
            & (by + dy <= fh - block_h)
            & (bx + dx >= 0)
            & (bx + dx <= fw - block_w)
        )
        update = valid & (mad <= min_mad)
        new_mv = torch.tensor([dx, dy], dtype=torch.float32, device=dev)
        mv = torch.where(update[..., None], new_mv, mv)
        min_mad = torch.where(update, mad, min_mad)
        update_count += update.to(torch.int32)
        valid_count += valid.to(torch.int32)
    flat = update_count == valid_count
    mv = torch.where(flat[..., None], torch.zeros((), device=dev), mv)
    return mv, min_mad


def refine_sads_plain(
    stack: torch.Tensor, mv: torch.Tensor, r: int, block_w: int, block_h: int
) -> torch.Tensor:
    """Plain PyTorch version of K3 (same contract as :func:`refine_sads`)."""
    tp1, fh, fw = stack.shape
    t = tp1 - 1
    bw, bh = block_w, block_h
    mfh, mfw = fh // bh, fw // bw
    dev = stack.device
    side = 2 * r + 1
    tracked = stack[:-1].to(torch.int32)
    anc = (
        stack[1:].to(torch.int32).reshape(t, mfh, bh, mfw, bw).permute(0, 1, 3, 2, 4)
    )  # (T, mfh, mfw, bh, bw)
    by, bx = _block_origins(mfh, mfw, bw, bh, dev)
    wy = (by + mv[..., 1] - r)[..., None] + torch.arange(bh + 2 * r, device=dev)
    wx = (bx + mv[..., 0] - r)[..., None] + torch.arange(bw + 2 * r, device=dev)
    inside = ((wy >= 0) & (wy < fh))[..., :, None] & (
        (wx >= 0) & (wx < fw)
    )[..., None, :]
    ti = torch.arange(t, device=dev)[:, None, None, None, None]
    win = tracked[
        ti, wy.clamp(0, fh - 1)[..., :, None], wx.clamp(0, fw - 1)[..., None, :]
    ]
    win = torch.where(inside, win, torch.zeros((), dtype=win.dtype, device=dev))
    sads = [
        (win[..., oy : oy + bh, ox : ox + bw] - anc).abs().sum(dim=(-2, -1))
        for oy in range(side)
        for ox in range(side)
    ]
    return torch.stack(sads, dim=1).to(torch.int32)


def refine_sads(
    stack: torch.Tensor, mv: torch.Tensor, r: int, block_w: int, block_h: int
) -> torch.Tensor:
    """Candidate SADs of one refinement level (kernel K3).

    Args:
      stack: ``(T+1, fh, fw)`` uint8 luma planes of one pyramid level;
        frame ``t`` is tracked against anchor ``t+1``.
      mv: ``(T, mfh, mfw, 2)`` int32 rounded propagated MVs, ``(x, y)``.
      r: refinement search radius.

    Returns ``(T, (2r+1)**2, mfh, mfw)`` int32 SADs in candidate ``(oy, ox)``
    raster order, tracked pixels outside the frame read as zero (entries
    whose window leaves the frame are masked by :func:`_refine_select`).
    """
    if stack.device.type == "cpu":
        return refine_sads_plain(stack, mv, r, block_w, block_h)
    if stack.device.type != "cuda":
        raise ValueError(f"refine_sads: unsupported device {stack.device}")
    if stack.dtype != torch.uint8 or stack.ndim != 3:
        raise TypeError("refine_sads: stack must be (T+1, fh, fw) uint8")
    tp1, fh, fw = stack.shape
    mfh, mfw = fh // block_h, fw // block_w
    if fh % block_h or fw % block_w:
        raise ValueError("refine_sads: frame dims must be block multiples")
    if mv.dtype != torch.int32 or tuple(mv.shape) != (tp1 - 1, mfh, mfw, 2):
        raise TypeError(
            f"refine_sads: mv must be ({tp1 - 1}, {mfh}, {mfw}, 2) int32, "
            f"got {tuple(mv.shape)} {mv.dtype}"
        )
    if mv.device != stack.device:
        raise ValueError("refine_sads: stack and mv on different devices")
    s = stack.contiguous()
    m = mv.contiguous()
    out = torch.empty(
        (tp1 - 1, (2 * r + 1) ** 2, mfh, mfw), dtype=torch.int32, device=s.device
    )
    if out.numel() == 0:
        return out
    with torch.cuda.device(s.device):
        REFINE_SADS.launch(
            s.data_ptr(), m.data_ptr(), out.data_ptr(),
            tp1 - 1, fh, fw, block_w, block_h, r, stream_handle(s),
        )
    return out


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
    ``(T, ncand, mfh, mfw)`` in raster offset order; candidates whose
    tracked block leaves the frame never update."""
    mfh, mfw = mv_field.shape[-3:-1]
    by, bx = _block_origins(mfh, mfw, block_w, block_h, mv_field.device)
    mv_round = torch.round(mv_field).to(torch.int32)
    py = by + mv_round[..., 1]
    px = bx + mv_round[..., 0]
    mv, best = mv_field, min_mad
    for i, (ey, ex) in enumerate(candidate_offsets(r)):
        ey, ex = int(ey), int(ex)
        mad = mads[:, i]
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


def hbma_stack(
    pyramid_stack: Sequence[torch.Tensor],
    search_range: int,
    block_w: int,
    block_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical block matching over a frame-stack pyramid.

    Each level is a ``(T+1, h_l, w_l)`` uint8 stack; frame ``t`` is tracked
    against anchor ``t+1``. The top level runs :func:`ebma` with range
    ``search_range // 2**(L-1)`` on ``2**(L-1)``-times-smaller blocks; every
    lower level doubles the MVs and refines around them with the same top
    range through K3, keeping the carried min-MAD.

    Returns ``(mv (T, mfh, mfw, 2), min_mad (T, mfh, mfw))``.
    """
    level_count = len(pyramid_stack)
    factor = 1 << (level_count - 1)
    if search_range < factor:
        raise ValueError(
            "search range must be >= the top level reduction factor"
        )
    if block_w % factor or block_h % factor:
        raise ValueError(
            "block dims must be divisible by the top level reduction factor"
        )
    top_range = search_range // factor
    top = pyramid_stack[-1]
    mv, min_mad = ebma(
        top[:-1], top[1:], top_range, block_w // factor, block_h // factor
    )
    r = top_range
    for lvl in range(level_count - 2, -1, -1):
        scale = 1 << lvl
        mv = mv * 2.0
        bw, bh = block_w // scale, block_h // scale
        stack = pyramid_stack[lvl]
        fh, fw = stack.shape[1:]
        area = torch.tensor(float(bw * bh), dtype=torch.float32, device=stack.device)
        sads = refine_sads(stack, torch.round(mv).to(torch.int32), r, bw, bh)
        mads = sads.to(torch.float32) / area
        mv, min_mad = _refine_select(mads, mv, min_mad, r, bw, bh, fh, fw)
    return mv, min_mad
