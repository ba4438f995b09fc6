"""Frame padding to codec-aligned dimensions (``svc_tpu/ops/pad.py``).

Padded dims divide both the MV block size and the top pyramid level's
reduction factor; the pad is constant zero on the bottom/right
(``cv::copyMakeBorder(..., BORDER_CONSTANT, 0)``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from svc_tpu_torch.utils.mathx import closest_larger_divisible, pow2


def padded_dims(
    frame_w: int,
    frame_h: int,
    mv_block_w: int,
    mv_block_h: int,
    pyr_lvl_count: int,
) -> Tuple[int, int]:
    """Padded (w, h) per the reference's LCM rule."""
    factor = pow2(pyr_lvl_count - 1)
    return (
        closest_larger_divisible(frame_w, mv_block_w, factor),
        closest_larger_divisible(frame_h, mv_block_h, factor),
    )


def pad_frame(frame: torch.Tensor, padded_w: int, padded_h: int) -> torch.Tensor:
    """Zero-pad ``(..., H, W, C)`` (C <= 4) or ``(..., H, W)`` on bottom/right."""
    if frame.ndim >= 3 and frame.shape[-1] <= 4:
        h, w = frame.shape[-3], frame.shape[-2]
        pad = (0, 0, 0, padded_w - w, 0, padded_h - h)
    else:
        h, w = frame.shape[-2], frame.shape[-1]
        pad = (0, padded_w - w, 0, padded_h - h)
    if not any(pad):
        return frame
    return F.pad(frame, pad, mode="constant", value=0)
