"""Region/gaze-adaptive quantization (``svc_tpu/ops/quant.py``).

Per transform block the decoder picks a step — 1 inside the gaze rectangle,
else the background step for background blocks and the foreground step for
the rest — and dequantizes every coefficient as ``round(c / step) * step``
with C ``std::round`` (halves away from zero) and true IEEE division
(libs/decoder.cpp:128-149).
"""

from __future__ import annotations

import torch

from svc_tpu.io.bitstream import BLOCK_TYPE_BACKGROUND


def dequantize(coeffs: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """``copysign(floor(|c / s| + 0.5) * s, c / s)`` — round half away
    from zero; ``step`` (> 0) broadcasts against ``coeffs``."""
    y = coeffs / step
    return torch.copysign(torch.floor(torch.abs(y) + 0.5) * step, y)


def block_quant_steps(
    block_types: torch.Tensor, gazed: torch.Tensor, fg_step: int, bg_step: int
) -> torch.Tensor:
    """Float32 per-block steps from ``(..., nby, nbx)`` wire block types and
    the gaze mask (block top-left inside the gaze rect)."""
    steps = torch.where(
        block_types == BLOCK_TYPE_BACKGROUND,
        torch.tensor(float(bg_step), dtype=torch.float32),
        torch.tensor(float(fg_step), dtype=torch.float32),
    ).to(block_types.device)
    return torch.where(gazed, torch.ones((), device=steps.device), steps)
