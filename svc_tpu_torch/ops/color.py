"""BGR -> luma (Y), bit-exact with OpenCV (``svc_tpu/ops/color.py``).

OpenCV's 8-bit path uses 14-bit fixed-point BT.601 luma weights with
round-half-up descaling: ``Y = (R*4899 + G*9617 + B*1868 + 2**13) >> 14``.
"""

from __future__ import annotations

import torch

_R2Y = 4899
_G2Y = 9617
_B2Y = 1868
_SHIFT = 14


def bgr_planes_to_y(
    b: torch.Tensor, g: torch.Tensor, r: torch.Tensor
) -> torch.Tensor:
    """OpenCV-exact uint8 luma from separate uint8 channel planes."""
    y = (
        r.to(torch.int32) * _R2Y
        + g.to(torch.int32) * _G2Y
        + b.to(torch.int32) * _B2Y
        + (1 << (_SHIFT - 1))
    ) >> _SHIFT
    return y.to(torch.uint8)
