"""Binary morphology on the MV-grid foreground mask
(``svc_tpu/ops/morphology.py``).

Rect-SE close followed by open (``cv::morphologyEx`` with
``MORPH_RECT``). Border pixels never constrain an erosion nor feed a
dilation (OpenCV's default border); the window anchor is ``k // 2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(mask: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Rect-SE binary dilation of a bool ``(..., H, W)`` mask."""
    ay, ax = kh // 2, kw // 2
    lead = mask.shape[:-2]
    x = mask.reshape((-1, 1) + tuple(mask.shape[-2:])).to(torch.float32)
    x = F.pad(x, (ax, kw - 1 - ax, ay, kh - 1 - ay), value=0.0)
    x = F.max_pool2d(x, kernel_size=(kh, kw), stride=1)
    return (x > 0).reshape(lead + tuple(mask.shape[-2:]))


def erode(mask: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """Rect-SE binary erosion: the complement of dilating the complement
    (out-of-frame cells count as set, so the border never erodes)."""
    return ~dilate(~mask, kw, kh)


def close_then_open(mask: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """The encoder's exact sequence: close (dilate, erode), then open
    (erode, dilate)."""
    closed = erode(dilate(mask, kw, kh), kw, kh)
    return dilate(erode(closed, kw, kh), kw, kh)
