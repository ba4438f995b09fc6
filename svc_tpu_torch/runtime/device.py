"""Resolve the device a public entry point runs on.

``svc_tpu`` leaves device choice to JAX's default backend; the port takes an
explicit ``device`` on every entry. A request for ``cuda`` without a usable
card is an error: nothing silently runs on the CPU in its place.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``, checking that it can run.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for device
    types the port does not run on (anything but ``cpu`` and ``cuda``).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is False)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device type {dev.type!r}: svc_tpu_torch runs on "
            "'cpu' (plain PyTorch) or 'cuda' (hand-written kernels)"
        )
    return dev


def device_scope(device: torch.device):
    """Make ``device`` current for the work queued inside (``cuda``: the
    kernels launch on its context and its current stream); a no-op on the
    CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
