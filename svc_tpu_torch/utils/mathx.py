"""Scalar/shape math helpers used across the port (a copy of
``svc_tpu/utils/mathx.py``).

Counterpart of the reference's header-only math layer (reference:
libs/math.hpp:10-291). Only the pieces that influence codec geometry and
numerics are re-provided; vector arithmetic is plain PyTorch in the port.
"""

from __future__ import annotations

import math


def pow2(exp: int) -> int:
    """2**exp for small non-negative ints (reference: libs/math.hpp:10-13)."""
    return 1 << exp


def closest_larger_divisible(a: int, x: int, y: int) -> int:
    """Smallest value >= ``a`` divisible by both ``x`` and ``y``.

    Used to compute padded frame dims that divide both the MV block size and
    the top pyramid level reduction factor
    (reference: libs/math.hpp:276-283, call site libs/encoder.cpp:165-172).
    """
    if x == 0 or y == 0:
        raise ValueError("divisors must be nonzero")
    lcm = math.lcm(x, y)
    return ((a + lcm - 1) // lcm) * lcm


def round_half_away_from_zero(a: float) -> int:
    """C ``std::round`` semantics: halves round away from zero.

    Python's ``round`` is banker's rounding; the reference relies on C
    rounding in MV conversion and quantization
    (reference: libs/math.hpp:15-18, libs/decoder.cpp:142).
    """
    return int(math.floor(a + 0.5)) if a >= 0 else int(math.ceil(a - 0.5))


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)
