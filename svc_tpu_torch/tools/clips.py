"""Synthetic "real-like" clip generator for the port's smoke test and
profiler (a copy of ``benchmarks/clips.make_clip``: the same seed gives the
same frames).

Content model: a fine-textured background with a slow global pan (exercises
RANSAC global motion, reference motion.cpp:182-266) plus several independently
moving textured rectangles (exercises foreground segmentation,
encoder.cpp:507-623). Dimensions divisible by 16 give zero LCM padding
(math.hpp:276-283), which is the regime where the reference's serializer is
self-consistent (SURVEY.md Q4).
"""

from __future__ import annotations

import numpy as np


def make_clip(w: int, h: int, n: int, seed: int = 7) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames: textured pan + 6 moving objects."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 4, w // 8 + 4, 3), dtype=np.uint8)
    bg = np.kron(base, np.ones((8, 8, 1), dtype=np.uint8))
    fine = rng.integers(0, 32, (bg.shape[0], bg.shape[1], 3), dtype=np.uint8)
    bg = np.clip(bg.astype(np.int16) + fine - 16, 0, 255).astype(np.uint8)

    objs = []
    for _ in range(6):
        ow = int(rng.integers(w // 16, w // 6))
        oh = int(rng.integers(h // 16, h // 6))
        tex = rng.integers(0, 256, (oh, ow, 3), dtype=np.uint8)
        x = float(rng.integers(0, w - ow))
        y = float(rng.integers(0, h - oh))
        vx = float(rng.uniform(-4, 4))
        vy = float(rng.uniform(-3, 3))
        objs.append([tex, x, y, vx, vy, ow, oh])

    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        panx, pany = (t * 2) % 8, t % 8
        fr = bg[pany : pany + h, panx : panx + w].copy()
        for o in objs:
            tex, x, y, _, _, ow, oh = o
            xi = int(x) % (w - ow)
            yi = int(y) % (h - oh)
            fr[yi : yi + oh, xi : xi + ow] = tex
            o[1] += o[3]
            o[2] += o[4]
        frames[t] = fr
    return frames
