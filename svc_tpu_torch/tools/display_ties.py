"""Display bytes on rounding ties: where two correct decodes may differ.

The display path rounds the float32 decode (dequantize, inverse DCT, row
lerp) half to even. Where the exact value is ``k + 1/2``, the float32
rounding of the transform decides the byte, and two correct versions
that sum in different orders land on ``k`` and ``k + 1``. Dequantized
coefficients are integers, and at 2x2 transform blocks the inverse DCT
is ``(±a ± b ± c ± d) / 2``: a large share of bytes are ties, against a
few in ten thousand at 4x4 to 16x16.

:func:`exact_display` is the decode in float64 before its rounding;
:func:`tie_mask` marks the bytes whose exact value is a tie. Run on the
card, the module decodes seeded wire payloads at 352x288 with 2x2 blocks
(the general K1), through the kernel, the plain version on the card and
the plain version on the CPU, and prints a JSON line with the share of
bytes each pair differs on, the share of those that are ties, and each
one's bytes against the exact value rounded. A width that is not a
multiple of 16 takes the decoder's width-excess route (K6, both axes
resampled; the exact decode through the column resample too)::

    python -m svc_tpu_torch.tools.display_ties [--block 2] [--width 120 --height 64]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from svc_tpu_torch.config import DecoderConfig
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.ops import dct
from svc_tpu_torch.ops.pad import padded_dims
from svc_tpu_torch.ops.quant import dequantize
from svc_tpu_torch.ops.resize import bilinear_axis_weights

# |exact - (k + 1/2)| below this is a tie: above the float32 decode's error
# at display magnitudes (~1e-4), so that a float32 decode may round such a
# byte either way and nowhere else
TIE_TOL = 1e-3


def wire_payloads(w: int, h: int, block: int, n: int, seed: int):
    """A header and ``n`` payloads of seeded coefficients and block types
    (the transform grid as the MV field), with one gaze each."""
    pw, ph = padded_dims(w, h, 16, 16, 4)
    header = bitstream.Header(n, w, h, pw - w, ph - h, block, block, 3)
    nby, nbx = ph // block, pw // block
    rng = np.random.default_rng(seed)
    payloads = [
        bitstream.serialize_frame_blocks(
            (rng.normal(size=(nby, nbx, 3, block, block)) * 90).astype(np.float32),
            rng.integers(0, 3, (nby, nbx)).astype(np.uint32), block, block)
        for _ in range(n)
    ]
    gazes = [(int(rng.integers(0, w)), int(rng.integers(0, h))) for _ in range(n)]
    return header, payloads, gazes


def decode_inputs(header, payloads: List[bytes],
                  gazes: List[Tuple[int, int]]):
    """The wire coefficients ``(T, nby, nbx, C*B*B)`` and per-block steps
    ``(T, nby, nbx)`` a :class:`Decoder` hands K1 for these payloads, on
    the CPU."""
    from svc_tpu_torch.models.decoder import Decoder

    dec = Decoder(DecoderConfig(), header, batch_size=len(payloads),
                  device="cpu")
    parsed = [bitstream.deserialize_frame_blocks(p, header) for p in payloads]
    coeffs = np.stack([c.reshape(c.shape[0], c.shape[1], -1) for _, c in parsed])
    types = np.stack([t for t, _ in parsed])
    rects = np.asarray([dec.padded_gaze_rect(g) for g in gazes], np.int32)
    steps = dec._steps(torch.from_numpy(types), torch.from_numpy(rects))
    return torch.from_numpy(coeffs), steps


def exact_display(coeffs: torch.Tensor, steps: torch.Tensor, out_h: int,
                  channels: int, block_h: int, block_w: int,
                  out_w: Optional[int] = None) -> np.ndarray:
    """K1's decode in float64, before the display rounding: ``(T, out_h,
    W*C)`` values in the packed byte layout, through the float64 DCT
    matrix; with ``out_w``, K6's: the columns resampled too, to ``(T,
    out_h, out_w*C)``. The dequantized coefficients and the lerp fractions
    (float32 by contract) are exact in float64."""
    c = coeffs.cpu().double()
    q = dequantize(c, steps.cpu().double()[..., None])
    t, nby, nbx, _ = c.shape
    blocks = q.reshape(t, nby, nbx, channels, block_h, block_w)
    dh = torch.from_numpy(dct.dct_matrix(block_h, np.float64))
    dw = torch.from_numpy(dct.dct_matrix(block_w, np.float64))
    x = torch.matmul(torch.matmul(dh.T, blocks), dw)
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(
        t, channels, nby * block_h, nbx * block_w)
    y0, y1, fy, ident = bilinear_axis_weights(out_h, x.shape[2])
    top = x[:, :, torch.as_tensor(y0, dtype=torch.int64)]
    if not ident:
        f = torch.from_numpy(fy.astype(np.float64))[:, None]
        top = top * (1 - f) + x[:, :, torch.as_tensor(y1, dtype=torch.int64)] * f
    if out_w is not None:
        x0, x1, fx, ident = bilinear_axis_weights(out_w, top.shape[3])
        left = top[..., torch.as_tensor(x0, dtype=torch.int64)]
        if not ident:
            f = torch.from_numpy(fx.astype(np.float64))
            left = (left * (1 - f)
                    + top[..., torch.as_tensor(x1, dtype=torch.int64)] * f)
        top = left
    return top.permute(0, 2, 3, 1).reshape(t, out_h, -1).numpy()


def tie_mask(exact: np.ndarray) -> np.ndarray:
    """True where the exact value is a tie the display rounding keeps
    (inside the clip range): either neighbour is a right answer there."""
    frac = np.abs(exact - np.floor(exact) - 0.5)
    return (frac < TIE_TOL) & (exact > -0.5) & (exact < 255.5)


def rounded(exact: np.ndarray) -> np.ndarray:
    """The exact value rounded half to even and clipped, as display bytes."""
    return np.clip(np.round(exact), 0, 255).astype(np.uint8)


def compare(a: np.ndarray, b: np.ndarray, ties: np.ndarray) -> dict:
    """Share of bytes ``a`` and ``b`` differ on, the share of those that
    are ties, and the largest difference."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    n = int((d > 0).sum())
    return {"differ": n / d.size, "on_ties": int((d[ties] > 0).sum()) / max(n, 1),
            "off_ties": int((d[~ties] > 0).sum()) / d.size,
            "max": int(d.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=352)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--block", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h, b = args.width, args.height, args.block
    header, payloads, gazes = wire_payloads(w, h, b, 7, seed=w)
    coeffs, steps = decode_inputs(header, payloads, gazes)
    # the decoder's route: K1 where the padded width is the frame's, else K6
    out_w = None if coeffs.shape[2] * b == w else w

    def decode(c, s, plain):
        if out_w is None:
            fn = dct.idct_display_plain if plain else dct.idct_display
            return fn(c, s, h, 3, b, b)
        if plain:
            return dct.idct_resize_display_plain(c, s, h, w, 3, b, b)
        return dct.idct_resize_display(c, s, h, w, 3, b, b)

    exact = exact_display(coeffs, steps, h, 3, b, b, out_w)
    ties = tie_mask(exact)
    cpu = decode(coeffs, steps, True).numpy()
    out = {"shape": [w, h, b, 7], "ties": float(ties.mean()),
           "cpu_plain_vs_exact": compare(cpu, rounded(exact), ties)}
    if args.device != "cpu":
        dev = torch.device(args.device)
        cd, sd = coeffs.to(dev), steps.to(dev)
        kern = decode(cd, sd, False).cpu().numpy()
        plain = decode(cd, sd, True).cpu().numpy()
        out.update({
            "kernel_vs_cpu_plain": compare(kern, cpu, ties),
            "card_plain_vs_cpu_plain": compare(plain, cpu, ties),
            "kernel_vs_card_plain": compare(kern, plain, ties),
            "kernel_vs_exact": compare(kern, rounded(exact), ties),
            "card_plain_vs_exact": compare(plain, rounded(exact), ties),
        })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
