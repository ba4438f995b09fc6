"""The encoder pipeline on torch tensors (``svc_tpu/models/encoder.py``).

Per batch of ``T + 1`` frames (frame ``t`` tracked against anchor
``t + 1``; frame 0 is the overlap frame, never emitted):

    BGR -> luma -> pad -> pyramid (K4) -> HBMA (top-level EBMA, then K3 per
    refinement level) -> RANSAC global motion -> foreground = outliers ->
    close/open -> k-means of foreground motion features -> per-cluster
    connected components -> block types; forward DCT of frames 1..T (K2)

Randomness: anchor ``i`` draws from ``fold_in(key(cfg.seed), i)``, split
into the RANSAC and k-means keys — the same derivation as ``svc_tpu``, so
both packages emit the same bitstream for the same input and config.

This slice implements ``EncoderConfig(reference_compat=True)``: k-means
features in the reference's effective ``(0, mv.x, x, y)`` layout (quirk Q1)
with cv::kmeans' split-the-biggest-cluster repair. The default config's
``global_farthest`` repair runs kernel K5 in ``svc_tpu``, not ported yet,
so the encoder raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from svc_tpu.config import EncoderConfig, VideoProperties
from svc_tpu.io import bitstream
from svc_tpu_torch.ops import prng
from svc_tpu_torch.ops.ccl import block_types_from_clusters
from svc_tpu_torch.ops.color import bgr_planes_to_y
from svc_tpu_torch.ops.dct import dct8x8_to_wire
from svc_tpu_torch.ops.kmeans import K5_MESSAGE, kmeans_t_frames
from svc_tpu_torch.ops.morphology import close_then_open
from svc_tpu_torch.ops.motion import hbma_stack
from svc_tpu_torch.ops.pad import pad_frame, padded_dims
from svc_tpu_torch.ops.pyramid import build_pyramid
from svc_tpu_torch.ops.ransac import estimate_global_motion_ransac, iter_count
from svc_tpu_torch.runtime.device import DeviceLike, resolve_device


class Encoder:
    """Batched video encoder.

    Args:
      cfg: validated ``EncoderConfig`` with ``reference_compat=True``.
      vidprops: source video properties.
      batch_size: anchor frames encoded per batch.
      device: ``"cuda"`` (kernels) or ``"cpu"`` (plain PyTorch versions).
    """

    def __init__(
        self,
        cfg: EncoderConfig,
        vidprops: VideoProperties,
        batch_size: int = 8,
        device: DeviceLike = "cuda",
    ):
        if not cfg.reference_compat:
            raise NotImplementedError(K5_MESSAGE.format("global_farthest"))
        if iter_count(cfg.ransac) == 0:
            raise ValueError(
                "RANSAC parameters yield zero hypotheses; nothing to fit"
            )
        self.cfg = cfg
        self.vidprops = vidprops
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.padded_w, self.padded_h = padded_dims(
            vidprops.frame_w,
            vidprops.frame_h,
            cfg.mv_block_w,
            cfg.mv_block_h,
            cfg.pyr_lvl_count,
        )
        self.excess_w = self.padded_w - vidprops.frame_w
        self.excess_h = self.padded_h - vidprops.frame_h
        self.mv_field_w = self.padded_w // cfg.mv_block_w
        self.mv_field_h = self.padded_h // cfg.mv_block_h

    def header(self, frame_count: Optional[int] = None) -> bitstream.Header:
        """Bitstream header; the first frame is reference-only, so the
        stream carries ``frame_count - 1`` payloads unless overridden."""
        if frame_count is None:
            frame_count = self.vidprops.frame_count
            if frame_count > 0:
                frame_count -= 1
        return bitstream.Header(
            frame_count=frame_count,
            frame_w=self.vidprops.frame_w,
            frame_h=self.vidprops.frame_h,
            frame_excess_w=self.excess_w,
            frame_excess_h=self.excess_h,
            transform_block_w=self.cfg.transform_block_w,
            transform_block_h=self.cfg.transform_block_h,
            channel_count=3,
        )

    def _keys(self, start_index: int, count: int) -> torch.Tensor:
        """``(count, 2)`` anchor keys ``fold_in(key(seed), i)``."""
        idx = torch.arange(start_index, start_index + count, device=self.device)
        return prng.fold_in(prng.key(self.cfg.seed, self.device), idx)

    def encode_batch(
        self, frames_bgr, first_anchor_index: int
    ) -> Dict[str, torch.Tensor]:
        """Encode ``(T+1, H, W, 3)`` uint8 BGR frames (numpy or tensor);
        anchor ``t`` of the batch has stream index ``first_anchor_index + t``.
        """
        frames = torch.as_tensor(np.ascontiguousarray(frames_bgr))
        n, h, w, c = frames.shape
        packed = frames.reshape(n, h, w * c).to(self.device)
        return self.encode_packed(packed, first_anchor_index)

    def encode_packed(
        self, packed: torch.Tensor, first_anchor_index: int
    ) -> Dict[str, torch.Tensor]:
        """Encode ``(T+1, H, W*3)`` uint8 packed rows already on the device."""
        cfg = self.cfg
        n, h, w3 = packed.shape
        t = n - 1
        mfh, mfw = self.mv_field_h, self.mv_field_w
        k = cfg.kmeans.cluster_count

        px = packed.reshape(n, h, w3 // 3, 3)
        y = bgr_planes_to_y(px[..., 0], px[..., 1], px[..., 2])
        y = pad_frame(y, self.padded_w, self.padded_h)
        pyr = build_pyramid(y, cfg.pyr_lvl_count)
        mv, _ = hbma_stack(pyr, cfg.mv_search_range, cfg.mv_block_w, cfg.mv_block_h)

        keys = prng.split(self._keys(first_anchor_index, t))  # (T, 2, 2)
        gm, rmse, inliers = estimate_global_motion_ransac(
            mv, cfg.ransac, keys[:, 0]
        )
        # foreground = RANSAC outliers, then morphological cleanup
        fg_raw = ~inliers
        fg = close_then_open(fg_raw, cfg.morph_rect_w, cfg.morph_rect_h)

        # k-means features per block, quirk Q1 layout (0, mv.x, x, y)
        dev = packed.device
        ys = (torch.arange(mfh, dtype=torch.float32, device=dev)[:, None]
              * cfg.mv_block_h).expand(mfh, mfw)
        xs = (torch.arange(mfw, dtype=torch.float32, device=dev)[None, :]
              * cfg.mv_block_w).expand(mfh, mfw)
        feats = torch.stack(
            [
                torch.zeros_like(mv[..., 0]),
                mv[..., 0],
                xs.expand(t, mfh, mfw),
                ys.expand(t, mfh, mfw),
            ],
            dim=1,
        ).reshape(t, 4, mfh * mfw)
        labels, _, _ = kmeans_t_frames(
            feats,
            fg.reshape(t, -1),
            k,
            keys[:, 1],
            attempts=cfg.kmeans.attempt_count,
            max_iter=cfg.kmeans.max_iter_count,
            epsilon=cfg.kmeans.epsilon,
            repair="opencv_split",
        )
        labels = labels.reshape(t, mfh, mfw)
        btypes, _ = block_types_from_clusters(
            labels, k, cfg.connected_components_connectivity
        )
        coeffs = dct8x8_to_wire(
            packed, 1, t, self.padded_h, self.padded_w,
            cfg.transform_block_h, cfg.transform_block_w, 3,
        )
        return {
            "coeffs": coeffs,
            "block_types": btypes,
            "mv_field": mv,
            "foreground_mask_raw": fg_raw,
            "foreground_mask": fg,
            "cluster_labels": labels,
            "global_motion": gm,
            "ransac_rmse": rmse,
        }

    def encode_video(
        self,
        frames: Iterator[np.ndarray],
        emit_header: bool = True,
        header_frame_count: Optional[int] = None,
        first_anchor_index: int = 0,
    ) -> Iterator[bytes]:
        """Stream encode: the header, then one payload per anchor frame."""
        return stream_encode(
            self,
            frames,
            emit_header=emit_header,
            header_frame_count=header_frame_count,
            first_anchor_index=first_anchor_index,
        )


def stream_encode(
    enc: Encoder,
    frames: Iterator[np.ndarray],
    emit_header: bool = True,
    header_frame_count: Optional[int] = None,
    first_anchor_index: int = 0,
) -> Iterator[bytes]:
    """Yield the header, then one wire payload per anchor frame.

    Frames are consumed ``batch_size + 1`` at a time; the last frame of a
    batch is the overlap (tracked-only) frame of the next. The final partial
    batch is padded with copies of its last frame and the surplus payloads
    are dropped. Synchronous: each batch is encoded, copied back and
    serialized before the next starts.
    """
    if emit_header:
        yield enc.header(header_frame_count).pack()

    cfg = enc.cfg
    batch = enc.batch_size
    anchor_index = first_anchor_index

    def run(window_frames: List[np.ndarray], n_valid: int) -> Iterator[bytes]:
        out = enc.encode_batch(np.stack(window_frames), anchor_index)
        c = out["coeffs"].cpu().numpy()
        t_, nby, nbx, _ = c.shape
        coeffs = c.reshape(
            t_, nby, nbx, -1, cfg.transform_block_h, cfg.transform_block_w
        )
        btypes = out["block_types"].cpu().numpy().astype(np.uint32)
        for i in range(n_valid):
            yield bitstream.serialize_frame_blocks(
                coeffs[i], btypes[i], cfg.mv_block_w, cfg.mv_block_h
            )

    window: List[np.ndarray] = []
    for frame in frames:
        window.append(np.asarray(frame, dtype=np.uint8))
        if len(window) == batch + 1:
            yield from run(window, batch)
            anchor_index += batch
            window = window[-1:]  # overlap frame
    remainder = len(window) - 1
    if remainder > 0:
        pad = [window[-1]] * (batch - remainder)
        yield from run(window + pad, remainder)
