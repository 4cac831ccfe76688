"""pose_estimation decoder: heatmaps -> keypoints + skeleton overlay.

Port of ``nnstreamer_tpu/decoders/pose.py`` (reference:
``tensordec-pose.c``, BASELINE config #3): per-keypoint heatmaps ->
argmax locations scaled to the output size -> keypoint dots and bone
lines on an RGBA overlay; the keypoints in ``meta["keypoints"]``.

Input contract: heatmaps ``(H', W', K)`` (batched ``[B, H', W', K]``),
PoseNet-style; an optional second tensor of short-range offsets is added
when present.  As in the JAX package, the offsets read are the first
``2K`` values of the offset tensor, in pairs (the ``2K`` channels of cell
(0, 0)), whichever cell each keypoint's argmax picked: a quirk of the
reference this port keeps, on the host path and the fused one alike.

Options: option1=labels (keypoint names; unused), option2=WIDTH:HEIGHT of
the overlay (default 640:480), option3=score threshold (default 0.3),
option4=output form (``overlay`` default | ``tensors``: the keypoint
coordinates themselves, (x f32 [K], y f32 [K], score f32 [K]), batched
``[B, K]``, and no canvas).

Fused (``device_fn``): the heatmap argmax (the first maximum, as
``jnp.argmax``), its score and the offset pairs run on the device, and
only ``[B, K]`` values cross to the host (one packed ``[B, K, 2(+2)]``
f32 tensor with ``option4=tensors``); ``host_post`` maps them to
coordinates, keypoint dicts and the batched overlay at the sink.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_decoder
from ..core.types import TensorSpec, TensorsSpec
from .base import Decoder

# COCO-17 skeleton bones (keypoint index pairs)
_BONES = [
    (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14), (14, 16),
]
_GREEN = np.array([60, 220, 60, 255], np.uint8)
_WHITE = np.array([255, 255, 255, 255], np.uint8)


@register_decoder("pose_estimation")
class PoseEstimation(Decoder):
    mode = "pose_estimation"

    def __init__(self, props):
        super().__init__(props)
        size = self.option(2) or "640:480"
        w, h = size.split(":")
        self.out_w, self.out_h = int(w), int(h)
        self.threshold = float(self.option(3) or 0.3)
        out_mode = (self.option(4) or "overlay").lower()
        if out_mode not in ("overlay", "tensors"):
            raise ValueError(f"option4 (output form) must be "
                             f"overlay|tensors, got {out_mode!r}")
        self.out_mode = out_mode

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        if self.out_mode == "tensors":
            return Caps.tensors()
        return Caps.new(
            MediaType.VIDEO, format="RGBA", width=self.out_w, height=self.out_h
        )

    # -- host path ---------------------------------------------------------
    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        hm = _to_numpy(tensors[0]).astype(np.float32, copy=False)
        if hm.ndim > 3:
            # batched heatmaps [..., H', W', K]: decode each frame
            lead = hm.shape[: hm.ndim - 3]
            n = int(np.prod(lead))
            frames = hm.reshape((n,) + hm.shape[-3:])
            if n > 1:
                rest = [_to_numpy(t) for t in tensors[1:]]
                per_frame, kps = [], []
                for i in range(n):
                    sub = [frames[i]] + [
                        t[i] if t.shape[:1] == (n,) else t for t in rest
                    ]
                    o = self._decode_one(sub, buf)
                    per_frame.append(o.tensors)
                    kps.append(o.meta["keypoints"])
                # every output tensor stacked over the frames (overlay:
                # one; tensors: x, y and score)
                stacked = [np.stack([f[t] for f in per_frame])
                           for t in range(len(per_frame[0]))]
                out = buf.with_tensors(stacked, spec=None)
                out.meta["keypoints"] = kps
                return out
            hm = frames[0]
        return self._decode_one([hm] + [_to_numpy(t) for t in tensors[1:]], buf)

    def _coords(self, idx, off, hh: int, hw: int):
        """Flat heatmap argmax indices [..., K] -> (px, py) overlay pixel
        coordinates: the one place the scale and offset math lives (the
        host decode and the fused ``host_post`` both call it)."""
        ys, xs = np.unravel_index(idx, (hh, hw))
        px = (xs + 0.5) / hw * self.out_w
        py = (ys + 0.5) / hh * self.out_h
        if off is not None:  # short-range offsets (..., K, 2) in cells
            px = px + off[..., 0] / hw * self.out_w
            py = py + off[..., 1] / hh * self.out_h
        return px, py

    def _keypoints(self, idx, scores, off, hh: int, hw: int):
        px, py = self._coords(idx, off, hh, hw)
        return [
            {"x": float(px[i]), "y": float(py[i]), "score": float(scores[i])}
            for i in range(len(idx))
        ]

    def _decode_one(self, tensors: List[np.ndarray], buf: Buffer) -> Buffer:
        hm = np.asarray(tensors[0], np.float32)
        hh, hw, k = hm.shape
        flat = hm.reshape(-1, k)
        idx = flat.argmax(axis=0)
        scores = flat[idx, np.arange(k)]
        off = (np.asarray(tensors[1], np.float32).reshape(-1, 2)[:k]
               if len(tensors) > 1 else None)
        keypoints = self._keypoints(idx, scores, off, hh, hw)
        if self.out_mode == "tensors":
            px, py = self._coords(idx, off, hh, hw)
            out = buf.with_tensors(
                [px.astype(np.float32), py.astype(np.float32),
                 scores.astype(np.float32)], spec=None)
        else:
            out = buf.with_tensors([self._draw(keypoints)], spec=None)
        out.meta["keypoints"] = keypoints
        return out

    # -- fusion ------------------------------------------------------------
    def device_fn(self, in_spec: TensorsSpec):
        shape = in_spec[0].shape
        if len(shape) != 4:
            return None
        batch, hh, hw, k = shape
        self._fused_grid = (hh, hw)
        have_off = len(in_spec) > 1
        pack = self.out_mode == "tensors"

        def fn(arrays):
            hm = arrays[0].float()
            b = hm.shape[0]
            flat = hm.reshape(b, -1, k)
            idx = torch.argmax(flat, dim=1)  # [B, K], the first maximum
            score = torch.gather(flat, 1, idx[:, None, :])[:, 0]
            outs = [idx.to(torch.int32), score]
            if have_off:
                outs.append(arrays[1].float().reshape(b, -1, 2)[:, :k])
            if pack:
                # ONE [B, K, 2(+2)] f32 payload (idx, score[, off]): one
                # copy to the host; idx as f32 is exact (cells << 2^24)
                cols = [outs[0].float()[..., None], outs[1][..., None]]
                if have_off:
                    cols.append(outs[2])
                return (torch.cat(cols, dim=-1),)
            return tuple(outs)

        if pack:
            return fn, TensorsSpec((TensorSpec.from_shape(
                (batch, k, 4 if have_off else 2), np.float32),))
        specs = [
            TensorSpec.from_shape((batch, k), np.int32),
            TensorSpec.from_shape((batch, k), np.float32),
        ]
        if have_off:
            specs.append(TensorSpec.from_shape((batch, k, 2), np.float32))
        return fn, TensorsSpec(tuple(specs))

    def host_post(self, arrays, buf: Buffer) -> Buffer:
        hh, hw = self._fused_grid
        if len(arrays) == 1:  # packed tensors-mode payload [B, K, 2(+2)]
            p = np.asarray(arrays[0], np.float32)
            idx = p[..., 0].astype(np.int64)
            scores = p[..., 1]
            off = p[..., 2:4] if p.shape[-1] >= 4 else None
        else:
            idx = np.asarray(arrays[0])
            scores = np.asarray(arrays[1], np.float32)
            off = (np.asarray(arrays[2], np.float32)
                   if len(arrays) > 2 else None)
        b, k = idx.shape
        px, py = self._coords(idx, off, hh, hw)
        if self.out_mode == "tensors":
            return buf.with_tensors(
                [px.astype(np.float32), py.astype(np.float32),
                 scores.astype(np.float32)], spec=None)
        kps_all = [
            [{"x": float(px[i, j]), "y": float(py[i, j]),
              "score": float(scores[i, j])} for j in range(k)]
            for i in range(b)
        ]
        overlays = self._draw_batch(px, py, scores)  # [B, H, W, 4]
        if b == 1:
            new = buf.with_tensors([overlays[0]], spec=None)
            new.meta["keypoints"] = kps_all[0]
            return new
        new = buf.with_tensors([overlays], spec=None)
        new.meta["keypoints"] = kps_all
        return new

    # -- drawing -----------------------------------------------------------
    def _draw_batch(self, px, py, scores, n: int = 64) -> np.ndarray:
        """Every frame's overlay in a few vectorized scatters, pixel-equal
        to a per-frame :meth:`_draw` (bones first, then dots, the same
        clipping).  px/py/scores: [B, K]."""
        b, k = px.shape
        h, w = self.out_h, self.out_w
        overlay = np.zeros((b, h, w, 4), np.uint8)
        ok = scores >= self.threshold  # [B, K]
        fi = np.arange(b)[:, None]
        for a, c in _BONES:
            if a >= k or c >= k:
                continue
            # [B, n] line points per frame: np.linspace with array ends,
            # the same values as the per-frame _line
            xs = np.linspace(px[:, a], px[:, c], n, axis=1).astype(int)
            ys = np.linspace(py[:, a], py[:, c], n, axis=1).astype(int)
            m = (ok[:, a] & ok[:, c])[:, None] & (xs >= 0) & (xs < w) & \
                (ys >= 0) & (ys < h)
            fr = np.broadcast_to(fi, xs.shape)
            overlay[fr[m], ys[m], xs[m]] = _WHITE
        # dots: a 6x6 patch at each confident keypoint (rows y-3..y+2)
        dy, dx = np.meshgrid(np.arange(-3, 3), np.arange(-3, 3), indexing="ij")
        yy = py.astype(int)[:, :, None, None] + dy  # [B, K, 6, 6]
        xx = px.astype(int)[:, :, None, None] + dx
        m = ok[:, :, None, None] & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        fr = np.broadcast_to(np.arange(b)[:, None, None, None], yy.shape)
        overlay[fr[m], yy[m], xx[m]] = _GREEN
        return overlay

    def _draw(self, kps) -> np.ndarray:
        overlay = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        for a, b in _BONES:
            if a < len(kps) and b < len(kps):
                ka, kb = kps[a], kps[b]
                if ka["score"] >= self.threshold and kb["score"] >= self.threshold:
                    self._line(overlay, ka, kb, _WHITE)
        for kp in kps:
            if kp["score"] >= self.threshold:
                x, y = int(kp["x"]), int(kp["y"])
                # clamp both ends: a negative stop would wrap around
                overlay[
                    max(0, y - 3) : max(0, y + 3),
                    max(0, x - 3) : max(0, x + 3),
                ] = _GREEN
        return overlay

    def _line(self, img, ka, kb, color, n: int = 64):
        xs = np.linspace(ka["x"], kb["x"], n).astype(int)
        ys = np.linspace(ka["y"], kb["y"], n).astype(int)
        m = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
        img[ys[m], xs[m]] = color
