"""direct_video and tensor_region decoders.

Port of ``nnstreamer_tpu/decoders/direct_video.py`` (reference:
``tensordec-directvideo.c``, ``tensordec-tensor_region.c``):

* ``direct_video`` reinterprets a ``uint8`` tensor ``C:W:H[:N]`` as one
  raw video frame (GRAY8, RGB or RGBA caps; the first frame of a batch);
* ``tensor_region`` turns a detector's corner boxes (``[..., 4]`` in
  [0, 1]) and scores (``[..., classes]``) into the ``[num, 4]`` uint32
  ``x, y, w, h`` pixel regions ``tensor_crop`` reads: anchors sorted by
  their best class score (numpy's ``argsort``, as the JAX package sorts,
  so ties fall as they fall there), the top ``option2`` taken, clipped to [0, 1] and scaled to
  ``option1=WIDTH:HEIGHT`` (default 640:480), zero rows padding the rest.

Both decode on the host; card tensors are fetched once per buffer by the
``tensor_decoder`` element.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_decoder
from ..core.types import TensorsSpec
from .base import Decoder


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
    return np.asarray(_to_numpy(t), np.float32)


@register_decoder("direct_video")
class DirectVideo(Decoder):
    mode = "direct_video"
    host_decode = True

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        fields = {}
        if in_spec is not None and len(in_spec) == 1:
            c, w, h = (list(in_spec[0].dims) + [1, 1, 1])[:3]
            fmt = {1: "GRAY8", 3: "RGB", 4: "RGBA"}.get(c)
            if fmt:
                fields = dict(format=fmt, width=w, height=h)
        return Caps.new(MediaType.VIDEO, **fields)

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        frame = np.asarray(_to_numpy(tensors[0]), np.uint8)
        if frame.ndim == 4:
            frame = frame[0]
        return buf.with_tensors([frame], spec=None)


def regions(boxes: np.ndarray, scores: Optional[np.ndarray], num: int,
            out_w: int, out_h: int) -> np.ndarray:
    """The ``tensor_region`` decode on host arrays -> ``[num, 4]`` uint32.
    Python floats as in the JAX package, so the pixels are its pixels."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    if scores is not None:
        best = np.asarray(scores, np.float32).reshape(boxes.shape[0], -1).max(axis=1)
        boxes = boxes[np.argsort(-best)]
    out = np.zeros((num, 4), np.uint32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:num]):
        out[i] = (int(np.clip(x1, 0, 1) * out_w), int(np.clip(y1, 0, 1) * out_h),
                  int(np.clip(x2 - x1, 0, 1) * out_w),
                  int(np.clip(y2 - y1, 0, 1) * out_h))
    return out


@register_decoder("tensor_region")
class TensorRegion(Decoder):
    """Detections -> crop regions for ``tensor_crop``: ``option1`` the
    pixel size ``WIDTH:HEIGHT``, ``option2`` the number of regions."""

    mode = "tensor_region"
    host_decode = True

    def __init__(self, props):
        super().__init__(props)
        w, h = (self.option(1) or "640:480").split(":")
        self.out_w, self.out_h = int(w), int(h)
        self.num = int(self.option(2) or 1)

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        return Caps.tensors(TensorsSpec.from_string(f"4:{self.num}", "uint32"))

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        scores = _f32(tensors[1]) if len(tensors) > 1 else None
        out = regions(_f32(tensors[0]), scores, self.num, self.out_w, self.out_h)
        return buf.with_tensors([out], spec=None)
