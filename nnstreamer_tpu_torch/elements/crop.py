"""tensor_crop: crop regions of a frame, driven by a second stream.

Port of ``nnstreamer_tpu/elements/crop.py`` (reference:
``gsttensor_crop.c``): ``sink_0`` (raw) carries the frames, ``sink_1``
(info) the ``[x, y, w, h]`` regions, e.g. from the ``tensor_region``
decoder; the runtime pairs one buffer of each (``sync_policy="all"``).
The output is FLEXIBLE: one tensor per region, ``(h, w, C)`` of the
frame, clipped to it (a region outside it crops to nothing).

The raw tensor reads video-style: dims ``(C, W, H, N)``, shape
``(N, H, W, C)``, x and y index W and H, and a batch crops its first
frame.  A frame is a numpy array or a torch tensor on any device; each
crop is a copy on the frame's side, never a view of it, so a crop does
not change if the frame's memory is written later.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_element
from ..core.types import TensorFormat, TensorsSpec
from .base import Element, ElementError, SRC


@register_element("tensor_crop")
class TensorCrop(Element):
    kind = "tensor_crop"
    sync_policy = "all"

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        caps = Caps.new(MediaType.FLEX_TENSORS)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process_group(self, bufs: Dict[str, Buffer]):
        pads = sorted(bufs)
        if len(pads) < 2:
            raise ElementError(
                "tensor_crop needs raw (sink_0) and info (sink_1) pads")
        frame = bufs[pads[0]].tensors[0]
        if not isinstance(frame, torch.Tensor):
            frame = np.asarray(frame)
        info = _to_numpy(bufs[pads[1]].tensors[0]).reshape(-1, 4)
        if frame.ndim < 2:
            raise ElementError("tensor_crop raw tensor must be at least rank 2")
        if frame.ndim == 4:  # (N, H, W, C): the batch's first frame
            frame = frame[0]
        if frame.ndim == 2:
            frame = frame[:, :, None]
        h, w = frame.shape[0], frame.shape[1]
        crops = []
        for x, y, cw, ch in info.astype(np.int64):
            x0, y0 = int(np.clip(x, 0, w)), int(np.clip(y, 0, h))
            x1, y1 = int(np.clip(x + cw, 0, w)), int(np.clip(y + ch, 0, h))
            crop = frame[y0:y1, x0:x1, :]
            crops.append(crop.clone() if isinstance(crop, torch.Tensor)
                         else crop.copy())
        out = bufs[pads[0]].with_tensors(
            crops, spec=TensorsSpec.of(crops, format=TensorFormat.FLEXIBLE))
        return [(SRC, out)]
