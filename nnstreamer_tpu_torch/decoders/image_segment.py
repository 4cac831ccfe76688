"""image_segment decoder: class scores -> class map or colored overlay.

Port of ``nnstreamer_tpu/decoders/image_segment.py`` (reference:
``tensordec-imagesegment.c``): per-pixel class scores ``(H, W, C)`` or
class ids ``(H, W)`` -> an RGBA palette overlay (``option1=overlay``, the
default) or the class ids themselves (``option1=classmap``: u8 while the
ids fit, else int32).  A leading batch of 1 is squeezed.  The host path
also takes a batch of score maps ``(B, H, W, C)``, which the JAX
package's refuses (it takes one frame a buffer, as the reference): the
maps come out stacked, as the fused path emits them, so an unfused
pipeline at batch B gives the fused one's output.

Fused (``device_fn``): the per-pixel argmax runs on the device, batched,
so one id a pixel crosses to the host; ``host_post`` gathers the palette
(overlay) or hands the map over as it is (classmap), a batch of one
squeezed to one frame.

``classmap`` admits any geometry (``admits_reduced_payload``): the
residency planner may feed it a model's native-stride score map.
``overlay`` is fixed-geometry RGBA media and does not.
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

_COLORS = np.array(
    [
        [0, 0, 0, 0],  # class 0 = background, transparent
        [230, 25, 75, 160], [60, 180, 75, 160], [255, 225, 25, 160],
        [0, 130, 200, 160], [245, 130, 48, 160], [145, 30, 180, 160],
        [70, 240, 240, 160], [240, 50, 230, 160], [210, 245, 60, 160],
        [250, 190, 190, 160], [0, 128, 128, 160], [230, 190, 255, 160],
        [170, 110, 40, 160], [255, 250, 200, 160], [128, 0, 0, 160],
        [170, 255, 195, 160], [128, 128, 0, 160], [255, 215, 180, 160],
        [0, 0, 128, 160], [128, 128, 128, 160],
    ],
    np.uint8,
)


@register_decoder("image_segment")
class ImageSegment(Decoder):
    mode = "image_segment"

    def __init__(self, props):
        super().__init__(props)
        out_mode = (self.option(1) or "overlay").lower()
        if out_mode not in ("overlay", "classmap"):
            raise ValueError(f"option1 (output form) must be "
                             f"overlay|classmap, got {out_mode!r}")
        self.out_mode = out_mode
        self.admits_reduced_payload = out_mode == "classmap"

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        if self.out_mode == "classmap":
            return Caps.tensors()
        return Caps.new(MediaType.VIDEO, format="RGBA")

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        x = np.squeeze(_to_numpy(tensors[0]))
        if x.ndim in (3, 4):  # ([B,] H, W, C) scores -> argmax
            classes = x.argmax(axis=-1)
        elif x.ndim == 2:
            classes = x.astype(np.int64)
        else:
            raise ValueError(f"image_segment expects rank 2/3/4, got {x.shape}")
        if self.out_mode == "classmap":
            # device_fn's dtype rule: u8 only when the ids fit
            n_cls = x.shape[-1] if x.ndim >= 3 else \
                int(classes.max(initial=0)) + 1
            dt = np.uint8 if n_cls <= 256 else np.int32
            out = buf.with_tensors([classes.astype(dt)], spec=None)
            out.meta["class_map"] = classes
            return out
        out = buf.with_tensors([_COLORS[classes % len(_COLORS)]], spec=None)
        out.meta["class_map"] = classes
        return out

    # -- fusion ------------------------------------------------------------
    def device_fn(self, in_spec: TensorsSpec):
        shape = in_spec[0].shape
        if len(shape) not in (3, 4):
            return None
        np_dtype = np.uint8 if shape[-1] <= 256 else np.int32
        dtype = torch.uint8 if shape[-1] <= 256 else torch.int32

        def fn(arrays):
            return (torch.argmax(arrays[0], dim=-1).to(dtype),)

        return fn, TensorsSpec((TensorSpec.from_shape(shape[:-1], np_dtype),))

    def host_post(self, arrays, buf: Buffer) -> Buffer:
        classes = np.asarray(arrays[0])
        if classes.ndim == 3 and classes.shape[0] == 1:
            classes = classes[0]  # a batch of one: one frame, as decode
        if self.out_mode == "classmap":
            # the device argmax's map is the output: no palette, no upcast
            out = buf.with_tensors([classes], spec=None)
            out.meta["class_map"] = classes
            return out
        classes = classes.astype(np.int64)
        out = buf.with_tensors([_COLORS[classes % len(_COLORS)]], spec=None)
        out.meta["class_map"] = classes
        return out
