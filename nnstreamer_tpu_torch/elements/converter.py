"""tensor_converter: media streams -> other/tensors.

Port of ``nnstreamer_tpu/elements/converter.py`` (reference:
``gsttensor_converter.c``), cut to what the vision and audio paths feed
it:

* ``video/x-raw`` frames ``(H, W, C)`` => dims ``C:W:H:N``
  (innermost-first), shape ``(N, H, W, C)``, NHWC; ``frames-per-tensor``
  batches N frames into one buffer;
* ``audio/x-raw`` samples => ``(samples, channels)`` interleaved, one
  buffer per input buffer; ``frames-per-tensor=N`` (N > 1) re-chunks the
  stream into buffers of N samples (dims ``channels:N``), carrying the
  remainder to the next input;
* ``other/tensors`` passes through.

Raw frame bytes (the 4-byte row-stride repack of camera and file
sources), text and octet-stream conversion and the converter
sub-plugins (``mode=``) raise "not yet ported"; they come with those
sources and the ``converters/*`` slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType, audio_dtype, video_bpp
from ..core.registry import register_element
from ..core.types import TensorSpec, TensorsSpec, dtype_from_name, parse_fraction
from .base import Element, ElementError, SRC


@register_element("tensor_converter")
class TensorConverter(Element):
    kind = "tensor_converter"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.frames_per_tensor = int(self.props.get("frames_per_tensor", 1))
        if self.props.get("mode"):
            raise ElementError(
                "tensor_converter mode= (converter sub-plugins) is not yet "
                "ported")
        self._media: Optional[MediaType] = None
        self._spec: Optional[TensorsSpec] = None
        self._pending: List[np.ndarray] = []

    # -- negotiation -------------------------------------------------------
    def configure(self, in_caps: Dict[str, Caps], out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        self._media = src.media if not src.is_any() else None
        spec: Optional[TensorsSpec] = None
        if self._media == MediaType.VIDEO:
            fmt = src.get("format", "RGB")
            w, h = src.get("width"), src.get("height")
            if isinstance(w, int) and isinstance(h, int) and isinstance(fmt, str):
                spec = TensorsSpec(
                    (TensorSpec((video_bpp(fmt), w, h, self.frames_per_tensor),
                                np.uint8),),
                    rate=parse_fraction(src.get("framerate", (0, 1))))
        elif self._media == MediaType.AUDIO:
            ch = src.get("channels")
            if isinstance(ch, int) and self.frames_per_tensor > 1:
                dt = dtype_from_name(audio_dtype(src.get("format", "S16LE")))
                spec = TensorsSpec((TensorSpec((ch, self.frames_per_tensor), dt),))
        elif self._media in (MediaType.TENSORS, MediaType.FLEX_TENSORS):
            spec = src.spec
        elif self._media is not None:
            raise ElementError(
                f"tensor_converter: {self._media.value} input is not yet ported")
        self._spec = spec
        caps = Caps.tensors(spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- streaming ---------------------------------------------------------
    def process(self, pad, buf: Buffer):
        if self._media == MediaType.VIDEO:
            return self._video(buf)
        if self._media == MediaType.AUDIO:
            return self._audio(buf)
        return [(SRC, buf)]

    def _video(self, buf: Buffer):
        frame = _to_numpy(buf.tensors[0])
        if frame.ndim == 1:
            raise ElementError(
                "tensor_converter: raw video bytes are not yet ported")
        if frame.ndim == 2:  # GRAY
            frame = frame[:, :, None]
        if self.frames_per_tensor == 1:
            return [(SRC, buf.with_tensors([frame[None]], spec=self._spec))]
        self._pending.append(frame)
        if len(self._pending) < self.frames_per_tensor:
            return []
        batch = np.stack(self._pending)
        self._pending = []
        return [(SRC, buf.with_tensors([batch], spec=self._spec))]

    def _audio(self, buf: Buffer):
        samples = _to_numpy(buf.tensors[0])  # (S, C) interleaved
        if samples.ndim == 1:
            samples = samples[:, None]
        if self.frames_per_tensor <= 1:
            return [(SRC, buf.with_tensors([samples]))]
        self._pending.append(samples)
        outs = []
        if sum(len(p) for p in self._pending) >= self.frames_per_tensor:
            cat = np.concatenate(self._pending)
            n = self.frames_per_tensor
            while len(cat) >= n:
                outs.append((SRC, buf.with_tensors([cat[:n]], spec=self._spec)))
                cat = cat[n:]
            self._pending = [cat] if len(cat) else []
        return outs
