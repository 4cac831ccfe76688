"""tensor_converter: media streams -> other/tensors.

Port of ``nnstreamer_tpu/elements/converter.py`` (reference:
``gsttensor_converter.c``):

* ``video/x-raw`` frames ``(H, W, C)`` => dims ``C:W:H:N``
  (innermost-first), shape ``(N, H, W, C)``, NHWC; a frame may also come
  as raw bytes, one 1-D ``uint8`` array as a camera delivers it, dense
  or with each row padded to a multiple of 4 bytes (GStreamer's default
  row stride), and the padding is stripped on the host through a strided
  numpy view; ``frames-per-tensor`` batches N frames into one buffer;
* ``audio/x-raw`` samples => ``(samples, channels)`` interleaved, one
  buffer per input buffer; ``frames-per-tensor=N`` (N > 1) re-chunks the
  stream into buffers of N samples (dims ``channels:N``), carrying the
  remainder to the next input;
* ``text/x-raw`` => the UTF-8 bytes, zero-padded or cut to
  ``input-dim`` (``input-type``) when it is set;
* ``application/octet-stream`` => one buffer per ``input-dim`` /
  ``input-type`` chunk of the bytes (a trailing partial chunk is
  dropped);
* ``other/tensors`` passes through;
* ``mode=<name>`` hands every buffer to the converter sub-plugin of that
  name (``converters/serialize.py``: ``flatbuf``, ``flexbuf``,
  ``protobuf``, ``python3``); an unknown name raises.

The raw frames of ``v4l2src``, ``filesrc`` and ``tensor_src_iio`` come
with those sources, which are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType, audio_dtype, video_bpp
from ..core.registry import KIND_CONVERTER, lookup, register_element
from ..core.types import TensorSpec, TensorsSpec, dtype_from_name, parse_fraction
from .base import Element, ElementError, SRC


def strip_row_stride(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """One raw video frame's bytes as an ``(h, w, c)`` array: dense
    (``h * w * c`` bytes, a view), or with each row padded to a multiple
    of 4 bytes (a contiguous copy of the rows without their padding)."""
    row = w * c
    stride = (row + 3) // 4 * 4
    if raw.size == h * row:
        return raw.reshape(h, w, c)
    if raw.size == h * stride:
        return np.ascontiguousarray(
            raw.reshape(h, stride)[:, :row]).reshape(h, w, c)
    raise ElementError(
        f"video buffer size {raw.size} matches neither dense {h * row} "
        f"nor strided {h * stride}")


@register_element("tensor_converter")
class TensorConverter(Element):
    kind = "tensor_converter"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.frames_per_tensor = int(self.props.get("frames_per_tensor", 1))
        self.input_dim = self.props.get("input_dim")
        self.input_type = str(self.props.get("input_type", "uint8"))
        self.mode = self.props.get("mode")  # converter sub-plugin
        self._sub = None
        self._media: Optional[MediaType] = None
        self._spec: Optional[TensorsSpec] = None
        self._pending: List[np.ndarray] = []

    # -- negotiation -------------------------------------------------------
    def configure(self, in_caps: Dict[str, Caps], out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        self._media = src.media if not src.is_any() else None
        spec: Optional[TensorsSpec] = None
        if self.mode:
            cls = lookup(KIND_CONVERTER, str(self.mode))
            if cls is None:
                raise ElementError(
                    f"unknown converter sub-plugin {self.mode!r}")
            self._sub = cls(self.props)
            spec = getattr(self._sub, "out_spec", None)
        elif self._media == MediaType.VIDEO:
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
        elif self._media in (MediaType.OCTET, MediaType.TEXT, None):
            if self.input_dim:
                spec = TensorsSpec.from_string(str(self.input_dim),
                                               self.input_type)
        elif self._media in (MediaType.TENSORS, MediaType.FLEX_TENSORS):
            spec = src.spec
        self._spec = spec
        caps = Caps.tensors(spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- streaming ---------------------------------------------------------
    def process(self, pad, buf: Buffer):
        if self._sub is not None:
            return [(SRC, self._sub.convert(buf))]
        media = self._media
        if media == MediaType.VIDEO:
            return self._video(buf)
        if media == MediaType.AUDIO:
            return self._audio(buf)
        if media == MediaType.TEXT:
            return self._text(buf)
        if media == MediaType.OCTET:
            return self._octet(buf)
        return [(SRC, buf)]

    def _video(self, buf: Buffer):
        frame = _to_numpy(buf.tensors[0])
        if frame.ndim == 1:  # raw bytes: undo the 4-byte row stride
            src = next(iter(self.in_caps.values()))
            w, h = src.get("width"), src.get("height")
            if w is None or h is None:
                raise ElementError("raw video bytes need width/height caps")
            frame = strip_row_stride(frame, h, w,
                                     video_bpp(src.get("format", "RGB")))
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

    def _text(self, buf: Buffer):
        raw = buf.tensors[0]
        if isinstance(raw, str):
            data = np.frombuffer(raw.encode("utf-8"), np.uint8)
        elif isinstance(raw, np.ndarray) and raw.dtype.kind in "US":
            data = np.frombuffer(str(raw).encode("utf-8"), np.uint8)
        else:
            data = _to_numpy(raw).astype(np.uint8, copy=False).ravel()
        if self._spec is not None:
            size = self._spec[0].count
            out = np.zeros(size, np.uint8)
            out[: min(size, data.size)] = data[:size]
            data = out.reshape(self._spec[0].shape)
        return [(SRC, buf.with_tensors([data], spec=self._spec))]

    def _octet(self, buf: Buffer):
        if self._spec is None:
            raise ElementError(
                "octet-stream conversion needs input-dim/input-type")
        spec = self._spec[0]
        arr = np.ascontiguousarray(_to_numpy(buf.tensors[0])).ravel().view(
            spec.dtype)
        n = spec.count
        return [(SRC, buf.with_tensors([arr[off: off + n].reshape(spec.shape)],
                                       spec=self._spec))
                for off in range(0, arr.size - n + 1, n)]

    def finalize(self):
        # an incomplete frames-per-tensor batch is dropped at EOS, as the
        # reference drops partials
        self._pending = []
        return []
