"""GStreamer-core compatibility elements: queue, compositor, videoconvert,
videoscale.

Port of ``nnstreamer_tpu/elements/video.py``.  Reference pipelines lean on GStreamer base elements the reference repo
does not implement but every example assumes (the stock object-detection
pipeline is ``v4l2src ! videoconvert ! videoscale ! ... ! tensor_filter``;
``queue`` appears wherever a stage boundary is wanted — SURVEY §1 "There
is no scheduler layer: scheduling IS GStreamer").  This module provides
the analogs so reference pipeline strings run as written:

* ``queue`` — in this runtime every element already runs on its own
  stage thread with a bounded feed queue, so ``queue`` is a passthrough
  marker; its GStreamer sizing properties are accepted for compatibility.
* ``videoconvert`` — channel-order/format conversion between the RGB
  family and GRAY8 on ``video/x-raw`` frames (``format=`` selects the
  target; default passthrough).
* ``videoscale`` — resize to ``width=``/``height=`` via nearest (default)
  or bilinear ``method=``.

* ``compositor`` -- source-over alpha blend of overlay pads onto the base
  pad ``sink_0`` through RGBA, ``sink_N::alpha``, slowest-pad sync.

These are host elements (media boundary, like the reference's); the
tensor path after ``tensor_converter`` is where device fusion begins.
A frame that arrives as a tensor (a card tensor included) is fetched to a
host array first; the arithmetic is the JAX package's numpy, so the
outputs are bitwise its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_element
from .base import Element, ElementError, SRC


@register_element("queue")
class Queue(Element):
    """Stage-boundary marker (GStreamer ``queue``).

    Threading/buffering is inherent to this runtime (one thread + bounded
    queue per stage), so data passes straight through; the reference's
    sizing/leaky properties are accepted for pipeline-string
    compatibility.
    """

    kind = "queue"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        # accepted for compatibility; the runtime's per-stage queues are
        # sized by Pipeline(queue_capacity=...)
        for p in ("max_size_buffers", "max_size_bytes", "max_size_time",
                  "leaky", "silent"):
            self.props.get(p)

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        self.out_caps = {p: src for p in out_pads}
        return self.out_caps

    def process(self, pad, buf):
        return [(SRC, buf)]


#: channel index order of each RGB-family format (None = alpha/pad slot)
_CHANNEL_ORDER = {
    "RGB": (0, 1, 2), "BGR": (2, 1, 0),
    "RGBA": (0, 1, 2, None), "BGRA": (2, 1, 0, None),
    "ARGB": (None, 0, 1, 2), "ABGR": (None, 2, 1, 0),
    "RGBx": (0, 1, 2, None), "BGRx": (2, 1, 0, None),
}

#: 4-channel formats whose 4th slot is PADDING, not alpha: semantically
#: opaque (the compositor must not read the undefined pad byte as alpha)
_PADDED_FMTS = frozenset({"RGBx", "BGRx"})

#: ITU-R BT.601 luma weights (the GStreamer videoconvert default)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)

#: planar (I420) / semi-planar (NV12) YUV 4:2:0 — the camera-native
#: formats every upstream v4l2src example negotiates before videoconvert.
#: Frames are the flat GStreamer byte layout viewed as [H*3/2, W] uint8
#: (or any shape totalling H*W*3/2 bytes); conversion is BT.601 limited
#: range (Y 16-235, chroma biased at 128), like GStreamer's default.
_YUV_FMTS = frozenset({"I420", "NV12"})


def _yuv_frame_hw(frame: np.ndarray, caps: Optional[Caps]) -> tuple:
    """(height, width) of a YUV frame: caps fields when negotiated, else
    derived from the canonical [H*3/2, W] shape."""
    if caps is not None:
        w = caps.get("width")
        h = caps.get("height")
        if w and h:
            return int(h), int(w)
    if frame.ndim == 2 and (frame.shape[0] * 2) % 3 == 0:
        return frame.shape[0] * 2 // 3, frame.shape[1]
    raise ElementError(
        f"YUV frame of shape {frame.shape} needs width=/height= caps "
        "(cannot derive the plane split)")


def _split_yuv(frame: np.ndarray, h: int, w: int, fmt: str):
    flat = np.asarray(frame, np.uint8).ravel()
    need = h * w * 3 // 2
    if flat.size != need:
        raise ElementError(
            f"{fmt} frame has {flat.size} bytes, {h}x{w} needs {need}")
    if h % 2 or w % 2:
        raise ElementError(f"{fmt} needs even dimensions, got {h}x{w}")
    y = flat[:h * w].reshape(h, w)
    if fmt == "I420":
        q = h * w // 4
        u = flat[h * w:h * w + q].reshape(h // 2, w // 2)
        v = flat[h * w + q:].reshape(h // 2, w // 2)
    else:  # NV12: interleaved UV plane
        uv = flat[h * w:].reshape(h // 2, w // 2, 2)
        u, v = uv[..., 0], uv[..., 1]
    return y, u, v


def _yuv_to_rgb(frame: np.ndarray, h: int, w: int, fmt: str) -> np.ndarray:
    """[flat YUV420] -> [H, W, 3] RGB uint8 (BT.601 limited range)."""
    y, u, v = _split_yuv(frame, h, w, fmt)
    yy = 1.164 * (y.astype(np.float32) - 16.0)
    # chroma upsample: nearest 2x2 (GStreamer's fast path)
    uu = np.repeat(np.repeat(u, 2, 0), 2, 1).astype(np.float32) - 128.0
    vv = np.repeat(np.repeat(v, 2, 0), 2, 1).astype(np.float32) - 128.0
    r = yy + 1.596 * vv
    g = yy - 0.813 * vv - 0.391 * uu
    b = yy + 2.018 * uu
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _rgb_to_yuv(rgb: np.ndarray, fmt: str) -> np.ndarray:
    """[H, W, 3] RGB uint8 -> [H*3/2, W] flat YUV420 (BT.601 limited)."""
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        raise ElementError(f"{fmt} needs even dimensions, got {h}x{w}")
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    uf = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    vf = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b
    # chroma subsample: 2x2 box average
    u = uf.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    v = vf.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    if fmt == "I420":
        flat = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
    else:  # NV12
        flat = np.concatenate([y.ravel(), np.stack([u, v], -1).ravel()])
    return np.clip(np.round(flat), 0, 255).astype(np.uint8).reshape(
        h * 3 // 2, w)


def _to_rgba(frame: np.ndarray, fmt: str) -> np.ndarray:
    """[H, W, C] in ``fmt`` -> [H, W, 4] RGBA (alpha preserved; opaque for
    alpha-less formats).  ``_CHANNEL_ORDER[fmt][i]`` names which RGB
    component lives in the format's channel ``i`` (None = the alpha/pad
    slot)."""
    if fmt == "GRAY8":
        rgba = np.repeat(frame[..., :1], 4, axis=-1)
        rgba[..., 3] = 255
        return rgba
    order = _CHANNEL_ORDER[fmt]
    rgba = np.full(frame.shape[:2] + (4,), 255, frame.dtype)
    for i, tgt in enumerate(order):
        rgba[..., 3 if tgt is None else tgt] = frame[..., i]
    if fmt in _PADDED_FMTS:  # x slot is padding, not alpha: opaque
        rgba[..., 3] = 255
    return rgba


def _from_rgba(rgba: np.ndarray, fmt: str) -> np.ndarray:
    """[H, W, 4] RGBA -> [H, W, C] in ``fmt`` (alpha carried into alpha
    slots; dropped for alpha-less formats, as GStreamer videoconvert does)."""
    if fmt == "GRAY8":
        y = (rgba[..., :3].astype(np.float32) @ _LUMA).round()
        return np.clip(y, 0, 255).astype(np.uint8)[..., None]
    order = _CHANNEL_ORDER[fmt]
    out = np.empty(rgba.shape[:2] + (len(order),), rgba.dtype)
    for i, tgt in enumerate(order):
        out[..., i] = rgba[..., 3 if tgt is None else tgt]
    return out


def _infer_fmt(caps: Caps, frame: np.ndarray) -> str:
    """Negotiated ``format`` field, else infer from channel count."""
    fmt = caps.get("format") if caps is not None else None
    if not fmt:
        c = 1 if frame.ndim == 2 else frame.shape[-1]
        fmt = {1: "GRAY8", 3: "RGB", 4: "RGBA"}.get(c, "RGB")
    fmt = str(fmt)
    if fmt not in _CHANNEL_ORDER and fmt != "GRAY8" and fmt not in _YUV_FMTS:
        raise ElementError(
            f"compositor: unsupported frame format {fmt!r} "
            "(8-bit RGB family / GRAY8 / I420 / NV12)")
    return fmt


@register_element("compositor")
class Compositor(Element):
    """Alpha-blend overlay streams onto a base video stream.

    Reference usage: the stock detection/pose examples composite the
    ``tensor_decoder`` RGBA overlay onto the camera frames.  ``sink_0``
    is the base frame; every other sink pad is an overlay blended in
    numeric pad order with per-pixel source-over alpha, scaled by the
    GStreamer per-pad property ``sink_N::alpha=<0..1>`` when given.
    Frames are converted through RGBA using each pad's NEGOTIATED format
    (channel-count inference when caps carry no format field), so BGR
    bases and ARGB overlays blend correctly; output format follows the
    base frame.  Sync is slowest-pad, matching the mux machinery.
    """

    kind = "compositor"
    PAD_TEMPLATES = {"sink_%u": Caps.new(MediaType.VIDEO)}
    sync_policy = "all"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.props.get("background")  # accepted for compatibility
        self._pad_alpha = {}

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        for pad in in_caps:  # read per-pad alphas while props are checked
            self._pad_alpha[pad] = float(
                self.props.get(f"{pad}::alpha", 1.0))
        base = in_caps.get("sink_0") or next(iter(in_caps.values()), Caps.any())
        self.out_caps = {p: base for p in out_pads}
        return self.out_caps

    def process(self, pad, buf):
        # Single-input compositor is legal in GStreamer: passthrough (the
        # runtime only collates groups when >1 sink pad is linked).
        return [(SRC, buf)]

    def process_group(self, bufs):
        from .routing import pad_index

        pads = sorted(bufs, key=pad_index)  # numeric: sink_10 > sink_2
        base_buf = bufs[pads[0]]
        base = _to_numpy(base_buf.tensors[0])
        base_fmt = _infer_fmt(self.in_caps.get(pads[0]), base)
        squeeze = False
        if base_fmt in _YUV_FMTS:  # camera-native base: blend in RGB space
            h, w = _yuv_frame_hw(base, self.in_caps.get(pads[0]))
            base = _yuv_to_rgb(base, h, w, base_fmt)
            out = _to_rgba(base, "RGB").astype(np.float32)
        else:
            squeeze = base.ndim == 2
            if squeeze:
                base = base[..., None]
            out = _to_rgba(base, base_fmt).astype(np.float32)
        a0 = self._pad_alpha.get(pads[0], 1.0)
        if a0 != 1.0:  # GStreamer fades the base toward the background
            out[..., :3] *= a0
        meta = dict(base_buf.meta)
        for pad in pads[1:]:
            ov_buf = bufs[pad]
            meta.update(ov_buf.meta)
            ov = _to_numpy(ov_buf.tensors[0])
            ov_fmt = _infer_fmt(self.in_caps.get(pad), ov)
            if ov_fmt in _YUV_FMTS:
                oh, ow = _yuv_frame_hw(ov, self.in_caps.get(pad))
                ov = _yuv_to_rgb(ov, oh, ow, ov_fmt)
                ov_fmt = "RGB"
            if ov.ndim == 2:
                ov = ov[..., None]
            if ov.shape[:2] != base.shape[:2]:
                raise ElementError(
                    f"{self.name}: overlay {ov.shape[:2]} != base "
                    f"{base.shape[:2]} (use videoscale)")
            rgba = _to_rgba(ov, ov_fmt).astype(np.float32)
            a = (rgba[..., 3:4] / 255.0) * self._pad_alpha.get(pad, 1.0)
            out[..., :3] = rgba[..., :3] * a + out[..., :3] * (1.0 - a)
        res = np.clip(np.round(out), 0, 255).astype(np.uint8)
        if base_fmt in _YUV_FMTS:  # output format follows the base frame
            res = _rgb_to_yuv(res[..., :3], base_fmt)
        else:
            res = _from_rgba(res, base_fmt)
        if squeeze:
            res = res[..., 0]
        new = base_buf.with_tensors([res], spec=None)
        new.meta.update(meta)
        pts = [b.pts for b in bufs.values() if b.pts is not None]
        new.pts = max(pts) if pts else None
        return [(SRC, new)]


@register_element("videoconvert")
class VideoConvert(Element):
    """Convert ``video/x-raw`` frames between the RGB family, GRAY8, and
    the camera-native YUV 4:2:0 formats (I420 / NV12, BT.601).

    ``format=`` names the output format; without it frames pass through
    (the reference negotiates; this runtime's negotiation is explicit).
    The stock upstream camera pipeline runs verbatim:
    ``v4l2src/appsrc (I420) ! videoconvert format=RGB ! tensor_converter``.
    """

    kind = "videoconvert"
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.VIDEO)}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.format = str(self.props.get("format", "") or "")
        known = set(_CHANNEL_ORDER) | {"GRAY8"} | _YUV_FMTS
        if self.format and self.format not in known:
            raise ElementError(
                f"{self.name}: unsupported format {self.format!r} "
                f"(one of {sorted(known)})")
        self._in_fmt: Optional[str] = None

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        if src.media not in (MediaType.VIDEO, MediaType.ANY):
            raise ElementError(
                f"{self.name}: needs video/x-raw input, got {src.media}")
        fields = dict(src.dict)
        fields.pop("spec", None)
        self._in_fmt = str(fields.get("format", "RGB"))
        if self.format:
            fields["format"] = self.format
        caps = Caps.new(MediaType.VIDEO, **fields)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process(self, pad, buf: Buffer):
        if not self.format or self.format == self._in_fmt:
            return [(SRC, buf)]
        frame = _to_numpy(buf.tensors[0])
        in_fmt = self._in_fmt or "RGB"
        in_caps = next(iter(self.in_caps.values()), None)
        if in_fmt in _YUV_FMTS:
            h, w = _yuv_frame_hw(frame, in_caps)
            rgb = _yuv_to_rgb(frame, h, w, in_fmt)
            if self.format in _YUV_FMTS:
                out = _rgb_to_yuv(rgb, self.format)
            elif self.format == "RGB":
                out = rgb
            else:
                out = _from_rgba(_to_rgba(rgb, "RGB"), self.format)
            return [(SRC, buf.with_tensors([out], spec=None))]
        if frame.ndim == 2:  # GRAY8 without channel dim
            frame = frame[..., None]
        rgba = _to_rgba(frame, in_fmt)
        if self.format in _YUV_FMTS:
            out = _rgb_to_yuv(rgba[..., :3], self.format)
        else:
            out = _from_rgba(rgba, self.format)
        return [(SRC, buf.with_tensors([out], spec=None))]


@register_element("videoscale")
class VideoScale(Element):
    """Resize ``video/x-raw`` frames to ``width=`` x ``height=``.

    ``method=nearest`` (default, GStreamer's 0) or ``method=bilinear``.
    Without width/height props, frames pass through (the reference
    negotiates the size from downstream caps; set them explicitly here).
    """

    kind = "videoscale"
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.VIDEO)}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.width = int(self.props.get("width", 0))
        self.height = int(self.props.get("height", 0))
        self.method = str(self.props.get("method", "nearest")).lower()
        if self.method not in ("nearest", "bilinear", "0", "1"):
            raise ElementError(
                f"{self.name}: method must be nearest|bilinear")
        if self.method in ("0",):
            self.method = "nearest"
        if self.method in ("1",):
            self.method = "bilinear"

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        if src.media not in (MediaType.VIDEO, MediaType.ANY):
            raise ElementError(
                f"{self.name}: needs video/x-raw input, got {src.media}")
        if str(src.get("format") or "") in _YUV_FMTS:
            raise ElementError(
                f"{self.name}: cannot scale subsampled YUV directly — "
                "insert 'videoconvert format=RGB' upstream")
        fields = dict(src.dict)
        fields.pop("spec", None)
        if self.width:
            fields["width"] = self.width
        if self.height:
            fields["height"] = self.height
        caps = Caps.new(MediaType.VIDEO, **fields)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process(self, pad, buf: Buffer):
        if not (self.width or self.height):
            return [(SRC, buf)]
        frame = _to_numpy(buf.tensors[0])
        chan_added = frame.ndim == 2
        if chan_added:  # 2-d gray frame: give it a channel dim for the math
            frame = frame[..., None]
        h, w = frame.shape[:2]
        oh = self.height or h
        ow = self.width or w
        if (oh, ow) == (h, w):
            return [(SRC, buf)]
        if self.method == "nearest":
            yi = (np.arange(oh) * (h / oh)).astype(int).clip(0, h - 1)
            xi = (np.arange(ow) * (w / ow)).astype(int).clip(0, w - 1)
            out = frame[yi[:, None], xi[None, :]]
        else:  # bilinear
            yf = (np.arange(oh) + 0.5) * (h / oh) - 0.5
            xf = (np.arange(ow) + 0.5) * (w / ow) - 0.5
            y0 = np.clip(np.floor(yf).astype(int), 0, h - 1)
            x0 = np.clip(np.floor(xf).astype(int), 0, w - 1)
            y1 = np.clip(y0 + 1, 0, h - 1)
            x1 = np.clip(x0 + 1, 0, w - 1)
            wy = np.clip(yf - y0, 0.0, 1.0)[:, None, None]
            wx = np.clip(xf - x0, 0.0, 1.0)[None, :, None]
            f = frame.astype(np.float32)
            top = f[y0[:, None], x0[None, :]] * (1 - wx) + \
                f[y0[:, None], x1[None, :]] * wx
            bot = f[y1[:, None], x0[None, :]] * (1 - wx) + \
                f[y1[:, None], x1[None, :]] * wx
            out = top * (1 - wy) + bot * wy
            if np.issubdtype(frame.dtype, np.integer):
                info = np.iinfo(frame.dtype)
                out = np.clip(np.round(out), info.min, info.max)
            out = out.astype(frame.dtype)
        if chan_added:
            out = out[..., 0]
        return [(SRC, buf.with_tensors([out], spec=None))]
