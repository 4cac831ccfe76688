"""Source elements.

Port of the ``appsrc``, ``videotestsrc`` and ``audiotestsrc`` of
``nnstreamer_tpu/elements/source.py``: the application-driven source,
with its end-to-end admission bound (``max-inflight``) and tenant stamp
(``tenant``), and the deterministic video and audio sources.  Sources
produce host buffers, and the stage that consumes them moves payloads to
the device; ``videotestsrc device=true`` and ``audiotestsrc device=true``
generate their batches on the device itself.  ``filesrc`` is not ported
yet.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import time as _time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.buffer import Buffer, Event
from ..core.caps import Caps, MediaType, parse_caps_string, video_bpp
from ..core.log import STALL_FLOOR_S
from ..core.log import metrics as _metrics
from ..core.meta_keys import META_TENANT
from ..core.registry import register_element
from ..core.types import TensorsSpec, parse_fraction
from .base import ElementError, SourceElement


class _InflightCredit:
    """End-to-end admission token (``appsrc max-inflight=N``): released
    the FIRST time this buffer — or any buffer derived from it; meta
    copies share the token by reference — reaches a sink, and as a safety
    net when every derived buffer is garbage-collected (drop/eviction
    paths must never leak a credit and deadlock the pusher)."""

    __slots__ = ("_sem", "_done", "_lock")

    def __init__(self, sem: threading.Semaphore):
        self._sem = sem
        self._done = False
        self._lock = threading.Lock()

    def release(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        self._sem.release()

    def __del__(self):  # drop-path safety net
        try:
            self.release()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


@register_element("appsrc")
class AppSrc(SourceElement):
    """Application-driven source: ``pipeline.push(name, array)`` feeds it.

    Props: ``caps`` (caps string describing what the app will push),
    ``max-buffers`` (feed queue bound), ``block`` (push blocks when full;
    ``block=false`` lets the feed queue grow unbounded, as GStreamer's
    appsrc does), ``max-inflight`` (END-TO-END admission bound: at most N
    pushed buffers anywhere between this source and a sink; push blocks
    past that), ``tenant`` (tenant identity stamped into every pushed
    buffer's meta — it rides the query wire, so a remote server's
    per-tenant accounting and admission control see it; app data,
    stamped whatever the trace mode).
    """

    kind = "appsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        cap = self.props.get("caps")
        self._caps = parse_caps_string(str(cap)) if cap else Caps.any()
        self.tenant = str(self.props.get("tenant", "") or "") or None
        self.block = bool(self.props.get("block", True))
        cap_n = int(self.props.get("max_buffers", 64))
        self._q: _queue.Queue = _queue.Queue(
            maxsize=cap_n if self.block else 0)
        self._eos = threading.Event()
        n_inflight = int(self.props.get("max_inflight", 0))
        self._inflight_sem = (threading.Semaphore(n_inflight)
                              if n_inflight > 0 else None)

    def configure(self, in_caps, out_pads):
        self.out_caps = {p: self._caps for p in out_pads}
        return self.out_caps

    # -- app API -----------------------------------------------------------
    def push(self, data, pts: Optional[int] = None) -> None:
        if self._eos.is_set():
            raise RuntimeError("appsrc already EOS")
        if isinstance(data, Buffer):
            buf = data
        elif isinstance(data, (list, tuple)):
            buf = Buffer(list(data), pts=pts)
        elif isinstance(data, str):
            buf = Buffer([np.frombuffer(data.encode("utf-8"), np.uint8)], pts=pts)
        elif isinstance(data, (bytes, bytearray)):
            buf = Buffer([np.frombuffer(bytes(data), np.uint8)], pts=pts)
        else:
            buf = Buffer([data if isinstance(data, torch.Tensor)
                          else np.asarray(data)], pts=pts)
        if self.tenant is not None and META_TENANT not in buf.meta:
            buf.meta[META_TENANT] = self.tenant
        if self._inflight_sem is not None:
            stop = getattr(self, "_stop_event", None)
            t0 = _time.perf_counter()
            while not self._inflight_sem.acquire(timeout=0.1):
                if self._eos.is_set() or (stop is not None
                                          and stop.is_set()):
                    raise RuntimeError("appsrc stopping; push abandoned")
            # the time the push blocked on admission: the backlog wait
            wait = _time.perf_counter() - t0
            _metrics.count(f"{self.name}.h2d_wait_ms", wait * 1e3)
            if wait > STALL_FLOOR_S:
                _metrics.count(f"{self.name}.h2d_stalls")
            buf.meta["_inflight_credit"] = _InflightCredit(
                self._inflight_sem)
        self._q.put(buf)

    def signal_eos(self) -> None:
        self._eos.set()

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        stop = getattr(self, "_stop_event", None)
        while True:
            try:
                yield self._q.get(timeout=0.05)
            except _queue.Empty:
                if self._eos.is_set() and self._q.empty():
                    return
                # stop() without EOS: exit instead of pinning the runner
                if stop is not None and stop.is_set():
                    return


@register_element("videotestsrc")
class VideoTestSrc(SourceElement):
    """Deterministic video frames (the reference test pipelines' workhorse).

    Props: ``width``, ``height``, ``format`` (RGB/BGR/RGBA/GRAY8),
    ``num-buffers``, ``pattern`` (``smpte`` gradient, ``ball``, ``black``,
    ``white``, ``random`` with a fixed seed), ``framerate``.  Host frames
    are bitwise the JAX package's.

    ``device=true`` generates the pattern on the device, ``batch`` frames
    per buffer, as batched ``other/tensors`` that stay there (the same
    bits as the host frames); ``num-buffers`` counts frames and the tail
    batch is truncated to it.  It generates on the device of the filter
    below it, folded into a fused stage or not (the planner sets
    ``gen_device``), and with no filter below it on the card, raising
    without one.  ``pattern=random`` with ``device=true``
    draws from ``jax.random`` in the JAX package, which torch cannot
    reproduce: it raises "not yet ported".
    """

    kind = "videotestsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.width = int(self.props.get("width", 320))
        self.height = int(self.props.get("height", 240))
        self.format = str(self.props.get("format", "RGB"))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.pattern = str(self.props.get("pattern", "smpte"))
        self.rate = parse_fraction(self.props.get("framerate", (30, 1)))
        self.device = bool(self.props.get("device", False))
        self.batch = int(self.props.get("batch", 1))
        #: where a device batch is generated: the planner sets the device of
        #: the filter below (None: the card)
        self.gen_device: Optional[torch.device] = None
        if self.device and self.pattern == "random":
            raise ElementError(
                "videotestsrc device=true pattern=random is not yet ported "
                "(the JAX package draws it from jax.random)")

    def configure(self, in_caps, out_pads):
        if self.device:
            c = video_bpp(self.format)
            spec = TensorsSpec.from_string(
                f"{c}:{self.width}:{self.height}:{self.batch}", "uint8"
            )
            caps = Caps.tensors(spec)
        else:
            caps = Caps.new(
                MediaType.VIDEO,
                format=self.format,
                width=self.width,
                height=self.height,
                framerate=self.rate,
            )
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def _frame(self, i: int) -> np.ndarray:
        c = video_bpp(self.format)
        h, w = self.height, self.width
        if self.pattern == "black":
            f = np.zeros((h, w, c), np.uint8)
        elif self.pattern == "white":
            f = np.full((h, w, c), 255, np.uint8)
        elif self.pattern == "random":
            rng = np.random.default_rng(i)
            f = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        elif self.pattern == "ball":
            f = np.zeros((h, w, c), np.uint8)
            cy = (i * 7) % h
            cx = (i * 11) % w
            yy, xx = np.ogrid[:h, :w]
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= (min(h, w) // 8) ** 2
            f[mask] = 255
        else:  # smpte-ish deterministic gradient
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            base = (xx * 255 // max(1, w - 1) + yy + i) % 256
            f = np.stack([(base + 85 * k) % 256 for k in range(c)], axis=-1).astype(np.uint8)
        return f

    def device_batch(self, i0: int, n: int, device) -> torch.Tensor:
        """Frames ``i0 .. i0 + n - 1`` as one ``[n, H, W, C]`` uint8 tensor
        made on ``device``: the host frames' integer arithmetic, batched."""
        h, w, c = self.height, self.width, video_bpp(self.format)
        if self.pattern == "black":
            return torch.zeros((n, h, w, c), dtype=torch.uint8, device=device)
        if self.pattern == "white":
            return torch.full((n, h, w, c), 255, dtype=torch.uint8, device=device)
        idx = torch.arange(i0, i0 + n, device=device)[:, None, None]
        yy = torch.arange(h, device=device)[None, :, None]
        xx = torch.arange(w, device=device)[None, None, :]
        if self.pattern == "ball":
            cy, cx = (idx * 7) % h, (idx * 11) % w
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= (min(h, w) // 8) ** 2
            f = mask.to(torch.uint8) * 255
            return f[..., None].expand(n, h, w, c).contiguous()
        base = (xx * 255 // max(1, w - 1) + yy + idx) % 256
        return torch.stack([(base + 85 * k) % 256 for k in range(c)],
                           dim=-1).to(torch.uint8)

    def generate(self):
        num = self.num_buffers if self.num_buffers >= 0 else 1 << 62
        frame_ns = int(1e9 * self.rate[1] / max(1, self.rate[0]))
        if self.device:
            from ..filters.base import resolve_device

            device = self.gen_device or resolve_device("")
            # num-buffers counts FRAMES; the tail batch is truncated so
            # the total matches.  The frame index wraps at 2^30, as in the
            # JAX package.
            emitted = 0
            i = 0
            while emitted < num:
                take = min(self.batch, num - emitted)
                arr = self.device_batch((i * self.batch) % (1 << 30), take,
                                        device)
                yield Buffer([arr], pts=emitted * frame_ns)
                emitted += take
                i += 1
            return
        for i in range(num):
            yield Buffer([self._frame(i)], pts=i * frame_ns)


@register_element("audiotestsrc")
class AudioTestSrc(SourceElement):
    """Deterministic audio: a sine wave.  Props: ``freq``,
    ``samplesperbuffer``, ``num-buffers``, ``rate``, ``channels``,
    ``format`` (S16LE/F32LE/U8).  Host buffers are ``(samples, channels)``
    arrays computed in float64, bitwise the JAX package's.

    ``device=true`` generates the sine on the device as batched float32
    ``other/tensors`` windows ``[batch, samplesperbuffer]`` that stay
    there; ``num-buffers`` counts windows, the tail batch is truncated to
    it, and ``channels`` is 1.  The sample index is an int32 folded by the
    rate (for an integer ``freq``, ``n -> n + rate`` moves the phase by
    whole cycles) and the phase is float32, computed as XLA compiles the
    JAX package's ``2 pi freq n / rate``: ``n * k`` with one float32
    constant ``k = f32(2 pi freq) * f32(1 / rate)``.  The batches then
    differ from the JAX package's only where torch's sine rounds
    otherwise than XLA's.  Like ``videotestsrc device=true`` it generates
    on the device of the filter below it (the planner sets
    ``gen_device``), folded into a fused stage or not, and with no filter
    below it on the card, raising without one.
    """

    kind = "audiotestsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.freq = float(self.props.get("freq", 440.0))
        self.spb = int(self.props.get("samplesperbuffer", 1024))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.sample_rate = int(self.props.get("rate", 44100))
        self.channels = int(self.props.get("channels", 1))
        self.format = str(self.props.get("format", "S16LE"))
        self.device = bool(self.props.get("device", False))
        self.batch = int(self.props.get("batch", 1))
        #: where a device batch is generated: the planner sets the device of
        #: the filter below (None: the card)
        self.gen_device: Optional[torch.device] = None

    def configure(self, in_caps, out_pads):
        if self.device:
            caps = Caps.tensors(TensorsSpec.from_string(
                f"{self.spb}:{self.batch}", "float32"))
        else:
            caps = Caps.new(MediaType.AUDIO, format=self.format,
                            rate=self.sample_rate, channels=self.channels)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def device_batch(self, n0: int, device) -> torch.Tensor:
        """One ``[batch, spb]`` float32 window batch on ``device``, the
        first sample at index ``n0`` (< rate)."""
        spb, rate = self.spb, self.sample_rate
        k = float(np.float32(2 * math.pi * self.freq) * np.float32(1.0 / rate))
        j = torch.arange(self.batch, dtype=torch.int32, device=device)[:, None]
        n = torch.remainder(
            n0 + j * spb + torch.arange(spb, dtype=torch.int32, device=device),
            rate)
        return torch.sin(n.float() * k)

    def generate(self):
        num = self.num_buffers if self.num_buffers >= 0 else 1 << 62
        if self.device:
            from ..filters.base import resolve_device

            device = self.gen_device or resolve_device("")
            emitted = 0
            i = 0
            while emitted < num:
                # the base index folded by the rate in exact python ints
                arr = self.device_batch(
                    (i * self.batch * self.spb) % self.sample_rate, device)
                take = min(self.batch, num - emitted)
                if take < self.batch:
                    arr = arr[:take]
                pts = int(1e9 * emitted * self.spb / self.sample_rate)
                yield Buffer([arr], pts=pts)
                emitted += take
                i += 1
            return
        t0 = 0
        for _ in range(num):
            n = np.arange(t0, t0 + self.spb, dtype=np.float64)
            wave = np.sin(2 * np.pi * self.freq * n / self.sample_rate)
            if self.format == "S16LE":
                samples = (wave * 32767).astype(np.int16)
            elif self.format == "U8":
                samples = ((wave * 0.5 + 0.5) * 255).astype(np.uint8)
            else:
                samples = wave.astype(np.float32)
            frame = np.repeat(samples[:, None], self.channels, axis=1)
            pts = int(1e9 * t0 / self.sample_rate)
            t0 += self.spb
            yield Buffer([frame], pts=pts)
