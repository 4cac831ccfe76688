"""Source elements.

Port of the ``appsrc``, ``videotestsrc`` and ``audiotestsrc`` of
``nnstreamer_tpu/elements/source.py``: the application-driven source,
with its end-to-end admission bound (``max-inflight``) and tenant stamp
(``tenant``), and the deterministic video and audio sources.  Sources
produce host buffers, and the stage that consumes them moves payloads to
the device; ``videotestsrc device=true`` and ``audiotestsrc device=true``
generate their batches on the device itself.

The file and sensor sources: ``filesrc`` (a file's bytes), ``tensor_src_iio``
(interleaved sensor scans from a file, a FIFO, a TCP stream, a sampler or
the built-in pseudo-sensor) and ``v4l2src`` (raw camera frames from a
regular file or a FIFO).  Their readers poll the pipeline's stop event
between reads, so a stalled producer never blocks shutdown.
``v4l2src``'s character-device backend (the ioctl/mmap capture ring of
the JAX package's native library) is not ported: ``io-mode=native``, or a
character device under ``io-mode=auto``, raises.
"""

from __future__ import annotations

import math
import os
import queue as _queue
import select
import socket
import stat
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
    without one.  ``pattern=random`` with ``device=true`` draws each
    frame from a ``torch.Generator`` on the generating device seeded with
    the frame's index, so a rerun gives the same frames and no two frames
    share a seed.  These frames are the port's own: the JAX package draws
    them from ``jax.random``, whose bits torch cannot reproduce, and a CPU
    generator's bits are not the card's either.
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
        #: ``pattern=random`` on the device: one generator, reseeded per
        #: frame
        self._gen: Optional[torch.Generator] = None

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
        made on ``device``: the host frames' integer arithmetic, batched
        (``pattern=random``: the port's own per-frame draws, see the class)."""
        h, w, c = self.height, self.width, video_bpp(self.format)
        if self.pattern == "black":
            return torch.zeros((n, h, w, c), dtype=torch.uint8, device=device)
        if self.pattern == "white":
            return torch.full((n, h, w, c), 255, dtype=torch.uint8, device=device)
        if self.pattern == "random":
            dev = torch.device(device)
            if self._gen is None or self._gen.device != dev:
                self._gen = torch.Generator(device=dev)
            out = torch.empty((n, h, w, c), dtype=torch.uint8, device=dev)
            for k in range(n):
                self._gen.manual_seed(i0 + k)
                out[k].random_(0, 256, generator=self._gen)
            return out
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


@register_element("filesrc")
class FileSrc(SourceElement):
    """A file's bytes as ``application/octet-stream``.

    Props: ``location``, ``blocksize`` (0 = the whole file in one buffer).
    """

    kind = "filesrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.location = str(self.props.get("location", ""))
        self.blocksize = int(self.props.get("blocksize", 0))

    def configure(self, in_caps, out_pads):
        caps = Caps.new(MediaType.OCTET)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def generate(self):
        with open(self.location, "rb") as f:
            data = f.read()
        if self.blocksize <= 0:
            yield Buffer([np.frombuffer(data, np.uint8)])
            return
        for off in range(0, len(data), self.blocksize):
            yield Buffer([np.frombuffer(data[off:off + self.blocksize], np.uint8)])


class _RawReader:
    """Reads whole records from a file or FIFO opened ``O_NONBLOCK``:
    ``select`` with a 0.2 s poll, the stop event checked between reads,
    and a FIFO's EOF before its first writer ignored (a FIFO with no
    writer yet reads as EOF)."""

    def __init__(self, owner: str, path: str):
        try:
            self.fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
            self.is_fifo = stat.S_ISFIFO(os.fstat(self.fd).st_mode)
        except OSError as e:
            raise ElementError(f"{owner}: cannot open device {path!r}: {e}") from e
        self.saw_data = False

    def read(self, need: int, stop: threading.Event) -> Optional[bytes]:
        """``need`` bytes, or None at EOF (a short tail is dropped), on a
        read error or at stop."""
        parts, got = [], 0
        while got < need:
            if stop.is_set():
                return None
            r, _, _ = select.select([self.fd], [], [], 0.2)
            if not r:
                continue
            try:
                chunk = os.read(self.fd, need - got)
            except BlockingIOError:
                continue
            except OSError:
                return None
            if chunk == b"":
                if self.is_fifo and not self.saw_data:
                    if stop.wait(0.05):
                        return None
                    continue
                return None
            self.saw_data = True
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


#: IIO scan-element wire formats: name -> numpy dtype
_IIO_FORMATS = {
    "s16le": np.dtype("<i2"), "u16le": np.dtype("<u2"),
    "s32le": np.dtype("<i4"), "u32le": np.dtype("<u4"),
    "s8": np.dtype("i1"), "u8": np.dtype("u1"),
    "f32le": np.dtype("<f4"), "f64le": np.dtype("<f8"),
}


@register_element("tensor_src_iio")
class TensorSrcIIO(SourceElement):
    """Industrial-I/O sensor source (reference: ``gsttensor_srciio.c``),
    the JAX package's ``tensor_src_iio``: buffered scans of interleaved
    per-channel raw samples, each emitted as a ``[capacity, channels]``
    float32 host tensor of ``(raw + offset) * scale``.

    * ``device=<path>``: a file or FIFO of interleaved raw records;
      ``device=tcp://host:port``: the same records over a socket.
    * ``scan-format`` (default ``s16le``, one of :data:`_IIO_FORMATS`),
      ``channels``, ``scale`` (default 1), ``offset`` (default 0).
    * ``buffer-capacity`` samples a buffer; a short tail scan is dropped.
    * ``trigger=data`` (default) emits as soon as a scan is read;
      ``trigger=timer`` paces emission at ``frequency`` Hz.
    * With no ``device``, a ``sampler`` callable (``i -> [channels]``) or
      the built-in deterministic pseudo-sensor makes the samples.
    * ``num-buffers`` (default 16; -1 = unbounded).
    """

    kind = "tensor_src_iio"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.frequency = float(self.props.get("frequency", 100.0))
        self.capacity = int(self.props.get("buffer_capacity", 16))
        self.channels = int(self.props.get("channels", 3))
        self.num_buffers = int(self.props.get("num_buffers", 16))
        self.sampler = self.props.get("sampler")
        self.device = str(self.props.get("device", "") or "")
        fmt = str(self.props.get("scan_format", "s16le")).lower()
        if fmt not in _IIO_FORMATS:
            raise ElementError(
                f"{self.name}: unknown scan-format {fmt!r} "
                f"(one of {sorted(_IIO_FORMATS)})")
        self.scan_dtype = _IIO_FORMATS[fmt]
        self.scale = float(self.props.get("scale", 1.0))
        self.offset = float(self.props.get("offset", 0.0))
        self.trigger = str(self.props.get("trigger", "data")).lower()
        if self.trigger not in ("data", "timer"):
            raise ElementError(
                f"{self.name}: trigger must be data|timer, got {self.trigger!r}")
        self._reader: Optional[_RawReader] = None
        self._sock = None

    def configure(self, in_caps, out_pads):
        spec = TensorsSpec.from_string(f"{self.channels}:{self.capacity}", "float32")
        caps = Caps.tensors(spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def start(self) -> None:
        if not self.device:
            return
        if self.device.startswith("tcp://"):

            host, port = self.device[6:].rsplit(":", 1)
            try:
                sock = socket.create_connection((host, int(port)), timeout=5.0)
            except OSError as e:
                raise ElementError(
                    f"{self.name}: cannot reach sensor stream {self.device}: {e}"
                ) from e
            # a short timeout: the reader checks the stop event between
            # recv()s, so a paused sender never blocks shutdown
            sock.settimeout(0.2)
            self._sock = sock
        else:
            self._reader = _RawReader(self.name, self.device)

    def stop(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _recv(self, need: int, stop: threading.Event) -> Optional[bytes]:
        parts, got = [], 0
        while got < need:
            if stop.is_set():
                return None
            try:
                chunk = self._sock.recv(need - got)
            except socket.timeout:
                continue
            except OSError:
                return None
            if not chunk:
                return None  # the sender closed
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def _read_scan(self, stop: threading.Event) -> Optional[np.ndarray]:
        """One full scan, ``[capacity, channels]`` float32, or None at
        EOF, on a short tail or at stop."""
        need = self.capacity * self.channels * self.scan_dtype.itemsize
        data = (self._reader.read(need, stop) if self._reader is not None
                else self._recv(need, stop))
        if data is None:
            return None
        raw = np.frombuffer(data, self.scan_dtype).astype(np.float32)
        raw = raw.reshape(self.capacity, self.channels)
        return (raw + np.float32(self.offset)) * np.float32(self.scale)

    def generate(self):
        stop = getattr(self, "_stop_event", None) or threading.Event()
        num = self.num_buffers if self.num_buffers >= 0 else 1 << 62
        period = (self.capacity / self.frequency) if self.frequency > 0 else 0.0
        next_t = _time.monotonic()
        if self.device:
            for i in range(num):
                if stop.is_set():
                    return
                scan = self._read_scan(stop)
                if scan is None:
                    return  # the sensor stream ended: EOS
                if self.trigger == "timer":
                    next_t += period
                    delay = next_t - _time.monotonic()
                    if delay > 0 and stop.wait(delay):
                        return
                pts = int(1e9 * i * self.capacity / max(self.frequency, 1e-9))
                yield Buffer([scan], pts=pts)
            return
        i = 0
        for _ in range(num):
            rows = []
            for _ in range(self.capacity):
                if callable(self.sampler):
                    rows.append(np.asarray(self.sampler(i), np.float32))
                else:  # the deterministic pseudo-sensor
                    rows.append(np.sin(np.arange(self.channels)
                                       + i / self.frequency).astype(np.float32))
                i += 1
            yield Buffer([np.stack(rows)])


#: v4l2src format name -> (fourcc, bytes per pixel)
_V4L2_FORMATS = {"RGB": ("RGB3", 3), "BGR": ("BGR3", 3),
                 "GRAY8": ("GREY", 1), "YUY2": ("YUYV", 2)}


@register_element("v4l2src")
class V4L2Src(SourceElement):
    """Camera capture, the ``v4l2src`` of the north-star pipeline
    (``v4l2src ! tensor_converter ! tensor_filter ! ...``), on its raw
    backend: a regular file or a FIFO of raw frames of ``width * height *
    bpp`` bytes each, read with ``tensor_src_iio``'s polling discipline.
    A short tail frame at EOF is dropped.

    Props: ``device`` (default ``/dev/video0``), ``width`` / ``height`` /
    ``format`` (RGB, BGR, GRAY8, YUY2; the caps are fixed at
    construction), ``num-buffers``, ``framerate``, ``io-mode`` (``auto``
    | ``native`` | ``raw``), ``n-bufs`` (accepted; the native ring's
    depth).  Emits
    host frames ``[H, W, bpp]`` uint8 with ``pts = i * frame_ns``.

    The character-device backend (a V4L2 node through the JAX package's
    native ioctl/mmap ring) is not ported: ``io-mode=native``, or a
    character device under ``io-mode=auto``, raises at start.
    """

    kind = "v4l2src"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.device = str(self.props.get("device", "/dev/video0"))
        self.width = int(self.props.get("width", 640))
        self.height = int(self.props.get("height", 480))
        self.format = str(self.props.get("format", "RGB")).upper()
        if self.format not in _V4L2_FORMATS:
            raise ElementError(
                f"{self.name}: format must be one of "
                f"{sorted(_V4L2_FORMATS)}, got {self.format!r}")
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.rate = parse_fraction(self.props.get("framerate", (30, 1)))
        self.io_mode = str(self.props.get("io_mode", "auto")).lower()
        if self.io_mode not in ("auto", "native", "raw"):
            raise ElementError(
                f"{self.name}: io-mode must be auto|native|raw, got {self.io_mode!r}")
        self.props.get("n_bufs")  # the native ring's depth: accepted, unused
        self._reader: Optional[_RawReader] = None

    def configure(self, in_caps, out_pads):
        caps = Caps.new(MediaType.VIDEO, format=self.format, width=self.width,
                        height=self.height, framerate=self.rate)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def _frame_bytes(self) -> int:
        return self.width * self.height * _V4L2_FORMATS[self.format][1]

    def start(self) -> None:
        try:
            st = os.stat(self.device)
        except OSError as e:
            raise ElementError(
                f"{self.name}: cannot stat device {self.device!r}: {e}") from e
        if self.io_mode == "native" or (self.io_mode == "auto"
                                        and stat.S_ISCHR(st.st_mode)):
            raise ElementError(
                f"{self.name}: the V4L2 character-device backend (io-mode="
                f"native, or a character device under io-mode=auto: "
                f"{self.device!r}) is not ported; feed raw frames from a file "
                "or a FIFO with io-mode=raw")
        self._reader = _RawReader(self.name, self.device)

    def stop(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def generate(self):
        stop = getattr(self, "_stop_event", None) or threading.Event()
        num = self.num_buffers if self.num_buffers >= 0 else 1 << 62
        frame_ns = int(1e9 * self.rate[1] / max(1, self.rate[0]))
        bpp = _V4L2_FORMATS[self.format][1]
        need = self._frame_bytes()
        for i in range(num):
            if stop.is_set():
                return
            data = self._reader.read(need, stop)
            if data is None:
                return  # EOF, or stop
            raw = np.frombuffer(data, np.uint8)
            yield Buffer([raw.reshape(self.height, self.width, bpp)],
                         pts=i * frame_ns)
