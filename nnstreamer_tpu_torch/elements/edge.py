"""edgesrc/edgesink: pub/sub tensor transport between pipelines/hosts.

Port of ``nnstreamer_tpu/elements/edge.py``: the same handshake, wire
frames and fan-out, so an ``edgesrc`` of either package subscribes to an
``edgesink`` of the other.  A buffer whose tensors sit on the card is
copied to the host once, as the wire encodes it (bf16 as its 2-byte
words); a received buffer holds host tensors.

Reference analog (SURVEY §2.7): ``gst/edge/gstedgesrc.c``/``gstedgesink.c``
publish/subscribe tensor streams through the nnstreamer-edge library (TCP
direct, or MQTT-hybrid broker discovery).  Here the transport is the
framework wire format over TCP: an ``edgesink`` listens and fans every
buffer out to all connected subscribers whose topic matches; an ``edgesrc``
connects, subscribes with a topic, and injects received buffers into its
pipeline.  This is the DCN-side stream feed of the distribution story (the
north-star maps broker transport to DCN streaming into per-host device_put).

Unlike tensor_query there is no response path and no per-message pairing —
fire-and-forget fan-out, matching the reference's pub/sub semantics (slow
subscribers drop: the publisher never backpressures the pipeline).
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Iterator, Optional, Union

from ..core.buffer import Buffer, Event
from ..core.log import logger, metrics
from ..core.registry import register_element
from ..utils import wire
from ..utils.net import TcpListener, client_handshake, server_handshake
from .base import ElementError, SinkElement, SourceElement

log = logger(__name__)

#: Per-subscriber queue EOS marker (publisher reached end of stream).
_EOS = None


@register_element("edgesink")
class EdgeSink(SinkElement):
    """Publish buffers to every connected subscriber.

    Props: ``host`` (bind address), ``port`` (0 = OS-assigned; see
    ``.bound_port``), ``topic``, ``max-queue`` (per-subscriber send queue;
    overflow drops oldest — pub/sub never backpressures).
    """

    kind = "edgesink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 0))
        self.topic = str(self.props.get("topic", ""))
        self.max_queue = int(self.props.get("max_queue", 64))
        self._subs: Dict[int, _queue.Queue] = {}
        self._lock = threading.Lock()
        self._next_sub = 0
        self._listener: Optional[TcpListener] = None

    def start(self) -> None:
        self._listener = TcpListener(self.host, self.port, self._sub_session,
                                     name=self.name)

    @property
    def bound_port(self) -> int:
        if self._listener is None:
            raise ElementError("edgesink not started")
        return self._listener.port

    def stop(self) -> None:
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        with self._lock:
            self._subs.clear()

    def _sub_session(self, conn: socket.socket) -> None:
        stopping = self._listener.stopping
        if server_handshake(conn, "subscribe", self.topic) is None:
            return
        conn.settimeout(None)
        q: _queue.Queue = _queue.Queue(maxsize=self.max_queue)
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            self._subs[sid] = q
        metrics.count(f"{self.name}.subscribers")
        try:
            while not stopping.is_set():
                try:
                    payload = q.get(timeout=0.2)
                except _queue.Empty:
                    continue
                if payload is _EOS:  # publisher EOS: close -> subscriber EOS
                    return
                wire.write_frame(conn, payload)
        finally:
            with self._lock:
                self._subs.pop(sid, None)

    def _offer(self, q: _queue.Queue, item) -> None:
        """Enqueue without ever blocking the pipeline: overflow drops the
        slow subscriber's oldest frame (pub/sub semantics)."""
        while True:
            try:
                q.put_nowait(item)
                return
            except _queue.Full:
                try:
                    q.get_nowait()
                    metrics.count(f"{self.name}.dropped")
                except _queue.Empty:
                    continue

    def process(self, pad, buf: Buffer):
        with self._lock:
            subs = list(self._subs.values())
        if not subs:
            metrics.count(f"{self.name}.no_subscribers")
            return []  # nobody listening: skip host copy + serialization
        payload = wire.encode_buffer(buf.resolve())
        for q in subs:
            self._offer(q, payload)
        metrics.count(f"{self.name}.published")
        return []

    def finalize(self):
        with self._lock:
            subs = list(self._subs.values())
        for q in subs:
            self._offer(q, _EOS)  # drop-oldest guarantees the marker lands
        return []


@register_element("edgesrc")
class EdgeSrc(SourceElement):
    """Subscribe to an edgesink and inject received buffers.

    Props: ``host``, ``port``, ``topic``, ``num-buffers`` (stop after N;
    -1 = until publisher closes).
    """

    kind = "edgesrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 0))
        self.topic = str(self.props.get("topic", ""))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        if self.port <= 0:
            raise ElementError(f"{self.name}: port property required")
        try:
            self._sock = socket.create_connection((self.host, self.port), timeout=5.0)
            client_handshake(self._sock, "subscribe", topic=self.topic)
        except (OSError, ConnectionError) as e:
            self.stop()
            raise ElementError(
                f"{self.name}: cannot subscribe {self.host}:{self.port}: {e}"
            ) from e
        self._sock.settimeout(0.2)

    def stop(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        stop = getattr(self, "_stop_event", threading.Event())
        count = 0
        while not stop.is_set() and count != self.num_buffers:
            sock = self._sock
            if sock is None:
                return
            try:
                raw = wire.read_frame(sock)
            except socket.timeout:
                continue
            except OSError:
                return
            except ValueError as e:  # corrupt frame (CRC mismatch)
                log.warning("%s: corrupt frame, treating as connection "
                            "loss: %s", self.name, e)
                metrics.count(f"{self.name}.corrupt")
                return
            if raw is None:
                return  # publisher closed: EOS
            try:
                buf, _flags = wire.decode_buffer(raw)
            except ValueError as e:
                log.warning("%s: corrupt payload, treating as connection "
                            "loss: %s", self.name, e)
                metrics.count(f"{self.name}.corrupt")
                return
            metrics.count(f"{self.name}.received")
            yield buf
            count += 1
