"""MQTT-lite broker: standalone topic-routed pub/sub over TCP.

Port of ``nnstreamer_tpu/utils/broker.py``: the same control frames,
topic filters, retained messages and QoS 0, so clients of either package
use a broker of the other.

Reference analog (SURVEY §2.7): the reference's ``mqttsrc``/``mqttsink``
publish GstBuffers through an external paho-mqtt broker; nnstreamer-edge's
MQTT-hybrid mode uses a broker for discovery.  No MQTT stack exists in this
environment, so the TPU build ships its own minimal broker speaking the
framework wire protocol — same role, same topology (N publishers, M
subscribers, a broker in between), none of the protocol baggage.

Semantics kept from MQTT:

* topic filters with ``#`` (multi-level, suffix) and ``+`` (single level);
* retained messages: a subscriber immediately receives the last retained
  message of every matching topic;
* QoS 0 only — fire-and-forget, slow subscribers drop oldest.

Control frames are JSON (type=hello/ack/sub/pub); payload frames carry
``topic`` in the buffer meta.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Optional, Tuple

from ..core.log import logger
from . import wire
from .net import TcpListener, parse_control

log = logger(__name__)


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT-style matching: ``a/+/c`` one level, ``a/#`` any suffix."""
    if pattern in ("", "#"):
        return True
    pp = pattern.split("/")
    tp = topic.split("/")
    for i, seg in enumerate(pp):
        if seg == "#":
            return True
        if i >= len(tp):
            return False
        if seg == "+":
            continue
        if seg != tp[i]:
            return False
    return len(pp) == len(tp)


class MqttLiteBroker:
    """Threaded broker; one instance per process, many topics."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, retain: bool = True):
        self.host = host
        self.max_queue = max_queue
        self.retain_enabled = retain
        self._subs: Dict[int, Tuple[str, _queue.Queue]] = {}
        self._retained: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._port = port
        self._listener: Optional[TcpListener] = None

    @property
    def port(self) -> int:
        return self._listener.port if self._listener else self._port

    def start(self) -> "MqttLiteBroker":
        if self._listener is None:
            self._listener = TcpListener(
                self.host, self._port, self._session, name="mqtt-broker"
            )
        return self

    def stop(self) -> None:
        if self._listener is not None:
            self._listener.close()
            self._listener = None  # lets start() rebind; also the signal
            # session threads poll via _stopping()
        with self._lock:
            for _, q in self._subs.values():
                self._offer(q, None)
            self._subs.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client session ----------------------------------------------------
    def _session(self, conn: socket.socket) -> None:
        from .net import finish_server_handshake

        conn.settimeout(0.2)
        hello = parse_control(self._read_idle(conn))
        hello = finish_server_handshake(conn, hello, ("pub", "sub"))
        if hello is None:
            conn.close()
            return
        if hello["type"] == "pub":
            self._pub_loop(conn, str(hello.get("topic", "")))
        else:
            self._sub_loop(conn, str(hello.get("topic", "#")))

    def _stopping(self) -> bool:
        # session threads may observe stop() clearing _listener mid-read:
        # a vanished listener means "stopping", never an AttributeError
        listener = self._listener
        return listener is None or listener.stopping.is_set()

    def _read_idle(self, conn) -> Optional[bytes]:
        while not self._stopping():
            try:
                return wire.read_frame(conn)
            except socket.timeout:
                continue
            except (OSError, ValueError):
                return None
        return None

    def _pub_loop(self, conn: socket.socket, default_topic: str) -> None:
        while not self._stopping():
            try:
                frame = wire.read_frame(conn)
            except socket.timeout:
                continue
            except (OSError, ValueError):
                break
            if frame is None:
                break
            self.publish_raw(frame, default_topic)
        conn.close()

    def subscriber_count(self, topic: Optional[str] = None) -> int:
        """Live subscriptions (optionally: those whose pattern matches
        ``topic``).  Lets publishers/tests wait for a subscriber to be
        registered instead of racing the SUBSCRIBE against the first
        QoS-0 publish (which is simply lost if it wins the race)."""
        with self._lock:
            if topic is None:
                return len(self._subs)
            return sum(1 for pat, _ in self._subs.values()
                       if topic_matches(pat, topic))

    def publish_raw(self, frame: bytes, default_topic: str = "") -> None:
        """Route one encoded-buffer frame to matching subscribers."""
        topic = default_topic
        try:  # topic override rides in buffer meta
            buf, _ = wire.decode_buffer(frame)
            topic = str(buf.meta.get("topic", default_topic))
        except ValueError:
            pass
        with self._lock:
            if self.retain_enabled:
                self._retained[topic] = frame
            targets = [q for (pat, q) in self._subs.values() if topic_matches(pat, topic)]
        for q in targets:
            self._offer(q, frame)

    def _sub_loop(self, conn: socket.socket, pattern: str) -> None:
        q: _queue.Queue = _queue.Queue(maxsize=self.max_queue)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._subs[sid] = (pattern, q)
            backlog = [
                f for t, f in self._retained.items() if topic_matches(pattern, t)
            ] if self.retain_enabled else []
        for f in backlog:
            self._offer(q, f)
        try:
            while not self._stopping():
                try:
                    item = q.get(timeout=0.2)
                except _queue.Empty:
                    continue
                if item is None:
                    break
                try:
                    wire.write_frame(conn, item)
                except OSError:
                    break
        finally:
            with self._lock:
                self._subs.pop(sid, None)
            conn.close()

    def _offer(self, q: _queue.Queue, item) -> None:
        while True:
            try:
                q.put_nowait(item)
                return
            except _queue.Full:
                try:
                    q.get_nowait()  # QoS 0: drop oldest
                except _queue.Empty:
                    pass
