"""mqttsrc/mqttsink: broker-routed pub/sub elements.

Port of ``nnstreamer_tpu/elements/mqtt.py`` over this package's
:class:`~nnstreamer_tpu_torch.utils.broker.MqttLiteBroker` (or the JAX
package's: the frames are the same).  A buffer on the card is copied to
the host once, as the wire encodes it.

Reference analog (SURVEY §2.7): ``gst/mqtt/mqttsrc.c``/``mqttsink.c`` —
publish/subscribe GstBuffers through a paho-mqtt broker, with NTP-based
timestamp sync across hosts (``ntputil.c``).  The TPU build talks to the
in-repo :class:`MqttLiteBroker` (same
topology; QoS 0; retained messages) and carries wall-clock epoch in buffer
meta for cross-host pts rebasing (the ntputil analog — hosts here share a
clock, so the offset is measured, not NTP-queried).

Props (both): ``host``, ``port`` (broker address), ``topic``
(``pub-topic``/``sub-topic`` aliases match the reference).
``mqttsink debug-epoch=true`` stamps ``epoch_ns``; ``mqttsrc
sync=rebase`` rewrites pts to the local monotonic timeline using it.
"""

from __future__ import annotations

import socket
import time
from typing import Iterator, Optional, Union

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.log import logger, metrics
from ..core.registry import register_element
from ..utils import wire
from .base import ElementError, SinkElement, SourceElement

log = logger(__name__)


class BrokerRejected(ElementError):
    """Deterministic broker nack (version/topic): never retried."""


def _connect(host: str, port: int, role: str, topic: str,
             timeout: float) -> socket.socket:
    from ..utils.net import client_handshake

    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            conn = socket.create_connection((host, port), timeout=2.0)
            conn.settimeout(2.0)
            # Shared handshake: carries PROTOCOL_VERSION so frame-layout
            # mismatches are rejected at connect, not mid-stream.
            client_handshake(conn, role, topic=topic)
            conn.settimeout(0.2)
            return conn
        except (ConnectionRefusedError, ConnectionResetError, TimeoutError) as e:
            # Broker not up yet / mid-restart: transient, keep retrying.
            last = e
            time.sleep(0.05)
        except ConnectionError as e:
            # An explicit nack (version/topic rejection) is deterministic —
            # retrying would hammer the broker and bury the reason.
            raise BrokerRejected(
                f"broker {host}:{port} rejected {role}: {e}") from e
        except (OSError, ValueError) as e:
            last = e
            time.sleep(0.05)
    raise ElementError(f"cannot reach broker {host}:{port}: {last}")


@register_element("mqttsink")
class MqttSink(SinkElement):
    kind = "mqttsink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 1883))
        self.topic = str(self.props.get("pub_topic", self.props.get("topic", "")))
        self.debug_epoch = bool(self.props.get("debug_epoch", True))
        self.connect_timeout = float(self.props.get("connect_timeout", 10.0))
        self._conn: Optional[socket.socket] = None

    def start(self) -> None:
        self._conn = _connect(self.host, self.port, "pub", self.topic,
                              self.connect_timeout)

    def stop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def process(self, pad, buf: Buffer):
        buf = buf.resolve()
        buf = buf.with_tensors(buf.tensors, spec=buf.spec)  # meta of its own
        buf.meta.setdefault("topic", self.topic)
        if self.debug_epoch:
            buf.meta["epoch_ns"] = time.time_ns()
            buf.meta["mono_ns"] = time.monotonic_ns()
        try:
            wire.write_frame(self._conn, wire.encode_buffer(buf))
            metrics.count(f"{self.name}.published")
        except OSError as e:
            # MQTT QoS 0: publishing into a dead broker drops, not errors.
            metrics.count(f"{self.name}.dropped")
            log.warning("%s: publish failed: %s", self.name, e)
        return []


@register_element("mqttsrc")
class MqttSrc(SourceElement):
    kind = "mqttsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 1883))
        self.topic = str(self.props.get("sub_topic", self.props.get("topic", "#")))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.sync = str(self.props.get("sync", "none"))  # none | rebase
        self.connect_timeout = float(self.props.get("connect_timeout", 10.0))
        # Reference: nnstreamer-edge reconnects MQTT-hybrid subscribers on
        # broker loss (SURVEY §5.3).  Opt-in: with reconnect=false (default)
        # a closed broker ends the stream immediately (EOS) — no stall.
        self.reconnect = bool(self.props.get("reconnect", False))
        self._conn: Optional[socket.socket] = None

    def configure(self, in_caps, out_pads):
        self.out_caps = {p: Caps.any() for p in out_pads}
        return self.out_caps

    def start(self) -> None:
        self._conn = _connect(self.host, self.port, "sub", self.topic,
                              self.connect_timeout)

    def stop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _reconnect(self, stop) -> bool:
        metrics.count(f"{self.name}.reconnects")
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        deadline = time.monotonic() + self.connect_timeout
        while time.monotonic() < deadline:
            if stop is not None and stop.is_set():
                return False
            try:
                self._conn = _connect(self.host, self.port, "sub", self.topic, 1.0)
                return True
            except BrokerRejected:
                raise  # deterministic rejection: surface, don't hammer
            except ElementError:
                time.sleep(0.2)
        log.warning("%s: broker did not come back within %.1fs",
                    self.name, self.connect_timeout)
        return False

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        n = 0
        stop = getattr(self, "_stop_event", None)
        while self.num_buffers < 0 or n < self.num_buffers:
            if stop is not None and stop.is_set():
                return
            try:
                frame = wire.read_frame(self._conn)
            except socket.timeout:
                continue
            except (OSError, ValueError) as e:
                log.warning("%s: broker connection lost: %s", self.name, e)
                if self.reconnect and self._reconnect(stop):
                    continue
                return
            if frame is None:  # broker closed the stream
                if self.reconnect and self._reconnect(stop):
                    continue
                return
            buf, _flags = wire.decode_buffer(frame)
            if self.sync == "rebase" and "mono_ns" in buf.meta:
                # ntputil analog: rebase the publisher's monotonic pts onto
                # our timeline using the wall-clock epoch it stamped.
                remote_wall = int(buf.meta.get("epoch_ns", 0))
                offset = time.time_ns() - remote_wall  # transit + clock skew
                buf.pts = (buf.pts or 0) + offset
                buf.meta["transit_ns"] = offset
            metrics.count(f"{self.name}.frames")
            n += 1
            yield buf
