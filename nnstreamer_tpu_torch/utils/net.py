"""Shared TCP listener + handshake scaffolding for the distribution
elements (tensor_query server, edgesink publisher).

Port of ``nnstreamer_tpu/utils/net.py``, copied whole: the same
handshake, protocol version and control frames, so a client of either
package talks to a server of the other.

Reference analog: the connection handshake / capability exchange inside
nnstreamer-edge (SURVEY §2.7) — one implementation serving both the
request/response (query) and pub/sub (edge) transports.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Optional

from ..core.log import logger
from . import tracing, wire

log = logger(__name__)


class TcpListener:
    """Bind + accept loop; one daemon thread per connection.

    ``session_cb(conn)`` runs on the connection's own thread and owns the
    socket's lifetime (the listener closes it after the callback returns).
    """

    def __init__(self, host: str, port: int,
                 session_cb: Callable[[socket.socket], None],
                 name: str = "tcp"):
        self._session_cb = session_cb
        self._name = name
        self._stopping = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name=f"{name}-accept:{self.port}",
            daemon=True,
        ).start()

    @property
    def stopping(self) -> threading.Event:
        return self._stopping

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._session, args=(conn,), daemon=True,
                name=f"{self._name}-conn",
            ).start()

    def _session(self, conn: socket.socket) -> None:
        try:
            self._session_cb(conn)
        except (OSError, ValueError) as e:
            log.debug("%s: session ended: %s", self._name, e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stopping.set()
        try:
            self._sock.close()
        except OSError:
            pass


def parse_control(raw: Optional[bytes]) -> Optional[dict]:
    """Control frames are JSON objects; tensor frames start with the wire
    magic.  Returns None for non-control frames."""
    if not raw:
        return None
    if len(raw) >= 4 and int.from_bytes(raw[:4], "little") == wire.MAGIC:
        return None
    try:
        msg = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    return msg if isinstance(msg, dict) else None


PROTOCOL_VERSION = 2  # v2: crc32-trailed wire frames


def finish_server_handshake(conn: socket.socket, hello: Optional[dict],
                            expect_types, topic: str = "") -> Optional[dict]:
    """Validate an already-read hello and reply ack/nack (the shared half of
    every server-side handshake: version gate, topic filter, TCP_NODELAY).

    ``expect_types`` is one type string or a tuple of acceptable ones.
    Returns the hello dict on success, None on rejection."""
    if isinstance(expect_types, str):
        expect_types = (expect_types,)
    if not hello or hello.get("type") not in expect_types:
        return None
    if hello.get("proto", 0) != PROTOCOL_VERSION:
        # Frame layout differs across versions: reject at connect time
        # instead of desyncing mid-stream.
        wire.write_frame(conn, json.dumps(
            {"type": "nack",
             "reason": f"protocol version {hello.get('proto')} != "
                       f"{PROTOCOL_VERSION}"}).encode())
        return None
    if topic and hello.get("topic", "") not in ("", topic):
        wire.write_frame(conn, json.dumps(
            {"type": "nack", "reason": "topic mismatch"}).encode())
        return None
    ack = {"type": "ack", "topic": topic, "proto": PROTOCOL_VERSION}
    if isinstance(hello.get("t0"), int):
        # nns-weave clock echo piggybacked on the handshake
        # (docs/OBSERVABILITY.md "Distributed tracing"): echo the
        # client's send stamp with our receive/send stamps + trace epoch
        # so the client can derive offset ± uncertainty between the two
        # monotonic bases.  t1 ideally marks hello arrival; stamping it
        # here (validation later than read) only widens the bound.
        ack.update(t0=hello["t0"], t1=time.monotonic_ns(),
                   epoch=tracing.trace_epoch(), t2=time.monotonic_ns())
    wire.write_frame(conn, json.dumps(ack).encode())
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return hello


def server_handshake(conn: socket.socket, expect_type: str,
                     topic: str = "") -> Optional[dict]:
    """Read a hello frame, enforce version + topic, reply ack/nack.

    Returns the hello dict on success, None on rejection (nack sent)."""
    conn.settimeout(5.0)
    hello = parse_control(wire.read_frame(conn))
    return finish_server_handshake(conn, hello, expect_type, topic)


def client_handshake(conn: socket.socket, hello_type: str, **fields) -> dict:
    """Send hello, await ack; raises ConnectionError on rejection.

    The hello carries a clock-echo stamp (``t0`` + this process's trace
    epoch); a weave-aware server echoes ``t0/t1/t2`` + its epoch in the
    ack, and the returned dict then gains a synthesized ``clock`` entry
    ``{"epoch", "offset_ns", "uncertainty_ns"}`` (offset = peer − local
    monotonic base) for the caller to feed into
    ``tracing.recorder.note_clock``.  Older servers ignore the stamp."""
    t0 = time.monotonic_ns()
    wire.write_frame(conn, json.dumps(
        {"type": hello_type, "proto": PROTOCOL_VERSION, "t0": t0,
         "epoch": tracing.trace_epoch(), **fields}).encode("utf-8"))
    ack = parse_control(wire.read_frame(conn))
    t3 = time.monotonic_ns()
    if ack and ack.get("type") == "nack":
        # the server's typed refusal carries the reason (version/topic
        # mismatch) — surface it instead of the raw frame
        raise ConnectionError(
            f"server rejected handshake: {ack.get('reason', 'unspecified')}")
    if not ack or ack.get("type") != "ack":
        raise ConnectionError(f"server rejected connection: {ack}")
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if ack.get("t0") == t0 and isinstance(ack.get("t1"), int) \
            and isinstance(ack.get("t2"), int) \
            and isinstance(ack.get("epoch"), int):
        off, unc = tracing.clock_offset(t0, ack["t1"], ack["t2"], t3)
        ack["clock"] = {"epoch": ack["epoch"], "offset_ns": off,
                        "uncertainty_ns": unc}
    return ack
