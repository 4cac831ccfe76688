"""tensor_query elements: offload inference to a remote pipeline.

Reference analog (SURVEY §2.7, §3.3): ``tensor_query_client`` serializes
input tensors, sends them to an "edge server" over nnstreamer-edge TCP,
receives results asynchronously matched by message id (GstMetaQuery), and
pushes them downstream; ``tensor_query_serversrc`` listens and injects
received tensors into the server-side pipeline; ``tensor_query_serversink``
returns each result to the client connection recorded in the buffer's meta.
Multiple clients are served concurrently.

Port of ``nnstreamer_tpu/elements/query.py``: the same elements, props,
protocol and wire bytes (utils/wire.py), so a client of either package
is served by a server of the other.  A server pipeline typically runs an
``llm`` filter on the card between the two server elements; the
serversink copies each answer to the host once before it is encoded.

Protocol (all frames length-prefixed, utils/wire.read_frame/write_frame):

  client->server  JSON hello  {"type":"hello","caps":str,"topic":str}
  server->client  JSON ack    {"type":"ack","caps":str}
  client->server  tensor frame (wire buffer; meta["_query_msg"]=msg id)
  server->client  tensor frame (same msg id echoed in meta)
"""

from __future__ import annotations

import collections
import json
import queue as _queue
import random
import socket
import threading
import time

import numpy as np
import torch
from typing import Deque, Dict, Iterator, List, Optional, Tuple, Union

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.log import logger, metrics
from ..core import meta_keys
from ..core.registry import register_element
from ..utils import elastic, tracing as _tracing, wire
from ..utils.armor import META_POISON
from ..utils.net import (TcpListener, client_handshake, parse_control,
                         server_handshake)
from .base import Element, ElementError, SourceElement, SinkElement, SRC

log = logger(__name__)

# Protocol meta keys are declared once in core/meta_keys.py (the nns-proto
# lint's alphabet source of truth); the short module aliases below keep
# call sites readable.
_META_MSG = meta_keys.META_QUERY_MSG
_META_CONN = meta_keys.META_QUERY_CONN
#: journal seqno of an accepted request (docs/ROBUSTNESS.md): stamped by
#: the serversrc reader when a request journal is configured, consumed
#: (ack + strip) by the serversink when the answer leaves
_META_JSEQ = meta_keys.META_JOURNAL_SEQ
#: marks a buffer re-admitted by journal replay (its original
#: connection died with the previous process; the serversink acks it
#: as answered instead of warning about the missing conn)
_META_REPLAY = meta_keys.META_JOURNAL_REPLAY
#: tenant identity riding the wire meta (core/meta_keys.META_TENANT):
#: stamped by the client (``tenant=`` prop / appsrc / hello fallback),
#: read by the server for per-tenant accounting + admission decisions
_META_TENANT = meta_keys.META_TENANT
#: serversrc batching: list of per-request meta dicts riding one stacked
#: buffer; serversink splits output rows back to each client.
_META_BATCH = meta_keys.META_QUERY_BATCH
# server verdict / streaming response flags (same registry)
_META_SHED = meta_keys.META_SHED
_META_WIRE_REJECT = meta_keys.META_WIRE_REJECT
_META_ERROR = meta_keys.META_ERROR
_META_ABORT = meta_keys.META_ABORT_REASON
_META_SIDX = meta_keys.META_STREAM_INDEX
_META_SLAST = meta_keys.META_STREAM_LAST
_META_SABORT = meta_keys.META_STREAM_ABORTED
_META_TQ = meta_keys.META_ENQUEUE_NS
#: distributed trace context (nns-weave, docs/OBSERVABILITY.md): the
#: client's epoch-prefixed trace id rides requests as _tparent, is
#: adopted server-side as the trace id (after the _tid scrub below) and
#: echoed on every response/token so both rings share one id
_META_TID = meta_keys.META_TRACE_ID
_META_TPARENT = meta_keys.META_TRACE_PARENT

#: Placeholder in ``_done`` for a fully-streamed request: advances the
#: in-order cursor without emitting (its buffers already went downstream).
_STREAM_DONE = object()

def _host(t):
    """One tensor on the host: a torch tensor is copied off the card once
    and keeps its dtype (bf16 included; the wire codec takes it from
    there), anything else becomes a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu()
    return np.asarray(t)


def _to_host(buf: Buffer) -> Buffer:
    return buf.with_tensors([_host(t) for t in buf.tensors])


def _stack(rows: List) -> Union[np.ndarray, torch.Tensor]:
    """Stack same-signature request tensors on a new leading axis (torch
    when a row is a torch tensor: the wire decodes bf16 into torch)."""
    if any(isinstance(r, torch.Tensor) for r in rows):
        return torch.stack([torch.as_tensor(r) for r in rows])
    return np.stack([np.asarray(r) for r in rows])


# Server cores shared between a serversrc and its serversink, keyed by the
# ``id`` property (reference: query server data registry paired by server id).
_servers: Dict[int, "_ServerCore"] = {}
_servers_lock = threading.Lock()


class _ServerCore:
    """TCP listener + per-connection readers feeding one inbound queue.

    The serversrc drains ``inbound``; the serversink routes responses back
    through ``send()`` using the connection id stamped into buffer meta
    (the GstMetaQuery analog).

    **Admission control** (docs/SERVING.md "Front door"): ``max_backlog``
    bounds the inbound queue; when it is full the ``admission`` policy
    decides what happens instead of the reader blocking the TCP stream
    behind an unbounded backlog:

    * ``block`` — the pre-admission behavior: the reader stalls until
      space frees (TCP backpressure propagates to the client's send);
    * ``shed`` — the request is DROPPED and the client receives an
      immediate empty response with ``meta["shed"]=True`` (same msg id),
      so it is never left waiting out its timeout.  Every shed is
      counted (``query_server.shed``, split per tenant) and
      span-stamped ``admit.shed`` with the victim's trace id;
    * ``downgrade`` — the request moves to a bounded LOW-PRIORITY lane
      drained only when the main queue is empty (counted as
      ``query_server.downgraded`` + ``admit.downgrade`` span); if the
      low lane is also full, it sheds as above.
    """

    _GUARDED_BY = {"_conns": "_lock", "_conn_locks": "_lock",
                   "_conn_tenants": "_lock", "_next_conn": "_lock"}

    def __init__(self, host: str, port: int, topic: str = "",
                 max_backlog: int = 256, admission: str = "block",
                 on_admit_event=None, send_buf: int = 0, journal=None):
        self.topic = topic
        self.admission = admission
        self.max_backlog = max_backlog
        #: durable request journal (utils/journal.Journal, or None):
        #: accepted requests append their wire payload BEFORE entering
        #: the pipeline; the serversink acks the entry when the answer
        #: leaves — docs/ROBUSTNESS.md "Durable request journal"
        self.journal = journal
        #: per-tenant admission OVERRIDE (tenant -> "shed"|"downgrade"):
        #: the autoscaler's host-value lever (utils/elastic.Autoscaler
        #: ``admission:`` action) — a burning tenant class can be
        #: flipped to shed while everyone else keeps the configured
        #: policy, and flipped back when its burn rate recovers
        self.tenant_admission: Dict[str, str] = {}
        #: per-connection SO_SNDBUF (0 = OS default).  Bounds how much
        #: of a wedged client's unread response stream the kernel
        #: absorbs before sends hit the socket timeout and the
        #: connection is dropped (the wedge_tenant chaos profile).
        self.send_buf = int(send_buf)
        self.inbound: _queue.Queue = _queue.Queue(maxsize=max_backlog)
        self.lowprio: _queue.Queue = _queue.Queue(maxsize=max_backlog)
        #: serversrc hook: called as (kind, buf, backlog) for every
        #: "shed"/"downgrade" decision (span stamping with the element's
        #: own recorder — the core stays pipeline-agnostic)
        self.on_admit_event = on_admit_event
        self._conns: Dict[int, socket.socket] = {}
        self._conn_locks: Dict[int, threading.Lock] = {}
        self._conn_tenants: Dict[int, str] = {}
        self._next_conn = 0
        self._lock = threading.Lock()
        self._listener = TcpListener(host, port, self._reader, name="query")
        self.port = self._listener.port

    @property
    def _stopping(self) -> threading.Event:
        return self._listener.stopping

    def _reader(self, conn: socket.socket) -> None:
        hello = server_handshake(conn, "hello", self.topic)
        if hello is None:
            log.warning("query: connection rejected at handshake")
            return
        conn.settimeout(0.2)
        if self.send_buf > 0:
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.send_buf)
            except OSError:
                pass
        conn_tenant = str(hello.get("tenant", "") or "") or None
        with self._lock:
            cid = self._next_conn
            self._next_conn += 1
            self._conns[cid] = conn
            self._conn_locks[cid] = threading.Lock()
            if conn_tenant is not None:
                self._conn_tenants[cid] = conn_tenant
        try:
            while not self._stopping.is_set():
                try:
                    raw = wire.read_frame(conn)
                except socket.timeout:
                    continue
                except wire.WireError as e:
                    # FRAMING-level violation (forged length / CRC
                    # mismatch): the byte stream can no longer be
                    # trusted to resync — count it and drop the
                    # connection.  Payload-level violations below are
                    # recoverable per frame.
                    self._wire_reject(cid, None, conn_tenant, e,
                                      fatal=True)
                    return
                if raw is None:
                    return
                ctrl = parse_control(raw)
                if ctrl is not None:
                    # post-handshake JSON control frame.  Today's only
                    # kind: the nns-weave clock echo (a traced client
                    # refreshes its offset estimate mid-connection);
                    # unknown kinds are ignored for forward compat.
                    if ctrl.get("type") == "clock" \
                            and isinstance(ctrl.get("t0"), int):
                        self.send(cid, json.dumps(
                            {"type": "clock_ack", "t0": ctrl["t0"],
                             "t1": time.monotonic_ns(),
                             "epoch": _tracing.trace_epoch(),
                             "t2": time.monotonic_ns()}).encode("utf-8"))
                    continue
                try:
                    buf, _flags = wire.decode_buffer(raw)
                except wire.WireError as e:
                    # ONE malformed frame must not tear down the whole
                    # connection: answer a typed reject (best-effort
                    # msg-id salvage so the client's slot resolves
                    # instead of timing out) and keep reading.
                    self._wire_reject(cid, raw, conn_tenant, e)
                    continue
                # stream ids are SERVER-minted (filters/llm.py submit
                # overwrites them): a client-supplied value would let one
                # tenant cancel another's live stream through the
                # dead-connection backchannel
                buf.meta.pop(elastic.META_STREAM_ID, None)
                # same trust boundary for the armor/journal plumbing
                # keys: never client-suppliable ("_poison" would let a
                # tenant bypass stage invokes AND force an inflight
                # flush per request on every batching stage)
                buf.meta.pop(_META_JSEQ, None)
                buf.meta.pop(_META_REPLAY, None)
                buf.meta.pop(META_POISON, None)
                # distributed trace context: a client-stamped _tid is
                # NEVER trusted (it would alias this server's own ids);
                # the _tparent context is adopted as the server-side
                # trace id only while tracing is active, and restored so
                # it rides every response back.  Off mode: scrub only,
                # zero stamps.
                buf.meta.pop(_META_TID, None)
                tparent = buf.meta.pop(_META_TPARENT, None)
                if _tracing.recorder.active \
                        and isinstance(tparent, int) \
                        and 0 < tparent < (1 << 63):
                    buf.meta[_META_TID] = tparent
                    buf.meta[_META_TPARENT] = tparent
                frame_had_tenant = _META_TENANT in buf.meta
                if conn_tenant is not None:
                    # per-frame meta wins; the hello tenant is the
                    # per-connection fallback
                    buf.meta.setdefault(_META_TENANT, conn_tenant)
                metrics.count("query_server.in",
                              tenant=buf.meta.get(_META_TENANT))
                if self.journal is not None:
                    # journal BEFORE admission: an accepted request must
                    # be durable before any work happens on it.  A shed
                    # decision acks immediately below (it was answered).
                    # A hello-fallback tenant is stamped into the
                    # journaled payload (re-encode) — a replayed entry
                    # must keep its tenant identity for quota/SLO/
                    # breaker attribution even though the original
                    # frame bytes lack the key.  The conn id is NOT
                    # stamped yet, so the record stays connection-free.
                    tenant = buf.meta.get(_META_TENANT)
                    jraw = (wire.encode_buffer(buf)
                            if (tenant is not None
                                and not frame_had_tenant) else raw)
                    seq = self.journal.append(jraw, tenant=tenant)
                    if seq:  # 0 = journal already closed (shutdown)
                        buf.meta[_META_JSEQ] = seq
                        if self.on_admit_event is not None:
                            self.on_admit_event("journal", buf, seq)
                buf.meta[_META_CONN] = cid
                self._admit(buf)
        finally:
            self.drop_conn(cid)

    def _wire_reject(self, cid: int, raw: Optional[bytes], conn_tenant,
                     err: wire.WireError, fatal: bool = False) -> None:
        """Count + answer one rejected wire frame (docs/ROBUSTNESS.md).
        ``fatal`` marks framing-level violations, where no answer can be
        routed (the stream is desynced) and the caller drops the
        connection."""
        meta = wire.salvage_meta(raw) if raw is not None else None
        tenant = ((meta or {}).get(_META_TENANT) or conn_tenant)
        metrics.count("query_server.wire_rejects", tenant=tenant)
        log.warning("query: rejected wire frame from conn %d "
                    "(tenant=%s%s): %s", cid, tenant,
                    ", connection dropped" if fatal else "", err)
        if self.on_admit_event is not None:
            victim = Buffer([], meta=dict(meta or {}))
            if tenant is not None:
                victim.meta.setdefault(_META_TENANT, tenant)
            self.on_admit_event("wire_reject", victim,
                                str(err)[:200])
        if fatal:
            return
        mid = (meta or {}).get(_META_MSG)
        if mid is None:
            return  # nothing to route the reject to
        notice = Buffer([], meta={
            _META_MSG: mid, _META_WIRE_REJECT: True,
            _META_ABORT: meta_keys.ABORT_REASON_WIRE,
            _META_ERROR: str(err)[:200]})
        if tenant is not None:
            notice.meta[_META_TENANT] = tenant
        self.send(int(cid), wire.encode_buffer(notice))

    # -- admission ---------------------------------------------------------
    def backlog(self) -> int:
        return self.inbound.qsize() + self.lowprio.qsize()

    def _admit(self, buf: Buffer) -> str:
        """Admit one request per the (tenant-overridable) policy;
        returns the decision: ``"ok"`` | ``"downgrade"`` | ``"shed"``."""
        # per-tenant override first (the autoscaler's admission action),
        # then the element-configured policy
        policy = self.admission
        tenant = buf.meta.get(_META_TENANT)
        if tenant is not None and self.tenant_admission:
            policy = self.tenant_admission.get(tenant, policy)
        if policy == "shed-all":
            # the armor circuit breaker's override (docs/ROBUSTNESS.md):
            # a repeat poison offender is shed UNCONDITIONALLY, not just
            # under backlog pressure like the autoscaler's "shed"
            self._shed(buf)
            metrics.gauge("query_server.backlog", float(self.backlog()))
            return "shed"
        if policy == "block":
            while not self._stopping.is_set():
                try:
                    self.inbound.put(buf, timeout=0.1)
                    break
                except _queue.Full:
                    continue
            metrics.gauge("query_server.backlog", float(self.backlog()))
            return "ok"
        decision = "ok"
        try:
            self.inbound.put_nowait(buf)
        except _queue.Full:
            if policy == "downgrade":
                try:
                    self.lowprio.put_nowait(buf)
                except _queue.Full:
                    self._shed(buf)
                    decision = "shed"
                else:
                    decision = "downgrade"
                    metrics.count("query_server.downgraded",
                                  tenant=buf.meta.get(_META_TENANT))
                    if self.on_admit_event is not None:
                        self.on_admit_event("downgrade", buf,
                                            self.backlog())
            else:
                self._shed(buf)
                decision = "shed"
        metrics.gauge("query_server.backlog", float(self.backlog()))
        return decision

    def _shed(self, buf: Buffer) -> None:
        """Drop one request at admission: count it per tenant, notify the
        serversrc (span), and answer the client immediately with an empty
        ``shed`` response so its slot never waits out the timeout."""
        tenant = buf.meta.get(_META_TENANT)
        metrics.count("query_server.shed", tenant=tenant)
        if self.on_admit_event is not None:
            self.on_admit_event("shed", buf, self.backlog())
        seq = buf.meta.get(_META_JSEQ)
        if seq is not None and self.journal is not None:
            # a shed IS the answer: the journal entry must not replay
            self.journal.ack(int(seq))
        cid = buf.meta.get(_META_CONN)
        mid = buf.meta.get(_META_MSG)
        if cid is None or mid is None:
            return  # nothing to answer (not a query-framed request)
        notice = Buffer([], meta={_META_MSG: mid, _META_SHED: True})
        if tenant is not None:
            notice.meta[_META_TENANT] = tenant
        self.send(int(cid), wire.encode_buffer(notice))

    def pop_request(self, timeout: float) -> Optional[Buffer]:
        """Next admitted request: the main queue strictly first, the
        low-priority lane only when the main queue is empty."""
        try:
            return self.inbound.get(timeout=timeout)
        except _queue.Empty:
            try:
                return self.lowprio.get_nowait()
            except _queue.Empty:
                return None

    def send(self, cid: int, payload: bytes) -> bool:
        with self._lock:
            conn = self._conns.get(cid)
            lk = self._conn_locks.get(cid)
        if conn is None:
            return False
        try:
            with lk:
                wire.write_frame(conn, payload)
            return True
        except OSError:
            self.drop_conn(cid)
            return False

    def drop_conn(self, cid: int) -> None:
        with self._lock:
            conn = self._conns.pop(cid, None)
            self._conn_locks.pop(cid, None)
            self._conn_tenants.pop(cid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._listener.close()
        with self._lock:
            conns = list(self._conns)
        for cid in conns:
            self.drop_conn(cid)


def _get_server(sid: int) -> Optional[_ServerCore]:
    with _servers_lock:
        return _servers.get(sid)


@register_element("tensor_query_serversrc")
class TensorQueryServerSrc(SourceElement):
    """Listen for query clients; push received tensors into the pipeline.

    Props: ``host`` (default 127.0.0.1), ``port`` (0 = OS-assigned; read the
    bound port via ``.bound_port``), ``id`` (pairs with the serversink of the
    same id), ``topic`` (optional capability filter), ``admission``
    (``block`` | ``shed`` | ``downgrade`` — what happens when the inbound
    backlog reaches ``max-backlog``; see :class:`_ServerCore` and
    docs/SERVING.md "Front door"), ``max-backlog`` (inbound queue bound,
    default 256).

    **Dynamic batching** (no reference analog — the reference
    serves one request per invoke): ``max-batch=N`` with
    ``batch-window-ms=W`` collects up to N concurrent client requests
    (first arrival opens a W-ms window), stacks them along a new leading
    batch axis, and emits ONE buffer — the downstream filter runs a single
    batched invoke instead of N sequential ones.  ``batch-pad=true``
    (default) pads partial groups to N by repeating the last row so the
    filter sees one static shape; the serversink drops padded rows.  Only
    same-shape/dtype requests share a group; a mismatch flushes the group.
    Requires the served model to be batch-leading and the pipeline's
    filter to accept [N, ...] inputs.  Streaming filters compose too:
    an ``llm`` filter behind ``max-batch=N`` decodes N concurrent
    same-length prompts in ONE batched decode and streams each client its
    own row of every token (ids only when batched — per-row byte pieces
    are not batch-leading; clients detokenize ids themselves).
    """

    kind = "tensor_query_serversrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 0))
        self.sid = int(self.props.get("id", 0))
        self.topic = str(self.props.get("topic", ""))
        self.max_batch = int(self.props.get("max_batch", 1))
        self.batch_window_s = float(self.props.get("batch_window_ms", 2.0)) / 1e3
        self.batch_pad = bool(self.props.get("batch_pad", True))
        if self.max_batch < 1:
            raise ElementError(f"{self.name}: max-batch must be >= 1")
        self.admission = str(self.props.get("admission", "block")).lower()
        if self.admission not in ("block", "shed", "downgrade"):
            raise ElementError(
                f"{self.name}: admission must be block|shed|downgrade, "
                f"got {self.admission!r}")
        self.max_backlog = int(self.props.get("max_backlog", 256))
        if self.max_backlog < 1:
            raise ElementError(f"{self.name}: max-backlog must be >= 1")
        # ``send-buf`` bounds per-connection kernel send buffering (0 =
        # OS default); see _ServerCore.send_buf
        self.send_buf = int(self.props.get("send_buf", 0))
        # Durable request journal (docs/ROBUSTNESS.md): ``journal=DIR``
        # appends every accepted request's wire payload to a
        # segment-rotated CRC'd WAL before the pipeline sees it;
        # ``journal-fsync=off|batch|always`` picks the durability/
        # latency trade; ``journal-replay=true`` (or the pipeline-level
        # ``Pipeline(journal_replay=True)`` attach) re-admits the
        # accepted-but-unanswered entries at start().
        self.journal_dir = str(self.props.get("journal", "") or "")
        self.journal_fsync = str(
            self.props.get("journal_fsync", "batch")).lower()
        self.journal_segment_bytes = int(
            self.props.get("journal_segment_bytes", 8 << 20))
        self.journal_replay = bool(self.props.get("journal_replay",
                                                  False))
        if self.journal_dir:
            from ..utils.journal import FSYNC_MODES

            if self.journal_fsync not in FSYNC_MODES:
                raise ElementError(
                    f"{self.name}: journal-fsync must be one of "
                    f"{FSYNC_MODES}, got {self.journal_fsync!r}")
        self._journal = None
        self._core: Optional[_ServerCore] = None
        self._carry: Optional[Buffer] = None  # shape-mismatch pushback
        #: journal-replay buffers awaiting re-admission, drained FIRST
        #: by generate() (normal backpressure — see _replay_journal)
        self._replay: Deque[Buffer] = collections.deque()

    def _on_admit_event(self, kind: str, buf: Buffer, detail) -> None:
        """Span-stamp one admission decision with the victim's trace id
        (minted here when the client did not send one) — follows THIS
        pipeline's trace mode via the element-pinned recorder.  Beside
        the shed/downgrade decisions, the core reports ``journal``
        (detail = the appended seqno -> ``journal.append`` span) and
        ``wire_reject`` (counted only; no taxonomy span)."""
        if kind == "wire_reject":
            return  # counted in query_server.wire_rejects; no span kind
        tracer = getattr(self, "_trace_rec", None)
        if tracer is None:
            return
        if kind == "journal":
            args = {"seq": detail}
            ten = buf.meta.get(_META_TENANT)
            if ten is not None:
                args["tenant"] = ten
            tracer.record("journal.append", self.name,
                          buf.meta.get("_tid"), time.monotonic_ns(), 0,
                          **args)
            return
        tid = buf.meta.get("_tid")
        if tid is None:
            from ..utils import tracing as _tracing

            # stamp the minted id back onto the buffer: a DOWNGRADED
            # request flows on into the pipeline, and ingress reuses a
            # pre-existing _tid — so the admission span and the request's
            # later spans share one timeline
            tid = buf.meta["_tid"] = _tracing.next_trace_id()
        args = {"msg": buf.meta.get(_META_MSG), "backlog": detail}
        ten = buf.meta.get(_META_TENANT)
        if ten is not None:
            args["tenant"] = ten
        tracer.record(f"admit.{kind}", self.name, tid,
                      time.monotonic_ns(), 0, **args)

    def start(self) -> None:
        with _servers_lock:
            if self.sid in _servers:
                raise ElementError(f"query server id={self.sid} already running")
        if self.journal_dir:
            from ..utils.journal import Journal

            self._journal = Journal(
                self.journal_dir, fsync=self.journal_fsync,
                segment_bytes=self.journal_segment_bytes)
        try:
            core = _ServerCore(self.host, self.port, topic=self.topic,
                               max_backlog=self.max_backlog,
                               admission=self.admission,
                               on_admit_event=self._on_admit_event,
                               send_buf=self.send_buf,
                               journal=self._journal)
            with _servers_lock:
                if self.sid in _servers:  # lost a construction race
                    core.close()
                    raise ElementError(
                        f"query server id={self.sid} already running")
                _servers[self.sid] = core
        except BaseException:
            # a failed bind / lost sid race must not leak the opened
            # journal (segment fd + the fsync=batch flusher thread)
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            raise
        self._core = core
        # journal replay BEFORE any new connection's traffic: the
        # previous process's accepted-but-unanswered requests re-enter
        # the inbound queue exactly once (seqno dedup in the journal)
        if self._journal is not None and (
                self.journal_replay
                or getattr(self, "_journal_replay", False)):
            self._replay_journal()

    def _replay_journal(self) -> None:
        """Stage the journal's recovery snapshot for :meth:`generate`.

        Two deliberate properties (docs/ROBUSTNESS.md): the source is
        the snapshot ``Journal.__init__`` captured BEFORE the listener
        existed — a reconnected client's resend, accepted once the
        port is live again, is a new entry and can never be admitted a
        second time by a later directory re-scan — and the buffers are
        handed to the source's own ``generate`` loop rather than the
        bounded inbound queue, so a backlog of unanswered entries
        larger than ``max-backlog`` drains through normal pipeline
        backpressure instead of deadlocking ``start()`` with no runner
        thread alive to consume the queue."""
        from ..utils import wire as _wire

        replayed = skipped = 0
        for seq, payload in self._journal.recovered_unanswered:
            try:
                buf, _flags = _wire.decode_buffer(payload)
            except _wire.WireError as e:
                # CRC'd journal bytes failing the (possibly tightened)
                # wire limits: ack + skip, never crash the restart
                log.warning("%s: journal entry %d unreplayable (%s); "
                            "acked as dropped", self.name, seq, e)
                self._journal.ack(seq)
                skipped += 1
                continue
            buf.meta.pop(_META_CONN, None)  # the old conn died with the
            buf.meta.pop(elastic.META_STREAM_ID, None)  # old process
            # the live reader's trust boundary applies to REPLAYED
            # bytes too: the journal may hold the original frame's
            # meta verbatim, and a client-minted poison marker must
            # not ride back in and retire the entry unprocessed
            buf.meta.pop(META_POISON, None)
            buf.meta[_META_JSEQ] = seq
            buf.meta[_META_REPLAY] = True
            metrics.count("query_server.replayed",
                          tenant=buf.meta.get(_META_TENANT))
            replayed += 1
            self._replay.append(buf)
        # release the snapshot's payload bytes: staged buffers hold the
        # only copy now (a large window must not stay pinned twice)
        self._journal.recovered_unanswered = []
        if replayed or skipped:
            log.info("%s: journal replay re-admitted %d unanswered "
                     "request(s) (%d unreplayable)", self.name,
                     replayed, skipped)
        tracer = getattr(self, "_trace_rec", None)
        if tracer is not None:
            tracer.record("journal.replay", self.name, None,
                          time.monotonic_ns(), 0, entries=replayed,
                          acked_skipped=skipped)

    def stop(self) -> None:
        # Idempotent: after the first stop ``self._core`` is None, and
        # ``_servers.get(sid) is None`` must NOT match it (that del
        # raised KeyError on double-stop before the elastic PR).
        with _servers_lock:
            if self._core is not None \
                    and _servers.get(self.sid) is self._core:
                del _servers[self.sid]
        if self._core is not None:
            self._core.close()
            self._core = None
        # undrained replay buffers stay unanswered in the journal and
        # simply replay again on the next start
        self._replay.clear()
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    @property
    def bound_port(self) -> int:
        if self._core is None:
            raise ElementError("serversrc not started")
        return self._core.port

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        stop = getattr(self, "_stop_event", threading.Event())
        while not stop.is_set():
            first = self._carry
            self._carry = None
            if first is None and self._replay:
                # journal-replayed requests re-admit ahead of new
                # traffic, through the same (batching) path
                first = self._replay.popleft()
            if first is None:
                first = self._core.pop_request(timeout=0.1)
                if first is None:
                    continue
            if self.max_batch <= 1:
                yield first
                continue
            yield self._collect_group(first)

    @staticmethod
    def _sig(buf: Buffer):
        return tuple((tuple(t.shape), str(t.dtype)) for t in buf.tensors)

    def _collect_group(self, first: Buffer) -> Buffer:
        """Stack up to max-batch same-shape requests arriving within the
        window opened by ``first`` into one batch-leading buffer."""
        stop = getattr(self, "_stop_event", threading.Event())
        group = [first]
        sig = self._sig(first)
        deadline = time.monotonic() + self.batch_window_s
        while len(group) < self.max_batch and not stop.is_set():
            # 0.1s slices keep shutdown responsive inside a long window.
            remaining = min(0.1, deadline - time.monotonic())
            if remaining <= 0:
                break
            nxt = self._core.pop_request(timeout=remaining)
            if nxt is None:
                continue
            if self._sig(nxt) != sig:
                self._carry = nxt  # different shape: flush, regroup next
                break
            group.append(nxt)
        valid = len(group)
        # occupancy = batched / (batch_groups * max_batch): how full the
        # dynamic batches actually run (serving-capacity observability).
        # Counted for EVERY flushed group — including batch-pad=false solo
        # flushes, where under-occupancy is precisely the signal.
        metrics.count("query_server.batched", valid)
        metrics.count("query_server.batch_groups")
        if valid == 1 and not self.batch_pad:
            return first
        rows = group
        if self.batch_pad and valid < self.max_batch:
            rows = group + [group[-1]] * (self.max_batch - valid)
        tensors = [_stack([b.tensors[i] for b in rows])
                   for i in range(len(first.tensors))]
        metas = [dict(b.meta) for b in group]
        return Buffer(tensors, pts=first.pts, meta={_META_BATCH: metas})


@register_element("tensor_query_serversink")
class TensorQueryServerSink(SinkElement):
    """Return each result buffer to the client connection recorded in its
    meta.  Props: ``id`` (matches the serversrc).

    **Dead-connection backchannel** (docs/SERVING.md "Elastic
    serving"): when a send fails because the client connection died and
    the buffer belongs to a continuous-serving token stream (it carries
    ``stream_index`` + ``stream_id`` meta), the sink cancels the stream
    through :func:`nnstreamer_tpu.utils.elastic.cancel_stream` — the
    serve loop reaps the orphaned slot and its KV blocks back to the
    free list after its ``stream_idle_timeout`` grace instead of
    decoding (and leaking pool capacity) until ``max_new`` runs out."""

    kind = "tensor_query_serversink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.sid = int(self.props.get("id", 0))
        self._cancelled_sids: set = set()  # dedupe per-token failures

    def _send_failed(self, meta: Dict) -> None:
        metrics.count(f"{self.name}.dropped")
        stream_id = meta.get(elastic.META_STREAM_ID)
        if _META_SIDX not in meta or stream_id is None \
                or stream_id in self._cancelled_sids:
            return
        if elastic.cancel_stream(stream_id, "dead-connection"):
            self._cancelled_sids.add(stream_id)
            if len(self._cancelled_sids) > 4096:  # bounded memory
                self._cancelled_sids.clear()
            metrics.count(f"{self.name}.streams_cancelled")

    @staticmethod
    def _ack_journal(core, meta: Dict, seq=None,
                     undeliverable: bool = False) -> bool:
        """Mark the request's journal entry answered — once: plain
        responses ack immediately, token streams ack on their final
        (``stream_last``/aborted) buffer only (``Journal.ack`` is
        additionally idempotent, so racing failure paths can't double-
        record).  ``undeliverable=True`` acks regardless of stream
        position: a DEAD client's entry must not pin the WAL's
        prefix GC forever — the answer was produced, the work is not
        lost, and replaying it to a vanished connection buys nothing
        (the reconnected client's resend is a new entry).  Returns
        True when an ack record was written."""
        if seq is None:
            seq = meta.get(_META_JSEQ)
        if seq is None or core.journal is None:
            return False
        if not undeliverable and _META_SIDX in meta \
                and not (meta.get(_META_SLAST)
                         or meta.get(_META_SABORT)):
            return False
        return core.journal.ack(int(seq))

    def process(self, pad, buf: Buffer):
        core = _get_server(self.sid)
        if core is None:
            raise ElementError(f"no query server with id={self.sid}")
        try:
            return self._process_routed(core, buf)
        except BaseException as e:
            # nns-proto unanswered-path: never let an exception strand a
            # routed client into a timeout — answer with a typed
            # ``abort_reason="internal"`` terminator first (double-answer
            # is safe: the client dedupes by msg id and journal acks are
            # idempotent, both model-checked by analysis/statemachine.py
            # exactly-once), then surface the error to the pipeline.
            self._abort_unanswered(core, buf.meta, e)
            raise

    def _process_routed(self, core, buf: Buffer):
        if _META_BATCH in buf.meta:
            return self._send_batched(core, buf)
        cid = buf.meta.get(_META_CONN)
        if cid is None:
            if buf.meta.get(_META_REPLAY) \
                    and buf.meta.get(_META_JSEQ) is not None:
                # journal-replayed request: its client connection died
                # with the previous process.  The answer is recorded
                # (acked) so a further restart never re-processes the
                # entry — the reconnected client's RESEND is a new
                # entry and gets its answer through the normal path.
                # Counted once per REQUEST (the ack write), not once
                # per token buffer of a replayed stream.
                if self._ack_journal(core, buf.meta):
                    metrics.count("query_server.replay_answered",
                                  tenant=buf.meta.get(_META_TENANT))
                return []
            log.warning("%s: buffer without query connection meta; dropped", self.name)
            metrics.count(f"{self.name}.dropped")
            return []
        out = _to_host(buf)
        # Do not leak server-side routing or tracer-internal meta back to
        # the client (the queue-stamp map is this pipeline's plumbing).
        out.meta.pop(_META_CONN, None)
        out.meta.pop(_META_TQ, None)
        out.meta.pop(_META_REPLAY, None)
        out.meta.pop(META_POISON, None)  # the typed abort_reason stays
        jseq = out.meta.pop(_META_JSEQ, None)
        if core.send(int(cid), wire.encode_buffer(out)):
            metrics.count("query_server.out",
                          tenant=out.meta.get(_META_TENANT))
            self._reply_span(out.meta)
            self._ack_journal(core, out.meta, jseq)
        else:
            # undeliverable (client gone): ack anyway — the answer was
            # produced; an unacked entry would pin the WAL's prefix GC
            # forever and replay to nobody after the next restart
            self._ack_journal(core, out.meta, jseq, undeliverable=True)
            self._send_failed(out.meta)
        return []

    def _send_batched(self, core, buf: Buffer):
        """Split a dynamically batched result (serversrc ``max-batch``)
        back into one response row per originating request; padded rows
        (rows past the _META_BATCH list) are dropped.  One copy to the host
        for the whole batch, not one per client."""
        host = _to_host(buf)
        metas = host.meta[_META_BATCH]
        tensors = host.tensors
        for t in tensors:
            if t.ndim == 0 or t.shape[0] < len(metas):
                err = ElementError(
                    f"{self.name}: batched output leading dim "
                    f"{t.shape[:1] or None} < {len(metas)} batched requests "
                    "— the served model must be batch-leading for "
                    "serversrc max-batch")
                # nns-proto unanswered-path: a bare raise here would
                # strand len(metas) clients into timeouts.  Answer each
                # batched request with a typed internal abort, THEN
                # surface the config error.
                for m in metas:
                    self._abort_unanswered(core, m, err)
                raise err
        resp_meta = {k: v for k, v in host.meta.items()
                     if k not in (_META_BATCH, _META_CONN, _META_TQ,
                                  _META_JSEQ, _META_REPLAY,
                                  META_POISON)}
        for i, m in enumerate(metas):
            cid = m.get(_META_CONN)
            jseq = m.get(_META_JSEQ)
            if cid is None:
                if m.get(_META_REPLAY) and jseq is not None:
                    if self._ack_journal(core, m, jseq):
                        metrics.count("query_server.replay_answered",
                                      tenant=m.get(_META_TENANT))
                else:
                    metrics.count(f"{self.name}.dropped")
                continue
            out = Buffer([t[i] for t in tensors], pts=host.pts,
                         meta={**{k: v for k, v in m.items()
                                  if k not in (_META_CONN, _META_JSEQ,
                                               _META_REPLAY)},
                               **resp_meta})
            if core.send(int(cid), wire.encode_buffer(out)):
                metrics.count("query_server.out",
                              tenant=out.meta.get(_META_TENANT))
                self._reply_span(out.meta)
                self._ack_journal(core, out.meta, jseq)
            else:
                self._ack_journal(core, out.meta, jseq,
                                  undeliverable=True)
                self._send_failed(out.meta)
        return []

    def _reply_span(self, out_meta: dict) -> None:
        """``query.reply`` instant for one response/token frame that hit
        the wire — the server end of the nns-weave reply→recv flow
        arrow.  Off mode: the element-pinned recorder is None and this
        is one pointer check."""
        rec = getattr(self, "_trace_rec", None)
        if rec is None:
            return
        args = {"msg": out_meta.get(_META_MSG)}
        ten = out_meta.get(_META_TENANT)
        if ten is not None:
            args["tenant"] = ten
        rec.record("query.reply", self.name, out_meta.get(_META_TID),
                   time.monotonic_ns(), 0, **args)

    def _abort_unanswered(self, core, meta: dict,
                          err: BaseException) -> None:
        """Answer one routed request (or every row of a batch) with a
        typed ``stream_aborted`` / ``abort_reason="internal"`` terminator
        instead of leaving the client to wait out its timeout.  Best
        effort — the client may already be gone — and idempotent: a
        duplicate answer is deduped by msg id client-side and the
        journal ack is a no-op the second time."""
        if _META_BATCH in meta:
            for m in meta[_META_BATCH]:
                self._abort_unanswered(core, m, err)
            return
        cid = meta.get(_META_CONN)
        jseq = meta.get(_META_JSEQ)
        if cid is None or meta.get(_META_MSG) is None:
            # nothing to route an answer to; still release the WAL entry
            self._ack_journal(core, meta, jseq, undeliverable=True)
            return
        term = Buffer([], meta={
            k: v for k, v in meta.items()
            if k not in (_META_CONN, _META_JSEQ, _META_REPLAY,
                         _META_BATCH, _META_TQ, META_POISON)})
        term.meta[_META_SABORT] = True
        term.meta[_META_ABORT] = meta_keys.ABORT_REASON_INTERNAL
        term.meta[_META_ERROR] = str(err)[:200]
        if _META_SIDX in term.meta:
            term.meta[_META_SLAST] = True
        try:
            core.send(int(cid), wire.encode_buffer(term))
        except Exception:
            pass  # answering is best-effort; the error still propagates
        self._ack_journal(core, term.meta, jseq, undeliverable=True)
        metrics.count("query_server.aborted_internal",
                      tenant=term.meta.get(_META_TENANT))


@register_element("tensor_query_client")
class TensorQueryClient(Element):
    """Offload buffers to a query server; push responses downstream in
    request order.

    Props: ``host``/``port`` (server address) or ``hosts=h1:p1,h2:p2``
    (round-robin fan-out over several servers — the reference's coarse
    data-parallel offload, SURVEY §2.9), ``timeout`` (seconds a response
    may take before the timeout policy fires), ``max-in-flight``
    (pipelining window: requests outstanding before ``process`` blocks),
    ``topic``, ``on-timeout`` (``error`` | ``drop``), ``tenant`` (tenant
    identity rides the hello handshake AND every request's wire meta, so
    the server's per-tenant accounting and admission control attribute
    this client's traffic — docs/SERVING.md "Front door").

    A server under ``admission=shed`` may answer a request with an empty
    ``meta["shed"]=True`` response instead of a result; it is delivered
    downstream like any response (the app checks the flag) and counted in
    ``<name>.sheds``.

    Responses arrive on a receiver thread, are re-ordered by message id (the
    reference pairs via GstMetaQuery msg ids), and are pushed downstream
    **asynchronously** in request order — exactly the reference's "(async)
    edge event cb: result arrives -> push result downstream" (SURVEY §3.3).

    Streaming servers (an ``llm`` filter behind the query pair) return MANY
    responses per request, tagged ``stream_index`` with ``stream_last`` on
    the final one.  Streamed responses are delivered immediately in arrival
    order (tokens must not wait on the reorder cursor); request-order
    reordering applies to plain (one-response) requests only, so
    interleaving streamed and plain requests on one client trades strict
    cross-request ordering for live token delivery.  For a streamed
    request, ``timeout`` bounds the INTER-TOKEN gap (each arriving token is
    progress and re-arms the clock), not the total generation time; with
    ``on-timeout=drop`` an aborted stream is terminated downstream by an
    empty ``stream_last`` + ``stream_aborted`` buffer so aggregating
    consumers never hang.
    """

    kind = "tensor_query_client"
    wants_async_emit = True

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.host = str(self.props.get("host", "127.0.0.1"))
        self.port = int(self.props.get("port", 0))
        self.timeout = float(self.props.get("timeout", 10.0))
        self.window = int(self.props.get("max_in_flight", 8))
        self.topic = str(self.props.get("topic", ""))
        self.on_timeout = str(self.props.get("on_timeout", "error"))
        self.tenant = str(self.props.get("tenant", "") or "") or None
        # Reconnect policy (docs/SERVING.md "Elastic serving"):
        # ``reconnect=N`` (default 0 = legacy fail-fast) retries a lost
        # connection up to N times with CAPPED EXPONENTIAL BACKOFF +
        # FULL JITTER — delay_k ~ U(0, min(cap, base * 2^k)) — so a
        # churned server is not hit by a synchronized thundering herd
        # (the BENCH_SOAK_r01 churn profile's reconnect tail).  The same
        # policy retries the initial connect.  On a successful
        # reconnect, outstanding PLAIN requests are resent (the wire
        # protocol is stateless request/response); partially streamed
        # requests cannot resume and are terminated downstream with
        # ``stream_aborted``.  Counters: ``<name>.reconnects``,
        # ``<name>.reconnect_backoff_ms`` (cumulative backoff),
        # ``<name>.resends``.
        self.reconnect = max(0, int(self.props.get("reconnect", 0)))
        self.reconnect_base_ms = float(
            self.props.get("reconnect_base_ms", 20.0))
        self.reconnect_cap_ms = float(
            self.props.get("reconnect_cap_ms", 1000.0))
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._next_msg = 0
        self._emit_next = 0
        self._pending: Dict[int, Tuple[Buffer, float]] = {}  # id -> (orig, t_sent)
        self._done: Dict[int, Buffer] = {}  # msg id -> response awaiting its turn
        self._streaming: set = set()  # mids that have streamed >= 1 response
        self._aborted: set = set()  # timed-out streams: drop late tokens quietly
        self._cv = threading.Condition()
        # Serializes the pop-ready+feed step across the rx thread and the
        # timeout path so in-order delivery holds (never held with _cv).
        self._emit_lock = threading.Lock()
        self._rx_error: Optional[BaseException] = None
        self._socks: List[socket.socket] = []
        self._readers: List[threading.Thread] = []
        self._async_emit = None  # injected by the runtime (wants_async_emit)
        # nns-weave clock refresh watermark (monotonic seconds of the last
        # accepted handshake echo / probe ack on ANY connection)
        self._clock_last = 0.0

    #: seconds between NTP-style clock probes on an idle connection
    CLOCK_REFRESH_S = 5.0

    def _note_clock(self, clk) -> None:
        """Feed one clock sample (handshake echo or probe ack, shape
        ``{"epoch", "offset_ns", "uncertainty_ns"}``) into the
        element-pinned recorder and re-arm the refresh timer; records a
        ``clock.sync`` instant so the residual skew is visible in the
        trace, never hidden.  Off mode: the recorder is None and the
        sample is dropped (no state, no spans)."""
        if not isinstance(clk, dict):
            return
        self._clock_last = time.monotonic()
        rec = getattr(self, "_trace_rec", None)
        if rec is None:
            return
        rec.note_clock(clk["epoch"], clk["offset_ns"],
                       clk["uncertainty_ns"])
        rec.record("clock.sync", self.name, None, time.monotonic_ns(), 0,
                   peer_epoch=clk["epoch"], offset_ns=clk["offset_ns"],
                   uncertainty_ns=clk["uncertainty_ns"])

    def _maybe_clock_probe(self, sock) -> None:
        """Periodic clock refresh: on an idle rx tick, send a ``clock``
        control probe so long-lived connections track drift between the
        peer monotonic bases (the handshake echo only samples once).
        Off mode: one pointer check."""
        if getattr(self, "_trace_rec", None) is None:
            return
        if time.monotonic() - self._clock_last < self.CLOCK_REFRESH_S:
            return
        self._clock_last = time.monotonic()  # re-arm even if the send fails
        probe = json.dumps({"type": "clock", "t0": time.monotonic_ns(),
                            "epoch": _tracing.trace_epoch()}).encode("utf-8")
        try:
            with self._send_lock:
                if self._socks:
                    wire.write_frame(sock, probe)
        except OSError:
            pass  # a dead socket is the reconnect machinery's problem

    def _handle_clock_ack(self, ctrl: dict) -> None:
        """Consume a ``clock_ack`` control frame (t0 echo + server
        receive/send stamps + server trace epoch) into a clock sample."""
        if ctrl.get("type") != "clock_ack":
            return
        t0, t1 = ctrl.get("t0"), ctrl.get("t1")
        t2, epoch = ctrl.get("t2"), ctrl.get("epoch")
        if not all(isinstance(v, int) for v in (t0, t1, t2, epoch)):
            return
        off, unc = _tracing.clock_offset(t0, t1, t2, time.monotonic_ns())
        self._note_clock({"epoch": epoch, "offset_ns": off,
                         "uncertainty_ns": unc})

    def _destinations(self) -> List[Tuple[str, int]]:
        """``hosts="h1:p1,h2:p2"`` (round-robin fan-out, the reference's
        coarse data-parallel offload — SURVEY §2.9) or single host/port."""
        spec = str(self.props.get("hosts", "") or "")
        if not spec:
            if self.port <= 0:
                raise ElementError(f"{self.name}: port property required")
            return [(self.host, self.port)]
        dests = []
        for part in spec.split(","):
            host, _, port = part.strip().rpartition(":")
            try:
                dests.append((host or "127.0.0.1", int(port)))
            except ValueError:
                raise ElementError(
                    f"{self.name}: bad hosts entry {part!r} "
                    "(expected host:port)") from None
        return dests

    def _backoff_sleep(self, attempt: int) -> bool:
        """One capped-exponential full-jitter backoff slice; returns
        False when the pipeline is stopping (abort the retry loop)."""
        delay = random.uniform(0.0, min(
            self.reconnect_cap_ms,
            self.reconnect_base_ms * (1 << min(attempt, 16)))) / 1e3
        metrics.count(f"{self.name}.reconnect_backoff_ms", delay * 1e3)
        stop = getattr(self, "_stop_event", None)
        if stop is not None:
            return not stop.wait(delay)
        time.sleep(delay)
        return True

    def _connect_one(self, host: str, port: int, retries: int,
                     backoff_first: bool = False):
        """``create_connection`` + handshake with the backoff policy;
        returns the connected socket or raises the last error (returns
        None only when the pipeline started stopping mid-backoff)."""
        last: Optional[Exception] = None
        for attempt in range(retries + 1):
            if (attempt or backoff_first) and \
                    not self._backoff_sleep(attempt - (0 if backoff_first
                                                       else 1)):
                return None
            if backoff_first and self._sock is None:
                return None  # stop() ran mid-outage
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
            except OSError as e:
                last = e
                continue
            try:
                hello_fields = dict(caps="other/tensors", topic=self.topic)
                if self.tenant is not None:
                    hello_fields["tenant"] = self.tenant
                ack = client_handshake(sock, "hello", **hello_fields)
            except (ConnectionError, OSError) as e:
                # OSError covers a handshake-phase socket.timeout; close
                # the half-open socket before retrying.
                try:
                    sock.close()
                except OSError:
                    pass
                last = e
                continue
            sock.settimeout(0.2)
            # handshake-piggybacked clock echo (client_handshake
            # synthesizes ack["clock"] from a weave-aware server's stamps)
            self._note_clock(ack.get("clock"))
            return sock
        raise last if last is not None else ElementError(
            f"{self.name}: cannot connect {host}:{port}")

    def start(self) -> None:
        self._socks = []
        self._readers = []
        for host, port in self._destinations():
            try:
                sock = self._connect_one(host, port, self.reconnect)
            except (OSError, ConnectionError) as e:
                self.stop()
                raise ElementError(
                    f"{self.name}: cannot connect {host}:{port}: {e}"
                ) from e
            if sock is None:  # stopping mid-backoff
                self.stop()
                return
            self._socks.append(sock)
        self._sock = self._socks[0]  # back-compat for single-dest callers
        for i, sock in enumerate(self._socks):
            t = threading.Thread(
                target=self._rx_loop, args=(sock, i),
                name=f"{self.name}-rx{i}", daemon=True,
            )
            t.start()
            self._readers.append(t)

    def stop(self) -> None:
        socks, self._socks = getattr(self, "_socks", []), []
        self._sock = None
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass
        for t in getattr(self, "_readers", []):
            t.join(timeout=2.0)
        self._readers = []

    def _rx_loop(self, sock, idx: int = 0) -> None:
        while True:
            if self._sock is None:  # stop() ran
                return
            try:
                raw = wire.read_frame(sock)
            except socket.timeout:
                self._maybe_clock_probe(sock)
                continue
            except OSError:
                raw = None
            except ValueError as e:  # corrupt frame (CRC mismatch)
                with self._cv:
                    self._rx_error = e
                    self._cv.notify_all()
                return
            if raw is None:
                stop = getattr(self, "_stop_event", None)
                if (self.reconnect > 0 and self._sock is not None
                        and (stop is None or not stop.is_set())):
                    nsock = self._try_reconnect(idx)
                    if nsock is not None:
                        sock = nsock
                        continue
                with self._cv:
                    # Only requests ROUTED TO THIS SOCKET are lost when a
                    # server closes: a fan-out peer going away must not
                    # poison requests pending on healthy servers.  With
                    # reconnect enabled, a reader that EXHAUSTED its
                    # retries is gone for good — record the error even
                    # with nothing pending, or a later send would park
                    # its request forever waiting on a dead reader.
                    n = max(1, len(self._socks))
                    mine = any(m % n == idx for m in self._pending)
                    if (mine or self.reconnect > 0) \
                            and self._rx_error is None:
                        self._rx_error = ConnectionError("query server closed connection")
                    self._cv.notify_all()
                return
            ctrl = parse_control(raw)
            if ctrl is not None:  # clock_ack etc.; never a tensor frame
                self._handle_clock_ack(ctrl)
                continue
            try:
                buf, _flags = wire.decode_buffer(raw)
            except ValueError as e:
                with self._cv:
                    self._rx_error = e
                    self._cv.notify_all()
                return
            try:
                self._handle_response(buf)
            except Exception as e:  # noqa: BLE001 - any escape kills the reader
                # e.g. emit attempted while not attached to a pipeline: an
                # exception escaping here would silently kill the reader
                # thread and outstanding requests would only surface via
                # timeout — record it so _wait_outstanding reports promptly.
                with self._cv:
                    if self._rx_error is None:
                        self._rx_error = e
                    self._cv.notify_all()
                return

    def _try_reconnect(self, idx: int):
        """Replace socket ``idx`` after an outage: capped-exponential
        full-jitter backoff (see __init__), then resend this socket's
        outstanding plain requests and terminate its partial streams.
        Returns the new socket, or None when attempts are exhausted or
        the pipeline is stopping (caller falls through to the legacy
        connection-error path)."""
        dests = self._destinations()
        host, port = dests[idx % len(dests)]
        try:
            sock = self._connect_one(host, port, self.reconnect - 1,
                                     backoff_first=True)
        except (OSError, ConnectionError):
            return None
        if sock is None:
            return None
        with self._send_lock:
            if not self._socks:  # stop() ran while reconnecting
                try:
                    sock.close()
                except OSError:
                    pass
                return None
            old = self._socks[idx]
            self._socks[idx] = sock
            if idx == 0:
                self._sock = sock
        try:
            old.close()
        except OSError:
            pass
        metrics.count(f"{self.name}.reconnects")
        log.info("%s: reconnected to %s:%d", self.name, host, port)
        self._resend_pending(idx)
        return sock

    def _resend_pending(self, idx: int) -> None:
        """The died socket's outstanding requests: plain requests are
        RESENT on the fresh connection (stateless request/response — the
        server treats them as new; their timeout clock restarts), while
        partially streamed requests cannot resume server-side state and
        are terminated downstream exactly like the timeout-drop path."""
        with self._cv:
            n = max(1, len(self._socks))
            resend = []
            for mid in sorted(m for m in self._pending if m % n == idx):
                orig, _t = self._pending[mid]
                if mid in self._streaming:
                    self._pending.pop(mid)
                    self._streaming.discard(mid)
                    term = orig.with_tensors([])
                    term.meta.update({_META_SLAST: True,
                                      _META_SABORT: True})
                    self._done[mid] = term
                else:
                    self._pending[mid] = (orig, time.monotonic())
                    resend.append((mid, orig))
            self._cv.notify_all()
        for mid, orig in resend:
            orig.meta[_META_MSG] = mid
            payload = wire.encode_buffer(orig)
            orig.meta.pop(_META_MSG, None)
            try:
                with self._send_lock:
                    socks = self._socks
                    if not socks:
                        return
                    wire.write_frame(socks[mid % len(socks)], payload)
            except OSError:
                # the replacement died too: the rx loop will notice and
                # run the backoff again (or give up and surface the
                # connection error)
                return
            metrics.count(f"{self.name}.resends")
        self._drain_ready()

    def _handle_response(self, buf: Buffer) -> None:
        """Pair one received response with its request and deliver it.

        A server pipeline with a streaming filter (llm) returns MANY
        responses per request, each tagged stream_index and the final one
        stream_last (the buffers' own meta rides the wire).  Streamed
        responses are delivered in ARRIVAL order immediately — the
        per-request reorder machinery applies to plain responses (config
        #5: "tensor_filter + tensor_query" token streaming).
        """
        mid = int(buf.meta.pop(_META_MSG, -1))
        rec = getattr(self, "_trace_rec", None)
        if rec is not None:
            # ``query.recv`` instant, tid = the echoed parent context so
            # the merge links it to this request's client/server spans
            rec.record("query.recv", self.name,
                       buf.meta.get(_META_TPARENT), time.monotonic_ns(),
                       0, msg=mid)
        streamed = _META_SIDX in buf.meta
        emit_now: Optional[Buffer] = None
        with self._cv:
            entry = self._pending.get(mid)
            if entry is None:
                if mid in self._aborted:
                    # late tokens of a timed-out (dropped) stream
                    if buf.meta.get(_META_SLAST):
                        self._aborted.discard(mid)
                    metrics.count(f"{self.name}.late_dropped")
                else:
                    log.warning("%s: unmatched response msg=%d",
                                self.name, mid)
                return
            orig, _t = entry
            # Response keeps the request's timing identity.
            buf.pts = orig.pts
            buf.seqno = orig.seqno
            if streamed:
                # keep-alive: each token resets the request's timeout
                self._pending[mid] = (orig, time.monotonic())
                self._streaming.add(mid)
                if buf.meta.get(_META_SLAST):
                    self._pending.pop(mid)
                    self._streaming.discard(mid)
                    self._done[mid] = _STREAM_DONE
                emit_now = buf
            else:
                self._pending.pop(mid)
                self._done[mid] = buf
            if buf.meta.get(_META_SHED):
                # the server's admission control dropped this request and
                # answered immediately (docs/SERVING.md "Front door")
                metrics.count(f"{self.name}.sheds")
            abort_reason = buf.meta.get(_META_ABORT)
            if abort_reason == meta_keys.ABORT_REASON_POISON:
                # typed poison terminator (docs/ROBUSTNESS.md): the
                # request crashed a server stage and was quarantined
                metrics.count(f"{self.name}.poisoned")
            elif buf.meta.get(_META_WIRE_REJECT):
                # the server rejected this request's wire frame (typed
                # WireError) — delivered like any response so the app
                # sees abort_reason="wire" instead of a timeout
                metrics.count(f"{self.name}.wire_rejected")
            elif abort_reason is not None:
                # any other typed abort (e.g. "internal"): the server
                # chose answering over silence; its error detail rides
                # the response meta
                log.warning("%s: msg=%d aborted by server (%s): %s",
                            self.name, mid, abort_reason,
                            buf.meta.get(_META_ERROR, ""))
                metrics.count(f"{self.name}.aborted")
            metrics.count(f"{self.name}.responses")
            self._cv.notify_all()
        if emit_now is not None:
            with self._emit_lock:
                if self._async_emit is None:
                    raise ElementError(
                        f"{self.name}: not attached to a pipeline")
                self._async_emit([(SRC, emit_now)])
        self._drain_ready()

    def _drain_ready(self) -> None:
        """Atomically pop in-order completed responses and feed them
        downstream.  Holding ``_emit_lock`` across pop+feed means whichever
        thread pops the current head also delivers it before any other
        thread can pop later items — in-order delivery under concurrency."""
        with self._emit_lock:
            with self._cv:
                ready: List[Buffer] = []
                while self._emit_next in self._done:
                    b = self._done.pop(self._emit_next)
                    if b is not _STREAM_DONE:  # stream already delivered
                        ready.append(b)
                    self._emit_next += 1
                self._cv.notify_all()
            if not ready:
                return
            if self._async_emit is None:  # unit use outside a pipeline
                raise ElementError(f"{self.name}: not attached to a pipeline")
            self._async_emit([(SRC, b) for b in ready])

    def _wait_outstanding(self, below: int) -> None:
        """Block until fewer than ``below`` requests are outstanding,
        enforcing the per-request timeout policy on the head request."""
        stop = getattr(self, "_stop_event", None)
        while True:
            if stop is not None and stop.is_set():
                return  # pipeline stopping: abandon outstanding requests
            drain = False
            with self._cv:
                if self._rx_error is not None:
                    raise ElementError(f"{self.name}: {self._rx_error}")
                outstanding = len(self._pending) + len(self._done)
                if outstanding < below:
                    break
                entry = self._pending.get(self._emit_next)
                if entry is not None:
                    overdue = time.monotonic() - entry[1] - self.timeout
                    if overdue >= 0:
                        mid = self._emit_next
                        self._pending.pop(mid)
                        metrics.count(f"{self.name}.timeouts")
                        if self.on_timeout != "drop":
                            raise ElementError(
                                f"{self.name}: no response for request "
                                f"{mid} within {self.timeout}s"
                            )
                        log.warning("%s: request %d timed out; dropped",
                                    self.name, mid)
                        if mid in self._streaming:
                            # A partial stream already went downstream:
                            # terminate it so aggregating consumers never
                            # hang, and swallow late tokens quietly.  The
                            # terminator goes through _done so the drain
                            # emits it and advances the cursor itself.
                            self._streaming.discard(mid)
                            self._aborted.add(mid)
                            term = entry[0].with_tensors([])
                            term.meta.update({_META_SLAST: True,
                                              _META_SABORT: True})
                            self._done[mid] = term
                        else:
                            self._emit_next += 1
                        drain = True
                    else:
                        self._cv.wait(timeout=min(-overdue, 0.2))
                elif self._emit_next in self._done:
                    drain = True
                else:
                    self._cv.wait(timeout=0.2)
            if drain:
                self._drain_ready()

    def process(self, pad, buf: Buffer):
        self._wait_outstanding(self.window)
        host_buf = _to_host(buf)
        if self.tenant is not None and _META_TENANT not in host_buf.meta:
            host_buf.meta[_META_TENANT] = self.tenant
        rec = getattr(self, "_trace_rec", None)
        tid = host_buf.meta.get(_META_TID) if rec is not None else None
        if isinstance(tid, int):
            # distributed parent context: the epoch-prefixed local trace
            # id rides the wire both directions (the server adopts it,
            # every response/token echoes it back)
            host_buf.meta[_META_TPARENT] = tid
        with self._cv:
            mid = self._next_msg
            self._next_msg += 1
            self._pending[mid] = (host_buf, time.monotonic())
        host_buf.meta[_META_MSG] = mid
        payload = wire.encode_buffer(host_buf)
        host_buf.meta.pop(_META_MSG, None)
        try:
            with self._send_lock:
                # Round-robin over destinations: coarse DP fan-out when
                # ``hosts=`` lists several servers; responses re-order by
                # msg id regardless of which server answered.
                socks = self._socks
                if not socks:
                    raise ElementError(f"{self.name}: not connected")
                wire.write_frame(socks[mid % len(socks)], payload)
        except (OSError, AttributeError) as e:
            if self.reconnect > 0:
                # leave the request pending: the rx loop detects the
                # dead socket, reconnects with backoff, and resends it
                # (_resend_pending); only if reconnection exhausts does
                # the connection error surface via _wait_outstanding
                log.warning("%s: send failed (%s); awaiting reconnect",
                            self.name, e)
                metrics.count(f"{self.name}.send_failures")
            else:
                raise ElementError(f"{self.name}: send failed: {e}") from e
        if rec is not None:
            rec.record("query.send", self.name, tid, time.monotonic_ns(),
                       0, msg=mid)
        metrics.count(f"{self.name}.requests")
        return []

    def finalize(self):
        # EOS: every outstanding request must resolve (or time out) before
        # EOS propagates downstream.
        self._wait_outstanding(1)
        # Barrier: the rx thread may have popped the last response but not
        # yet fed it; it feeds under _emit_lock, so taking it once here
        # guarantees delivery happened before EOS follows.
        with self._emit_lock:
            pass
        return []
