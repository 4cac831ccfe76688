"""Shared registry of protocol-bearing buffer-meta keys.

Port of ``nnstreamer_tpu/core/meta_keys.py``, copied whole: the
query wire carries these keys between the two packages unchanged.

Every meta key that rides the query wire, routes a message, or carries a
protocol decision (shed / abort / replay) is declared HERE and imported
by the modules that stamp or read it (elements/query.py, elements/sink.py,
utils/tracing.py, utils/elastic.py, utils/armor.py, filters/llm.py).
The nns-proto lint (analysis/protocol.py, docs/ANALYSIS.md "Protocol
pass") treats this module as the alphabet source of truth: a protocol
meta literal used elsewhere that is not registered here is reported as
``meta-key-drift``, and the checked protocol models
(analysis/statemachine.py) must declare the same alphabet or the
model-vs-code drift gate fails.

Import rule: this module is pure constants — no imports — so anything
(core/, utils/, elements/, filters/) may depend on
it without cycles.
"""

# --- message routing (elements/query.py) --------------------------------
#: wire message id: stamped by the client, echoed by every response
META_QUERY_MSG = "_query_msg"
#: server-side connection id the answer routes back to (never on the wire)
META_QUERY_CONN = "_query_conn"
#: journal seqno of an accepted request (docs/ROBUSTNESS.md): stamped by
#: the serversrc reader, consumed (ack + strip) by the serversink
META_JOURNAL_SEQ = "_journal_seq"
#: marks a buffer re-admitted by journal replay after a crash
META_JOURNAL_REPLAY = "_journal_replay"
#: serversrc batching: list of per-request meta dicts on one stacked buffer
META_QUERY_BATCH = "_query_batch"

# --- identity / tracing (utils/tracing.py, docs/SERVING.md) -------------
#: tenant identity riding the wire meta (admission + accounting)
META_TENANT = "_tenant"
#: per-buffer trace id (stamped at source ingress when tracing is active)
META_TRACE_ID = "_tid"
#: distributed parent trace context (docs/OBSERVABILITY.md "Distributed
#: tracing"): the CLIENT's epoch-prefixed trace id riding the query wire
#: both directions — the serversrc adopts it as the server-side trace id
#: (after scrubbing any client-supplied ``_tid``), and the serversink
#: echoes it on every response/token so the client can link ``recv``
#: spans back to the originating request
META_TRACE_PARENT = "_tparent"
#: ingress timestamp (ns) for end-to-end latency spans
META_INGRESS_NS = "_ts0"
#: enqueue timestamp (ns) for queue-wait spans
META_ENQUEUE_NS = "_tq"

# --- poison armor (utils/armor.py) --------------------------------------
#: marks a quarantined/poison terminator buffer (runners skip stages)
META_POISON = "_poison"
#: dead-letter-queue record annotation (why/when the entry quarantined)
META_DLQ = "_dlq"
#: host-side completion callback handle — stripped (popped) before a
#: buffer is quarantined or turned into a terminator; stamped by the
#: runtime, outside the protocol modules
META_HOST_POST = "_host_post"

# --- streaming telemetry (filters/llm.py) -------------------------------
#: monotonic emit timestamp stamped on every streamed token; consumed by
#: client-side TPOT dashboards, outside the protocol modules
META_EMIT_T = "emit_t"

# --- streaming responses (utils/elastic.py, filters/llm.py) -------------
#: continuous-batching stream identity (submit -> every emitted token)
META_STREAM_ID = "stream_id"
#: 0-based index of a streamed response chunk within its request
META_STREAM_INDEX = "stream_index"
#: final chunk of a streamed response (True on exactly one buffer)
META_STREAM_LAST = "stream_last"
#: typed terminator: the stream ended abnormally (pair with abort reason)
META_STREAM_ABORTED = "stream_aborted"
#: why a stream/request was aborted — value must be in :data:`ABORT_REASONS`
META_ABORT_REASON = "abort_reason"

# --- server verdict flags (elements/query.py responses) -----------------
#: admission verdict: request shed under backlog/tenant pressure
META_SHED = "shed"
#: a frame failed wire validation; client sees this instead of a timeout
META_WIRE_REJECT = "wire_reject"
#: human-readable error detail riding a reject/abort response
META_ERROR = "error"

#: closed vocabulary for :data:`META_ABORT_REASON` values.  Extending it
#: means teaching the client taxonomy (elements/query.py
#: ``_handle_response``) AND the protocol models about the new reason.
ABORT_REASON_WIRE = "wire"
ABORT_REASON_POISON = "poison"
ABORT_REASON_INTERNAL = "internal"
ABORT_REASONS = frozenset({
    ABORT_REASON_WIRE, ABORT_REASON_POISON, ABORT_REASON_INTERNAL,
})

#: JSON control-channel message types (utils/net.py handshake; the
#: clock pair is the nns-weave NTP-style echo — docs/OBSERVABILITY.md
#: "Distributed tracing": a client-initiated probe carrying t0, answered
#: with (t0, t1, t2) + the server's trace epoch)
CTRL_HELLO = "hello"
CTRL_ACK = "ack"
CTRL_NACK = "nack"
CTRL_CLOCK = "clock"
CTRL_CLOCK_ACK = "clock_ack"
CONTROL_TYPES = frozenset({
    CTRL_HELLO, CTRL_ACK, CTRL_NACK, CTRL_CLOCK, CTRL_CLOCK_ACK,
})

#: the full meta-key alphabet — the lint's ground truth
PROTOCOL_META_KEYS = frozenset({
    META_QUERY_MSG, META_QUERY_CONN, META_JOURNAL_SEQ, META_JOURNAL_REPLAY,
    META_QUERY_BATCH, META_TENANT, META_TRACE_ID, META_TRACE_PARENT,
    META_INGRESS_NS,
    META_ENQUEUE_NS, META_POISON, META_DLQ, META_STREAM_ID,
    META_STREAM_INDEX, META_STREAM_LAST, META_STREAM_ABORTED,
    META_ABORT_REASON, META_SHED, META_WIRE_REJECT, META_ERROR,
    META_HOST_POST, META_EMIT_T,
})

#: keys whose producer OR consumer lives outside the protocol modules
#: (runtime stamping, tracing spans, DLQ drain tooling, client-side
#: dashboards).  Registered so they cannot drift, but exempt from the
#: handler-totality check (sent-without-reader / read-without-sender is
#: expected across the lint boundary) and from the model drift alphabet.
EXTERNAL_META_KEYS = frozenset({
    META_TRACE_ID, META_INGRESS_NS, META_ENQUEUE_NS,
    META_HOST_POST, META_EMIT_T, META_DLQ,
})
