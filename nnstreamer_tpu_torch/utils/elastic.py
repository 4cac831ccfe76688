"""nns-elastic: the stream registry, the cancel/orphan backchannel of
continuous serving (docs/SERVING.md "Elastic serving").

Port of the stream registry of ``nnstreamer_tpu/utils/elastic.py``.
Every continuous-serving stream (``filters/llm.py _ContinuousLoop``)
registers a process-unique ``stream_id`` here at submit; the id rides
every emitted token's meta (:data:`META_STREAM_ID`) all the way to the
query wire.  Downstream failure detectors (``tensor_query_serversink``
on a dead connection) call :func:`cancel_stream` — a host-value
backchannel that lets the serve loop release the orphaned stream's KV
blocks and slot after a ``stream_idle_timeout`` grace instead of
leaking pool capacity until ``max_new`` runs out.  This module is the
one place a stream id is minted in the process.

Trimmed, for the slices that own them: the ``Autoscaler`` (it reads
``utils/slo.py``'s burn rates), the chaos hooks of the soak harness and
the reconfig knob table of the deep lint.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List

from ..core.log import logger
#: buffer-meta key carrying the continuous-serving stream id.  App data
#: (JSON-safe int), stamped at submit regardless of trace mode: the
#: dead-connection backchannel must work in untraced deployments too.
#: Declared in the shared protocol registry (core/meta_keys.py).
from ..core.meta_keys import META_STREAM_ID  # noqa: F401  (re-export)
from . import tracing

log = logger(__name__)


_stream_ids = itertools.count(1)
_streams: Dict[int, Callable[[str, bool], None]] = {}
_streams_lock = threading.Lock()


def next_stream_id() -> int:
    """GLOBALLY-unique continuous-serving stream id (minted at submit):
    epoch-prefixed like trace ids, so ids minted by two processes never
    collide.  Sampler seeds are a function of the admission number, not
    this id, so determinism is unaffected."""
    return (tracing.trace_epoch() << 32) | (next(_stream_ids) & 0xFFFFFFFF)


def register_stream(stream_id: int,
                    cancel_cb: Callable[[str, bool], None]) -> None:
    """Register a live/queued serve stream.  ``cancel_cb(reason, force)``
    must be safe to call from any thread (the serve loop consumes the
    mark at its next chunk boundary)."""
    with _streams_lock:
        _streams[stream_id] = cancel_cb


def unregister_stream(stream_id: int) -> None:
    with _streams_lock:
        _streams.pop(stream_id, None)


def cancel_stream(stream_id, reason: str = "cancelled",
                  force: bool = False) -> bool:
    """Mark one serve stream dead.  ``force=False`` (the dead-connection
    default) gives the stream its loop's ``stream_idle_timeout`` grace
    before its blocks/slot are reaped; ``force=True`` reaps at the next
    chunk boundary.  Returns False for an unknown/already-finished id
    (idempotent: a serversink retrying failed sends may call this once
    per failed token)."""
    if stream_id is None:
        return False
    try:
        stream_id = int(stream_id)
    except (TypeError, ValueError):
        return False  # not a server-minted id: nothing to cancel
    with _streams_lock:
        cb = _streams.get(stream_id)
    if cb is None:
        return False
    try:
        cb(reason, force)
    except Exception:  # noqa: BLE001 - backchannel must never throw upward
        log.exception("cancel_stream(%s) callback failed", stream_id)
        return False
    return True


def live_stream_ids() -> List[int]:
    """Registered (queued or live) serve stream ids, for tests/tools."""
    with _streams_lock:
        return sorted(_streams)
