"""Sink elements.

Port of the ``tensor_sink`` of ``nnstreamer_tpu/elements/sink.py``
(reference: gsttensor_sink.c, an appsink-like terminal).  ``pop()``
returns host numpy arrays by default (one device-to-host copy at the
pipeline edge), or the tensors as they arrived with ``to_host=false``.
A buffer with a deferred host mapping (a fused decoder's ``host_post``)
is resolved here, in the app's thread: at ``pop()``, or before the
callbacks see it.
A buffer's appsrc ``max-inflight`` credit is released when the app takes
it (pop or callback), or when a ``drop=true`` sink discards it.  The
JAX package's fetch window (``fetch-depth``) is not ported yet.
"""

from __future__ import annotations

import queue as _queue
import time as _time
from typing import Callable, List, Optional

from ..core.buffer import Buffer
from ..core.log import metrics
from ..core.meta_keys import META_TENANT
from ..core.registry import register_element
from .base import SinkElement


def _release_credit(buf) -> None:
    """Free an appsrc max-inflight admission slot: called at delivery
    (pop/callback) or when a drop-mode sink discards the buffer."""
    credit = getattr(buf, "meta", {}).get("_inflight_credit")
    if credit is not None:
        credit.release()


@register_element("tensor_sink")
class TensorSink(SinkElement):
    """Terminal sink with an app-facing pull queue + callbacks.

    Props: ``max-buffers`` (queue bound; the oldest buffer is dropped when
    full and ``drop=true``, else the pipeline backs up), ``to-host``,
    ``emit-signals`` (kept for reference familiarity; callbacks fire
    regardless).
    """

    kind = "tensor_sink"
    #: residency planner (``pipeline/residency.py``): the pull API hands
    #: the app whatever geometry arrives
    admits_reduced_payload = True

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        cap = int(self.props.get("max_buffers", 1024))
        self.drop = bool(self.props.get("drop", False))
        self.emit_signals = bool(self.props.get(
            "emit_signal", self.props.get("emit_signals", True)))
        self.to_host = bool(self.props.get("to_host", True))
        self._q: _queue.Queue = _queue.Queue(maxsize=cap)
        self._callbacks: List[Callable[[Buffer], None]] = []

    def connect_new_data(self, cb: Callable[[Buffer], None]) -> None:
        """Reference: g_signal_connect(sink, "new-data", ...)."""
        self._callbacks.append(cb)

    def process(self, pad, buf: Buffer):
        # frames split per tenant when the buffer carries one
        metrics.count(f"{self.name}.frames",
                      tenant=buf.meta.get(META_TENANT))
        callbacks = list(self._callbacks)
        if callbacks:
            buf = buf.resolve()
            _release_credit(buf)  # callback consumers take delivery here
        for cb in callbacks:
            cb(buf)
        stop = getattr(self, "_stop_event", None)
        while True:
            try:
                self._q.put(buf, timeout=0.1)
                return []
            except _queue.Full:
                if self.drop:
                    try:
                        dropped = self._q.get_nowait()
                    except _queue.Empty:
                        pass
                    else:
                        _release_credit(dropped)  # never popped: free now
                elif stop is not None and stop.is_set():
                    return []  # pipeline stopping: shed instead of deadlocking
                # else: keep blocking — backpressure to the pipeline

    # -- app API -----------------------------------------------------------
    def pop(self, timeout: float = 30.0, check: Optional[Callable] = None) -> Buffer:
        deadline = _time.monotonic() + timeout
        while True:
            try:
                buf = self._q.get(timeout=0.1)
                break
            except _queue.Empty:
                if check:
                    check()
                if _time.monotonic() > deadline:
                    raise TimeoutError(f"no buffer at sink {self.name!r} in {timeout}s")
        out = buf.to_host() if self.to_host else buf.resolve()
        _release_credit(out)  # delivered: the admission slot frees
        return out
