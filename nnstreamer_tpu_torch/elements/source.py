"""Source elements.

Port of the ``appsrc`` of ``nnstreamer_tpu/elements/source.py``: the
application-driven source, with its end-to-end admission bound
(``max-inflight``) and tenant stamp (``tenant``).  Sources produce host
buffers; the stage that consumes them moves payloads to the card.
"""

from __future__ import annotations

import queue as _queue
import threading
import time as _time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.buffer import Buffer, Event
from ..core.caps import Caps, parse_caps_string
from ..core.log import STALL_FLOOR_S
from ..core.log import metrics as _metrics
from ..core.meta_keys import META_TENANT
from ..core.registry import register_element
from .base import SourceElement


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
