"""Sink elements.

Port of ``nnstreamer_tpu/elements/sink.py`` (reference: gsttensor_sink.c,
an appsink-like terminal; GStreamer's fakesink, which discards and
counts, and filesink, which writes raw bytes).  ``pop()`` returns host
numpy arrays by default (one device-to-host copy at the pipeline edge),
or the tensors as they arrived with ``to_host=false``; ``try_pop()`` is
the app's non-blocking poll and ``depth`` the count of buffers waiting.
A buffer's appsrc ``max-inflight`` credit is released when the app takes
it (pop, try_pop or callback), when a ``drop=true`` sink discards it,
when its resolution failed, or when a filesink has written it.

The fetch window (``fetch-depth`` prop > the pipeline's ``fetch_depth`` >
the config's): a buffer bound for ``pop()`` is materialized on a pool of
that many threads, not in the app's thread, so the fetch of buffer N
overlaps the work on buffer N+1.  A card tensor's copy into pinned host
memory is started at arrival, on the sink thread's stream, with an event
recorded after it; the pool thread waits on that event (its own current
stream is not the producer's) and maps the result, applying a deferred
``host_post`` (a fused decoder's host half).  Emission order stays FIFO:
the pull queue holds the futures in arrival order whatever order they
finish in.  A buffer with deferred ``host_post`` and no window (callbacks,
``drop=true``, a deep queue) is resolved in the app's thread as before.
"""

from __future__ import annotations

import concurrent.futures as _cf
import queue as _queue
import time as _time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, start_fetch
from ..core.config import get_config
from ..core.log import STALL_FLOOR_S, logger, metrics
from ..core.meta_keys import META_TENANT, META_TRACE_ID
from ..core.registry import register_element
from ..utils import locks, tracing
from .base import SinkElement

log = logger(__name__)


def _release_credit(buf) -> None:
    """Free an appsrc max-inflight admission slot: called at delivery
    (pop/callback) or when a drop-mode sink discards the buffer."""
    credit = getattr(buf, "meta", {}).get("_inflight_credit")
    if credit is not None:
        credit.release()


def _start_host_copies(buf: Buffer) -> Buffer:
    """``buf`` with each card tensor replaced by a pinned host tensor its
    copy is on the way into (on this thread's stream, after the work that
    produced it), and the event that marks the copies done in
    ``meta["_d2h_done"]``; unchanged when no tensor is on the card or a
    fused stage already started the copies."""
    card = [i for i, t in enumerate(buf.tensors)
            if isinstance(t, torch.Tensor) and t.is_cuda]
    if not card or "_d2h_done" in buf.meta:
        return buf
    host, done = start_fetch([buf.tensors[i] for i in card])
    tensors = list(buf.tensors)
    for i, h in zip(card, host):
        tensors[i] = h
    out = buf.with_tensors(tensors, spec=buf.spec)
    out.meta["_d2h_done"] = done
    return out


@register_element("tensor_sink")
class TensorSink(SinkElement):
    """Terminal sink with an app-facing pull queue + callbacks.

    Props: ``max-buffers`` (queue bound; the oldest buffer is dropped when
    full and ``drop=true``, else the pipeline backs up), ``to-host``,
    ``fetch-depth`` (the fetch window), ``emit-signals`` (kept for
    reference familiarity; callbacks fire regardless).
    """

    kind = "tensor_sink"
    #: residency planner (``pipeline/residency.py``): the pull API hands
    #: the app whatever geometry arrives
    admits_reduced_payload = True

    #: lock discipline (utils/locks.py)
    _GUARDED_BY = {"_pool": "_win_lock", "_pool_stopped": "_win_lock",
                   "_outstanding": "_win_lock", "_win_peak": "_win_lock"}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        cap = int(self.props.get("max_buffers", 1024))
        self.drop = bool(self.props.get("drop", False))
        self.emit_signals = bool(self.props.get(
            "emit_signal", self.props.get("emit_signals", True)))
        self.to_host = bool(self.props.get("to_host", True))
        self._q: _queue.Queue = _queue.Queue(maxsize=cap)
        self._callbacks: List[Callable[[Buffer], None]] = []
        self._fetch_depth_prop = int(self.props.get("fetch_depth", 0))
        self._pool = None  # the fetch window's pool, made at first need
        self._pool_stopped = False  # stop() ran: never make a pool again
        self._outstanding = 0  # submitted, not yet materialized
        self._win_lock = locks.make_lock("TensorSink._win_lock")
        self._win_peak = 0
        self._parked = None  # what a pop that timed out materializing held

    def connect_new_data(self, cb: Callable[[Buffer], None]) -> None:
        """Reference: g_signal_connect(sink, "new-data", ...)."""
        self._callbacks.append(cb)

    def process(self, pad, buf: Buffer):
        # frames split per tenant when the buffer carries one
        metrics.count(f"{self.name}.frames",
                      tenant=buf.meta.get(META_TENANT))
        callbacks = list(self._callbacks)
        # <= not <: a full bounded queue still windows the buffer about to
        # block in put(), which is the backpressure
        window_cap = min(16, self._q.maxsize or 16)
        if (self.to_host and not callbacks and not self.drop
                and self._q.qsize() <= window_cap
                and ("_host_post" in buf.meta
                     or any(isinstance(t, torch.Tensor) for t in buf.tensors))):
            # materialized on the pool, not here (the stage thread) and
            # not in pop() (the app's thread); a host-only buffer has
            # nothing to overlap and resolves at pop
            buf = self._submit_fetch(_start_host_copies(buf))
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

    # -- fetch window --------------------------------------------------------
    @property
    def fetch_depth(self) -> int:
        """The fetch window's width: the element's ``fetch-depth`` prop,
        else the pipeline's (``_fetch_depth``, set by the runtime), else
        the config's."""
        d = self._fetch_depth_prop
        if d <= 0:
            d = int(getattr(self, "_fetch_depth", 0) or 0)
        if d <= 0:
            d = get_config().fetch_depth
        return max(1, d)

    def _fetch_pool(self):
        # check-then-create under the lock, atomic with stop(): a pool made
        # after stop() would leak its threads
        with self._win_lock:
            if self._pool is None and not self._pool_stopped:
                self._pool = _cf.ThreadPoolExecutor(
                    self.fetch_depth, thread_name_prefix=f"{self.name}-fetch")
            return self._pool

    def _fetch_done(self, fut) -> None:
        with self._win_lock:  # on pool threads, racing _submit_fetch
            locks.assert_guarded(self, "_outstanding")
            self._outstanding -= 1
            metrics.gauge(f"{self.name}.fetch_window",
                          float(max(0, self._outstanding)))

    def _submit_fetch(self, buf: Buffer):
        """One buffer's materialization into the window: returns its
        Future (or the buffer itself once stop() has run: pop then
        materializes it)."""
        cell = {"dur": 0.0}

        def job(b=buf, cell=cell):
            t1 = _time.perf_counter()
            out = b.to_host()
            cell["dur"] = _time.perf_counter() - t1
            return out

        pool = self._fetch_pool()
        if pool is None:
            return buf
        try:
            fut = pool.submit(job)
        except RuntimeError:  # shut down by a racing stop()
            return buf
        tid = buf.meta.get(META_TRACE_ID)
        fut._nns_tid = tid
        fut._nns_cell = cell
        # the admission credit must survive a FAILED resolution: pop()
        # releases it then, so an app that catches the error streams on
        fut._nns_credit = buf.meta.get("_inflight_credit")
        # count, gauge and peak under one lock hold, before the done
        # callback can run (inline, when the job is already done)
        with self._win_lock:
            self._outstanding += 1
            depth = max(1, self._outstanding)
            metrics.gauge(f"{self.name}.fetch_window", float(depth))
            if depth > self._win_peak:
                self._win_peak = depth
                metrics.gauge(f"{self.name}.fetch_window_peak", float(depth))
        fut.add_done_callback(self._fetch_done)
        tracer = getattr(self, "_trace_rec", None)
        if tracer is not None:
            tracer.record("fetch.window", self.name, tid,
                          _time.monotonic_ns(), 0, depth=depth)
        return fut

    # -- app API -----------------------------------------------------------
    def pop(self, timeout: float = 30.0, check: Optional[Callable] = None) -> Buffer:
        deadline = _time.monotonic() + timeout
        buf = self._parked  # one whose materialization timed out goes first
        while buf is None:
            try:
                buf = self._q.get(timeout=0.1)
            except _queue.Empty:
                if check:
                    check()
                if _time.monotonic() > deadline:
                    raise TimeoutError(f"no buffer at sink {self.name!r} in {timeout}s")
        # the timeout bounds arrival; materialization gets its own budget,
        # and a materialization that times out keeps the buffer for the
        # next pop, never drops it
        try:
            out = self._materialize(buf, timeout)
        except TimeoutError:
            self._parked = buf
            raise
        self._parked = None
        _release_credit(out)  # delivered: the admission slot frees
        return out

    def try_pop(self) -> Optional[Buffer]:
        """Non-blocking poll: None while no buffer is ready.  A buffer
        whose fetch is still resolving is parked (the pull API has one
        consumer) and returned by the next pop or try_pop once done."""
        item = self._parked
        if item is None:
            try:
                item = self._q.get_nowait()
            except _queue.Empty:
                return None
        if isinstance(item, _cf.Future) and not item.done():
            self._parked = item
            return None
        self._parked = None
        out = self._materialize(item, 30.0)
        _release_credit(out)
        return out

    @property
    def depth(self) -> int:
        """Buffers waiting in the pull queue (a parked one not counted)."""
        return self._q.qsize()

    def _materialize(self, item, timeout: float) -> Buffer:
        tracer = getattr(self, "_trace_rec", None)
        if tracer is None:
            return self._materialize_inner(item, timeout)
        # the fetch span: what the app's pop() waits for the host copy
        t0 = _time.monotonic_ns()
        out = self._materialize_inner(item, timeout)
        ten = out.meta.get(META_TENANT)
        args = {} if ten is None else {"tenant": ten}
        tracer.record("fetch", self.name, out.meta.get(META_TRACE_ID), t0,
                      _time.monotonic_ns() - t0, **args)
        return out

    def _materialize_inner(self, item, timeout: float) -> Buffer:
        if not isinstance(item, _cf.Future):
            if not self.to_host:
                return item.resolve()
            t0 = _time.perf_counter()
            out = item.to_host()
            self._account_wait(_time.perf_counter() - t0)
            return out
        t0 = _time.perf_counter()
        tid = getattr(item, "_nns_tid", None)
        try:
            out = item.result(timeout=timeout)
        except _cf.TimeoutError:
            tracing.dump_recent_to_log(
                log, reason=f"fetch resolution timeout at sink {self.name!r} "
                            f"(trace id {tid})")
            raise TimeoutError(
                f"host fetch at sink {self.name!r} exceeded {timeout}s "
                f"(trace id {tid})") from None
        except Exception as e:  # noqa: BLE001 - annotate, release, re-raise
            tracing.dump_recent_to_log(
                log, reason=f"fetch resolution FAILED at sink {self.name!r} "
                            f"(trace id {tid}): {e!r}")
            credit = getattr(item, "_nns_credit", None)
            if credit is not None:
                credit.release()
            raise
        wait = _time.perf_counter() - t0
        self._account_wait(wait)
        # fetch time that overlapped pipeline work instead of the pull
        metrics.count(f"{self.name}.fetch_overlap_ms",
                      max(0.0, item._nns_cell["dur"] - wait) * 1e3)
        return out

    def _account_wait(self, wait: float) -> None:
        """The time the pull blocked on a host copy (the output half of
        the h2d/d2h stall split)."""
        metrics.count(f"{self.name}.d2h_wait_ms", wait * 1e3)
        if wait > STALL_FLOOR_S:
            metrics.count(f"{self.name}.d2h_stalls")

    def stop(self) -> None:
        with self._win_lock:  # atomic with _fetch_pool's check-then-create
            self._pool_stopped = True
            pool, self._pool = self._pool, None
        if pool is not None:
            # no wait, no cancel: buffers submitted before EOS still
            # resolve and stay poppable
            pool.shutdown(wait=False)
        super().stop()


def _wait_ready(buf: Buffer) -> None:
    """Block until the card work behind ``buf`` has finished: its pending
    host copy, else the devices its tensors lie on."""
    done = buf.meta.get("_d2h_done")
    if done is not None:
        done.synchronize()
        return
    for dev in {t.device for t in buf.tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@register_element("fakesink")
class FakeSink(SinkElement):
    """Discard everything, but count it (``<name>.frames``, per tenant
    when the buffer carries one).  A buffer is delivered when the work
    that made it has finished on the card, so its appsrc ``max-inflight``
    credit is released then: a fakesink measures the pipeline, not a
    queue of launches."""

    kind = "fakesink"
    #: residency planner: discarded payloads admit any geometry
    admits_reduced_payload = True

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.count = 0
        self.sync = bool(self.props.get("sync", False))
        self.last: Optional[Buffer] = None

    def process(self, pad, buf):
        _wait_ready(buf)
        _release_credit(buf)
        self.count += 1
        self.last = buf
        metrics.count(f"{self.name}.frames",
                      tenant=buf.meta.get(META_TENANT))
        return []


def raw_bytes(t) -> bytes:
    """A tensor's raw bytes in C order: a bf16 tensor as its ``uint16``
    bits, which are the bytes ``ml_dtypes``' bf16 writes."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().contiguous().numpy().tobytes()
    return np.asarray(t).tobytes()


@register_element("filesink")
class FileSink(SinkElement):
    """Write each buffer's tensors' raw bytes to ``location`` (reference:
    filesink in the SSAT golden tests); card tensors are fetched here."""

    kind = "filesink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.location = str(self.props.get("location", "out.bin"))
        self._f = None

    def start(self):
        self._f = open(self.location, "wb")

    def stop(self):
        if self._f:
            self._f.close()
            self._f = None

    def process(self, pad, buf):
        for t in buf.resolve().tensors:
            self._f.write(raw_bytes(t))
        _release_credit(buf)  # bytes on disk: delivered
        return []
