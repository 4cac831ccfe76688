"""Pipeline executor.

Port of ``nnstreamer_tpu/pipeline/runtime.py`` (reference analog:
GStreamer's streaming threads, with ``queue`` elements as stage
boundaries):

* each planned stage (an element, or a fused chain of device elements,
  ``pipeline/plan.py``) runs on its own runner thread with ONE bounded
  input queue;
* a buffer with a deferred host mapping (``_host_post``, from a fused
  stage whose decoder finishes on the host) stays lazy up to a
  ``tensor_sink``, which resolves it at pull or callback; any other
  consumer (a host element, the query server's sink) gets it resolved
  first;
* upstream pushes block when the queue is full (backpressure);
* EOS and error events travel in-band through the same queues;
* a stage whose ``process`` returns a generator (a streaming
  tensor_filter) has it iterated by the runner, so every yielded buffer
  is pushed downstream as soon as it exists;
* with ``trace_mode`` on, a trace id, ingress time and default tenant are
  stamped at the source, enqueue times at every stage queue, and queue,
  stage and end-to-end spans go to the flight recorder
  (``utils/tracing.py``); with it off (the default) no stamp is written;
* a poison terminator (``utils/armor.py``) rides to the sinks without
  invoking any stage, and ``quarantine=`` turns a stage's failed invoke
  into one;
* before negotiation the residency planner (``pipeline/residency.py``)
  lets a filter whose consumers all admit any geometry switch to its
  model's reduced output (``reduce_outputs``), and after planning
  ``Pipeline.residency`` records what crosses to the host at each sink;
* each ``tensor_sink`` resolves up to ``fetch_depth`` buffers at once
  on a pool (its fetch window, ``elements/sink.py``);
* a restartable stage (``Stage.restartable``: a fused chain or a pure
  filter) whose ``process()`` raises is re-entered in place up to
  ``max_stage_restarts`` times, losing that one buffer
  (``<stage>.restarts``, ``<stage>.dropped``), before the pipeline fails;
* ``slo=`` runs the per-tenant SLO engine (``utils/slo.py``) beside the
  pipeline, over the sinks' ``<sink>.e2e_latency`` series, and
  :meth:`Pipeline.slo_report` reads it now;
* :meth:`Pipeline.drain_stream` / :meth:`Pipeline.adopt_stream` move a
  live continuous-serving stream between pipelines (``filters/llm.py``);
* :meth:`Pipeline.swap_params` copies new weights (a tree or a trainer
  checkpoint) into a live serving stage, and a ``tensor_trainer
  swap-to=<stage>`` calls it after every epoch (train-while-serve);
* with ``batch_max > 1`` a batchable stage's runner drains up to that
  many already-queued buffers of one signature (``batch_linger_ms``
  waits for stragglers) and runs them as one bucketed step
  (``pipeline/batching.py``; ``<stage>.batch_occupancy``), and holds up
  to ``dispatch_depth`` dispatched micro-batches before emitting the
  oldest (its dispatch window), which events, poison terminators, stop
  and a restart flush first;
* ``donate_ingress`` lets the planner hand a host source's frames to the
  only fused chain it feeds (``pipeline/plan.py``);
* a stage whose element has ``sync_policy="all"`` and more than one sink
  pad (``tensor_mux``, ``tensor_merge``, ``tensor_crop``) collates: its
  runner keeps each pad's buffers pending and hands the element one per
  pad (``process_group``), in arrival order per pad; a pad at EOS pairs
  what it still has pending, then what the other pads hold is dropped
  (``<stage>.dropped``); such a stage never batches, and its stage span
  links every member's trace id; appsrc ``max-inflight`` bounds how far
  one pad runs ahead of another;
* with ``trace_mode`` on, a sampler thread sets ``<stage>.queue_depth``
  (plain and per tenant), ``<stage>.inflight_window`` and
  ``<sink>.staleness_s`` every 0.1 s (:meth:`Pipeline.sample_queues`),
  and a sink's deliveries set ``<sink>.watermark_pts``.

* ``validate=True`` runs the static analyzer (``analysis/``) before the
  pipeline is built and raises :class:`~..analysis.PipelineLintError`
  with every error; ``validate="deep"`` adds the deep pass;
* with ``xray`` on, every captured step registers with xray's census
  against the predicted budgets, replays are timed with CUDA events, a
  reconciler thread holds the memory ledger to the deep lint's estimate,
  and :meth:`Pipeline.explain` reports predicted against actual
  (``utils/xray.py``).

* ``Pipeline(data_parallel=, model_parallel=)`` builds one ``(data,
  model)`` mesh (``parallel/mesh.py``) over the local slots of the
  filters' device kind, lazily and at most once (``pipeline/plan.
  mesh_plan``): shardable stages with ``batch_max > 1`` split their
  micro-batches over it, and the llm filter runs tensor-parallel on its
  ``model`` axis (``custom=tp:N`` is promoted to ``model_parallel``).
  ``data_parallel=0`` takes the slots of one device: a mesh spans
  distinct cards only when a knob asks for it (no run over such a
  mesh exists yet).  An over-ask raises :class:`PipelineError`; nothing
  falls back to one slot.

Threads, not asyncio: stages do blocking work (device dispatch, host
copies) and release the interpreter lock inside torch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch

from ..core.buffer import Buffer, Event, batch_signature
from ..core.caps import Caps
from ..core.config import get_config
from ..core.log import Timer, logger, metrics
from ..core.registry import KIND_ELEMENT, get as registry_get
from ..elements.base import Element, SinkElement, SourceElement, SRC
from ..elements.sink import TensorSink
from ..utils import locks, tracing
from ..utils.armor import META_POISON as _META_POISON
from .graph import PipelineGraph
from .parser import parse as parse_launch
from . import residency as _residency
from .batching import AdaptiveLadder, ladder
from .plan import Stage, adaptive_variant_budget, mesh_plan, plan_stages

log = logger(__name__)

#: in-band shutdown sentinel: Pipeline.stop() closes every stage queue
#: with one of these, so blocked getters wake at once
_POISON = object()


class PipelineError(RuntimeError):
    pass


class _StageQueue:
    """Bounded stage input queue with stop-aware blocking: putters and
    getters block on two condition variables over one lock, and
    :meth:`close` wakes every waiter at once.

    The lock and conditions come from ``utils/locks.py`` under the JAX
    package's names: plain ``threading`` objects unless ``NNS_TPU_TSAN=1``,
    tracked ones (order graph, guard checks) under it."""

    #: lock discipline: ``lint --threads`` checks it statically,
    #: ``NNS_TPU_TSAN=1`` live
    _GUARDED_BY = {"_dq": "_lock", "_closed": "_lock"}

    def __init__(self, capacity: int):
        self._dq: Deque = collections.deque()
        self._cap = max(1, capacity)
        self._lock = locks.make_lock("StageQueue._lock")
        self._not_empty = locks.make_condition(self._lock,
                                               name="StageQueue._not_empty")
        self._not_full = locks.make_condition(self._lock,
                                              name="StageQueue._not_full")
        self._closed = False

    def put(self, item) -> bool:
        """Block until space (backpressure); False = pipeline stopping and
        the item was shed."""
        with self._lock:
            while len(self._dq) >= self._cap:
                if self._closed:
                    return False
                self._not_full.wait()
            if self._closed:
                return False
            self._dq.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        """Block until an item arrives; ``(None, _POISON)`` once closed;
        None after ``timeout`` seconds (the batch linger's wait)."""
        with self._lock:
            while not self._dq:
                if self._closed:
                    return (None, _POISON)
                if not self._not_empty.wait(timeout=timeout):
                    return None
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def get_nowait(self):
        """Non-blocking get; None when empty (the drain's opportunistic
        take)."""
        with self._lock:
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._dq.append((None, _POISON))
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def qsize(self) -> int:
        with self._lock:
            return len(self._dq)

    def tenant_depths(self) -> Dict[str, int]:
        """Queued buffers per tenant (``meta['_tenant']``): the sampler's
        per-tenant ``queue_depth``.  Cold path: counts a snapshot of the
        queue taken under the lock."""
        with self._lock:
            items = list(self._dq)
        depths: Dict[str, int] = {}
        for it in items:
            buf = it[1] if isinstance(it, tuple) and len(it) == 2 else None
            if isinstance(buf, Buffer):
                ten = buf.meta.get(tracing.META_TENANT)
                if ten is not None:
                    depths[ten] = depths.get(ten, 0) + 1
        return depths


class _Port:
    """Destination of an edge: a stage's runner + the pad name inside it."""

    def __init__(self, stage: "_Runner", pad: str):
        self.stage = stage
        self.pad = pad


class _Runner:
    """One streaming thread driving one planned stage."""

    def __init__(self, pipeline: "Pipeline", stage: Stage, capacity: int):
        self.pipeline = pipeline
        self.stage = stage
        self.element = stage.element
        self.queue = _StageQueue(capacity)
        self.out_ports: Dict[str, List[_Port]] = {}
        self.thread = threading.Thread(
            target=self._run, name=f"nns-{self.element.name}", daemon=True
        )
        # Elements that emit from a thread of their own (the continuous
        # LLM serve loop) push downstream through this runner's _emit.
        if getattr(self.element, "wants_async_emit", False):
            self.element._async_emit = self._emit
        self.in_pads: List[str] = []
        self._eos_pads: set = set()
        #: a collating stage's (``sync_policy="all"``) buffers per pad,
        #: waiting for one on every pad; ``_pending_peak`` is the longest
        #: any pad's list has been
        self._pending: Dict[str, List[Buffer]] = {}
        self._pending_peak = 0
        # Micro-batching: only stages the planner marked batchable drain
        # more than one buffer; batch_max=1 keeps the one-buffer path.
        self.batch_max = pipeline.batch_max if stage.batchable else 1
        self.batch_linger_s = pipeline.batch_linger_ms / 1e3
        if stage.batchable:
            # the element builds its BatchRunner at its first batch and
            # reads the pipeline's ladder from these
            self.element._batch_buckets = pipeline.batch_buckets
            if pipeline.adaptive_buckets and self.batch_max > 1:
                self.element._batch_ladder = AdaptiveLadder(
                    ladder(self.batch_max, pipeline.batch_buckets),
                    budget=pipeline._ladder_budget,
                    warm=pipeline.bucket_ladders.get(self.element.name),
                    name=self.element.name)
        # The dispatch window: a batching stage holds this many dispatched
        # micro-batches before emitting the oldest, so the next drain
        # overlaps the previous one's work on the card; FIFO emission.
        self.dispatch_depth = (max(1, pipeline.dispatch_depth)
                               if self.batch_max > 1 else 1)
        self._inflight: Deque[Tuple[list, int, int]] = collections.deque()
        #: the item a drain popped but could not batch (an event, another
        #: pad or signature): handled next, and kept across a restart, or
        #: a restarted stage would lose the EOS it carried
        self._carry = None
        name = self._nm = self.element.name
        self._m_occupancy = f"{name}.batch_occupancy"
        self._m_in = f"{name}.in"
        self._m_out = f"{name}.out"
        self._m_dropped = f"{name}.dropped"
        self._m_proc = f"{name}.proc"
        self._m_qwait = f"{name}.queue_wait"
        self._m_e2e = f"{name}.e2e_latency"
        self._m_restarts = f"{name}.restarts"
        #: elastic in-place restarts taken so far
        self._restarts = 0
        #: buffers in the hands of process() right now: what a restart
        #: loses (counted into .dropped)
        self._proc_n = 0
        # Flight recorder: None when trace_mode is off, so every hook
        # below is one pointer check and no meta stamp is written.  Also
        # pinned on the element, so its own spans (query admission,
        # replies) follow THIS pipeline's trace mode.
        self._tr = tracing.recorder if pipeline.trace_mode != "off" else None
        self.element._trace_rec = self._tr
        # xray's registry (None = off): the element's census, its bucket
        # steps and its framework read it when they capture.  A folded
        # device source wraps a FusedElement outside pipeline.elements:
        # both handles go to it too.
        self.element._xray = pipeline._xray_reg
        fused_inner = getattr(self.element, "fused", None)
        if fused_inner is not None:
            fused_inner._xray = pipeline._xray_reg
            fused_inner._trace_rec = self._tr
        self._is_sink = isinstance(self.element, SinkElement)
        # the one consumer that resolves a deferred host mapping itself
        self._lazy_post = isinstance(self.element, TensorSink)
        # the sampler's state (traced runs): the last delivery at a sink
        # (staleness), the highest pts delivered, tenants with a gauge
        self._last_sink_ns = 0
        self._max_pts = None
        self._gauge_tenants: set = set()

    def connect(self, out_pad: str, port: _Port) -> None:
        self.out_ports.setdefault(out_pad, []).append(port)

    def feed(self, pad: str, item: Union[Buffer, Event]) -> None:
        """Blocking put (backpressure point)."""
        if self._tr is not None and isinstance(item, Buffer):
            # queue-wait span start, keyed by the CONSUMING stage so
            # fan-out is exact; the stamp map is rebuilt, not mutated, so
            # two buffers that inherited one map never overwrite each
            # other's start time
            stamps = item.meta.get(tracing.META_ENQUEUE_NS)
            base = stamps if isinstance(stamps, dict) else {}
            item.meta[tracing.META_ENQUEUE_NS] = {
                **base, self._nm: time.monotonic_ns()}
        self.queue.put((pad, item))

    def _emit(self, outs) -> None:
        """Push (out_pad, item) pairs downstream; ``outs`` may be a
        generator, pushed item by item as it yields.  Safe to call from
        another thread while the runner also emits: the ports are fixed
        at construction and each feed is a locked queue put.  EOS leaves
        only after the element's ``finalize``, which for an async emitter
        waits until its thread has emitted everything."""
        for out_pad, item in outs:
            ports = self.out_ports.get(out_pad, [])
            if not ports and isinstance(item, Buffer):
                metrics.count(self._m_dropped)
                continue
            for port in ports:
                # a deferred host mapping stays lazy up to a tensor_sink;
                # any other consumer needs the real payload now
                if (isinstance(item, Buffer) and "_host_post" in item.meta
                        and not port.stage._lazy_post):
                    item = item.resolve()
                port.stage.feed(port.pad, item)

    def _broadcast(self, item) -> None:
        for ports in self.out_ports.values():
            for port in ports:
                port.stage.feed(port.pad, item)

    def _run(self) -> None:
        el = self.element
        while True:
            try:
                if isinstance(el, SourceElement):
                    self._run_source()
                else:
                    self._run_stream()
                return
            except Exception as e:  # noqa: BLE001 - must not kill the process
                if self._restartable(e):
                    continue
                log.exception("stage %s failed", el.name)
                self.pipeline._record_error(el.name, e)
                # batches dispatched before the failing one are whole:
                # deliver them before the error, as depth 1 would have
                self._flush_inflight_logged()
                self._broadcast(Event.error(e))
                self._broadcast(Event.eos())
                return

    def _restartable(self, e: Exception) -> bool:
        """Elastic stage restart: a pure stage holds no state from one
        buffer to the next, so re-entering its loop after a fault raised
        inside ``process()`` (``_proc_n`` is set around exactly that) loses
        the one buffer that raised it.  A fault while handling an event
        (EOS, then ``finalize``) has consumed it for good and is never
        restarted, nor is a stage past its budget (a source is never
        restartable)."""
        if not (self.stage.restartable and self._proc_n > 0
                and self._restarts < self.pipeline.max_stage_restarts
                and not self.pipeline._stopping.is_set()):
            return False
        self._restarts += 1
        metrics.count(self._m_restarts)
        metrics.count(self._m_dropped, self._proc_n)
        self._proc_n = 0
        log.warning("stage %s failed (%r); restarting in place (%d/%d)",
                    self.element.name, e, self._restarts,
                    self.pipeline.max_stage_restarts)
        # the window's batches were dispatched before the fault: deliver
        # them first, so order holds
        self._flush_inflight_logged()
        return True

    def _flush_inflight_logged(self) -> None:
        try:
            self._flush_inflight()
        except Exception:  # noqa: BLE001 - the caller must go on
            log.exception("in-flight flush failed for %s", self.element.name)

    def _run_source(self) -> None:
        el = self.element
        tr = self._tr
        for item in el.generate():
            if self.pipeline._stopping.is_set():
                break
            if tr is not None and isinstance(item, Buffer):
                self._stamp_ingress(tr, item)
            self._emit([(SRC, item)])
            metrics.count(self._m_out)
        self._emit(el.finalize())
        self._broadcast(Event.eos())

    def _stamp_ingress(self, tr, buf: Buffer) -> None:
        """INGRESS: the buffer's trace id is born here (or kept, when the
        query wire brought one) and rides ``Buffer.meta`` downstream; the
        pipeline's default tenant is stamped here, in traced runs only
        (an element-level tenant, appsrc ``tenant=`` or the wire meta, is
        app data and rides whatever the trace mode)."""
        tid = buf.meta.get(tracing.META_TRACE_ID)
        if tid is None:
            tid = buf.meta[tracing.META_TRACE_ID] = tracing.next_trace_id()
        t = time.monotonic_ns()
        buf.meta[tracing.META_INGRESS_NS] = t
        ten = buf.meta.get(tracing.META_TENANT)
        if ten is None and self.pipeline.tenant is not None:
            ten = buf.meta[tracing.META_TENANT] = self.pipeline.tenant
        if ten is None:
            tr.record("ingress", self._nm, tid, t, 0, pts=buf.pts)
        else:
            tr.record("ingress", self._nm, tid, t, 0, pts=buf.pts,
                      tenant=ten)

    # -- nns-armor: poison-pill quarantine ---------------------------------
    def _invoke(self, el, pad: str, buf: Buffer):
        """The stage invoke, armored under ``Pipeline(quarantine=...)``: an
        exception quarantines the request to the DLQ and answers it with
        a typed ``abort_reason=poison`` terminator, and the pipeline
        serves on.  Sinks keep the plain semantics (a failed send is not
        a poisoned request).  A streaming stage's generator is iterated
        under the armor as the runner emits it, so a failure mid-stream is
        caught too (tokens already emitted stay emitted)."""
        armor = self.pipeline._armor
        if armor is None or self._is_sink:
            return el.process(pad, buf)
        return self._armored(armor, el, pad, buf)

    def _armored(self, armor, el, pad: str, buf: Buffer):
        try:
            yield from el.process(pad, buf)
        except Exception as e:  # noqa: BLE001 - the quarantine contract
            yield self._poison(armor, buf, e)

    def _poison(self, armor, buf: Buffer, err: BaseException):
        from ..utils import armor as _armor_mod

        metrics.count(f"{self._nm}.poisoned")
        armor.quarantine(buf, error=err, stage=self._nm)
        return SRC, _armor_mod.poison_terminator(buf, err)

    def _invoke_batch(self, el, pad: str, batch: List[Buffer]) -> list:
        """``process_batch``, armored like :meth:`_invoke`: a failed
        micro-batch is re-run one buffer at a time (a batchable stage is
        pure), so only the buffers that fail become poison terminators and
        the innocent rows that shared the dispatch are answered."""
        armor = self.pipeline._armor
        try:
            return list(el.process_batch(pad, batch))
        except Exception:  # noqa: BLE001 - the quarantine contract
            if armor is None:
                raise
            outs = []
            for b in batch:
                try:
                    outs.extend(el.process(pad, b))
                except Exception as e:  # noqa: BLE001 - the real pill
                    outs.append(self._poison(armor, b, e))
            return outs

    # -- tracing helpers ---------------------------------------------------
    def _trace_queue_wait(self, buf: Buffer, end_ns: int) -> Optional[int]:
        """Record the queue-wait span of one consumed buffer (popping THIS
        stage's enqueue stamp); returns its trace id."""
        tid = buf.meta.get(tracing.META_TRACE_ID)
        stamps = buf.meta.get(tracing.META_ENQUEUE_NS)
        tq = None
        if isinstance(stamps, dict):
            tq = stamps.pop(self._nm, None)
            if not stamps:
                # drained map: delivered buffers (and wire-encoded
                # responses) stay free of it
                buf.meta.pop(tracing.META_ENQUEUE_NS, None)
        if tq is not None and end_ns >= tq:
            ten = buf.meta.get(tracing.META_TENANT)
            if ten is None:
                self._tr.record("queue", self._nm, tid, tq, end_ns - tq)
            else:
                self._tr.record("queue", self._nm, tid, tq, end_ns - tq,
                                tenant=ten)
            metrics.observe_latency(self._m_qwait, (end_ns - tq) / 1e9,
                                    tenant=ten)
        return tid

    @staticmethod
    def _propagate_trace(src: Buffer, outs) -> None:
        """Back-fill the trace id and ingress time onto output buffers an
        element built from scratch (``with_tensors`` already copies
        meta).  Returns the outputs, a generator's lazily."""
        def fill(o):
            if isinstance(o, Buffer):
                if tracing.META_TRACE_ID not in o.meta:
                    o.meta[tracing.META_TRACE_ID] = \
                        src.meta.get(tracing.META_TRACE_ID)
                if (tracing.META_INGRESS_NS not in o.meta
                        and tracing.META_INGRESS_NS in src.meta):
                    o.meta[tracing.META_INGRESS_NS] = \
                        src.meta[tracing.META_INGRESS_NS]
            return o

        for out_pad, o in outs:
            yield out_pad, fill(o)

    def _trace_sink_delivery(self, buf: Buffer, end_ns: int) -> None:
        """End-to-end span (ingress -> sink delivery) of one buffer, split
        per tenant when it carries one, and the sink's staleness and
        ``watermark_pts`` state (a high-water mark: a tee or mux fan-in
        can deliver pts out of order)."""
        self._last_sink_ns = end_ns
        if buf.pts is not None and (self._max_pts is None
                                    or buf.pts > self._max_pts):
            self._max_pts = buf.pts
            metrics.gauge(f"{self._nm}.watermark_pts", float(buf.pts))
        ts0 = buf.meta.get(tracing.META_INGRESS_NS)
        if ts0 is None or end_ns < ts0:
            return
        ten = buf.meta.get(tracing.META_TENANT)
        metrics.observe_latency(self._m_e2e, (end_ns - ts0) / 1e9,
                                tenant=ten)
        tid = buf.meta.get(tracing.META_TRACE_ID)
        if ten is None:
            self._tr.record("e2e", self._nm, tid, ts0, end_ns - ts0)
        else:
            self._tr.record("e2e", self._nm, tid, ts0, end_ns - ts0,
                            tenant=ten)

    # -- micro-batching and the dispatch window ----------------------------
    def _drain_batch(self, pad: str, first: Buffer):
        """Take up to batch_max - 1 more already-queued buffers of the same
        pad and signature; wait for stragglers only up to
        ``batch_linger_ms``.  Returns (batch, carry): ``carry`` is the
        first item that could not join (an event, another pad or
        signature), handled after the batch so stream order holds."""
        batch = [first]
        sig = batch_signature(first)
        deadline = None
        while len(batch) < self.batch_max:
            nxt = self.queue.get_nowait()
            if nxt is None:
                if self.batch_linger_s <= 0.0:
                    break
                if deadline is None:
                    deadline = time.monotonic() + self.batch_linger_s
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    break
                nxt = self.queue.get(timeout=remaining)
                if nxt is None:
                    break
            npad, nitem = nxt
            if (nitem is _POISON or isinstance(nitem, Event)
                    or npad != pad or batch_signature(nitem) != sig):
                return batch, nxt
            batch.append(nitem)
        return batch, None

    def _run_batch(self, pad: str, item: Buffer) -> None:
        """One drained micro-batch: a bucketed step for n > 1, the
        one-buffer path for n == 1; ``.proc`` per buffer (the batch's time
        over n), so the series keeps one meaning with batching on or off."""
        el, tr = self.element, self._tr
        tdr0 = time.monotonic_ns() if tr is not None else 0
        batch, self._carry = self._drain_batch(pad, item)
        n = len(batch)
        metrics.count(self._m_in, n)
        metrics.observe_bucketed(self._m_occupancy, float(n))
        t0 = time.perf_counter()
        self._proc_n = n
        outs = (self._invoke_batch(el, pad, batch) if n > 1
                else list(self._invoke(el, pad, batch[0])))
        self._proc_n = 0
        dt = time.perf_counter() - t0
        metrics.observe_latency(self._m_proc, dt / n)
        if tr is not None:
            self._trace_batch(batch, outs, tdr0, dt)
        if self.dispatch_depth > 1:
            # the runner loops back to drain the next batch while this
            # one runs on the card; emission (which may block on a full
            # queue downstream) waits until the window is full
            self._inflight.append(
                (outs, n, time.monotonic_ns() if tr is not None else 0))
            while len(self._inflight) >= self.dispatch_depth:
                self._emit_oldest_inflight()
        else:
            self._emit(outs)
            metrics.count(self._m_out, n)

    def _emit_oldest_inflight(self) -> None:
        outs, n, t_disp = self._inflight.popleft()
        if self._tr is not None and t_disp:
            first = next((o for _, o in outs if isinstance(o, Buffer)), None)
            tid = ten = None
            if first is not None:
                tid = first.meta.get(tracing.META_TRACE_ID)
                ten = first.meta.get(tracing.META_TENANT)
            args = {"rows": n}
            if ten is not None:
                args["tenant"] = ten
            self._tr.record("inflight", self._nm, tid, t_disp,
                            time.monotonic_ns() - t_disp, **args)
        self._emit(outs)
        metrics.count(self._m_out, n)

    def _flush_inflight(self) -> None:
        while self._inflight:
            self._emit_oldest_inflight()

    def _trace_batch(self, batch: List[Buffer], outs: list, tdr0: int,
                     dt: float) -> None:
        """Spans of one micro-batch: each member's queue wait, the batch
        formation window (first buffer in hand -> dispatch) and the stage
        span LINKING every member's trace id (``per_row_ns`` amortizes the
        one dispatch over its rows); each member's tenant gets the
        per-row time in its ``.proc`` twin."""
        tr = self._tr
        tids = [self._trace_queue_wait(b, tdr0) for b in batch]
        n = len(batch)
        dur = int(dt * 1e9)
        disp0 = time.monotonic_ns() - dur
        tens = [b.meta.get(tracing.META_TENANT) for b in batch]
        for ten in tens:
            if ten is not None:
                metrics.observe_latency_labeled(self._m_proc, dt / n, ten)
        if n > 1:
            extra = ({"tenants": tens} if any(t is not None for t in tens)
                     else {})
            tr.record("batch", self._nm, tids[0], tdr0, max(0, disp0 - tdr0),
                      trace_ids=tids, rows=n, **extra)
            tr.record("stage", self._nm, tids[0], disp0, dur, trace_ids=tids,
                      rows=n, per_row_ns=dur // n, **extra)
        elif tens[0] is None:
            tr.record("stage", self._nm, tids[0], disp0, dur)
        else:
            tr.record("stage", self._nm, tids[0], disp0, dur, tenant=tens[0])
        # back-fill trace meta onto outputs built from scratch: row by row
        # when one output per input (the batch contract), else the first's
        aligned = len(outs) == n
        for i, (_, o) in enumerate(outs):
            if isinstance(o, Buffer):
                src = batch[i] if aligned else batch[0]
                if tracing.META_TRACE_ID not in o.meta:
                    o.meta[tracing.META_TRACE_ID] = \
                        src.meta.get(tracing.META_TRACE_ID)
                if (tracing.META_INGRESS_NS not in o.meta
                        and tracing.META_INGRESS_NS in src.meta):
                    o.meta[tracing.META_INGRESS_NS] = \
                        src.meta[tracing.META_INGRESS_NS]

    def _run_stream(self) -> None:
        el = self.element
        # a collating stage waits for one buffer on every pad and never
        # batches
        all_policy = el.sync_policy == "all" and len(self.in_pads) > 1
        batching = self.batch_max > 1 and not all_policy
        while True:
            if self._carry is not None:
                pad, item = self._carry
                self._carry = None
            else:
                nxt = None
                if self._inflight:
                    # keep batches in flight only while more work is
                    # already queued: before blocking, emit what is held,
                    # or an idle stream pays the window as latency
                    nxt = self.queue.get_nowait()
                    if nxt is None:
                        self._flush_inflight()
                if nxt is None:
                    nxt = self.queue.get()
                pad, item = nxt
            if item is _POISON:
                self._flush_inflight()
                return
            if isinstance(item, Event):
                # an event is an ordering fence: what was dispatched
                # before it is emitted before it is handled
                self._flush_inflight()
                if item.kind == "eos":
                    self._eos_pads.add(pad)
                    if all_policy:
                        self._try_groups()
                    if self._eos_pads >= set(self.in_pads):
                        self._emit(el.finalize())
                        self._broadcast(Event.eos())
                        return
                    continue
                if item.kind == "error":
                    self._broadcast(item)
                    continue
                self._emit(el.on_event(pad, item))
                continue
            if (not self._is_sink and not all_policy
                    and item.meta.get(_META_POISON)):
                # a poison terminator is an ANSWER riding to the sink,
                # never work: forward it untouched (a collator pairs it
                # instead, or the other pads' streams would shift by one)
                self._flush_inflight()
                metrics.count(self._m_in)
                self._emit([(SRC, item)])
                metrics.count(self._m_out)
                continue
            if all_policy:
                metrics.count(self._m_in)
                queued = self._pending.setdefault(pad, [])
                queued.append(item)
                self._pending_peak = max(self._pending_peak, len(queued))
                self._try_groups()
                continue
            if batching:
                self._run_batch(pad, item)
                continue
            metrics.count(self._m_in)
            tr = self._tr
            # a streaming stage's process() runs as the runner emits it
            self._proc_n = 1
            if tr is None:
                with Timer(self._m_proc):
                    self._emit(self._invoke(el, pad, item))
            else:
                now0 = time.monotonic_ns()
                tid = self._trace_queue_wait(item, now0)
                ten = item.meta.get(tracing.META_TENANT)
                t0 = time.perf_counter()
                self._emit(self._propagate_trace(
                    item, self._invoke(el, pad, item)))
                dt = time.perf_counter() - t0
                metrics.observe_latency(self._m_proc, dt, tenant=ten)
                dur = int(dt * 1e9)
                if ten is None:
                    tr.record("stage", self._nm, tid, now0, dur)
                else:
                    tr.record("stage", self._nm, tid, now0, dur, tenant=ten)
                if self._is_sink:
                    self._trace_sink_delivery(item, now0 + dur)
            self._proc_n = 0
            metrics.count(self._m_out)

    def _try_groups(self) -> None:
        """Collate one buffer per pad (slowest-pad sync, the reference's
        tensor_mux ``sync-mode=slowest``) into ``process_group``.  A pad
        keeps pairing from its pending list after its EOS; once a pad is
        at EOS with nothing pending no group can form again, and what the
        other pads hold is dropped (counted in ``.dropped``): a partial
        group would break the element's negotiated caps."""
        el = self.element
        while True:
            if any(p in self._eos_pads and not self._pending.get(p)
                   for p in self.in_pads):
                n = sum(len(v) for v in self._pending.values())
                if n:
                    metrics.count(self._m_dropped, n)
                    self._pending.clear()
                return
            if not all(self._pending.get(p) for p in self.in_pads):
                return
            group = {p: self._pending[p].pop(0) for p in self.in_pads}
            tr = self._tr
            if tr is None:
                with Timer(self._m_proc):
                    outs = list(el.process_group(group))
                self._emit(outs)
            else:
                members = list(group.values())
                now0 = time.monotonic_ns()
                tids = [self._trace_queue_wait(b, now0) for b in members]
                t0 = time.perf_counter()
                outs = el.process_group(group)
                dt = time.perf_counter() - t0
                metrics.observe_latency(self._m_proc, dt)
                dur = int(dt * 1e9)
                # the collation span links every member's trace id
                tr.record("stage", self._nm, tids[0], now0, dur,
                          trace_ids=tids)
                if self._is_sink:
                    self._trace_sink_delivery(members[0], now0 + dur)
                self._emit(self._propagate_trace(members[0], outs))
            metrics.count(self._m_out)


_LLM_FRAMEWORKS = ("llm", "llamacpp", "llama.cpp")


def _llm_tp_alias(graph: PipelineGraph) -> int:
    """Largest ``custom=tp:N`` of an llm tensor_filter in the graph (1 =
    none): promoted to ``Pipeline(model_parallel=N)`` at construction so
    the filter runs on the pipeline's mesh."""
    from ..filters.base import parse_custom_options

    tp = 1
    for node in graph.nodes.values():
        if node.kind != "tensor_filter":
            continue
        if str(node.props.get("framework", "")).lower() not in _LLM_FRAMEWORKS:
            continue
        opts = parse_custom_options(str(node.props.get("custom", "")))
        try:
            tp = max(tp, int(opts.get("tp", 1)))
        except (TypeError, ValueError):
            pass  # a non-literal tp: the filter's own open() rejects it
    return tp


class Pipeline:
    """Build + run a pipeline graph.

    Accepts a pipeline description string or a parsed PipelineGraph.
    ``queue_capacity`` bounds each stage's input queue (backpressure).
    ``trace_mode`` (``off``/``ring``/``full``) switches on the per-buffer
    flight recorder (:meth:`dump_trace` writes it as Chrome trace JSON);
    ``tenant`` is a default tenant stamped at source ingress in traced
    runs.  ``fuse=True`` (the default) lets the planner merge adjacent
    device-capable elements into one fused stage (``pipeline/plan.py``);
    ``fuse=False`` runs one stage per element.  ``quarantine`` (a DLQ directory, policy dict or
    ``QuarantinePolicy``) turns a request whose stage invoke raises into
    a DLQ record and a typed ``abort_reason=poison`` answer, with a
    per-tenant circuit breaker that sheds repeat offenders at the query
    front door; ``journal_replay=True`` asks every journaled query
    serversrc to re-admit its accepted-but-unanswered requests at start.
    ``reduce_outputs`` lets the residency planner switch a filter to its
    model's reduced output (deeplab's native-stride map) when every
    consumer below admits any geometry; ``Pipeline.residency`` is the
    plan.  ``fetch_depth`` is the sinks' fetch window (a sink's own
    ``fetch-depth`` wins).  ``max_stage_restarts`` lets a restartable stage
    (a fused chain or a pure filter) survive that many faults in
    ``process()``, each losing its one buffer.  ``slo`` (an
    :class:`~..utils.slo.SLOPolicy`, a policy dict or a JSON file path,
    validated here) runs the SLO engine while the pipeline runs; it
    reads the sinks' end-to-end series, which ``trace_mode`` feeds.
    ``batch_max`` lets a batchable stage drain up to that many queued
    buffers into one bucketed step (``batch_buckets`` the ladder,
    ``batch_linger_ms`` a wait for stragglers, ``adaptive_buckets`` its
    online refinement, ``bucket_ladders`` warm-start ladders by stage
    name, read back with :meth:`ladder_snapshot`); ``dispatch_depth`` is
    a batching stage's dispatch window; ``donate_ingress`` lets a fused
    chain own the frames of the host source that feeds only it
    (``pipeline/plan.py``).  ``xray`` switches on predicted-against-actual
    reconciliation (``utils/xray.py``, :meth:`explain`); ``validate``
    (True or ``"deep"``) runs the static analyzer first.
    Defaults come from :func:`get_config`.  Elements are instantiated and
    caps negotiated at construction (which opens models); threads start
    at :meth:`start` or on entering a ``with`` block.
    """

    def __init__(self, graph: Union[str, PipelineGraph], *,
                 queue_capacity: Optional[int] = None,
                 trace_mode: Optional[str] = None,
                 tenant: Optional[str] = None,
                 quarantine=None,
                 journal_replay: bool = False,
                 fuse: bool = True,
                 reduce_outputs: Optional[bool] = None,
                 fetch_depth: Optional[int] = None,
                 max_stage_restarts: Optional[int] = None,
                 slo=None,
                 batch_max: Optional[int] = None,
                 batch_buckets: Optional[List[int]] = None,
                 batch_linger_ms: Optional[float] = None,
                 adaptive_buckets: Optional[bool] = None,
                 bucket_ladders: Optional[Dict[str, List[int]]] = None,
                 dispatch_depth: Optional[int] = None,
                 donate_ingress: Optional[bool] = None,
                 xray: Optional[bool] = None,
                 data_parallel: Optional[int] = None,
                 model_parallel: Optional[int] = None,
                 validate: Union[bool, str] = False):
        if validate:
            # lint before strict validation: the analyzer reports every
            # problem at once where parse/validate stop at the first
            from ..analysis import analyze

            deep = validate == "deep"
            kw = dict(queue_capacity=queue_capacity, deep=deep)
            if deep:  # the deep pass budgets with THIS pipeline's knobs
                kw.update(batch_max=batch_max, batch_buckets=batch_buckets,
                          adaptive_buckets=adaptive_buckets,
                          data_parallel=data_parallel,
                          model_parallel=model_parallel,
                          dispatch_depth=dispatch_depth)
            if isinstance(graph, str):
                source = graph
                graph = parse_launch(graph, validate=False)
                report = analyze(graph, **kw)
                report.source = source
                report.raise_if_errors()
            else:
                analyze(graph, **kw).raise_if_errors()
        if isinstance(graph, str):
            graph = parse_launch(graph)
        graph.validate()
        cfg = get_config()
        # xray (utils/xray.py): captures register with the process-wide
        # program census, replays are timed, the memory ledger is held
        # against the deep lint.  Off: elements hold None.
        self.xray = bool(xray if xray is not None else cfg.xray)
        self._xray_reg = None
        if self.xray:
            from ..utils import xray as _xray_mod

            self._xray_reg = _xray_mod.registry
        self.graph = graph
        self.fuse = bool(fuse)
        self.reduce_outputs = bool(reduce_outputs if reduce_outputs is not None
                                   else cfg.reduce_outputs)
        self.capacity = queue_capacity or cfg.queue_capacity
        self.fetch_depth = max(1, int(
            fetch_depth if fetch_depth is not None else cfg.fetch_depth))
        self.max_stage_restarts = max(0, int(
            max_stage_restarts if max_stage_restarts is not None
            else cfg.max_stage_restarts))
        self.batch_max = max(
            1, batch_max if batch_max is not None else cfg.batch_max)
        self.batch_buckets = list(
            batch_buckets if batch_buckets is not None else cfg.batch_buckets
        ) or None
        self.batch_linger_ms = float(
            batch_linger_ms if batch_linger_ms is not None
            else cfg.batch_linger_ms)
        self.adaptive_buckets = bool(
            adaptive_buckets if adaptive_buckets is not None
            else cfg.adaptive_buckets)
        self.bucket_ladders: Dict[str, List[int]] = dict(
            bucket_ladders if bucket_ladders is not None
            else cfg.bucket_ladders)
        self.data_parallel = max(0, int(
            data_parallel if data_parallel is not None
            else cfg.data_parallel))
        self.model_parallel = max(0, int(
            model_parallel if model_parallel is not None
            else cfg.model_parallel))
        self.dispatch_depth = max(1, int(
            dispatch_depth if dispatch_depth is not None
            else cfg.dispatch_depth))
        self.donate_ingress = bool(
            donate_ingress if donate_ingress is not None
            else cfg.donate_ingress)
        # the slo policy is parsed HERE so that a bad one fails the
        # construction (naming every problem), not start() with threads up
        self._slo_policy = None
        self._slo_engine = None
        if slo is not None:
            from ..utils.slo import load_policy

            try:
                self._slo_policy = load_policy(slo)
            except (ValueError, OSError) as e:
                raise PipelineError(str(e)) from e
        self.trace_mode = str(
            trace_mode if trace_mode is not None else cfg.trace_mode)
        if self.trace_mode not in ("off", "ring", "full"):
            raise PipelineError(
                f"trace_mode must be off|ring|full, got {self.trace_mode!r}")
        self.tenant = None if tenant is None else str(tenant)
        if self.trace_mode != "off":
            # the flight recorder is process-wide, like core.log.metrics;
            # an untraced pipeline never touches it
            tracing.recorder.configure(self.trace_mode,
                                       cfg.trace_ring_capacity)
        self._armor = None
        if quarantine is not None:
            from ..utils import armor as _armor

            try:
                self._armor = _armor.Armor(
                    _armor.QuarantinePolicy.of(quarantine), nan_guard=False,
                    apply_admission=self._breaker_admission,
                    recorder=(tracing.recorder
                              if self.trace_mode != "off" else None))
            except ValueError as e:
                raise PipelineError(str(e)) from e
        self._journal_replay = bool(journal_replay)
        self._stopping = threading.Event()
        self._errors: List[Tuple[str, BaseException]] = []
        self._err_lock = threading.Lock()
        self._started = False

        # custom=tp:N on an llm filter is promoted to the pipeline's
        # model_parallel before any element opens, so the filter lands on
        # the pipeline's mesh; an explicit model_parallel (0 or > 1) wins
        tp_alias = _llm_tp_alias(graph)
        if tp_alias > 1:
            if self.model_parallel == 1:
                log.warning(
                    "tensor_filter llm custom=tp:%d is deprecated — "
                    "promoted to Pipeline(model_parallel=%d); the filter "
                    "now runs tensor-parallel on the pipeline's shared "
                    "(data x model) mesh", tp_alias, tp_alias)
                self.model_parallel = tp_alias
            else:
                log.warning(
                    "custom=tp:%d ignored: the pipeline's explicit "
                    "model_parallel=%d wins (tp: is a deprecated alias)",
                    tp_alias, self.model_parallel)
        # THE pipeline mesh: built at most once, from start() for sharded
        # micro-batching or earlier from a tensor-parallel filter's
        # _mesh_provider call in its open()
        self._mesh_obj = None
        self._mesh_built = False
        self._mesh_lock = threading.Lock()
        #: resolved (data, model) axis sizes once the mesh is built
        self.mesh_shape: Tuple[int, int] = (1, 1)

        # 1. instantiate elements
        self.elements: Dict[int, Element] = {}
        for node in graph.nodes.values():
            if node.kind == "capsfilter":
                el = _CapsFilter(node.caps)
            else:
                cls = registry_get(KIND_ELEMENT, node.kind)
                el = cls(dict(node.props), name=node.name or f"{node.kind}{node.id}")
            self.elements[node.id] = el
            # armor + journal attach: journaled serversrcs honour the
            # pipeline-level replay flag
            el._armor = self._armor
            # a tensor_trainer with swap-to=<stage> copies its parameters
            # into that serving stage after each epoch through this
            el._swap_cb = self.swap_params
            # a tensor-parallel framework opens on the pipeline's mesh
            el._mesh_provider = self._model_mesh
            if self._journal_replay:
                el._journal_replay = True

        # 2. residency pre-pass, before negotiation (it changes specs):
        # mark the filters whose consumers all admit reduced geometry
        if self.reduce_outputs:
            _residency.mark_reduced_admissible(graph, self.elements)

        # 3. caps negotiation in topo order
        self._negotiate()

        # 4. plan stages (the fusion pass), the residency plan, and one
        # runner per stage
        self.stages: List[Stage] = plan_stages(
            graph, self.elements, fuse=self.fuse,
            donate_ingress=self.donate_ingress)
        # an adaptive ladder's budget: max_compiled_variants split over the
        # batchable stages (plan.adaptive_variant_budget)
        self._ladder_budget = adaptive_variant_budget(
            len(ladder(self.batch_max, self.batch_buckets)),
            sum(1 for s in self.stages if s.batchable),
            cfg.max_compiled_variants)
        self.residency = _residency.plan_residency(graph, self.elements,
                                                   self.stages)
        if self.residency.fetch or self.residency.reduced_outputs:
            log.info("%s", self.residency.render())
        # the sinks read the pipeline's fetch window width
        for el in self.elements.values():
            if isinstance(el, SinkElement):
                el._fetch_depth = self.fetch_depth
        self._runners: Dict[int, _Runner] = {}
        for st in self.stages:
            r = _Runner(self, st, self.capacity)
            for nid in st.node_ids:
                self._runners[nid] = r
        for e in graph.edges:
            r_src, r_dst = self._runners[e.src], self._runners[e.dst]
            if r_src is r_dst:
                continue  # an edge inside a fused stage
            r_src.connect(e.src_pad, _Port(r_dst, e.dst_pad))
            r_dst.in_pads.append(e.dst_pad)

        self._by_name: Dict[str, Element] = {}
        for nid, el in self.elements.items():
            node = graph.nodes[nid]
            if node.name:
                self._by_name[node.name] = el
            self._by_name.setdefault(el.name, el)

        # A non-source element with no input link can never receive a
        # buffer — almost always a missing '!' between two elements.
        for nid, el in self.elements.items():
            if not isinstance(el, SourceElement) and not graph.in_edges(nid):
                raise PipelineError(
                    f"element {el.name!r} ({graph.nodes[nid].kind}) "
                    "has no input link — missing '!' before it?")

    def _negotiate(self) -> None:
        out_caps: Dict[Tuple[int, str], Caps] = {}
        for node in self.graph.topo_order():
            el = self.elements[node.id]
            in_caps: Dict[str, Caps] = {}
            for e in self.graph.in_edges(node.id):
                in_caps[e.dst_pad] = out_caps.get((e.src, e.src_pad), Caps.any())
            out_pads = sorted({e.src_pad for e in self.graph.out_edges(node.id)}) or [SRC]
            produced = el.configure(in_caps, out_pads)
            for pad in out_pads:
                out_caps[(node.id, pad)] = produced.get(pad, Caps.any())

    def _unique_runners(self) -> List[_Runner]:
        return list({id(r): r for r in self._runners.values()}.values())

    # -- control plane -----------------------------------------------------
    def start(self) -> "Pipeline":
        if getattr(self, "_dead", False):
            raise PipelineError(
                "pipeline failed startup validation and was stopped; "
                "build a new Pipeline")
        if self._started:
            return self
        self._started = True
        for el in self.elements.values():
            el._stop_event = self._stopping  # lets blocking sinks shed on stop
            el.start()
        # Reject typo'd properties like gst_parse_launch ("no property X
        # in element"): by now every element consulted what it understands.
        unknown = {
            el.name: sorted(u)
            for el in self.elements.values()
            if (u := el.unknown_props())
        }
        if unknown:
            self.stop()
            self._dead = True
            raise PipelineError(
                f"unknown element properties (typo?): {unknown}")
        try:
            mesh = self._build_mesh()
        except Exception:
            # elements already started: tear them down now, and a retried
            # start() raises instead of returning a dead instance
            self.stop()
            self._dead = True
            raise
        if mesh is not None:
            # read by each shardable stage's runner at its first batched
            # dispatch; no other stage sees it
            from ..parallel.mesh import mesh_axis_size

            replicas = mesh_axis_size(mesh, "data")
            for r in self._unique_runners():
                if r.stage.shardable and r.batch_max > 1:
                    r.element._shard_mesh = mesh
                    lad = getattr(r.element, "_batch_ladder", None)
                    if lad is not None:
                        # minted sizes stay replica-aligned
                        lad.align = max(1, replicas)
        if self._xray_reg is not None:
            # the predicted census, before any streaming thread captures,
            # and the deep lint's memory estimate (the reconciler reads it
            # cached, so the lint never competes with the serving threads)
            from ..utils import xray as _xray_mod

            self._install_xray_expectations()
            _xray_mod.predicted_hbm(self)
        for r in self._unique_runners():
            r.thread.start()
        if self.trace_mode != "off":
            # the queue-depth, dispatch-window and staleness gauges,
            # sampled off the streaming threads until stop()
            self._sampler = threading.Thread(
                target=self._sample_loop, name="nns-sampler", daemon=True)
            self._sampler.start()
        if self._slo_policy is not None:
            # per-tenant burn rate and breach gauges off the live series
            self._slo_loop().start()
        if self._xray_reg is not None:
            # predicted against actual: the gauges and the ledger, on the
            # SLO engine's cadence; stopped and joined by stop()
            from ..utils.xray import XrayReconciler

            self._xray_recon = XrayReconciler(self)
            self._xray_recon.start()
        return self

    @property
    def mesh(self):
        """THE pipeline mesh (None before it is built, or when the plan is
        one slot)."""
        return self._mesh_obj

    def _model_mesh(self, device=None):
        """The mesh provider handed to elements (the llm filter's
        tensor-parallel path, called with its device): the pipeline mesh
        when a ``model`` axis is configured, else None."""
        if self.model_parallel == 1:
            return None
        return self._shared_mesh({device.type} if device is not None else set())

    def _shared_mesh(self, kinds: set):
        """Build (at most once) the pipeline mesh from the resolved
        ``(data, model)`` plan over the local slots of ``kinds`` (the
        device kind of the stages that use it: ``accelerator=``); None
        when the plan is one slot.  Raises :class:`PipelineError` on an
        over-ask, a plan that does not divide, or mixed device kinds."""
        with self._mesh_lock:
            if self._mesh_built:
                have = self._mesh_obj.kind if self._mesh_obj is not None else None
                if have is not None and kinds - {have}:
                    raise PipelineError(
                        f"a pipeline mesh takes one device kind: it is on "
                        f"{have}, a stage asks for {sorted(kinds - {have})}")
                return self._mesh_obj
            from ..parallel.mesh import local_devices, make_mesh, one_device_slots

            if len(kinds) > 1:
                raise PipelineError(
                    f"a pipeline mesh takes one device kind; its stages run "
                    f"on {sorted(kinds)} (accelerator=)")
            try:
                devs = local_devices(next(iter(kinds)) if kinds else None)
            except (RuntimeError, ValueError) as e:
                raise PipelineError(str(e)) from e
            dp, mp = mesh_plan(self.data_parallel, self.model_parallel,
                               self.batch_max, len(devs),
                               absorb=one_device_slots(devs))
            if dp * mp > len(devs):
                if mp == 1:
                    raise PipelineError(
                        f"data_parallel={dp} needs {dp} local devices, "
                        f"have {len(devs)}")
                raise PipelineError(
                    f"data_parallel={dp} x model_parallel={mp} needs "
                    f"{dp * mp} local devices, have {len(devs)}")
            self.mesh_shape = (dp, mp)
            if dp == 1 and mp == 1:
                self._mesh_obj = None
            else:
                try:
                    self._mesh_obj = make_mesh(data=dp, model=mp,
                                               devices=devs[:dp * mp])
                except ValueError as e:
                    raise PipelineError(str(e)) from e
            self._mesh_built = True
            return self._mesh_obj

    def _build_mesh(self):
        """The pipeline mesh, or None for one-slot dispatch: built on the
        thread driving start(), and only when a shardable stage batches
        or a ``model`` axis is configured (a tensor-parallel filter may
        have built it already, in its open())."""
        dp_wanted = (self.batch_max > 1 and self.data_parallel != 1
                     and any(s.shardable for s in self.stages))
        mp_wanted = self.model_parallel != 1
        if not (dp_wanted or mp_wanted or self._mesh_built):
            return None
        kinds = set()
        for r in self._unique_runners():
            if r.stage.shardable and r.batch_max > 1:
                dev = getattr(r.element, "device", None)
                if isinstance(dev, torch.device) and dev.type != "meta":
                    kinds.add(dev.type)
        return self._shared_mesh(kinds)

    def _install_xray_expectations(self) -> None:
        """The predicted census of every stage that captures, with the
        deep lint's arithmetic: the bucket ladder (or the adaptive budget)
        for a batching stage, two single-buffer steps for a fused stage
        (its static signature and a truncated tail's).  A lone element
        outside the batching path runs eagerly and is noted so.  The llm
        loop and the trainer install their own when their framework
        attaches (``serving_plan``, ``TRAINER_PROGRAMS``)."""
        reg = self._xray_reg
        for r in self._unique_runners():
            el = r.element
            target = getattr(el, "fused", el)  # a folded source's chain
            nm = target.name
            mesh = getattr(el, "_shard_mesh", None)
            if r.stage.batchable and r.batch_max > 1 and mesh is not None:
                # one captured step per bucket and slot with rows
                from ..parallel.mesh import mesh_axis_size
                from .batching import shard_bucket_for, split_runs

                d, m = mesh_axis_size(mesh, "data"), mesh_axis_size(mesh, "model")
                sb = {shard_bucket_for(b, d, self.batch_buckets)
                      for b in ladder(r.batch_max, self.batch_buckets)}
                reg.expect(nm, "batch", budget=sum(
                    d * sum(1 for k in split_runs(b // d, m) if k) for b in sb),
                    note="sharded bucket ladder: a step per bucket and slot")
            elif r.stage.batchable and r.batch_max > 1:
                if getattr(el, "_batch_ladder", None) is not None:
                    reg.expect(nm, "batch", budget=self._ladder_budget,
                               note="adaptive ladder budget")
                else:
                    allow = set(ladder(r.batch_max, self.batch_buckets))
                    reg.expect(nm, "batch", budget=len(allow), allow=allow,
                               note="static bucket ladder")
            if getattr(target, "kind", "") == "fused":
                reg.expect(nm, "stage", budget=2,
                           note="single-buffer step (+ tail shape)")
            elif r.stage.batchable and r.batch_max == 1:
                # a lone pure filter: its invoke runs eagerly
                reg.note_eager(nm, "invoke (uncaptured single stage)")

    def explain(self) -> dict:
        """The predicted-against-actual report (``utils/xray.explain``):
        plan, residency, census against the deep lint's budgets, the
        memory ledger by category, per-stage device time.  Call it before
        :meth:`stop` for the live ledger; JSON-serializable.  Works with
        xray off (census and device time stay empty)."""
        from ..utils import xray as _xray_mod

        return _xray_mod.explain(self)

    def stop(self) -> None:
        self._stopping.set()
        if self._slo_engine is not None:
            self._slo_engine.stop()  # joins its thread
        recon = getattr(self, "_xray_recon", None)
        if recon is not None:
            recon.stop()  # joins its thread
        runners = self._unique_runners()
        # Close every stage queue first: blocked getters receive _POISON
        # and blocked putters shed immediately.
        for r in runners:
            r.queue.close()
        for r in runners:
            if r.thread.ident is not None:  # start() may have failed part-way
                r.thread.join(timeout=5.0)
        for el in self.elements.values():
            try:
                el.stop()
            except Exception:  # noqa: BLE001 - stop the rest regardless
                log.exception("stop() failed for %s", el.name)
        # the sampler ends on _stopping; joined, so that no thread of
        # this pipeline outlives stop()
        sampler = getattr(self, "_sampler", None)
        if sampler is not None and sampler.is_alive():
            sampler.join(timeout=2.0)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every stage thread finished (sources EOS'd and all
        buffers drained)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in self._unique_runners():
            t = None if deadline is None else max(0.0, deadline - time.monotonic())
            r.thread.join(timeout=t)
            if r.thread.is_alive():
                raise PipelineError(f"stage {r.element.name} did not finish")
        self.check()

    def check(self) -> None:
        with self._err_lock:
            if self._errors:
                name, exc = self._errors[0]
                raise PipelineError(f"stage {name} failed: {exc!r}") from exc

    def _record_error(self, name: str, exc: BaseException) -> None:
        with self._err_lock:
            self._errors.append((name, exc))
        # post-mortem: the recent span timeline, when the recorder is on
        tracing.dump_recent_to_log(
            log, reason=f"stage {name} failed: {exc!r}")

    def _breaker_admission(self, tenant: str, engage: bool) -> None:
        """The armor circuit breaker's lever: flip ``tenant``'s admission
        override to shed on every query-server core of this pipeline."""
        for el in self.elements.values():
            core = getattr(el, "_core", None)
            if core is not None and hasattr(core, "tenant_admission"):
                if engage:
                    # unconditional: a poison spewer must not keep
                    # crashing invokes because the queue has room
                    core.tenant_admission[tenant] = "shed-all"
                else:
                    core.tenant_admission.pop(tenant, None)

    # -- SLO -----------------------------------------------------------------
    def _slo_loop(self):
        """The SLO engine bound to this pipeline's sinks (built once)."""
        if self._slo_engine is None:
            from ..utils.slo import SLOEngine, SLOPolicy

            sinks = [el.name for el in self.elements.values()
                     if isinstance(el, SinkElement)]
            self._slo_engine = SLOEngine(self._slo_policy or SLOPolicy(),
                                         sinks=sinks)
        return self._slo_engine

    def slo_report(self) -> dict:
        """Per-tenant SLO verdict evaluated now off the live series:
        p50/p99/fps against each tenant's objectives, sheds, error-budget
        burn rate and, for a breaching tenant, the span kind that took
        most of its time in the flight recorder.  Latency and throughput
        need ``trace_mode`` on (the sinks' end-to-end series)."""
        return self._slo_loop().report()

    # -- elastic serving: drain / adopt ---------------------------------------
    def serve_streams(self) -> Dict[int, dict]:
        """Continuous-serving streams on this pipeline: ``stream_id ->
        {"state", "tenant", "slot", "blocks", "element"}``."""
        out: Dict[int, dict] = {}
        for el in self.elements.values():
            table_fn = getattr(el, "serve_streams", None)
            if table_fn is None:
                continue
            for sid, info in table_fn().items():
                out[sid] = {**info, "element": el.name}
        return out

    def drain_stream(self, stream_id: int, timeout: float = 30.0) -> dict:
        """Take one live (or queued) continuous-serving stream off this
        pipeline as a host snapshot (persist it with
        ``trainer.checkpoint.save_stream_snapshot``); its slot and blocks
        return to the pool.  :meth:`adopt_stream` on another pipeline (or
        this one after a restart with another config) continues it, token
        for token.  No captured step is touched (span ``elastic.drain``)."""
        for el in self.elements.values():
            table_fn = getattr(el, "serve_streams", None)
            if table_fn is not None and stream_id in table_fn():
                return el.drain_serve_stream(stream_id, timeout)
        raise PipelineError(
            f"no live serve stream {stream_id} on this pipeline "
            f"(known: {sorted(self.serve_streams())})")

    def adopt_stream(self, snapshot: dict, timeout: float = 30.0) -> int:
        """Re-admit a drained stream (a :meth:`drain_stream` snapshot, or
        one read by ``trainer.checkpoint.load_stream_snapshot``) into this
        pipeline's continuous-serving filter; returns its stream id, and
        its remaining tokens flow to this pipeline's sinks (span
        ``elastic.adopt``)."""
        last_err: Optional[Exception] = None
        for el in self.elements.values():
            adopt_fn = getattr(el, "adopt_serve_stream", None)
            fw = getattr(el, "fw", None)
            if adopt_fn is None or not getattr(fw, "continuous", False):
                continue
            try:
                return adopt_fn(snapshot, timeout=timeout)
            except Exception as e:  # noqa: BLE001 - try the other filters
                last_err = e
        if last_err is not None:
            raise PipelineError(f"adopt_stream failed: {last_err}") from last_err
        raise PipelineError(
            "no continuous-serving filter on this pipeline to adopt into "
            "(need tensor_filter framework=llm custom=serve:continuous)")

    def swap_params(self, stage: str, tree_or_ckpt) -> int:
        """Hot-swap new weights into the LIVE serving stage ``stage``:
        ``tree_or_ckpt`` is a parameter tree (a trainer's
        ``export_params()``) or a trainer checkpoint's path
        (``trainer/checkpoint.py``).  The values are copied into the stage's
        live tensors at a dispatch boundary (``TensorFilter.swap_params``;
        an llm loop at its next chunk boundary): nothing is recaptured, a
        no-op swap is bitwise, a real one serves the new weights from the
        next dispatch.  Returns the stage's param version.

        Raises :class:`PipelineError` for a stage that cannot swap: one
        FUSED into a chain (its captured program closes over the weights
        the planner traced: run the serving filter unfused, ``fuse=False``
        or between host elements), a MICRO-BATCHED one (its bucket steps
        close over them too: ``batch_max=1``), or a framework without
        swappable parameters."""
        el = self.element(stage)
        nid = next((k for k, v in self.elements.items() if v is el), None)
        runner = self._runners.get(nid) if nid is not None else None
        if runner is not None and runner.element is not el:
            raise PipelineError(
                f"stage {stage!r} is fused into {runner.element.name!r} — "
                "the fused program captures params at build time, so a "
                "swap would silently not take; keep hot-swappable "
                "serving filters unfused (fuse=False, or a graph where "
                "the filter is not part of a linear device chain)")
        if runner is not None and runner.batch_max > 1 \
                and runner.stage.batchable:
            raise PipelineError(
                f"stage {stage!r} runs micro-batched (batch_max="
                f"{runner.batch_max}) — bucketed dispatch captures "
                "params at build time, so a swap would silently not "
                "take; run the hot-swappable serving stage with "
                "batch_max=1 (or an llm serve:continuous stage, whose "
                "loop swaps at chunk boundaries)")
        swap = getattr(el, "swap_params", None)
        if swap is None:
            raise PipelineError(
                f"element {stage!r} ({getattr(el, 'kind', '?')}) has no "
                "swappable parameters")
        tree = tree_or_ckpt
        if isinstance(tree_or_ckpt, str):
            from ..trainer.checkpoint import load_checkpoint

            tree, _opt, _step = load_checkpoint(tree_or_ckpt)
        try:
            return int(swap(tree))
        except Exception as e:  # noqa: BLE001 - typed to the caller
            raise PipelineError(f"swap_params({stage!r}) failed: {e}") from e

    def ladder_snapshot(self) -> Dict[str, List[int]]:
        """Every adaptive stage's current bucket ladder (base + minted) by
        stage name: feed it back through ``Pipeline(bucket_ladders=...)``
        (``Config.bucket_ladders``, ini ``[ladders]``,
        ``NNS_TPU_BUCKET_LADDERS``) to capture the refined ladder at
        warm-up.  Empty when ``adaptive_buckets`` is off."""
        out: Dict[str, List[int]] = {}
        for r in self._unique_runners():
            lad = getattr(r.element, "_batch_ladder", None)
            if lad is not None:
                out[r.element.name] = lad.export()
        return out

    def sample_queues(self) -> None:
        """One sampler tick: per stage ``<stage>.queue_depth`` (plain and
        per tenant; a tenant seen before and absent now is zeroed, so an
        idle tenant reads 0, not its last backlog) and, for a stage with a
        dispatch window, ``<stage>.inflight_window``; per sink
        ``<sink>.staleness_s``, the seconds since its last delivery.
        Public, so an app can sample on its own cadence."""
        now = time.monotonic_ns()
        for r in self._unique_runners():
            metrics.gauge(f"{r._nm}.queue_depth", float(r.queue.qsize()))
            depths = r.queue.tenant_depths()
            for ten in r._gauge_tenants.difference(depths):
                metrics.gauge(f"{r._nm}.queue_depth", 0.0, tenant=ten)
            for ten, depth in depths.items():
                metrics.gauge(f"{r._nm}.queue_depth", float(depth),
                              tenant=ten)
            r._gauge_tenants.update(depths)
            if r.dispatch_depth > 1:
                metrics.gauge(f"{r._nm}.inflight_window",
                              float(len(r._inflight)))
            if r._is_sink and r._last_sink_ns:
                metrics.gauge(f"{r._nm}.staleness_s",
                              (now - r._last_sink_ns) / 1e9)

    def _sample_loop(self, period_s: float = 0.1) -> None:
        while not self._stopping.wait(period_s):
            try:
                self.sample_queues()
            except Exception:  # noqa: BLE001 - the sampler must not die
                log.exception("queue sampler tick failed")

    def dump_trace(self, path: str) -> int:
        """Write the flight recorder's contents as Chrome trace-event JSON
        (Perfetto / chrome://tracing); returns the span count."""
        return tracing.dump_chrome(tracing.recorder.events(), path)

    def __enter__(self) -> "Pipeline":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- app I/O -----------------------------------------------------------
    def element(self, name: str) -> Element:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"no element named {name!r}") from None

    def push(self, name: str, data, pts: Optional[int] = None) -> None:
        el = self.element(name)
        if not hasattr(el, "push"):
            raise PipelineError(f"element {name!r} is not an app source")
        el.push(data, pts=pts)
        self.check()

    def eos(self, name: Optional[str] = None) -> None:
        """Signal end-of-stream on one (or every) app source."""
        targets = [self.element(name)] if name else list(self.elements.values())
        for el in targets:
            if hasattr(el, "signal_eos"):
                el.signal_eos()

    def pull(self, name: str, timeout: float = 30.0):
        el = self.element(name)
        if not hasattr(el, "pop"):
            raise PipelineError(f"element {name!r} is not a pullable sink")
        return el.pop(timeout=timeout, check=self.check)


class _CapsFilter(Element):
    """Pseudo-element for inline caps constraints (``other/tensors,...``):
    a negotiation-time constraint; buffers pass through untouched."""

    kind = "capsfilter"

    def __init__(self, caps: Optional[Caps]):
        super().__init__({}, name="capsfilter")
        self.filter_caps = caps or Caps.any()

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        merged = src.intersect(self.filter_caps)
        if merged is None:
            raise PipelineError(
                f"caps filter {self.filter_caps} incompatible with upstream {src}"
            )
        self.out_caps = {p: merged for p in out_pads}
        return self.out_caps

    def process(self, pad, buf):
        return [(SRC, buf)]

    def device_fn(self, in_spec):
        # Identity: the constraint was enforced at negotiation, so inside
        # a fused stage this element is a no-op; the out spec is the
        # merged caps' spec when one was negotiated, else the input's.
        caps = self.out_caps.get(SRC) if self.out_caps else None
        spec = getattr(caps, "spec", None)
        return (lambda arrays: arrays), (spec or in_spec)
