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
  ``Pipeline.residency`` records what crosses to the host at each sink.

Left for later slices: ``slo=``, elastic stage restarts and the
autoscaler, micro-batching, ingress donation and the dispatch and fetch
windows.

Threads, not asyncio: stages do blocking work (device dispatch, host
copies) and release the interpreter lock inside torch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

from ..core.buffer import Buffer, Event
from ..core.caps import Caps
from ..core.config import get_config
from ..core.log import Timer, logger, metrics
from ..core.registry import KIND_ELEMENT, get as registry_get
from ..elements.base import Element, SinkElement, SourceElement, SRC
from ..elements.sink import TensorSink
from ..utils import tracing
from ..utils.armor import META_POISON as _META_POISON
from .graph import PipelineGraph
from .parser import parse as parse_launch
from . import residency as _residency
from .plan import Stage, plan_stages

log = logger(__name__)

#: in-band shutdown sentinel: Pipeline.stop() closes every stage queue
#: with one of these, so blocked getters wake at once
_POISON = object()


class PipelineError(RuntimeError):
    pass


class _StageQueue:
    """Bounded stage input queue with stop-aware blocking: putters and
    getters block on two condition variables over one lock, and
    :meth:`close` wakes every waiter at once."""

    def __init__(self, capacity: int):
        self._dq: Deque = collections.deque()
        self._cap = max(1, capacity)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
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

    def get(self):
        """Block until an item arrives; ``(None, _POISON)`` once closed."""
        with self._lock:
            while not self._dq:
                if self._closed:
                    return (None, _POISON)
                self._not_empty.wait()
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


class _Port:
    """Destination of an edge: a stage's runner + the pad name inside it."""

    def __init__(self, stage: "_Runner", pad: str):
        self.stage = stage
        self.pad = pad


class _Runner:
    """One streaming thread driving one planned stage."""

    def __init__(self, pipeline: "Pipeline", stage: Stage, capacity: int):
        self.pipeline = pipeline
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
        name = self._nm = self.element.name
        self._m_in = f"{name}.in"
        self._m_out = f"{name}.out"
        self._m_dropped = f"{name}.dropped"
        self._m_proc = f"{name}.proc"
        self._m_qwait = f"{name}.queue_wait"
        self._m_e2e = f"{name}.e2e"
        # Flight recorder: None when trace_mode is off, so every hook
        # below is one pointer check and no meta stamp is written.  Also
        # pinned on the element, so its own spans (query admission,
        # replies) follow THIS pipeline's trace mode.
        self._tr = tracing.recorder if pipeline.trace_mode != "off" else None
        self.element._trace_rec = self._tr
        self._is_sink = isinstance(self.element, SinkElement)
        # the one consumer that resolves a deferred host mapping itself
        self._lazy_post = isinstance(self.element, TensorSink)

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
        try:
            if isinstance(el, SourceElement):
                self._run_source()
            else:
                self._run_stream()
        except Exception as e:  # noqa: BLE001 - must not kill the process
            log.exception("stage %s failed", el.name)
            self.pipeline._record_error(el.name, e)
            self._broadcast(Event.error(e))
            self._broadcast(Event.eos())

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
            from ..utils import armor as _armor_mod

            metrics.count(f"{self._nm}.poisoned")
            armor.quarantine(buf, error=e, stage=self._nm)
            yield SRC, _armor_mod.poison_terminator(buf, e)

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
        per tenant when it carries one."""
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

    def _run_stream(self) -> None:
        el = self.element
        while True:
            pad, item = self.queue.get()
            if item is _POISON:
                return
            if isinstance(item, Event):
                if item.kind == "eos":
                    self._eos_pads.add(pad)
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
            if not self._is_sink and item.meta.get(_META_POISON):
                # a poison terminator is an ANSWER riding to the sink,
                # never work: forward it untouched
                metrics.count(self._m_in)
                self._emit([(SRC, item)])
                metrics.count(self._m_out)
                continue
            metrics.count(self._m_in)
            tr = self._tr
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
            metrics.count(self._m_out)


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
    plan.  Defaults come from :func:`get_config`.  Elements are instantiated and
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
                 reduce_outputs: Optional[bool] = None):
        if isinstance(graph, str):
            graph = parse_launch(graph)
        graph.validate()
        cfg = get_config()
        self.graph = graph
        self.fuse = bool(fuse)
        self.reduce_outputs = bool(reduce_outputs if reduce_outputs is not None
                                   else cfg.reduce_outputs)
        self.capacity = queue_capacity or cfg.queue_capacity
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
        self.stages: List[Stage] = plan_stages(graph, self.elements,
                                               fuse=self.fuse)
        self.residency = _residency.plan_residency(graph, self.elements,
                                                   self.stages)
        if self.residency.fetch or self.residency.reduced_outputs:
            log.info("%s", self.residency.render())
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
        for r in self._unique_runners():
            r.thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
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
