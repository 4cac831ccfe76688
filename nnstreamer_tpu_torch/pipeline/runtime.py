"""Pipeline executor.

Port of ``nnstreamer_tpu/pipeline/runtime.py`` (reference analog:
GStreamer's streaming threads, with ``queue`` elements as stage
boundaries):

* each planned stage runs on its own runner thread with ONE bounded
  input queue;
* upstream pushes block when the queue is full (backpressure);
* EOS and error events travel in-band through the same queues;
* a stage whose ``process`` returns a generator (a streaming
  tensor_filter) has it iterated by the runner, so every yielded buffer
  is pushed downstream as soon as it exists.

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
from ..elements.base import Element, SourceElement, SRC
from .graph import PipelineGraph
from .parser import parse as parse_launch
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
        name = self.element.name
        self._m_in = f"{name}.in"
        self._m_out = f"{name}.out"
        self._m_dropped = f"{name}.dropped"
        self._m_proc = f"{name}.proc"

    def connect(self, out_pad: str, port: _Port) -> None:
        self.out_ports.setdefault(out_pad, []).append(port)

    def feed(self, pad: str, item: Union[Buffer, Event]) -> None:
        """Blocking put (backpressure point)."""
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
        for item in el.generate():
            if self.pipeline._stopping.is_set():
                break
            self._emit([(SRC, item)])
            metrics.count(self._m_out)
        self._emit(el.finalize())
        self._broadcast(Event.eos())

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
            metrics.count(self._m_in)
            with Timer(self._m_proc):
                self._emit(el.process(pad, item))
            metrics.count(self._m_out)


class Pipeline:
    """Build + run a pipeline graph.

    Accepts a pipeline description string or a parsed PipelineGraph.
    ``queue_capacity`` bounds each stage's input queue (backpressure);
    the default comes from :func:`get_config`.  Elements are instantiated
    and caps negotiated at construction (which opens models); threads
    start at :meth:`start` or on entering a ``with`` block.
    """

    def __init__(self, graph: Union[str, PipelineGraph], *,
                 queue_capacity: Optional[int] = None):
        if isinstance(graph, str):
            graph = parse_launch(graph)
        graph.validate()
        self.graph = graph
        self.capacity = queue_capacity or get_config().queue_capacity
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

        # 2. caps negotiation in topo order
        self._negotiate()

        # 3. plan stages and wire one runner per stage
        self.stages: List[Stage] = plan_stages(graph, self.elements)
        self._runners: Dict[int, _Runner] = {}
        for st in self.stages:
            r = _Runner(self, st, self.capacity)
            for nid in st.node_ids:
                self._runners[nid] = r
        for e in graph.edges:
            r_src, r_dst = self._runners[e.src], self._runners[e.dst]
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
