"""The closed program census: one captured decode step per signature.

The JAX package runs each decode chunk as one jitted program and pins
how many it compiles (``jax.jit``'s cache, read by its tests through
``_cache_size()``).  Here the counterpart is a CUDA graph: a step
function that reads and writes only tensors the caller owns (its static
inputs and outputs) is captured once per signature and replayed after
that, one graph launch in place of the step's thousands of eager ones.

A :class:`Census` holds the steps of one filter path.  On a CUDA device,
:meth:`Census.capture` gives each step its own capture-and-replay
stream, runs the step once eagerly on that stream (the warm-up: kernel
libraries load, and per-stream state such as the int4 split-K tickets
exists before capture), captures it with ``torch.cuda.graph``, with
every given generator registered, and :meth:`Step.replay` replays it on
the same stream, ordered after the caller's stream and before whatever
the caller queues next.  A capture that fails raises: nothing reverts
to eager launches on the card.  On the CPU the same step function runs
eagerly on the same buffers, warm-up included, so that the tests drive
the path the card takes.

Launch counts stay honest: the kernel launches of the warm-up and the
capture are held back (:func:`~..ops.kernels.held_launches`), and each
replay adds what the capture recorded.

With xray on (:meth:`Census.attach_xray`), every capture registers with
xray's program registry, counted with its warm-up's FLOPs and bytes, and
each replay records a pair of CUDA events on the step's stream around
``graph.replay()`` (``utils/xray.py``); with it off nothing of that runs.

Python's cyclic collector is held off while a stream captures
(:func:`collector_paused`).  A captured step sits in reference cycles
(its set and its step function refer to each other), so only a
collection frees it, and a collection can start at any allocation of the
capturing thread: destroying a graph is not permitted while a stream
captures, and the attempt invalidates the capture (a cuDNN call of the
step then fails with ``CUDNN_STATUS_INTERNAL_ERROR``).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from ..ops import kernels
from ..utils import locks


_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic collector disabled for the block (it is process-wide:
    counted across threads that capture at once, and re-enabled, if it was
    on, when the last of them leaves)."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


class Step:
    """One captured step: :meth:`replay` runs it once more."""

    def __init__(self, census: "Census", signature: Hashable,
                 fn: Callable[[], None], graph=None, stream=None,
                 launches: Dict[kernels.LaunchCount, int] = None,
                 track=None):
        self.census = census
        self.signature = signature
        self._fn = fn
        self._graph = graph
        self._stream = stream
        self._launches = launches or {}
        #: xray's tracker of this step (``utils/xray.py``), None with xray off
        self.track = track

    def replay(self) -> None:
        self.launch()
        self.join()

    def launch(self) -> None:
        """Start one replay on the step's stream, after the caller's work
        so far; :meth:`join` makes the caller wait for it (steps on other
        streams launched in between run beside it)."""
        tr = self.track
        if self._graph is None:
            if tr is None:
                self._fn()
            else:
                t0 = time.perf_counter_ns()
                self._fn()
                tr.add_time(time.perf_counter_ns() - t0)
        else:
            caller = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                if tr is None:
                    self._graph.replay()
                else:  # events around the replay, outside the capture
                    pair = tr.begin(self._stream)
                    self._graph.replay()
                    tr.end(pair, self._stream)
            for counter, n in self._launches.items():
                counter.add(n)
        self.census._replayed(self.signature, self._launches)

    def join(self) -> None:
        """The caller's stream waits for the last :meth:`launch`."""
        if self._graph is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(self._stream)

    def add_work(self, flops: float, nbytes: float) -> None:
        """Data-dependent work of one replay that the warm-up's count could
        not see (the paged KV rows of the live contexts); no-op without
        xray."""
        if self.track is not None:
            self.track.add_work(flops, nbytes)


class Census:
    """The captured steps of one path, by signature.

    ``signatures`` is the set of signatures captured so far, ``captures``
    the number of captures (a signature captured again, for a second set
    of static buffers or after its set was dropped, counts again) and
    ``replays`` the replays of all of them; ``launches`` holds, by
    signature, the kernel launches its replays added to each counter.
    Its lock comes from ``utils/locks.py`` (tracked under
    ``NNS_TPU_TSAN=1``)."""

    _GUARDED_BY = {"signatures": "_lock", "captures": "_lock",
                   "replays": "_lock", "launches": "_lock"}

    def __init__(self, device):
        self.device = torch.device(device)
        self.signatures: set = set()
        self.captures = 0
        self.replays = 0
        self.launches: Dict[Hashable, Dict[kernels.LaunchCount, int]] = {}
        self._lock = locks.make_lock("Census._lock")
        #: xray (``utils/xray.py``): (registry, stage, recorder) or None
        self._xray = None
        #: run every step eagerly, also on the card: set by a path whose
        #: step spans several devices (a tensor-parallel step over
        #: distinct cards), which one stream cannot capture
        self.eager = False

    def attach_xray(self, registry, stage: str, rec=None) -> None:
        """Register every later capture with xray's ``registry`` under
        ``stage`` and time its step's replays."""
        self._xray = (registry, stage, rec)

    def capture(self, signature: Hashable, fn: Callable[[], None],
                generators: Sequence[torch.Generator] = (), *,
                kind: Optional[str] = None, rows: Optional[int] = None,
                stream=None) -> Step:
        """Warm ``fn`` up and capture it under ``signature``.  ``fn`` takes
        no arguments and touches only tensors that outlive the step: it
        runs once here (its effects on those tensors and generators
        happen), then once per :meth:`Step.replay`.  ``generators`` are
        the generators it draws from; their state advances on every
        replay as it would in an eager call.  With xray attached the
        capture registers under ``(stage, kind)`` (``kind``: the
        signature's leading name, else ``stage``; ``rows``: the bucket a
        batch step was captured for), with the warm-up's FLOPs and bytes
        (``ops/cost.py``).  ``stream``: the capture-and-replay stream
        (a mesh slot's, ``parallel/mesh.py``) and so the device the step
        runs on; default a new stream on the census's device.  A census
        made ``eager`` (a tensor-parallel step over distinct cards) runs
        every step eagerly, by its owner's declared choice."""
        xr = self._xray
        counted = []
        warm = fn
        if xr is not None:
            from ..ops import cost

            def warm():
                with cost.counting() as c:
                    fn()
                counted.append(c)
        t0 = time.perf_counter()
        dev = stream.device if stream is not None else self.device
        if dev.type == "cuda" and not self.eager:
            step = self._capture_cuda(signature, fn, generators, warm, stream)
        else:
            with kernels.held_launches():
                warm()
            step = Step(self, signature, fn)
        if xr is not None:
            registry, stage, rec = xr
            if kind is None:
                kind = (signature[0] if isinstance(signature, tuple) and signature
                        and isinstance(signature[0], str) else "stage")
            c = counted[0]
            step.track = registry.register(
                stage, kind, signature, compile_s=time.perf_counter() - t0,
                flops=c.flops, bytes_=c.bytes, rows=rows, rec=rec)
        with self._lock:
            self.signatures.add(signature)
            self.captures += 1
        return step

    def _capture_cuda(self, signature, fn, generators, warm, stream=None) -> Step:
        dev = stream.device if stream is not None else self.device
        caller = torch.cuda.current_stream(dev)
        if stream is None:
            stream = torch.cuda.Stream(dev)
        stream.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(stream):
            with kernels.held_launches():
                warm()
            with kernels.held_launches() as launches, collector_paused():
                # torch.cuda.graph collects once on entry, before the
                # capture begins; none may run inside it
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    fn()
        caller.wait_stream(stream)
        return Step(self, signature, fn, graph, stream, dict(launches))

    def _replayed(self, signature: Hashable,
                  launches: Dict[kernels.LaunchCount, int]) -> None:
        with self._lock:
            self.replays += 1
            tally = self.launches.setdefault(signature, {})
            for counter, n in launches.items():
                tally[counter] = tally.get(counter, 0) + n
