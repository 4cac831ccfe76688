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
from typing import Callable, Dict, Hashable, Sequence

import torch

from ..ops import kernels


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
                 launches: Dict[kernels.LaunchCount, int] = None):
        self.census = census
        self.signature = signature
        self._fn = fn
        self._graph = graph
        self._stream = stream
        self._launches = launches or {}

    def replay(self) -> None:
        if self._graph is None:
            self._fn()
        else:
            caller = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                self._graph.replay()
            caller.wait_stream(self._stream)
            for counter, n in self._launches.items():
                counter.add(n)
        self.census._replayed(self.signature, self._launches)


class Census:
    """The captured steps of one path, by signature.

    ``signatures`` is the set of signatures captured so far, ``captures``
    the number of captures (a signature captured again, for a second set
    of static buffers or after its set was dropped, counts again) and
    ``replays`` the replays of all of them; ``launches`` holds, by
    signature, the kernel launches its replays added to each counter."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.signatures: set = set()
        self.captures = 0
        self.replays = 0
        self.launches: Dict[Hashable, Dict[kernels.LaunchCount, int]] = {}
        self._lock = threading.Lock()

    def capture(self, signature: Hashable, fn: Callable[[], None],
                generators: Sequence[torch.Generator] = ()) -> Step:
        """Warm ``fn`` up and capture it under ``signature``.  ``fn`` takes
        no arguments and touches only tensors that outlive the step: it
        runs once here (its effects on those tensors and generators
        happen), then once per :meth:`Step.replay`.  ``generators`` are
        the generators it draws from; their state advances on every
        replay as it would in an eager call."""
        if self.device.type == "cuda":
            step = self._capture_cuda(signature, fn, generators)
        else:
            with kernels.held_launches():
                fn()
            step = Step(self, signature, fn)
        with self._lock:
            self.signatures.add(signature)
            self.captures += 1
        return step

    def _capture_cuda(self, signature, fn, generators) -> Step:
        caller = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(stream):
            with kernels.held_launches():
                fn()
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
