"""Stage planner: the physical execution plan and its fusion pass.

Port of ``nnstreamer_tpu/pipeline/plan.py``.  Contiguous device-capable
elements (``tensor_transform`` chains, the ``jax`` tensor_filter, the
decoder's device half) are grouped into ONE fused stage: one torch
callable, the counterpart of the JAX package's one ``jax.jit`` program
per chain.  The element graph stays the logical model; the plan is the
physical one, with host boundaries only at app sources, sinks and
host-only elements.

Fusion rule (the JAX package's): a maximal linear chain of nodes, each
exposing ``device_fn`` for its negotiated static input spec, with single
in/out edges on the default pads, becomes a :class:`FusedElement` (a
chain of one element stays that element).  A device source
(``videotestsrc device=true``) folds into the chain below it as a
:class:`FusedSourceElement`: generate and process run back to back on
one thread.  Stage names are the JAX package's (``a+b+c``).

On the card a fused stage runs as a captured CUDA graph, one per input
signature (``pipeline/graphs.py`` :class:`~.graphs.Census`): the stage
owns a static input tensor per signature, fills it with ``copy_`` from
each buffer (through pinned memory for host arrays) and replays the
graph.  A replay writes into the same output tensors every time, so a
stage never hands them downstream: a deferred ``host_post`` tail starts
their copy into fresh pinned host memory (the only bytes that cross to
the host), any other chain clones them.  On the CPU the same callable
runs eagerly on the same static tensors.  A capture that fails raises.

The JAX package's ingress donation and micro-batching hooks
(``batchable``/``shardable``/``restartable``) wait for
``pipeline/batching.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer, start_fetch
from ..core.caps import MediaType
from ..core.log import logger
from ..core.types import TensorsSpec
from ..elements.base import Element, SourceElement, SRC, SINK
from .graph import PipelineGraph
from .graphs import Census

log = logger(__name__)


@dataclasses.dataclass
class Stage:
    """One schedulable unit: a single element or a fused chain."""

    element: Element
    node_ids: List[int]


def chain_device(elements: List[Element]) -> Optional[torch.device]:
    """Where a fused chain runs: its filter's device (the card unless the
    filter says ``accelerator=true:cpu``); None for a chain with no
    element bound to a device (transforms and decoders only), which runs
    where its input lies, as the same elements unfused would."""
    for el in elements:
        dev = getattr(el, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return None


def source_device(graph: PipelineGraph, elements: Dict[int, Element],
                  nid: int) -> Optional[torch.device]:
    """Where the device source ``nid`` generates, folded or not: on the
    device of the first element below it bound to one (its filter's
    ``accelerator=``), found through single edges; None when there is
    none, and the source then takes the card (raising without one)."""
    while True:
        outs = graph.out_edges(nid)
        if len(outs) != 1:
            return None
        nid = outs[0].dst
        dev = chain_device([elements[nid]])
        if dev is not None:
            return dev


def _signature(tensors) -> Tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class _StaticSet:
    """The static input tensors of one signature and its captured step."""

    def __init__(self, fused: "FusedElement", signature, tensors):
        dev = fused.device
        self.inputs = [torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
                       for t in tensors]
        self.outputs: Tuple = ()
        composed = fused.composed
        self.fill(tensors)

        def step():
            self.outputs = composed(tuple(self.inputs))

        self.step = fused.census.capture(signature, step)

    def fill(self, tensors) -> None:
        for dst, src in zip(self.inputs, tensors):
            if dst.is_cuda and not src.is_cuda:
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)


class FusedElement(Element):
    """A chain of device elements run as one callable (one captured CUDA
    graph per input signature on the card)."""

    kind = "fused"

    def __init__(self, elements: List[Element], specs: List[TensorsSpec]):
        super().__init__({}, name="+".join(e.name for e in elements))
        self.chain = elements
        # a tail element may pair its device_fn with a deferred host
        # mapping (image_labeling: device argmax -> host label text)
        self._host_post = getattr(elements[-1], "host_post", None)
        fns: List[Callable] = []
        spec = specs[0]
        for el in self.chain:
            df = el.device_fn(spec)
            if df is None:  # the planner only chains fusable elements
                raise RuntimeError(f"element {el.name} not fusable")
            fn, spec = df
            fns.append(fn)
        self._out_spec = spec

        def composed(arrays: Tuple) -> Tuple:
            for f in fns:
                arrays = f(arrays)
            return arrays

        self.composed = composed
        self.device = chain_device(elements)
        self.census = Census(self.device) if self.device is not None else None
        self._sets: Dict[Tuple, _StaticSet] = {}

    def process(self, pad: str, buf: Buffer):
        tensors = [_as_tensor(t) for t in buf.tensors]
        if self.census is None:  # no filter: run where the input lies
            self.device = tensors[0].device
            self.census = Census(self.device)
        sig = _signature(tensors)
        st = self._sets.get(sig)
        if st is None:
            # a new signature (the first buffer, or a truncated tail
            # batch): capture once, never recompute on stale rows
            st = self._sets[sig] = _StaticSet(self, sig, tensors)
        else:
            st.fill(tensors)
        st.step.replay()
        return [(SRC, self._finish(buf, st.outputs))]

    def _finish(self, buf: Buffer, out) -> Buffer:
        """The replay's outputs as a buffer of its own: copied out of the
        static outputs the next replay overwrites.  A tail's ``host_post``
        stays deferred, its inputs on their way to pinned host memory."""
        spec = self._out_spec
        if spec is not None and len(out) and tuple(out[0].shape) != spec[0].shape:
            spec = None  # a truncated tail batch: the buffer derives its own
        done = None
        if self._host_post is not None and self.device.type == "cuda":
            tensors, done = start_fetch(out)
        else:
            tensors = [t.clone() for t in out]
        new = buf.with_tensors(tensors, spec=spec)
        if self._host_post is not None:
            new.meta["_host_post"] = self._host_post
            if done is not None:
                new.meta["_d2h_done"] = done
        return new

    def finalize(self):
        outs = []
        for el in self.chain:
            outs.extend(el.finalize())
        return outs


class FusedSourceElement(SourceElement):
    """A device source folded into its downstream fused chain: generate
    and the fused callable dispatch back to back on one thread.  The
    planner has set where the source generates (:func:`source_device`):
    the chain's filter's device, or the card for a chain with no filter."""

    kind = "fused"

    def __init__(self, source: Element, fused: FusedElement):
        super().__init__({}, name=f"{source.name}+{fused.name}")
        self.source = source
        self.fused = fused

    # No start()/stop(): the pipeline starts and stops the original
    # per-node elements itself.

    def generate(self):
        for item in self.source.generate():
            if not isinstance(item, Buffer):
                yield item  # events pass through
                continue
            for _, out in self.fused.process(SINK, item):
                yield out

    def finalize(self):
        return list(self.source.finalize()) + list(self.fused.finalize())


def plan_stages(graph: PipelineGraph, elements: Dict[int, Element], *,
                fuse: bool = True) -> List[Stage]:
    """Partition the graph into stages in topological order; with
    ``fuse``, linear device chains become one stage each."""
    order = graph.topo_order()
    for node in order:
        el = elements[node.id]
        if isinstance(el, SourceElement) and getattr(el, "device", None) is True:
            el.gen_device = source_device(graph, elements, node.id)
    if not fuse:
        return [Stage(elements[n.id], [n.id]) for n in order]

    def linear(nid: int) -> bool:
        ins = graph.in_edges(nid)
        outs = graph.out_edges(nid)
        return (
            len(ins) == 1
            and len(outs) <= 1
            and ins[0].dst_pad == SINK
            and all(e.src_pad == SRC for e in outs)
        )

    def fusable(nid: int) -> Optional[TensorsSpec]:
        """In-spec if the element can join a fused chain, else None."""
        el = elements[nid]
        caps = el.in_caps.get(SINK)
        if caps is None or caps.media not in (MediaType.TENSORS,
                                              MediaType.FLEX_TENSORS):
            return None
        spec = caps.spec
        if spec is None or spec.format.value != "static":
            return None
        if el.device_fn(spec) is None:
            return None
        return spec

    stages: List[Stage] = []
    consumed: set = set()

    def grow(first: int) -> Optional[Tuple[List[int], List[TensorsSpec]]]:
        """Maximal fusable chain from ``first`` (None if it can't fuse)."""
        if first in consumed or not linear(first):
            return None
        spec = fusable(first)
        if spec is None:
            return None
        chain = [first]
        specs = [spec]
        cur_spec = elements[first].device_fn(spec)[1]
        cur = first
        while True:
            outs = graph.out_edges(cur)
            if len(outs) != 1:
                break
            nxt = outs[0].dst
            if nxt in consumed or not linear(nxt):
                break
            el = elements[nxt]
            caps = el.in_caps.get(SINK)
            nspec = (caps.spec if caps else None) or cur_spec
            df = el.device_fn(nspec)
            if df is None:
                break
            chain.append(nxt)
            specs.append(nspec)
            cur_spec = df[1]
            cur = nxt
        return chain, specs

    for node in order:
        if node.id in consumed:
            continue
        el = elements[node.id]
        # A device source folds into its downstream chain: the pipeline
        # front becomes one stage.  `device is True` exactly, as in the
        # JAX package (a device PATH string is a blocking host reader).
        if isinstance(el, SourceElement) and getattr(el, "device", None) is True:
            outs = graph.out_edges(node.id)
            if (len(outs) == 1 and outs[0].src_pad == SRC
                    and outs[0].dst_pad == SINK):
                grown = grow(outs[0].dst)
                if grown is not None:
                    chain, specs = grown
                    fs = FusedSourceElement(
                        el, FusedElement([elements[i] for i in chain], specs))
                    log.info("fused device source into one stage: %s", fs.name)
                    stages.append(Stage(fs, [node.id] + chain))
                    consumed.add(node.id)
                    consumed.update(chain)
                    continue
        grown = grow(node.id)
        if grown is None or len(grown[0]) == 1:
            stages.append(Stage(el, [node.id]))
            consumed.add(node.id)
            continue
        chain, specs = grown
        fe = FusedElement([elements[i] for i in chain], specs)
        log.info("fused %d elements into one stage: %s", len(chain), fe.name)
        stages.append(Stage(fe, chain))
        consumed.update(chain)
    return stages
