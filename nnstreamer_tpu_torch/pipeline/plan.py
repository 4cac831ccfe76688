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

A stage is ``batchable`` and ``restartable`` when its work is pure,
holding nothing from one buffer to the next: a fused chain, or a single
element whose work is one pure device callable
(:meth:`~..elements.base.Element.batch_capable`: a pure tensor_filter), as
the JAX package marks them.  With ``Pipeline(batch_max > 1)`` its runner
drains micro-batches into one bucketed step (:meth:`FusedElement.
process_batch`, ``pipeline/batching.py``); the runtime may restart it in
place after a fault (``Pipeline(max_stage_restarts=)``).

Ingress donation (``plan_stages(donate_ingress=)``) is planned as in the
JAX package: a fused chain fed by a host source whose only consumer it is
owns its frames (``_donate``, ``_ingress_put``), and so does a folded
device source (``_donate``).  On the card ownership changes no copy: a
captured step reads its own static input either way, each host frame
goes there through pinned memory, and staging frames through reused
pinned slots instead of a fresh pinned copy measured no faster
(``PERF.md``).  The JAX package's ``shardable`` waits for the
multi-device slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer, split_rows, start_fetch
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
    #: pure device stage whose runner may drain a micro-batch from its
    #: queue into one bucketed step (the runtime also needs batch_max > 1)
    batchable: bool = False
    #: pure stage whose runner may restart in place after a fault in
    #: ``process()`` (bounded by the pipeline's ``max_stage_restarts``);
    #: sources, sinks and elements with state across buffers (the llm
    #: filter, async emitters) stay fail-fast
    restartable: bool = False


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
    """Where the device source ``nid`` generates, folded or not (or where
    a ``device=true`` aggregator keeps its ring): on the device of the
    first element below it bound to one (its filter's ``accelerator=``),
    found through single edges; None when there is none, and the source
    then takes the card (raising without one)."""
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

    def __init__(self, elements: List[Element], specs: List[TensorsSpec],
                 donate: bool = False, ingress_put: bool = False):
        super().__init__({}, name="+".join(e.name for e in elements))
        self.chain = elements
        #: the planner proved this stage the sole owner of its input (a
        #: folded device source, or a host source feeding only it)
        self._donate = donate
        #: ... fed by a host source (ingress donation; no copy changes)
        self._ingress_put = ingress_put
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
        self._batcher = None

    def _place(self, first: torch.Tensor) -> None:
        if self.census is None:  # no filter: run where the input lies
            self.device = first.device
            self.census = Census(self.device)

    def process(self, pad: str, buf: Buffer):
        tensors = [_as_tensor(t) for t in buf.tensors]
        self._place(tensors[0])
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

    def _copy_out(self, out):
        """The replay's outputs copied out of the static outputs the next
        replay overwrites -> (tensors, the fetch's event or None): a
        tail's ``host_post`` inputs on their way to pinned host memory,
        any other outputs cloned."""
        if self._host_post is not None and self.device.type == "cuda":
            return start_fetch(out)
        return [t.clone() for t in out], None

    def _finish(self, buf: Buffer, out) -> Buffer:
        """The replay's outputs as a buffer of its own; a tail's
        ``host_post`` stays deferred."""
        tensors, done = self._copy_out(out)
        return self._wrap(buf, tensors, done)

    def _wrap(self, buf: Buffer, tensors, done) -> Buffer:
        spec = self._out_spec
        if (spec is not None and len(tensors)
                and tuple(tensors[0].shape) != spec[0].shape):
            spec = None  # a truncated tail batch: the buffer derives its own
        new = buf.with_tensors(tensors, spec=spec)
        if self._host_post is not None:
            new.meta["_host_post"] = self._host_post
            if done is not None:
                new.meta["_d2h_done"] = done
        return new

    # -- micro-batching ----------------------------------------------------
    def batch_capable(self) -> bool:
        return True

    def process_batch(self, pad: str, bufs):
        """N same-signature buffers -> one replay of their bucket's
        vmapped step (``pipeline/batching.py``, through this stage's
        census); the real rows' outputs are copied out once per tensor
        (one fetch for a ``host_post`` tail) and each buffer gets its row,
        its own pts and meta, in order."""
        if self._batcher is None:
            from .batching import BatchRunner

            self._place(_as_tensor(bufs[0].tensors[0]))
            self._batcher = BatchRunner(
                self.composed, getattr(self, "_batch_buckets", None),
                name=self.name, ladder=getattr(self, "_batch_ladder", None),
                census=self.census)
        out = self._batcher.dispatch([b.tensors for b in bufs])
        tensors, done = self._copy_out(out)
        return [(SRC, self._wrap(buf, row, done))
                for buf, row in zip(bufs, split_rows(tensors, len(bufs)))]

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


#: minted buckets an adaptive ladder may add per stage when no
#: ``max_compiled_variants`` budget is set (uncapped would leave the
#: census open)
ADAPTIVE_EXTRA_DEFAULT = 4


def adaptive_variant_budget(base_len: int, n_batchable: int,
                            max_compiled_variants: int) -> int:
    """Most ladder entries (base + minted) ONE adaptive stage may capture:
    ``max_compiled_variants`` split evenly over the batchable stages,
    never below the base ladder (refinement may be squeezed out, the
    census may not); unset, the base ladder plus
    :data:`ADAPTIVE_EXTRA_DEFAULT`."""
    if max_compiled_variants > 0:
        return max(base_len, max_compiled_variants // max(1, n_batchable))
    return base_len + ADAPTIVE_EXTRA_DEFAULT


def _element_batchable(el: Element) -> bool:
    """Can this single element's runner drain micro-batches?  A source
    has no input queue; the probe never vetoes planning by raising."""
    if isinstance(el, SourceElement):
        return False
    try:
        return bool(el.batch_capable())
    except Exception:  # noqa: BLE001 - capability probe only
        return False


def plan_stages(graph: PipelineGraph, elements: Dict[int, Element], *,
                fuse: bool = True, donate_ingress: bool = False) -> List[Stage]:
    """Partition the graph into stages in topological order; with
    ``fuse``, linear device chains become one stage each.
    ``donate_ingress`` lets a fused chain fed by a host source (not a
    ``device=true`` source, which folds instead) that has the chain as
    its only consumer own its ingress (``FusedElement._ingress_put``)."""
    order = graph.topo_order()
    for node in order:
        el = elements[node.id]
        if getattr(el, "device", None) is not True:
            continue
        if isinstance(el, SourceElement):
            el.gen_device = source_device(graph, elements, node.id)
        elif hasattr(el, "ring_device"):  # tensor_aggregator device=true
            el.ring_device = source_device(graph, elements, node.id)

    def single(nid: int) -> Stage:
        b = _element_batchable(elements[nid])
        return Stage(elements[nid], [nid], batchable=b, restartable=b)

    if not fuse:
        return [single(n.id) for n in order]

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
                        el, FusedElement([elements[i] for i in chain], specs,
                                         donate=True))
                    log.info("fused device source into one stage: %s", fs.name)
                    stages.append(Stage(fs, [node.id] + chain))
                    consumed.add(node.id)
                    consumed.update(chain)
                    continue
        grown = grow(node.id)
        if grown is None or len(grown[0]) == 1:
            stages.append(single(node.id))
            consumed.add(node.id)
            continue
        chain, specs = grown
        donate = False
        if donate_ingress:
            ins = graph.in_edges(chain[0])
            if len(ins) == 1:
                # sole ownership: a host source whose only consumer is
                # this chain (a device=true source folded above instead)
                feeder = elements[ins[0].src]
                donate = (isinstance(feeder, SourceElement)
                          and getattr(feeder, "device", None) is not True
                          and len(graph.out_edges(ins[0].src)) == 1)
        fe = FusedElement([elements[i] for i in chain], specs,
                          donate=donate, ingress_put=donate)
        if donate:
            log.info("ingress donation enabled for fused stage %s", fe.name)
        log.info("fused %d elements into one stage: %s", len(chain), fe.name)
        stages.append(Stage(fe, chain, batchable=True, restartable=True))
        consumed.update(chain)
    return stages
