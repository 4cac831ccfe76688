"""Residency planner: decide, per sink edge, what crosses to the host.

Port of ``nnstreamer_tpu/pipeline/residency.py``.  Tensors stay on the
device between the elements of a pipeline; the boundary that costs is
the copy to the host at a sink.  Two parts:

* **Reduced-output selection** (:func:`mark_reduced_admissible`): when a
  model offers a reduced output variant (``ModelBundle.reduced_variant``:
  deeplab's native-stride score map, the class decision at the model's
  true resolution) and every consumer below its filter admits any tensor
  geometry (``admits_reduced_payload``: ``tensor_sink``, ``image_segment
  option1=classmap``), the filter switches to it during negotiation.
  ``Pipeline(reduce_outputs=False)`` or ``NNS_TPU_REDUCE_OUTPUTS=0`` opts
  out.
* **Fetch plan** (:func:`plan_residency`, ``Pipeline.residency``): for
  every edge into a sink, what crosses a buffer: a fused stage's device
  outputs when its tail pairs ``device_fn`` with a deferred ``host_post``
  (argmax, top-k, NMS already on the device), or the negotiated spec's
  bytes otherwise; edges between device stages stay on the device.

Left out: the JAX package's pricing (``fetch_ms``, ``compute_floor_ms``,
``HBM_GBPS``), which turns planned bytes into milliseconds for its deep
lint (``analysis/tracecheck.py``, not ported); its constants describe
another device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..elements.base import Element, SinkElement, SourceElement


@dataclasses.dataclass
class FetchEdge:
    """The planned crossing to the host of one edge into a sink."""

    sink: str  # sink element name
    producer: str  # the stage (or element) feeding it
    #: bytes crossing a buffer (-1: not known statically)
    bytes_per_buffer: int
    #: how the payload shrank before crossing: "fused host_post" (a
    #: device reduction's small outputs), "reduced output" (the planner's
    #: reduced model output), or None (the negotiated spec crosses)
    reduced: Optional[str] = None


@dataclasses.dataclass
class ResidencyPlan:
    """The residency planner's verdict for one pipeline."""

    fetch: List[FetchEdge]
    #: edges between stages whose payload stays on the device
    resident_edges: int = 0
    #: names of the filters whose reduced output the planner selected
    reduced_outputs: List[str] = dataclasses.field(default_factory=list)

    def render(self) -> str:
        lines = [f"residency plan: {self.resident_edges} device-resident "
                 f"edge(s)"]
        for name in self.reduced_outputs:
            lines.append(f"  reduced output selected: {name}")
        for e in self.fetch:
            size = "?" if e.bytes_per_buffer < 0 else f"{e.bytes_per_buffer} B"
            via = f" via {e.reduced}" if e.reduced else ""
            lines.append(f"  fetch {e.sink} <- {e.producer}: {size}/buffer{via}")
        return "\n".join(lines)


def _admits_downstream(graph, elements: Dict[int, Element], nid: int,
                       memo: Dict[int, bool]) -> bool:
    """True when every path from ``nid``'s outputs to a sink runs through
    elements that declare ``admits_reduced_payload``; an element that does
    not opt in vetoes, and so does a dangling output."""
    if nid in memo:
        return memo[nid]
    memo[nid] = False  # cycle-safe: a loop never reaches a sink
    outs = graph.out_edges(nid)
    if not outs:
        return False
    for e in outs:
        dst = elements[e.dst]
        if not getattr(dst, "admits_reduced_payload", False):
            return False
        if not isinstance(dst, SinkElement) \
                and not _admits_downstream(graph, elements, e.dst, memo):
            return False
    memo[nid] = True
    return True


def mark_reduced_admissible(graph, elements: Dict[int, Element]) -> List[str]:
    """Before negotiation: mark every tensor_filter whose consumers all
    admit reduced geometry (``_reduced_admissible``), so that its
    ``configure()`` may switch to the model's reduced variant.  Returns
    the names marked."""
    from ..elements.filter import TensorFilter

    memo: Dict[int, bool] = {}
    marked: List[str] = []
    for nid, el in elements.items():
        if isinstance(el, TensorFilter) and _admits_downstream(
                graph, elements, nid, memo):
            el._reduced_admissible = True
            marked.append(el.name)
    return marked


def _spec_bytes(caps) -> int:
    spec = getattr(caps, "spec", None)
    if spec is None or spec.is_flexible:
        return -1
    try:
        return int(spec.nbytes)
    except (TypeError, ValueError):
        return -1


def plan_residency(graph, elements: Dict[int, Element], stages) -> ResidencyPlan:
    """The pipeline's :class:`ResidencyPlan` from the negotiated graph and
    the planned stages.  An edge into a sink fetches the producing fused
    stage's device outputs when its tail has a deferred ``host_post``,
    else the negotiated spec's bytes at the edge (-1 when flexible)."""
    node_to_stage = {nid: st for st in stages for nid in st.node_ids}

    def device_stage(st) -> bool:
        el = st.element
        return (getattr(st, "batchable", False)
                or getattr(el, "kind", "") == "fused"
                or getattr(el, "device_resident", False)
                or type(el).device_fn is not Element.device_fn)

    fetch: List[FetchEdge] = []
    resident = 0
    reduced_names = [el.name for el in elements.values()
                     if getattr(el, "reduced_output_selected", None)]
    for e in graph.edges:
        src_st, dst_st = node_to_stage.get(e.src), node_to_stage.get(e.dst)
        if src_st is None or dst_st is None or src_st is dst_st:
            continue  # an edge inside a fused stage
        dst_el = dst_st.element
        if isinstance(dst_el, SinkElement):
            prod = src_st.element
            # a folded device source wraps the fused chain, which carries
            # the host_post and the device out spec
            fused = getattr(prod, "fused", prod)
            spec = getattr(fused, "_out_spec", None)
            if getattr(fused, "_host_post", None) is not None and spec is not None:
                fetch.append(FetchEdge(
                    sink=dst_el.name, producer=prod.name,
                    bytes_per_buffer=-1 if spec.is_flexible else int(spec.nbytes),
                    reduced="fused host_post"))
            else:
                src_el = elements.get(e.src)
                caps = src_el.out_caps.get(e.src_pad) if src_el is not None else None
                red = ("reduced output" if getattr(
                    src_el, "reduced_output_selected", None) else None)
                fetch.append(FetchEdge(
                    sink=dst_el.name, producer=prod.name,
                    bytes_per_buffer=_spec_bytes(caps), reduced=red))
        elif device_stage(src_st) and device_stage(dst_st) \
                and not isinstance(src_st.element, SourceElement):
            resident += 1  # device stage -> device stage: stays on the card
    return ResidencyPlan(fetch=fetch, resident_edges=resident,
                         reduced_outputs=reduced_names)
