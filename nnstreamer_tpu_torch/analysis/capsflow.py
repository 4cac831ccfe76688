"""Whole-graph caps/spec propagation — the analyzer's negotiation pass.

Port of ``nnstreamer_tpu/analysis/capsflow.py`` over this package's
element classes.

Propagates :class:`~nnstreamer_tpu.core.caps.Caps` through every edge of a
parsed graph in topological order, the way the runtime negotiates — but
*offline*: no device, no model files, and it does not stop at the first
failure.  Three mechanisms, from cheapest to deepest:

1. **pad templates** (``Element.PAD_TEMPLATES``, class metadata): every
   edge's propagated caps are intersected with the downstream pad's
   template via :func:`~nnstreamer_tpu.core.caps.intersect_template`; a
   miss is a ``caps-mismatch`` diagnostic carrying the field-level reason
   (``media video/x-raw ⊄ other/tensors``).
2. **safe configure**: element kinds whose constructor+configure are pure
   caps math (sources, converter, transform, routing, video, ...) are
   instantiated and their real ``configure`` runs (inside
   :func:`~..filters.base.abstract_build`, so a device they would resolve
   is the meta device), so the analyzer computes exactly what the runtime
   would — an ``ElementError`` becomes
   a diagnostic and propagation continues with ANY so the REST of the
   graph still gets checked.
3. **static transfers** for kinds whose configure touches the outside
   world (``tensor_filter`` loads a model, query/edge elements open
   sockets): a pure-props transfer that still checks the upstream spec
   against declared/registered model I/O (``dtype uint8 ⊄ float32``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.caps import (
    Caps,
    MediaType,
    explain_mismatch,
    intersect_template,
)
from ..core.registry import KIND_ELEMENT, lookup
from ..core.types import TensorFormat, TensorsSpec
from ..elements.base import Element, ElementError, SINK, SRC
from ..filters.base import abstract_build
from ..pipeline.graph import PipelineGraph
from .diagnostics import Diagnostic, ERROR, WARNING, edge_path, node_label

#: kinds whose __init__ + configure are pure caps/props math — safe to run
#: offline.  Anything NOT listed here (and without a static transfer below)
#: is treated as opaque: templates still apply, output caps become ANY.
SAFE_CONFIGURE = frozenset({
    "appsrc", "videotestsrc", "audiotestsrc",
    "tensor_converter", "tensor_transform", "tensor_aggregator",
    "tee", "queue", "join",
    "tensor_mux", "tensor_demux", "tensor_merge", "tensor_split",
    "tensor_if", "tensor_crop", "tensor_rateadjust",
    "tensor_sparse_enc", "tensor_sparse_dec",
    "videoconvert", "videoscale", "compositor",
    "tensor_debug", "tensor_sink", "fakesink",
    "tensor_reposink", "tensor_reposrc",
    "tensor_decoder",
    # nns-learn: configure() only emits the fixed stats spec — pure
    "tensor_trainer",
})


def propagate(
    graph: PipelineGraph,
) -> Tuple[List[Diagnostic], Dict[Tuple[int, str], Caps]]:
    """Run the pass.  Returns (diagnostics, out-caps per (node_id, pad))."""
    diags: List[Diagnostic] = []
    out_caps: Dict[Tuple[int, str], Caps] = {}

    for node in _kahn_order(graph):
        in_caps: Dict[str, Caps] = {}
        for e in graph.in_edges(node.id):
            up = out_caps.get((e.src, e.src_pad), Caps.any())
            in_caps[e.dst_pad] = up
            # pad-template admission check (pure class metadata)
            cls = _element_class(node.kind)
            if cls is not None and not up.is_any():
                tmpl = cls.pad_template(e.dst_pad)
                if intersect_template(up, tmpl) is None:
                    t0 = tmpl[0] if isinstance(tmpl, tuple) else tmpl
                    diags.append(Diagnostic(
                        "caps-mismatch", ERROR, explain_mismatch(up, t0),
                        path=edge_path(graph, e), pos=node.pos))
                    in_caps[e.dst_pad] = Caps.any()  # keep flowing

        out_pads = sorted(
            {e.src_pad for e in graph.out_edges(node.id)}) or [SRC]
        produced, node_diags = _transfer(graph, node, in_caps, out_pads)
        diags.extend(node_diags)
        for pad in out_pads:
            out_caps[(node.id, pad)] = produced.get(pad, Caps.any())

    diags.extend(_check_demux_arity(graph, out_caps))
    return diags, out_caps


def _kahn_order(graph: PipelineGraph):
    """Topological order that tolerates cycles: leftover (cyclic) nodes are
    simply skipped here — the topology pass reports the cycle itself."""
    indeg = {i: len(graph.in_edges(i)) for i in graph.nodes}
    ready = sorted(i for i, d in indeg.items() if d == 0)
    while ready:
        i = ready.pop(0)
        yield graph.nodes[i]
        for e in graph.out_edges(i):
            indeg[e.dst] -= 1
            if indeg[e.dst] == 0:
                ready.append(e.dst)
        ready.sort()


def _element_class(kind: str) -> Optional[type]:
    if kind == "capsfilter":
        return None
    cls = lookup(KIND_ELEMENT, kind)
    return cls if isinstance(cls, type) and issubclass(cls, Element) else None


def _transfer(graph, node, in_caps: Dict[str, Caps], out_pads: List[str]
              ) -> Tuple[Dict[str, Caps], List[Diagnostic]]:
    """Out caps for one node + any diagnostics it produced."""
    if node.kind == "capsfilter":
        src = next(iter(in_caps.values()), Caps.any())
        merged = src.intersect(node.caps or Caps.any())
        if merged is None:
            return (
                {p: node.caps for p in out_pads},
                [Diagnostic(
                    "caps-mismatch", ERROR,
                    explain_mismatch(src, node.caps),
                    path=f"{node_label(node)}:sink", pos=node.pos)],
            )
        return {p: merged for p in out_pads}, []

    if node.kind == "tensor_filter":
        return _filter_transfer(node, in_caps, out_pads)

    cls = _element_class(node.kind)
    if cls is None or node.kind not in SAFE_CONFIGURE:
        # opaque element: honor its src template, else ANY
        tmpl = Caps.any() if cls is None else cls.pad_template(SRC)
        t0 = tmpl[0] if isinstance(tmpl, tuple) else tmpl
        return {p: t0 for p in out_pads}, []

    try:
        with abstract_build():
            el = cls(dict(node.props), name=node.name or f"{node.kind}{node.id}")
            produced = el.configure(dict(in_caps), list(out_pads))
        return dict(produced), []
    except (ElementError, ValueError, KeyError) as e:
        return (
            {p: Caps.any() for p in out_pads},
            [Diagnostic(
                "caps-incompat", ERROR, str(e),
                path=node_label(node), pos=node.pos)],
        )
    except Exception:  # noqa: BLE001 - environment-dependent (files, ...)
        return {p: Caps.any() for p in out_pads}, []


def _filter_transfer(node, in_caps: Dict[str, Caps], out_pads: List[str]
                     ) -> Tuple[Dict[str, Caps], List[Diagnostic]]:
    """Static tensor_filter transfer: NEVER loads a framework/model.

    Model I/O is taken from explicit ``input``/``output`` props, or — for
    ``framework=custom-easy`` — from the in-process model registry (a plain
    dict lookup).  The upstream spec is checked against the model input the
    same way configure() does, with input-combination selection applied.
    """
    diags: List[Diagnostic] = []
    props = node.props

    def bad_prop(msg: str) -> None:
        diags.append(Diagnostic("caps-incompat", ERROR, msg,
                                path=node_label(node), pos=node.pos))

    declared_in = declared_out = None
    try:
        if props.get("input"):
            declared_in = TensorsSpec.from_string(
                str(props["input"]), str(props.get("inputtype", "float32")))
        if props.get("output"):
            declared_out = TensorsSpec.from_string(
                str(props["output"]), str(props.get("outputtype", "float32")))
    except ValueError as e:  # malformed dims/dtype string is a FINDING,
        bad_prop(str(e))     # not an analyzer crash
        return {p: Caps.new(MediaType.TENSORS) for p in out_pads}, diags
    if str(props.get("framework", "")).lower() == "custom-easy":
        from ..filters.custom_easy import _models

        entry = _models.get(str(props.get("model")))
        if entry is not None:
            reg_in, reg_out = entry[1], entry[2]
            declared_in = declared_in or reg_in
            declared_out = declared_out or reg_out

    src = next(iter(in_caps.values()), Caps.any())
    up_spec = src.spec
    if up_spec is not None and not up_spec.is_flexible:
        combo = str(props.get("input_combination", "")).strip()
        if combo:
            try:
                idxs = [int(v) for v in combo.split(",")]
            except ValueError:
                bad_prop(f"input-combination {combo!r} is not a "
                         "comma-separated index list")
                idxs, up_spec = [], None
            if up_spec is not None and any(i >= len(up_spec) for i in idxs):
                diags.append(Diagnostic(
                    "caps-incompat", ERROR,
                    f"input-combination {idxs} out of range for upstream "
                    f"spec ({len(up_spec)} tensors)",
                    path=node_label(node), pos=node.pos))
                up_spec = None
            elif up_spec is not None:
                up_spec = TensorsSpec(
                    tuple(up_spec[i] for i in idxs), rate=up_spec.rate)
        if up_spec is not None and declared_in is not None \
                and not up_spec.is_compatible(declared_in):
            diags.append(Diagnostic(
                "caps-mismatch", ERROR,
                explain_mismatch(Caps.tensors(up_spec),
                                 Caps.tensors(declared_in)),
                path=f"{node_label(node)}:sink", pos=node.pos))

    out_spec = declared_out
    if out_spec is not None and bool(props.get("invoke_dynamic", False)):
        out_spec = out_spec.replace(format=TensorFormat.FLEXIBLE)
    caps = Caps.tensors(out_spec) if out_spec is not None else Caps.new(
        MediaType.TENSORS)
    return {p: caps for p in out_pads}, diags


def _check_demux_arity(graph, out_caps) -> List[Diagnostic]:
    """Numbered src pads past what the negotiated spec can supply.

    tensor_demux emits one stream per (picked) upstream tensor: a link from
    ``src_3`` of a demux whose input has 2 tensors can never see a buffer.
    """
    diags: List[Diagnostic] = []
    for node in graph.nodes.values():
        if node.kind != "tensor_demux":
            continue
        if str(node.props.get("by-meta", node.props.get("by_meta", ""))):
            # meta routing forwards the WHOLE buffer to one pad chosen
            # by a meta value: every pad can emit, the per-tensor arity
            # rule does not apply
            continue
        ins = graph.in_edges(node.id)
        if not ins:
            continue
        up = out_caps.get((ins[0].src, ins[0].src_pad))
        spec = up.spec if up is not None else None
        if spec is None or spec.is_flexible:
            continue
        pick = str(node.props.get("tensorpick", ""))
        try:
            idxs = ([int(v) for v in pick.split(",") if v != ""]
                    if pick else None)
        except ValueError:
            diags.append(Diagnostic(
                "caps-incompat", ERROR,
                f"tensorpick {pick!r} is not a comma-separated index list",
                path=node_label(node), pos=node.pos))
            continue
        n_out = len(idxs) if idxs else len(spec)
        if idxs and any(i >= len(spec) for i in idxs):
            diags.append(Diagnostic(
                "caps-incompat", ERROR,
                f"tensorpick {idxs} out of range for upstream spec "
                f"({len(spec)} tensors)", path=node_label(node),
                pos=node.pos))
            continue
        for e in graph.out_edges(node.id):
            base, sep, i = e.src_pad.rpartition("_")
            if sep and i.isdigit() and int(i) >= n_out:
                diags.append(Diagnostic(
                    "pad-arity", ERROR,
                    f"demux pad {e.src_pad} can never emit: input supplies "
                    f"{n_out} stream(s)", path=edge_path(graph, e),
                    pos=node.pos))
    return diags
