"""Topology / concurrency checks over a parsed PipelineGraph.

Copy of ``nnstreamer_tpu/analysis/topology.py``, over this package's
registry and element classes.

Everything here is pure graph structure + element-class metadata (kind,
is_source/is_sink, sync_policy, request-pad numbering) — no element is
instantiated, no torch op runs.  Checks:

* dangling ``name.pad`` refs (``graph.unresolved_refs`` from
  ``parse(..., validate=False)``)
* unknown element kinds (with a did-you-mean suggestion)
* cycles outside the ``tensor_repo`` loop mechanism
* sources with inputs / non-sources without inputs (the missing-'!' bug)
* sinks with outputs, and non-sink leaves that silently drop buffers
* double-linked src pads (branching without a tee)
* mux/merge arity: single-input collators, numbered-pad gaps that stall
  slowest-sync collation forever
* the tee-diamond deadlock hazard: branches of one tee rejoining a
  slowest-sync collator (mux/merge/compositor/crop) without a ``queue``
  on every branch.  In this runtime every stage already owns a bounded
  queue, so the GStreamer-style hard deadlock becomes unbounded pending
  growth + latency skew at the collator — the check sizes the hazard
  against the configured per-stage queue capacity and branch depth skew.
"""

from __future__ import annotations

import difflib
from typing import Dict, List, Optional, Set

from ..core.registry import KIND_ELEMENT, lookup, names
from ..elements.base import SinkElement, SourceElement
from ..pipeline.graph import PipelineGraph
from .diagnostics import Diagnostic, ERROR, WARNING, node_label

#: kinds whose class collates one buffer per sink pad (sync_policy "all")
#: — the reconvergence points the deadlock check cares about
_COLLATORS = {"tensor_mux", "tensor_merge", "compositor", "tensor_crop"}

#: the explicit stage-boundary element (GStreamer ``queue``)
_QUEUE_KINDS = {"queue"}


def _cls(kind: str):
    if kind == "capsfilter":
        return None
    return lookup(KIND_ELEMENT, kind)


def check_topology(graph: PipelineGraph, *,
                   queue_capacity: Optional[int] = None) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    add = lambda *a, **k: diags.append(Diagnostic(*a, **k))  # noqa: E731

    # dangling named-pad refs (validate=False parse carries them through)
    for name, pad, pos in getattr(graph, "unresolved_refs", []):
        add("dangling-pad-ref", ERROR,
            f"reference to unknown element {name!r} (pad {pad!r})",
            path=f"{name}.{pad}", pos=pos)

    # unknown kinds
    known: Dict[int, object] = {}
    all_names = None
    for node in graph.nodes.values():
        cls = _cls(node.kind)
        if cls is None and node.kind != "capsfilter":
            if all_names is None:
                all_names = names(KIND_ELEMENT)
            near = difflib.get_close_matches(node.kind, all_names, n=1)
            hint = f" — did you mean {near[0]!r}?" if near else ""
            add("unknown-element", ERROR,
                f"no element kind {node.kind!r}{hint}",
                path=node_label(node), pos=node.pos)
        else:
            known[node.id] = cls

    # cycles (reference: loops must go through tensor_repo slots, which
    # break the edge — reposrc has no in-edge)
    cycle = graph.find_cycle()
    cycle_nodes: Set[int] = set(cycle or ())
    if cycle:
        path = " -> ".join(node_label(graph.nodes[i]) for i in cycle)
        add("cycle", ERROR,
            f"pipeline graph has a cycle: {path} — loops must go through "
            "tensor_reposink/tensor_reposrc slots",
            path=node_label(graph.nodes[cycle[0]]),
            pos=graph.nodes[cycle[0]].pos)

    # double-linked src pads (graph.validate would reject; lint reports all)
    seen_src: Set = set()
    for e in graph.edges:
        k = (e.src, e.src_pad)
        if k in seen_src:
            add("pad-linked-twice", ERROR,
                f"source pad {e.src_pad!r} linked twice — insert a tee to "
                "branch", path=node_label(graph.nodes[e.src]),
                pos=graph.nodes[e.src].pos)
        seen_src.add(k)

    # nodes whose in/out link was dropped because a name ref never
    # resolved: the dangling-pad-ref diagnostic IS their finding — no
    # derived missing-'!'/unreachable/leaf noise on either side
    phantom_fed: Set[int] = set(getattr(graph, "phantom_fed", ()))
    phantom_out: Set[int] = set(getattr(graph, "phantom_out", ()))

    # per-node structural checks
    for node in graph.nodes.values():
        cls = known.get(node.id)
        ins = graph.in_edges(node.id)
        outs = graph.out_edges(node.id)
        is_source = cls is not None and issubclass(cls, SourceElement)
        is_sink = cls is not None and issubclass(cls, SinkElement)
        if is_source and ins:
            add("source-has-input", ERROR,
                f"source element {node.kind!r} cannot have input links",
                path=node_label(node), pos=node.pos)
        if not is_source and cls is not None and not ins \
                and node.id not in cycle_nodes \
                and node.id not in phantom_fed:
            add("no-input", ERROR,
                f"element {node.kind!r} has no input link — missing '!' "
                "before it?", path=node_label(node), pos=node.pos)
        if is_sink and outs:
            add("sink-has-output", ERROR,
                f"sink element {node.kind!r} cannot have output links",
                path=node_label(node), pos=node.pos)
        if not is_sink and cls is not None and not outs \
                and node.id not in phantom_out:
            add("leaf-not-sink", WARNING,
                f"element {node.kind!r} has no downstream link — its output "
                "buffers are silently dropped", path=node_label(node),
                pos=node.pos)

        # collator arity + numbered-pad gaps: slowest-sync waits for a
        # buffer on EVERY connected sink pad, so a gap in sink_N numbering
        # is usually a mislinked branch
        if node.kind in _COLLATORS and _collates(node):
            idxs = sorted(
                int(e.dst_pad.rsplit("_", 1)[1]) for e in ins
                if "_" in e.dst_pad and e.dst_pad.rsplit("_", 1)[1].isdigit()
            )
            if len(ins) < 2:
                add("collator-single-input", WARNING,
                    f"{node.kind} collates one buffer per sink pad but has "
                    f"{len(ins)} input(s)", path=node_label(node),
                    pos=node.pos)
            if idxs and idxs != list(range(idxs[0], idxs[0] + len(idxs))):
                add("pad-gap", ERROR,
                    f"{node.kind} sink pads are numbered {idxs} — gaps stall "
                    "slowest-sync collation", path=node_label(node),
                    pos=node.pos)

    # unreachable branches: BFS from every true root (phantom-fed nodes
    # count as roots — their feed exists, it just failed to resolve)
    roots = [
        n.id for n in graph.nodes.values()
        if not graph.in_edges(n.id)
        and (n.id in phantom_fed or known.get(n.id) is None
             or issubclass(known[n.id], SourceElement))
    ]
    reached: Set[int] = set()
    work = list(roots)
    while work:
        i = work.pop()
        if i in reached:
            continue
        reached.add(i)
        work.extend(e.dst for e in graph.out_edges(i))
    for node in graph.nodes.values():
        if node.id in reached or node.id in cycle_nodes:
            continue
        ins = graph.in_edges(node.id)
        # nodes whose only problem is a missing input were reported above
        if not ins:
            continue
        add("unreachable", WARNING,
            f"element {node.kind!r} can never receive a buffer (no source "
            "feeds this branch)", path=node_label(node), pos=node.pos)

    diags.extend(_check_tee_diamonds(graph, known, queue_capacity))
    return diags


def _collates(node) -> bool:
    """Does this collator instance actually run slowest-sync?  sync-mode
    basepad/refresh switch the element to 'any' collation at runtime."""
    mode = str(node.props.get("sync_mode", "slowest")).lower()
    return mode not in ("basepad", "refresh")


def _reachable(graph: PipelineGraph, start: int, *,
               skip_kinds: Set[str] = frozenset()) -> Dict[int, int]:
    """BFS depths from ``start`` (inclusive), not expanding through nodes
    whose kind is in ``skip_kinds`` (used to ask "is there a queue-less
    path?" by deleting queues)."""
    depth = {start: 0}
    work = [start]
    while work:
        i = work.pop(0)
        if graph.nodes[i].kind in skip_kinds:
            continue
        for e in graph.out_edges(i):
            if e.dst not in depth:
                depth[e.dst] = depth[i] + 1
                work.append(e.dst)
    return depth


def _check_tee_diamonds(graph: PipelineGraph, known: Dict[int, object],
                        queue_capacity: Optional[int]) -> List[Diagnostic]:
    """Branches of one multi-out element rejoining a slowest-sync collator
    must each pass through a bounded ``queue``.

    Reference semantics: a queue-less tee diamond hard-deadlocks GStreamer
    (the tee's chain call blocks in the muxer while the muxer waits for the
    other branch).  This runtime gives every stage its own bounded queue, so
    the failure mode is softer but real: the collator's pending lists grow
    by one buffer per *depth-skew* step between the branches, and with the
    per-stage queue capacity C the upstream tee stalls once the short
    branch runs C buffers ahead — pipeline throughput then degrades to the
    long branch with zero overlap.  The check therefore reports severity by
    sizing depth skew against C (planner stage/queue model: one stage and
    one bounded queue per element outside fused spans).
    """
    if queue_capacity is None:
        from ..core.config import get_config

        queue_capacity = get_config().queue_capacity
    diags: List[Diagnostic] = []
    for node in graph.nodes.values():
        outs = graph.out_edges(node.id)
        if len(outs) < 2:
            continue
        branch_heads = sorted({e.dst for e in outs})
        if len(branch_heads) < 2:
            continue
        depths = {h: _reachable(graph, h) for h in branch_heads}
        noq = {h: _reachable(graph, h, skip_kinds=_QUEUE_KINDS)
               for h in branch_heads}
        joins = {}
        for join in graph.nodes.values():
            if join.kind not in _COLLATORS or not _collates(join):
                continue
            through = [h for h in branch_heads if join.id in depths[h]]
            if len(through) < 2:
                continue
            joins[join.id] = through
        for join_id, through in joins.items():
            join = graph.nodes[join_id]
            bare = [h for h in through if join_id in noq[h]]
            if not bare:
                continue  # every rejoining branch is decoupled by a queue
            skew = (max(depths[h][join_id] for h in through)
                    - min(depths[h][join_id] for h in through))
            sev = ERROR if len(bare) == len(through) else WARNING
            branches = ", ".join(
                f"via {node_label(graph.nodes[h])}" for h in bare)
            diags.append(Diagnostic(
                "tee-deadlock", sev,
                f"branches of {node_label(node)} rejoin slowest-sync "
                f"{join.kind} without a queue on every branch ({branches}); "
                f"branch depth skew {skew} vs stage queue capacity "
                f"{queue_capacity} — insert 'queue' after each branch",
                path=f"{node_label(node)} → {node_label(join)}",
                pos=node.pos))
    return diags
