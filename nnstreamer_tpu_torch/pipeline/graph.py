"""Pipeline graph representation.

Copy of ``nnstreamer_tpu/pipeline/graph.py``.  The logical dataflow graph
a pipeline string parses into (reference analog: GStreamer's
GstBin/GstElement/GstPad topology built by gst_parse_launch): a plain DAG
that the planner (pipeline/plan.py) partitions into executable stages.
Pure structure + validation.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from ..core.caps import Caps


@dataclasses.dataclass
class Node:
    """One element instance in the graph."""

    id: int
    kind: str  # registered element name, e.g. "tensor_converter"
    props: Dict[str, object] = dataclasses.field(default_factory=dict)
    name: Optional[str] = None  # user-assigned name (name=... property)
    caps: Optional[Caps] = None  # for capsfilter pseudo-elements
    #: 0-based character offset of this element's token in the pipeline
    #: string (set by the parser; None for programmatically built graphs) —
    #: lets lint diagnostics point back at the source text.
    pos: Optional[int] = None

    def __str__(self):  # pragma: no cover
        nm = f" name={self.name}" if self.name else ""
        return f"[{self.id}:{self.kind}{nm}]"


@dataclasses.dataclass(frozen=True)
class Edge:
    """A link src(node,pad) -> dst(node,pad).  Pads are string names;
    "src"/"sink" are the default always-pads, "src_%u"/"sink_%u" request pads
    (mux/demux/tee analogs)."""

    src: int
    src_pad: str
    dst: int
    dst_pad: str


class GraphError(ValueError):
    pass


class PipelineGraph:
    def __init__(self):
        self._next_id = itertools.count()
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []
        self.by_name: Dict[str, Node] = {}
        #: dangling ``name.pad`` refs the parser could not resolve —
        #: populated only by ``parse(..., validate=False)`` as
        #: (name, pad, pos) tuples for the analyzer to report.
        self.unresolved_refs: List[Tuple[str, str, int]] = []
        #: node ids whose upstream link was dropped because it came from an
        #: unresolved chain-start ref (validate=False only): the dangling
        #: ref IS their input, so the analyzer must not also flag them as
        #: "missing '!'" or unreachable.
        self.phantom_fed: set = set()
        #: node ids whose DOWNSTREAM link was dropped because its target
        #: name never resolved (validate=False only): they did link out,
        #: just to a bad name — no derived leaf-not-sink noise.
        self.phantom_out: set = set()

    # -- construction ------------------------------------------------------
    def add(self, kind: str, props: Optional[Dict[str, object]] = None,
            caps: Optional[Caps] = None, pos: Optional[int] = None) -> Node:
        props = dict(props or {})
        name = props.pop("name", None)
        node = Node(next(self._next_id), kind, props, name, caps, pos)
        self.nodes[node.id] = node
        if name is not None:
            if name in self.by_name:
                raise GraphError(f"duplicate element name {name!r}")
            self.by_name[str(name)] = node
        return node

    def link(self, src: Node, dst: Node, src_pad: str = "src", dst_pad: str = "sink"):
        e = Edge(src.id, src_pad, dst.id, dst_pad)
        self.edges.append(e)
        return e

    # -- queries -----------------------------------------------------------
    def out_edges(self, node_id: int) -> List[Edge]:
        return [e for e in self.edges if e.src == node_id]

    def in_edges(self, node_id: int) -> List[Edge]:
        return [e for e in self.edges if e.dst == node_id]

    def sources(self) -> List[Node]:
        return [n for n in self.nodes.values() if not self.in_edges(n.id)]

    def sinks(self) -> List[Node]:
        return [n for n in self.nodes.values() if not self.out_edges(n.id)]

    def topo_order(self) -> List[Node]:
        """Topological order; repo-loop back-edges (reposrc/reposink pairs by
        slot name) are implicit — reposrc has no in-edge, so the DAG check
        holds even for recurrent pipelines (reference: tensor_repo slots)."""
        indeg = {i: len(self.in_edges(i)) for i in self.nodes}
        ready = sorted(i for i, d in indeg.items() if d == 0)
        out: List[Node] = []
        while ready:
            i = ready.pop(0)
            out.append(self.nodes[i])
            for e in self.out_edges(i):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
            ready.sort()
        if len(out) != len(self.nodes):
            cyc = self.find_cycle()
            detail = ""
            if cyc:
                detail = " — " + " -> ".join(
                    self.nodes[i].name or f"{self.nodes[i].kind}[{i}]"
                    for i in cyc)
            raise GraphError(
                "pipeline graph has a cycle (use tensor_repo for loops)"
                + detail)
        return out

    def find_cycle(self) -> Optional[List[int]]:
        """Node ids forming one cycle (closed: first == last), or None.
        Used by topo_order's error message and the static analyzer's
        topology pass (which must report, not raise)."""
        WHITE, GREY, BLACK = 0, 1, 2
        color = {i: WHITE for i in self.nodes}
        stack: List[int] = []

        def dfs(i: int) -> Optional[List[int]]:
            color[i] = GREY
            stack.append(i)
            for e in self.out_edges(i):
                if color[e.dst] == GREY:
                    return stack[stack.index(e.dst):] + [e.dst]
                if color[e.dst] == WHITE:
                    got = dfs(e.dst)
                    if got is not None:
                        return got
            stack.pop()
            color[i] = BLACK
            return None

        for i in sorted(self.nodes):
            if color[i] == WHITE:
                got = dfs(i)
                if got is not None:
                    return got
        return None

    def validate(self) -> None:
        if not self.nodes:
            raise GraphError("empty pipeline")
        self.topo_order()
        # pad uniqueness: one edge per (node, pad) endpoint
        seen_src, seen_dst = set(), set()
        for e in self.edges:
            if e.src not in self.nodes or e.dst not in self.nodes:
                raise GraphError(f"edge references unknown node: {e}")
            k = (e.src, e.src_pad)
            if k in seen_src:
                raise GraphError(f"source pad linked twice: {k} (insert a tee)")
            seen_src.add(k)
            k = (e.dst, e.dst_pad)
            if k in seen_dst:
                raise GraphError(f"sink pad linked twice: {k}")
            seen_dst.add(k)

    def __str__(self):  # pragma: no cover
        lines = [str(n) for n in self.nodes.values()]
        lines += [f"  {e.src}.{e.src_pad} -> {e.dst}.{e.dst_pad}" for e in self.edges]
        return "\n".join(lines)
