"""gst-launch-style pipeline string parser.

Copy of ``nnstreamer_tpu/pipeline/parser.py``.  Parses the reference's
declarative pipeline DSL (the grammar of ``gst_parse_launch`` /
``tools/development/parser`` upstream — reconstructed, SURVEY §2.8) into a
:class:`~.graph.PipelineGraph`.

Supported grammar subset (everything the reference's own test pipelines use):

* chains:            ``a ! b ! c``
* properties:        ``elem key=value key2="quoted value"``
* caps filters:      ``video/x-raw,format=RGB,width=640,framerate=30/1``
* named elements:    ``tee name=t``  then branch refs ``t. ! queue ! ...``
* named pads:        ``mux.sink_0`` / ``demux.src_1``
* multiple chains separated by starting a new element without ``!``

The parser is deliberately strict: unknown syntax raises ParseError with the
offending token, because a silently-misparsed pipeline is how streaming bugs
are born.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..core.caps import parse_caps_string
from .graph import GraphError, Node, PipelineGraph


class ParseError(ValueError):
    """Pipeline-string syntax error.

    ``pos`` is the 0-based character offset of the offending token in the
    pipeline string (None when no single position applies), so tools — the
    lint CLI in particular — can point a caret at the source.
    """

    def __init__(self, message: str, pos: Optional[int] = None):
        if pos is not None:
            message = f"{message} (at char {pos})"
        super().__init__(message)
        self.pos = pos


#: stand-in for an unresolvable chain-start ref under validate=False:
#: links from it are silently dropped (the analyzer reports the ref itself)
_PHANTOM = object()

_NAME_RE = re.compile(r"^[A-Za-z_][\w\-]*$")
_PROP_RE = re.compile(r"^([A-Za-z_][\w\-]*)=(.*)$", re.S)
# GStreamer per-pad property syntax: sink_1::alpha=0.5
_PAD_PROP_RE = re.compile(r"^([A-Za-z_][\w\-]*::[A-Za-z_][\w\-]*)=(.*)$", re.S)
_REF_RE = re.compile(r"^([A-Za-z_][\w\-]*)\.([\w\-]*)$")
_CAPS_RE = re.compile(r"^[a-z]+/[\w\-\.\+]+")


def _tokenize(text: str) -> List[Tuple[str, int]]:
    """Split on whitespace and '!' outside quotes; quoted spans (single or
    double) keep their content verbatim — including '!' and spaces.
    Returns (token, offset) pairs, offset = 0-based char position of the
    token's first character in ``text`` (diagnostics point there)."""
    toks: List[Tuple[str, int]] = []
    cur: List[str] = []
    start = 0
    quote: Optional[str] = None
    quote_pos = 0
    for i, ch in enumerate(text):
        if quote is not None:
            if ch == quote:
                quote = None
            else:
                cur.append(ch)
            continue
        if ch in "\"'":
            if not cur:
                start = i
            quote = ch
            quote_pos = i
            continue
        if ch.isspace() or ch == "!":
            if cur:
                toks.append(("".join(cur), start))
                cur = []
            if ch == "!":
                toks.append(("!", i))
            continue
        if not cur:
            start = i
        cur.append(ch)
    if quote is not None:
        raise ParseError(
            f"unterminated quote in pipeline string: {text!r}", quote_pos)
    if cur:
        toks.append(("".join(cur), start))
    return toks


def _coerce(v: str):
    if len(v) >= 2 and v[0] in "\"'" and v[-1] == v[0]:
        return v[1:-1]
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    return v


def parse(text: str, *, validate: bool = True) -> PipelineGraph:
    """Parse a pipeline description string into a validated PipelineGraph.

    ``validate=False`` is the static analyzer's entry point: syntax errors
    still raise, but *semantic* problems that validation would reject —
    dangling name refs, cycles, double-linked pads — are left in the graph
    for the analysis passes to report ALL AT ONCE (dangling refs land in
    ``graph.unresolved_refs`` as ``(name, pad, pos)`` tuples).
    """
    toks = _tokenize(text)
    if not toks:
        raise ParseError("empty pipeline description")

    g = PipelineGraph()
    # pending link state
    prev: Optional[Node] = None
    prev_pad = "src"
    want_link = False  # saw '!' and waiting for the next element
    # deferred name refs we couldn't resolve yet
    deferred: List[Tuple[str, str, Node, str, int]] = []  # (name, pad, src_node, src_pad, pos)

    i = 0
    n = len(toks)
    while i < n:
        t, tpos = toks[i]

        if t == "!":
            if prev is None:
                raise ParseError("'!' with no element before it", tpos)
            if want_link:
                raise ParseError("two '!' in a row", tpos)
            want_link = True
            i += 1
            continue

        ref = _REF_RE.match(t)
        if ref and not _PROP_RE.match(t):
            name, pad = ref.group(1), ref.group(2)
            if want_link:
                # prev ! name.pad  => link INTO named element's sink pad
                pad = pad or "sink"
                target = g.by_name.get(name)
                if prev is _PHANTOM:
                    # upstream ref already recorded; the SINK-side ref must
                    # still be checked — a second dangling name here is its
                    # own finding, a resolved one is phantom-fed
                    if target is None:
                        g.unresolved_refs.append((name, pad, tpos))
                    else:
                        g.phantom_fed.add(target.id)
                elif target is None:
                    deferred.append((name, pad, prev, prev_pad, tpos))
                else:
                    g.link(prev, target, prev_pad, pad)
                want_link = False
                prev, prev_pad = None, "src"
            else:
                # chain start: name.pad ! ...  => link FROM named element's src pad
                target = g.by_name.get(name)
                if target is None:
                    if not validate:
                        # record + parse on: the ref'd chain hangs off a
                        # phantom source, so downstream elements still
                        # exist for the analyzer (it reports the dangling
                        # ref AND whatever else is wrong, in one run).
                        g.unresolved_refs.append((name, pad or "src", tpos))
                        prev, prev_pad = _PHANTOM, "src"
                        i += 1
                        continue
                    raise ParseError(
                        f"reference to unknown element {name!r}", tpos)
                prev = target
                prev_pad = pad or _next_src_pad(g, target)
            i += 1
            continue

        if _CAPS_RE.match(t) and "=" not in t.split(",", 1)[0]:
            try:
                caps = parse_caps_string(t)
            except ValueError as e:
                raise ParseError(str(e), tpos) from None
            node = g.add("capsfilter", {}, caps=caps, pos=tpos)
            if want_link:
                if prev is not _PHANTOM:
                    g.link(prev, node, prev_pad, "sink")
                else:
                    g.phantom_fed.add(node.id)
                want_link = False
            prev, prev_pad = node, "src"
            i += 1
            continue

        if _NAME_RE.match(t):
            kind = t
            props: Dict[str, object] = {}
            i += 1
            while i < n:
                if toks[i][0] == "!":
                    break
                pm = _PAD_PROP_RE.match(toks[i][0])
                m = pm or _PROP_RE.match(toks[i][0])
                if not m:
                    break
                key = m.group(1)
                if pm is None:
                    key = key.replace("-", "_")
                else:  # pad props keep the pad name verbatim: sink_1::alpha
                    pad, _, prop = key.partition("::")
                    key = f"{pad}::{prop.replace('-', '_')}"
                props[key] = _coerce(m.group(2))
                i += 1
            try:
                node = g.add(kind, props, pos=tpos)
            except GraphError as e:  # duplicate element name
                raise ParseError(str(e), tpos) from None
            if want_link:
                if prev is not _PHANTOM:
                    g.link(prev, node, prev_pad, "sink")
                else:
                    g.phantom_fed.add(node.id)
                want_link = False
            elif prev is not None:
                pass  # new chain begins
            prev, prev_pad = node, "src"
            continue

        raise ParseError(f"unexpected token {t!r}", tpos)

    if want_link:
        raise ParseError("pipeline ends with '!'", toks[-1][1])

    for name, pad, src_node, src_pad, pos in deferred:
        target = g.by_name.get(name)
        if target is None:
            if not validate:
                g.unresolved_refs.append((name, pad, pos))
                g.phantom_out.add(src_node.id)
                continue
            raise ParseError(f"reference to unknown element {name!r}", pos)
        g.link(src_node, target, src_pad, pad)

    _assign_request_pads(g)
    if validate:
        g.validate()
    return g


_MULTI_SRC = ("tee", "tensor_demux", "tensor_split", "tensor_if")


def _next_src_pad(g: PipelineGraph, node: Node) -> str:
    """Auto-number source pads for tee/demux-style elements referenced as 'name.'."""
    used = {e.src_pad for e in g.out_edges(node.id)}
    if node.kind not in _MULTI_SRC:
        if "src" in used:
            raise ParseError(
                f"element {node.name or node.kind!r} has a single src pad already "
                "linked; insert a tee to branch"
            )
        return "src"
    i = 0
    while f"src_{i}" in used:
        i += 1
    return f"src_{i}"


def _assign_request_pads(g: PipelineGraph) -> None:
    """Give multi-input elements (mux/merge/join) numbered sink pads and
    multi-output elements numbered src pads when linked via default pads."""
    multi_sink = {"tensor_mux", "tensor_merge", "join", "tensor_trainer",
                  "compositor"}
    multi_src = {"tee"}
    for node in g.nodes.values():
        if node.kind in multi_sink:
            counter = 0
            used = {e.dst_pad for e in g.in_edges(node.id) if e.dst_pad != "sink"}
            for idx, e in enumerate(g.edges):
                if e.dst == node.id and e.dst_pad == "sink":
                    while f"sink_{counter}" in used:
                        counter += 1
                    g.edges[idx] = type(e)(e.src, e.src_pad, e.dst, f"sink_{counter}")
                    used.add(f"sink_{counter}")
        if node.kind in multi_src:
            counter = 0
            used = {e.src_pad for e in g.out_edges(node.id) if e.src_pad != "src"}
            for idx, e in enumerate(g.edges):
                if e.src == node.id and e.src_pad == "src":
                    while f"src_{counter}" in used:
                        counter += 1
                    g.edges[idx] = type(e)(e.src, f"src_{counter}", e.dst, e.dst_pad)
                    used.add(f"src_{counter}")
