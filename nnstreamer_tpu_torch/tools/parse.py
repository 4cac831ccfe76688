"""Standalone pipeline-string parser / validator CLI.

Copy of ``nnstreamer_tpu/tools/parse.py`` (reference analog:
``tools/development/parser``, SURVEY §2.8):

    python -m nnstreamer_tpu_torch.tools.parse "videotestsrc ! tensor_converter ! tensor_sink"
    python -m nnstreamer_tpu_torch.tools.parse --dot ... > graph.dot
    python -m nnstreamer_tpu_torch.tools.parse --plan ...   # instantiate + show fusion plan

``--plan`` builds the pipeline, which opens its models on the card unless
a filter sets ``accelerator=true:cpu``.

Without ``--plan`` nothing is instantiated — parse + topology validation
only, so unknown models/files don't block validating the string's shape.
"""

from __future__ import annotations

import argparse
import sys


def graph_summary(graph) -> str:
    lines = []
    for node in graph.topo_order():
        props = " ".join(f"{k}={v}" for k, v in node.props.items())
        name = f" name={node.name}" if node.name else ""
        lines.append(f"  [{node.id}] {node.kind}{name}{' ' + props if props else ''}")
    lines.append("  links:")
    for e in graph.edges:
        lines.append(f"    {e.src}:{e.src_pad} -> {e.dst}:{e.dst_pad}")
    return "\n".join(lines)


def graph_dot(graph) -> str:
    out = ["digraph pipeline {", "  rankdir=LR;"]
    for node in graph.nodes.values():
        label = node.kind + (f"\\n{node.name}" if node.name else "")
        out.append(f'  n{node.id} [label="{label}" shape=box];')
    for e in graph.edges:
        out.append(f"  n{e.src} -> n{e.dst};")
    out.append("}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch.tools.parse",
        description="Validate a pipeline description without running it.",
    )
    ap.add_argument("pipeline", help="gst-launch-style description")
    ap.add_argument("--dot", action="store_true", help="emit graphviz dot")
    ap.add_argument(
        "--plan", action="store_true",
        help="instantiate elements and print the fused execution plan",
    )
    args = ap.parse_args(argv)

    from ..pipeline.parser import ParseError, parse

    try:
        graph = parse(args.pipeline)
        graph.validate()
        # Element kinds must exist (registry lookup only — nothing is
        # instantiated, so model files aren't needed to validate a string).
        from ..core.registry import KIND_ELEMENT, lookup, names

        for node in graph.nodes.values():
            if node.kind != "capsfilter" and lookup(KIND_ELEMENT, node.kind) is None:
                raise KeyError(
                    f"unknown element {node.kind!r}; known: "
                    f"{sorted(names(KIND_ELEMENT))}"
                )
    except (ParseError, KeyError, ValueError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1

    if args.dot:
        print(graph_dot(graph))
        return 0

    print(f"VALID: {len(graph.nodes)} elements, {len(graph.edges)} links")
    print(graph_summary(graph))

    if args.plan:
        from ..pipeline.runtime import Pipeline

        try:
            p = Pipeline(graph, fuse=True)
        except Exception as e:  # noqa: BLE001 - surface anything to the user
            print(f"PLAN FAILED: {e}", file=sys.stderr)
            return 2
        print("plan:")
        for st in p.stages:
            kind = "fused" if len(st.node_ids) > 1 else "stage"
            print(f"  {kind}: {st.element.name} (nodes {st.node_ids})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
