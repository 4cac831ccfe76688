"""nns-trace CLI: validate, summarize, and capture flight-recorder dumps.

Port of ``nnstreamer_tpu/tools/trace.py``: the same subcommands, output
and exit codes, over the port's ``utils/tracing.py`` (whose ring dumps
and Chrome traces are the JAX package's format, so rings of both
packages merge into one trace) and ``nnstreamer_tpu_torch.Pipeline``.

    # schema-check a dump (traceEvents present, required keys, ts monotonic)
    python -m nnstreamer_tpu_torch.tools.trace validate trace.json

    # per-(stage, kind) latency table of a dump
    python -m nnstreamer_tpu_torch.tools.trace summary trace.json

    # run a self-driving pipeline string with the flight recorder on and
    # write the Chrome trace next to you (load in Perfetto / chrome://tracing)
    python -m nnstreamer_tpu_torch.tools.trace run \\
        "videotestsrc num-buffers=64 ! tensor_converter ! tensor_sink" \\
        --out trace.json

    # join N per-process ring dumps (tracing.dump_ring) into ONE
    # offset-corrected Chrome trace with cross-wire flow arrows
    # (docs/OBSERVABILITY.md "Distributed tracing")
    python -m nnstreamer_tpu_torch.tools.trace merge server.ring client.ring \\
        --out merged.json

``run`` places the pipeline's device stages as their elements say (on
the card unless a filter sets ``accelerator=true:cpu``).  See
docs/OBSERVABILITY.md for the span taxonomy and how the per-buffer trace
ids link batched dispatches back to individual rows.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_validate(args) -> int:
    from ..utils.tracing import validate_chrome

    try:
        with open(args.file) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{args.file}: unreadable: {e}", file=sys.stderr)
        return 1
    problems = validate_chrome(obj)
    if problems:
        for p in problems[:50]:
            print(f"{args.file}: {p}", file=sys.stderr)
        if len(problems) > 50:
            print(f"... and {len(problems) - 50} more", file=sys.stderr)
        return 1
    n = len(obj.get("traceEvents", []))
    linked = sum(1 for e in obj["traceEvents"]
                 if isinstance(e, dict)
                 and (e.get("args") or {}).get("trace_ids"))
    print(f"OK: {n} events, {linked} batch-linked spans")
    return 0


def _cmd_summary(args) -> int:
    try:
        with open(args.file) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{args.file}: unreadable: {e}", file=sys.stderr)
        return 1
    # aggregate straight off the Chrome events (a dump may come from
    # another process — no recorder state needed)
    tracks = {e["tid"]: e["args"]["name"]
              for e in obj.get("traceEvents", [])
              if isinstance(e, dict) and e.get("ph") == "M"
              and e.get("name") == "thread_name"}
    agg: dict = {}
    for e in obj.get("traceEvents", []):
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        key = (tracks.get(e.get("tid"), f"tid{e.get('tid')}"),
               e.get("name", "?"))
        a = agg.setdefault(key, [0, 0.0, 0.0])
        a[0] += 1
        dur_ms = float(e.get("dur", 0.0)) / 1e3
        a[1] += dur_ms
        a[2] = max(a[2], dur_ms)
    if not agg:
        print("no complete (ph=X) spans in dump")
        return 0
    print(f"{'stage':<22s} {'kind':<10s} {'count':>7s} {'total ms':>10s} "
          f"{'mean ms':>9s} {'max ms':>9s}")
    for (stage, kind), (n, total, mx) in sorted(
            agg.items(), key=lambda kv: -kv[1][1]):
        print(f"{stage:<22s} {kind:<10s} {n:>7d} {total:>10.3f} "
              f"{total / n:>9.3f} {mx:>9.3f}")
    return 0


def _cmd_run(args) -> int:
    from ..pipeline.runtime import Pipeline
    from ..utils.tracing import recorder

    recorder.clear()
    p = Pipeline(args.pipeline, trace_mode=args.mode)
    with p:
        p.wait(timeout=args.timeout)
    n = p.dump_trace(args.out)
    print(f"{args.out}: {n} spans "
          f"(load in https://ui.perfetto.dev or chrome://tracing)")
    return 0


def _cmd_merge(args) -> int:
    from ..utils.tracing import merge_ring_files, validate_chrome

    try:
        obj, stats = merge_ring_files(args.files)
    except (OSError, ValueError) as e:
        print(f"merge: {e}", file=sys.stderr)
        return 1
    problems = validate_chrome(obj)
    with open(args.out, "w") as f:
        json.dump(obj, f)
    align = obj.get("otherData", {}).get("weave", [])
    unaligned = [a["proc"] for a in align if not a.get("aligned", True)]
    print(f"{args.out}: {stats['rings']} rings, {stats['spans']} spans, "
          f"{stats['arrows']} cross-wire arrows"
          + (f"; UNALIGNED (no clock path): {', '.join(unaligned)}"
             if unaligned else ""))
    if problems:
        for p in problems[:20]:
            print(f"{args.out}: {p}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.tools.trace",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-check a Chrome trace dump")
    v.add_argument("file")
    s = sub.add_parser("summary", help="per-stage/kind latency table")
    s.add_argument("file")
    r = sub.add_parser(
        "run", help="run a self-driving pipeline string traced, dump JSON")
    r.add_argument("pipeline")
    r.add_argument("--out", default="trace.json")
    r.add_argument("--mode", default="ring", choices=["ring", "full"])
    r.add_argument("--timeout", type=float, default=120.0)
    m = sub.add_parser(
        "merge", help="join N per-process ring dumps into one Chrome "
        "trace (offset-corrected, cross-wire flow arrows)")
    m.add_argument("files", nargs="+")
    m.add_argument("--out", default="merged.json")
    args = ap.parse_args(argv)
    return {"validate": _cmd_validate, "summary": _cmd_summary,
            "run": _cmd_run, "merge": _cmd_merge}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
