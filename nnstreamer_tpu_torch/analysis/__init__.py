"""nns-lint: static pipeline verification.

Port of ``nnstreamer_tpu/analysis/__init__.py``.  The runtime surfaces
pipeline misconfigurations one at a time, mid-stream.  This package finds
them *before a pipeline ever starts*, with passes over the parsed
:class:`~..pipeline.graph.PipelineGraph` — no device, no model storage:

1. :mod:`.capsflow` — whole-graph caps/spec propagation through every
   edge, reporting EVERY incompatibility in one run with element-path
   diagnostics;
2. :mod:`.topology` — dangling refs, cycles, unreachable branches,
   collator arity, tee-diamond deadlock hazards;
3. :mod:`.purity` — the graph-break and host-sync lint over device_fns
   and registered pure filter functions (what a captured step cannot
   hold);
4. with ``deep=True``, :mod:`.tracecheck` — every device stage run on
   meta tensors, and the static memory and census report.

Entry points::

    report = analyze("appsrc ! tensor_converter ! tensor_sink")
    report.ok            # no errors
    print(report.render())

    nt.Pipeline(desc, validate=True)   # raises PipelineLintError on errors
    python -m nnstreamer_tpu_torch.tools.lint "<pipeline>"   # CLI

Package-level passes, over the port's own source rather than one
pipeline: :mod:`.concurrency` (``lint --threads``), and :mod:`.protocol`
with the :mod:`.statemachine` model checker (``lint --proto``, or
``analyze(desc, proto=True)``).
"""

from __future__ import annotations

from typing import Optional, Union

from ..pipeline.graph import PipelineGraph
from ..pipeline.parser import ParseError, parse
from .diagnostics import (  # noqa: F401
    Diagnostic,
    ERROR,
    PipelineLintError,
    Report,
    WARNING,
)


def analyze(
    pipeline: Union[str, PipelineGraph],
    *,
    caps: bool = True,
    topology: bool = True,
    purity: bool = True,
    proto: bool = False,
    queue_capacity: Optional[int] = None,
    deep: bool = False,
    batch_max: Optional[int] = None,
    batch_buckets: Optional[list] = None,
    adaptive_buckets: Optional[bool] = None,
    data_parallel: Optional[int] = None,
    model_parallel: Optional[int] = None,
    dispatch_depth: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    max_compiled_variants: Optional[int] = None,
    reconfig: Optional[dict] = None,
) -> Report:
    """Run the static passes; always returns a :class:`Report` (a syntax
    error becomes a single ``parse-error`` diagnostic rather than an
    exception, so tools can render every pipeline the same way).

    ``deep=True`` also runs the abstract-execution pass
    (:mod:`.tracecheck`): every device stage runs on meta tensors against
    the negotiated spec (shape/dtype contract violations, tracing
    failures) and a static memory/census report is attached as
    ``report.resources``.  No device is touched and no model storage is
    allocated.  The remaining keyword knobs parameterize its resource
    model and default to the global Config (``data_parallel`` and
    ``model_parallel`` are sized against ``parallel.mesh.local_devices()``,
    as the runtime's mesh is).

    ``proto=True`` adds the protocol pass's findings over the port's
    serving protocol modules (:func:`.protocol.lint_package`: the
    alphabet, handler totality, the unanswered-path proof and the
    model-vs-code drift gate) — a property of the package, not of this
    pipeline."""
    source = pipeline if isinstance(pipeline, str) else None
    report = Report(source)
    if isinstance(pipeline, str):
        try:
            graph = parse(pipeline, validate=False)
        except ParseError as e:
            report.add("parse-error", ERROR, str(e), pos=e.pos)
            return report
    else:
        graph = pipeline

    def run(name, fn):
        # report everything, never crash: a bug in one pass must not take
        # down the CLI or hide the other passes' findings
        try:
            report.extend(fn())
        except Exception as e:  # noqa: BLE001
            report.add("analyzer-error", ERROR,
                       f"{name} pass crashed: {e!r} — report this bug")

    if topology:
        from .topology import check_topology

        run("topology",
            lambda: check_topology(graph, queue_capacity=queue_capacity))
    caps_state = {}
    if caps:
        from .capsflow import propagate

        def _run_caps():
            diags, out_caps = propagate(graph)
            caps_state["out_caps"] = out_caps  # reused by the deep pass
            return diags

        run("capsflow", _run_caps)
    if purity:
        from .purity import lint_graph

        run("purity", lambda: lint_graph(graph))
    if proto:
        from . import protocol as _protocol

        def _run_proto():
            reports, _stats = _protocol.lint_package()
            return [d for rep in reports for d in rep]

        run("protocol", _run_proto)
    if deep:
        from .tracecheck import deep_check

        try:
            ddiags, resources = deep_check(
                graph, batch_max=batch_max, batch_buckets=batch_buckets,
                adaptive_buckets=adaptive_buckets,
                data_parallel=data_parallel, model_parallel=model_parallel,
                dispatch_depth=dispatch_depth,
                hbm_budget_bytes=hbm_budget_bytes,
                max_compiled_variants=max_compiled_variants,
                reconfig=reconfig,
                out_caps=caps_state.get("out_caps"))
            report.extend(ddiags)
            report.resources = resources
        except Exception as e:  # noqa: BLE001 - report, never crash
            report.add("analyzer-error", ERROR,
                       f"deep pass crashed: {e!r} — report this bug")
    return report
