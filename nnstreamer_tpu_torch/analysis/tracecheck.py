"""Deep analysis pass: abstract execution on meta tensors + a static
resource budget.

Port of ``nnstreamer_tpu/analysis/tracecheck.py``.  The syntactic passes
(capsflow/topology/purity) verify what elements *declare*.  This pass
verifies what their device code *actually does*: after capsflow
negotiation it runs every device-capable stage's real closure on meta
tensors (``torch.device("meta")``: shapes and dtypes, no storage) built
from the negotiated spec, with the model's parameters built on meta too
(:func:`~..filters.base.abstract_build`, ``zoo.build(device="meta")``),
and reports, in one run:

1. **shape/dtype contract violations** (``trace-shape-mismatch``): the
   traced output of a ``device_fn`` / framework ``pure_fn`` disagrees with
   the spec capsflow propagated downstream, with the field-level diff from
   :func:`~..core.caps.explain_mismatch`;
2. **tracing failures** (``trace-error``): what the meta run cannot do —
   ``.item()`` or another host read of a tensor, a data-dependent output
   shape, an arity or dtype bug — the errors a capture on the card would
   hit at the first buffer (and that the eager CPU path can hide), with
   the element path and source caret;
3. a **static resource report** (:class:`ResourceReport`): per-stage param
   bytes + abstract activation bytes, multiplied out over the bucket
   ladder (``pipeline/batching.ladder``) and the ``dispatch_depth``
   in-flight window — an estimated device-memory high-water mark per
   category and a census of captured steps, each checked against
   ``Config.hbm_budget_bytes`` / ``Config.max_compiled_variants``
   (``hbm-budget`` / ``recompile-budget`` warnings anchored at the
   dominant stage).

The pass touches no device: no storage is allocated on the card or the
host for a model (``tests/test_torch_deep_analysis.py`` pins it).  The
pipeline mesh is priced with the runtime's arithmetic
(``pipeline/plan.mesh_plan`` over ``parallel.mesh.local_devices()``):
shardable stages per slot (replica-rounded buckets, params whole on
every device as the runtime places them, their pspecs checked by
:func:`_pspec_audit`), the llm filter's weights and pool per slot, and the over-ask, ``model-divisibility`` and
``mesh-axis-missing`` diagnostics in the JAX package's words.  A
``tensor_trainer`` under a ``model`` axis raises
:class:`MultiDeviceNotPorted` (its ``mesh=`` is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.caps import Caps, explain_mismatch
from ..core.config import get_config
from ..core.types import TensorFormat, TensorSpec, TensorsSpec
from ..elements.base import Element, SINK, SRC
from ..filters.base import abstract_build
from ..pipeline.batching import ladder as bucket_ladder
from ..pipeline.graph import PipelineGraph
from ..pipeline.batching import shard_bucket_for, split_runs
from ..pipeline.plan import adaptive_variant_budget, mesh_plan
from ..pipeline.residency import FetchEdge, compute_floor_ms, fetch_ms
from .capsflow import SAFE_CONFIGURE, _element_class, _kahn_order, propagate
from .diagnostics import Diagnostic, ERROR, WARNING, node_label


class MultiDeviceNotPorted(ValueError):
    """A mesh the port does not carry yet: the trainer's ``mesh=`` (ROADMAP
    Queue A 6)."""


def _one_card(model_par: int, label: str) -> None:
    """A ``tensor_trainer`` runs on one slot: a ``model`` axis over 1
    raises, naming it."""
    if model_par > 1:
        raise MultiDeviceNotPorted(
            f"{label}: model_parallel={model_par}: the trainer's mesh= "
            "waits for ROADMAP Queue A 6; the port trains on one card")


def _mib(n: int) -> str:
    return f"{n / (1 << 20):.1f} MiB"


@dataclasses.dataclass
class StageResource:
    """Static resource estimate for one deep-traced stage (a device
    element, or a maximal linear chain the planner would fuse)."""

    label: str  # "a+b" for chains, mirroring FusedElement naming
    #: planned param bytes on the card
    param_bytes: int
    #: peak abstract activation bytes for ONE row (batch entry): max over
    #: the chain's links of input+output bytes
    act_row_bytes: int
    #: rows resident per device at the top of the bucket ladder
    rows_per_device: int
    #: captured steps this stage contributes (0 = host or eager path)
    variants: int
    batchable: bool = False
    #: would shard if a >1-wide data mesh existed (batchable, no host_post)
    shard_eligible: bool = False
    sharded: bool = False
    pos: Optional[int] = None  # source offset of the stage head
    #: paged KV block pool resident for the stage's lifetime (continuous
    #: LLM serving — filters/llm.py serving_plan)
    pool_bytes: int = 0
    #: device-resident aggregator ring carried between window dispatches
    #: (elements/aggregator.py device mode) — like the KV pool, resident
    #: for the stage's lifetime
    ring_bytes: int = 0
    #: device-resident TRAINING state (nns-learn, trainer/subplugin.py
    #: train_plan): optimizer moments + the streaming sample window,
    #: resident for the stage's lifetime; the transient per-step
    #: gradient tree is priced into act_row_bytes instead
    train_bytes: int = 0
    #: speculative-decoding draft model (continuous LLM serving,
    #: custom=draft:<preset>): INFORMATIONAL split of bytes ALREADY
    #: counted in param_bytes / pool_bytes above — the draft's params
    #: and its block pool (which shares the target allocator's
    #: n_blocks/block_size at the draft's own geometry).  Rendered in
    #: the report so "the draft is priced" is visible and gateable;
    #: excluded from hbm_bytes/by_category to avoid double counting.
    draft_param_bytes: int = 0
    draft_pool_bytes: int = 0
    #: sampler per-slot PRNG key state (continuous LLM serving with
    #: ``temperature > 0`` — serving_plan's ``prng_state_bytes``);
    #: tiny but ledger-reconciled like every resident category
    prng_bytes: int = 0
    #: per-step decode HBM TRAFFIC model (continuous LLM serving): K+V
    #: bytes the grouped-GQA kernel streams per live context token per
    #: decode step — priced at ``n_kv_heads`` (serving_plan's
    #: ``decode_bytes_per_ctx_token``); pricing at ``n_heads`` is the
    #: stale over-prediction the reconciliation regression pins.
    #: Traffic, not residency: excluded from ``hbm_bytes``.
    decode_bytes_per_ctx_token: int = 0
    #: query heads sharing one KV head's streamed blocks (H / Hkv)
    kv_groups: int = 1

    @property
    def hbm_bytes(self) -> int:
        """Per-device HBM this stage plans for: resident params + KV pool
        + aggregator ring + training state + sampler PRNG state +
        in-flight activations (dispatch window already multiplied into
        rows)."""
        return (self.param_bytes + self.pool_bytes + self.ring_bytes
                + self.train_bytes + self.prng_bytes
                + self.act_row_bytes * self.rows_per_device)


@dataclasses.dataclass
class ResourceReport:
    """The deep pass's static resource estimate for one pipeline."""

    stages: List[StageResource]
    batch_max: int
    data_parallel: int  # resolved replicas (1 = unsharded)
    model_parallel: int = 1
    dispatch_depth: int = 1
    ladder: Tuple[int, ...] = ()
    hbm_budget_bytes: int = 0
    max_compiled_variants: int = 0
    #: adaptive bucket ladder enabled: batchable stages are priced at
    #: their full mint budget (``ladder_budget`` programs each — the
    #: worst case the runtime's AdaptiveLadder can ever compile), so the
    #: census stays closed by construction
    adaptive_buckets: bool = False
    ladder_budget: int = 0
    #: planned D2H per sink edge (pipeline/residency.py): what actually
    #: crosses to host per buffer, priced against the calibrated link
    #: when one is configured (Config.link_d2h_mbps)
    fetch_edges: List[FetchEdge] = dataclasses.field(default_factory=list)
    link_d2h_mbps: float = 0.0
    link_rtt_ms: float = 0.0

    @property
    def hbm_estimate(self) -> int:
        return sum(s.hbm_bytes for s in self.stages)

    @property
    def compiled_variants(self) -> int:
        return sum(s.variants for s in self.stages)

    def by_category(self) -> Dict[str, int]:
        """The HBM estimate split per ledger category — what nns-xray's
        runtime HBM ledger reconciles measured bytes against
        (utils/xray.py, docs/OBSERVABILITY.md "Predicted vs actual")."""
        return {
            "params": sum(s.param_bytes for s in self.stages),
            "kv_pool": sum(s.pool_bytes for s in self.stages),
            "agg_rings": sum(s.ring_bytes for s in self.stages),
            "activations": sum(s.act_row_bytes * s.rows_per_device
                               for s in self.stages),
            "train_state": sum(s.train_bytes for s in self.stages),
            "prng_state": sum(s.prng_bytes for s in self.stages),
        }

    def summary(self) -> str:
        return (f"{len(self.stages)} device stage(s), est HBM high-water "
                f"{_mib(self.hbm_estimate)}"
                + (f" (budget {_mib(self.hbm_budget_bytes)})"
                   if self.hbm_budget_bytes else "")
                + f", {self.compiled_variants} compiled signature(s)"
                + (f" (max {self.max_compiled_variants})"
                   if self.max_compiled_variants else ""))

    def render(self) -> str:
        lines = [
            "deep resource report "
            f"(batch_max={self.batch_max}, "
            f"buckets={','.join(map(str, self.ladder))}, "
            + (f"adaptive (budget {self.ladder_budget}/stage), "
               if self.adaptive_buckets else "")
            + f"data_parallel={self.data_parallel}, "
            f"model_parallel={self.model_parallel}, "
            f"dispatch_depth={self.dispatch_depth})"
        ]
        if not self.stages:
            lines.append("  no device stages traced")
        for s in self.stages:
            flags = "".join(
                f for f, on in (("B", s.batchable), ("S", s.sharded)) if on)
            lines.append(
                f"  {s.label}: params {_mib(s.param_bytes)}"
                + (f" (draft params {_mib(s.draft_param_bytes)})"
                   if s.draft_param_bytes else "")
                + ", "
                + (f"kv pool {_mib(s.pool_bytes)}"
                   + (f" (draft pool {_mib(s.draft_pool_bytes)})"
                      if s.draft_pool_bytes else "")
                   + ", " if s.pool_bytes else "")
                + (f"agg ring {_mib(s.ring_bytes)}, " if s.ring_bytes
                   else "")
                + (f"train state {_mib(s.train_bytes)}, " if s.train_bytes
                   else "")
                + (f"prng state {s.prng_bytes} B, " if s.prng_bytes
                   else "")
                + (f"decode traffic {s.decode_bytes_per_ctx_token} "
                   f"B/ctx-token (x{s.kv_groups} KV sharing), "
                   if s.decode_bytes_per_ctx_token and s.kv_groups > 1
                   else "")
                + f"act/row {_mib(s.act_row_bytes)}, "
                f"rows/dev {s.rows_per_device}, "
                f"programs {s.variants}"
                + (f" [{flags}]" if flags else ""))
        for e in self.fetch_edges:
            size = "?" if e.bytes_per_buffer < 0 else f"{e.bytes_per_buffer} B"
            via = f" via {e.reduced}" if e.reduced else ""
            priced = ""
            if self.link_d2h_mbps > 0 and e.bytes_per_buffer >= 0:
                # the RTT is shown but excluded from d2h_ms and the
                # fetch-bound decision: it amortizes behind the async
                # fetch window, link occupancy cannot (docs/FETCH.md)
                rtt = (f" + {self.link_rtt_ms:g} ms rtt/pull"
                       if self.link_rtt_ms > 0 else "")
                priced = (f" (d2h {e.d2h_ms:.2f} ms on "
                          f"{self.link_d2h_mbps:g} MB/s{rtt} vs compute "
                          f"floor {e.compute_floor_ms:.2f} ms)")
            lines.append(
                f"  fetch {e.sink} <- {e.producer}: {size}/buffer"
                f"{via}{priced}")
        lines.append("  totals: " + self.summary())
        return "\n".join(lines)


@dataclasses.dataclass
class _NodeTrace:
    """Per-node result of the abstract execution walk."""

    node: object
    element: Element
    in_bytes: int
    out_bytes: int
    param_bytes: int
    batchable: bool
    host_post: bool
    linear: bool  # single default-pad in/out edges (fusion-chain eligible)


def _trace_msg(e: BaseException) -> str:
    first = str(e).strip().splitlines()
    head = first[0] if first else repr(e)
    if len(head) > 300:
        head = head[:297] + "..."
    return f"{type(e).__name__}: {head}"


def _static(spec: TensorsSpec) -> TensorsSpec:
    return spec if spec.format == TensorFormat.STATIC else spec.replace(
        format=TensorFormat.STATIC)


def deep_check(
    graph: PipelineGraph,
    *,
    batch_max: Optional[int] = None,
    batch_buckets: Optional[List[int]] = None,
    adaptive_buckets: Optional[bool] = None,
    data_parallel: Optional[int] = None,
    model_parallel: Optional[int] = None,
    dispatch_depth: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    max_compiled_variants: Optional[int] = None,
    link_d2h_mbps: Optional[float] = None,
    link_rtt_ms: Optional[float] = None,
    reconfig: Optional[Dict] = None,
    out_caps: Optional[Dict] = None,
) -> Tuple[List[Diagnostic], ResourceReport]:
    """Run the deep pass over a parsed graph.  Knobs default to the global
    :class:`~..core.config.Config` the runtime would use, so the report
    predicts what an actual ``Pipeline(desc)`` would plan.
    ``out_caps`` lets the caller hand over an existing capsflow
    :func:`propagate` result instead of re-running negotiation."""
    cfg = get_config()
    batch_max = max(1, batch_max if batch_max is not None else cfg.batch_max)
    # Normalize like BatchRunner does (sorted unique ascending):
    # bucket_for scans in order, so a raw [8,2,4] would collapse the
    # census to the first listed bucket and diverge from the runtime.
    buckets = list(batch_buckets if batch_buckets is not None
                   else cfg.batch_buckets) or None
    if buckets:
        buckets = sorted(set(buckets))
    adaptive = bool(adaptive_buckets if adaptive_buckets is not None
                    else cfg.adaptive_buckets)
    dp_knob = max(0, data_parallel if data_parallel is not None
                  else cfg.data_parallel)
    mp_knob = max(0, model_parallel if model_parallel is not None
                  else cfg.model_parallel)
    dispatch_depth = max(1, dispatch_depth if dispatch_depth is not None
                         else cfg.dispatch_depth)
    hbm_budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                  else cfg.hbm_budget_bytes)
    max_variants = (max_compiled_variants if max_compiled_variants is not None
                    else cfg.max_compiled_variants)
    d2h_mbps = float(link_d2h_mbps if link_d2h_mbps is not None
                     else cfg.link_d2h_mbps)
    rtt_ms = float(link_rtt_ms if link_rtt_ms is not None
                   else cfg.link_fetch_rtt_ms)

    from ..parallel.mesh import local_devices, one_device_slots

    # what Pipeline._shared_mesh sizes against (no device is touched)
    slots = local_devices()
    n_devices = len(slots)
    req_dp, req_mp = mesh_plan(dp_knob, mp_knob, batch_max, n_devices,
                               absorb=one_device_slots(slots))
    # model what could run; the over-ask itself is a diagnostic below
    model_par = min(req_mp, n_devices)
    replicas = min(req_dp, max(1, n_devices // model_par))
    requested = req_dp
    diags: List[Diagnostic] = []
    if out_caps is None:
        # capsflow's own diagnostics are the syntactic pass's to report;
        # here we only need the negotiated specs
        _, out_caps = propagate(graph)

    traces: Dict[int, _NodeTrace] = {}
    serving_stages: List[StageResource] = []
    for node in _kahn_order(graph):
        serving = _llm_serving_stage(node, diags, model_par)
        if serving is not None:
            # continuous LLM serving is priced STATICALLY (building the
            # element would materialize the full parameter set); True =
            # a serving stage that couldn't be priced, already diagnosed
            if isinstance(serving, StageResource):
                serving_stages.append(serving)
            continue
        train = _trainer_stage(node, diags, req_mp)
        if train is not None:
            # tensor_trainer: priced statically via the runtime's own
            # train_plan arithmetic (the model built on meta).  The
            # element is stateful (device window + opt moments), so the
            # generic stateless walk must skip it either way.
            if isinstance(train, StageResource):
                serving_stages.append(train)
            continue
        ring = _aggregator_stage(graph, node, out_caps, diags)
        if ring is not None:
            # device-resident aggregator (elements/aggregator.py device
            # mode): its ring is priced here; the element itself is
            # stateful, so the generic (stateless) trace walk must skip it
            if isinstance(ring, StageResource):
                serving_stages.append(ring)
            continue
        got = _trace_node(graph, node, out_caps, diags, model_par)
        if got is not None:
            traces[node.id] = got

    report = _resources(graph, traces, batch_max=batch_max, buckets=buckets,
                        replicas=replicas, model_par=model_par,
                        dispatch_depth=dispatch_depth,
                        hbm_budget=hbm_budget, max_variants=max_variants,
                        adaptive=adaptive)
    report.stages.extend(serving_stages)
    report.link_d2h_mbps = d2h_mbps
    report.link_rtt_ms = rtt_ms
    if reconfig:
        diags.extend(_reconfig_check(graph, reconfig))
    diags.extend(_fetch_check(graph, traces, out_caps, report))
    for t in traces.values():
        # Throwaway trace elements may hold real checkpoints (configure()
        # opened the framework) — release them now, not at GC.
        try:
            t.element.stop()
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass
    # exactly when the runtime builds the mesh (a model axis configured,
    # or a shardable stage with batching on), an over-asked plan fails
    # start() (or the llm filter's open()) with this arithmetic
    if requested * req_mp > n_devices and (
            mp_knob != 1
            or (batch_max > 1
                and any(s.shard_eligible for s in report.stages))):
        top = next((s for s in report.stages if s.shard_eligible), None)
        if requested > 1 and req_mp > 1:
            plan = f"data_parallel={requested} x model_parallel={req_mp}"
        elif req_mp > 1:
            plan = f"model_parallel={req_mp}"
        else:
            plan = f"data_parallel={requested}"
        diags.append(Diagnostic(
            "data-parallel-devices", ERROR,
            f"{plan} needs {requested * req_mp} local devices, "
            f"have {n_devices} — start() will fail with PipelineError",
            path=top.label if top else "",
            pos=top.pos if top else None))
    diags.extend(_budget_diags(report))
    return diags, report


#: tensor_filter ``framework=`` names that resolve to the llm framework
_LLM_FRAMEWORKS = ("llm", "llamacpp", "llama.cpp")


def _reconfig_check(graph, reconfig: Dict) -> List[Diagnostic]:
    """``recompile-on-reconfig``: given a proposed runtime config change
    (``analyze(..., reconfig={"slots": 8})`` / ``lint --reconfig``),
    warn for every continuous-serving knob whose change would actually
    change a COMPILED program signature — the table lives in
    ``utils/elastic.SERVE_KNOB_SIGNATURE`` (slots is the decode
    program's row count, kv_blocks the pool's static shape, temperature
    a compiled-in sampler constant, ...).  Host-value knobs (max_new,
    prefill_budget, quotas, timeouts) pass silently: they are safe to
    mutate on a running loop.  The remediation for a flagged knob is the
    elastic drain path: ``Pipeline.drain_stream()`` every live stream →
    restart with the new (versioned) config → ``adopt_stream()`` —
    docs/SERVING.md "Elastic serving"."""
    from ..filters.base import parse_custom_options
    from ..utils.elastic import SERVE_KNOB_SIGNATURE, signature_changes

    diags: List[Diagnostic] = []
    first_serving = None
    for node in graph.nodes.values():
        if node.kind != "tensor_filter":
            continue
        if str(node.props.get("framework", "")).lower() \
                not in _LLM_FRAMEWORKS:
            continue
        opts = parse_custom_options(str(node.props.get("custom", "")))
        if str(opts.get("serve", "")).lower() != "continuous":
            continue
        if first_serving is None:
            first_serving = node
        for knob, old, new in signature_changes(opts, reconfig):
            diags.append(Diagnostic(
                "recompile-on-reconfig", WARNING,
                f"changing {knob}: "
                f"{'<default>' if old is None else old} -> {new} changes "
                "a compiled program signature (the standing loop's "
                "census is static in it) — a live mutation would "
                "recompile mid-serve; apply it behind a drain instead: "
                "Pipeline.drain_stream() each live stream, restart with "
                "the versioned config, adopt_stream() them back "
                "(docs/SERVING.md 'Elastic serving')",
                path=node_label(node), pos=node.pos))
    # node-independent: one finding per run, not one per serving filter
    unknown = [k for k in reconfig if k not in SERVE_KNOB_SIGNATURE]
    if unknown and first_serving is not None:
        diags.append(Diagnostic(
            "recompile-on-reconfig", WARNING,
            f"reconfig knob(s) {sorted(unknown)} are not in the "
            "documented runtime-mutable table "
            "(utils/elastic.SERVE_KNOB_SIGNATURE) — signature "
            "impact unknown, treat as recompile-requiring",
            path=node_label(first_serving), pos=first_serving.pos))
    return diags


def _llm_serving_stage(node, diags, model_par: int = 1):
    """Price a ``serve:continuous`` llm filter statically.

    Returns ``None`` when the node is not a continuous-serving llm
    filter, a :class:`StageResource` when priced, or ``True`` when it IS
    one but could not be priced (diagnostic already appended) — either
    way a non-None result means the generic trace walk must skip the
    node: the standing loop's programs have a CLOSED census by
    construction (``serving_plan``), so the ``invoke-dynamic`` flag that
    normally means "recompile per signature" does not apply; and
    building the element to trace it would materialize the full
    parameter set, which at 7B is exactly what a static pass must never
    do.

    The paged decode signature is static in every admission-state
    dimension (block tables / positions / occupancy change VALUES only).
    If the serving knobs themselves cannot be resolved to ints — the one
    way the signature could come to depend on occupancy — the stage gets
    the ``recompile-unbounded`` warning the census cannot bound."""
    if node.kind != "tensor_filter":
        return None
    if str(node.props.get("framework", "")).lower() not in _LLM_FRAMEWORKS:
        return None
    from ..filters.base import parse_custom_options

    opts = parse_custom_options(str(node.props.get("custom", "")))
    if str(opts.get("serve", "")).lower() != "continuous":
        return None
    label = node_label(node)
    from ..models import llama

    model = str(node.props.get("model") or "llama_tiny")
    cfg = llama.resolve_config(model, opts)
    if cfg is None:
        diags.append(Diagnostic(
            "serving-unpriced", WARNING,
            f"serve:continuous with model {model!r}: the config lives in "
            "the checkpoint file, which a static pass must not open — "
            "the paged KV pool cannot be priced (use a preset model name "
            "to budget it statically)",
            path=label, pos=node.pos))
        return True
    try:
        slots = int(opts.get("slots", 4))
        plan_kw = dict(
            slots=slots,
            block_size=max(1, int(opts.get("block_size", 16))),
            kv_blocks=max(0, int(opts.get("kv_blocks", 0))),
            prefill_chunk=max(1, int(opts.get("prefill_chunk", 32))),
        )
        int(opts.get("stream_chunk", 8))  # the decode chunk length
        spec_k = max(1, int(opts.get("spec_k", 4)))
        temperature = float(opts.get("temperature", 0.0))
    except (TypeError, ValueError):
        diags.append(Diagnostic(
            "recompile-unbounded", WARNING,
            "continuous decode signature depends on unresolvable serving "
            "knobs (slots/block_size/prefill_chunk/stream_chunk/spec_k "
            "must be integer literals) — the compiled-variant census "
            "cannot bound this stage",
            path=label, pos=node.pos))
        return True
    # Speculative decoding: the draft's params + its block pool (same
    # allocator geometry as the target's) are resident for the stage
    # lifetime — price them with the SAME shared arithmetic the loop
    # sizes with (serving_plan), and the census of captured steps grows
    # 1 -> 2 (propose and verify in place of the decode step).
    draft_name = str(opts.get("draft", "") or "")
    draft_cfg = None
    if draft_name:
        draft_cfg = llama.resolve_config(draft_name, {
            "vocab": cfg.vocab, "max_seq": cfg.max_seq})
        if draft_cfg is None:
            diags.append(Diagnostic(
                "serving-unpriced", WARNING,
                f"draft model {draft_name!r} cannot be resolved "
                "statically — the llm filter's open() only accepts "
                "preset zoo names for draft: and will fail; the draft "
                "params/pool cannot be priced",
                path=label, pos=node.pos))
    from ..filters.llm import serving_plan

    dtype = str(opts.get("dtype", "bfloat16"))
    plan = serving_plan(cfg, dtype=dtype, draft_cfg=draft_cfg,
                        spec_k=spec_k, temperature=temperature,
                        **plan_kw)
    quant = str(opts.get("quant", "")).lower()
    param_dtype = str(opts.get("param_dtype", "float32"))
    # tensor parallelism: the pipeline's model axis, or custom=tp: when
    # the pipeline knob is off (the runtime promotes it the same way)
    ways = model_par
    if ways <= 1:
        try:
            ways = max(1, int(opts.get("tp", 1)))
        except (TypeError, ValueError):
            ways = 1
    params = llama.param_bytes_estimate(cfg, quant=quant,
                                        param_dtype=param_dtype)
    pool = plan["pool_bytes"]
    draft_params = (llama.param_bytes_estimate(
        draft_cfg, param_dtype=param_dtype)
        if draft_cfg is not None else 0)
    draft_pool = plan["draft_pool_bytes"]
    if ways > 1:
        problems = llama.tp_divisibility_problems(cfg, ways)
        if draft_cfg is not None:
            problems += [f"draft {p}" for p in
                         llama.tp_divisibility_problems(draft_cfg, ways)]
        if problems:
            # open() raises the same arithmetic at runtime
            diags.append(Diagnostic(
                "model-divisibility", ERROR,
                f"model geometry does not divide model_parallel={ways}: "
                + "; ".join(problems)
                + " — the llm filter's open() will fail",
                path=label, pos=node.pos))
        else:
            # per slot: the cut mats and the lm_head divide by M, embed
            # and norms are whole; the pool is cut by kv head
            shard, repl = llama.param_bytes_split(cfg, quant=quant,
                                                  param_dtype=param_dtype)
            params = shard // ways + repl
            pool = pool // ways
            if draft_cfg is not None:
                dsh, drep = llama.param_bytes_split(
                    draft_cfg, param_dtype=param_dtype)
                draft_params = dsh // ways + drep
                draft_pool = draft_pool // ways
    # Per-slot in-flight activations of the decode step: the f32 logits
    # row dominates ([vocab] per slot per scan step — the k+1-wide
    # verify step multiplies it by spec_k+1 under speculation), plus
    # the hidden state at a couple of residencies — a deliberate
    # over-estimate that stays O(vocab + dim), nowhere near pool/param
    # scale.
    act_row = (4 * cfg.vocab * (spec_k + 1 if draft_cfg is not None
                                else 1) + 8 * cfg.dim)
    return StageResource(
        label=label, param_bytes=params + draft_params,
        act_row_bytes=act_row,
        rows_per_device=slots, variants=plan["programs"],
        batchable=False, shard_eligible=False, sharded=ways > 1,
        pos=node.pos, pool_bytes=pool + draft_pool,
        draft_param_bytes=draft_params, draft_pool_bytes=draft_pool,
        prng_bytes=plan["prng_state_bytes"],
        decode_bytes_per_ctx_token=plan["decode_bytes_per_ctx_token"],
        kv_groups=plan["kv_groups"])


def _trainer_stage(node, diags, model_par: int = 1):
    """Price a ``tensor_trainer`` stage statically.

    Returns ``None`` when the node is not a trainer of this package's
    ``jax``-named sub-plugin (the JAX package's name, kept), a
    :class:`StageResource` when priced, or
    ``True`` when it is one but could not be priced (diagnostic
    appended).  The arithmetic is the runtime's own
    :func:`~..trainer.subplugin.train_plan` (the ``serving_plan``
    discipline): param bytes from the model built on meta, the
    optimizer's per-parameter state, the card-resident window, and one
    gradient tree (activation-class).  The census is the trainer's
    :data:`~..trainer.subplugin.TRAINER_PROGRAMS` captured steps (update
    step and eval), held live by xray."""
    if node.kind != "tensor_trainer":
        return None
    fw = str(node.props.get("framework", "jax")).lower()
    if fw != "jax":
        return None
    label = node_label(node)
    _one_card(model_par, label)
    from ..trainer.subplugin import train_plan

    try:
        plan = train_plan(dict(node.props))
    except Exception:  # noqa: BLE001 - unpriceable model config
        plan = None
    if plan is None:
        diags.append(Diagnostic(
            "training-unpriced", WARNING,
            f"tensor_trainer model {node.props.get('model')!r} cannot be "
            "resolved statically — optimizer-state/gradient HBM cannot "
            "be priced (use mlp:IN:...:OUT or a preset zoo name)",
            path=label, pos=node.pos))
        return True
    return StageResource(
        label=label, param_bytes=plan["param_bytes"],
        act_row_bytes=plan["grad_bytes"],  # one gradient tree per step
        rows_per_device=1, variants=plan["programs"],
        batchable=False, shard_eligible=False, sharded=False,
        pos=node.pos, train_bytes=plan["opt_bytes"] + plan["window_bytes"])


#: captured steps a device-mode aggregator runs for its life: none.  The
#: port's ring (elements/aggregator.py) is one allocation of two slots and
#: a fixed launch count a buffer (one append copy, and per window a
#: copy-out and a compaction), eager on the card; the JAX package's ring
#: is three jitted programs.
AGGREGATOR_PROGRAMS = 0


def _aggregator_stage(graph, node, out_caps, diags):
    """Price a ``tensor_aggregator device=true`` stage statically.

    Returns ``None`` when the node is not a device-mode aggregator, a
    :class:`StageResource` when priced, or ``True`` when it is one but
    the upstream spec is unknown/flexible (diagnosed: the device ring
    needs a static window signature).  The ring is resident for the
    stage's lifetime: two slots of ``(frames_out + frames_in)`` frames
    (``need + step``; a window's compaction copies from one slot into the
    other), and one window a buffer in flight; the census is
    :data:`AGGREGATOR_PROGRAMS`."""
    if node.kind != "tensor_aggregator":
        return None
    if str(node.props.get("device", "")).lower() not in ("true", "1", "yes"):
        return None
    label = node_label(node)
    ins = graph.in_edges(node.id)
    up = out_caps.get((ins[0].src, ins[0].src_pad)) if len(ins) == 1 else None
    spec = up.spec if up is not None else None
    if spec is None or spec.is_flexible or len(spec) != 1:
        diags.append(Diagnostic(
            "recompile-unbounded", WARNING,
            "tensor_aggregator device=true needs ONE static upstream "
            "tensor spec: the HBM ring's shape (and its zero-recompile "
            "pin) derive from it — a flexible stream would re-specialize "
            "the ring programs per signature",
            path=label, pos=node.pos))
        return True
    try:
        frames_in = max(1, int(node.props.get("frames_in", 1)))
        frames_out = max(1, int(node.props.get("frames_out", 1)))
    except (TypeError, ValueError):
        frames_in = frames_out = 1
    in_bytes = int(spec.nbytes)
    frame_bytes = in_bytes // frames_in
    # carry capacity is need + step frames (elements/aggregator.py):
    # valid can reach need-1 before an append of step more
    ring = 2 * (frames_out + frames_in) * frame_bytes
    out_bytes = frames_out * frame_bytes
    return StageResource(
        label=label, param_bytes=0, act_row_bytes=in_bytes + out_bytes,
        rows_per_device=1, variants=AGGREGATOR_PROGRAMS,
        batchable=False, shard_eligible=False, sharded=False,
        pos=node.pos, ring_bytes=ring)


class _CapsIdentity:
    """Stand-in element for a fused-through capsfilter in the census walk
    (the runtime's ``_CapsFilter.device_fn`` identity, mirrored so chain
    merging — and therefore the recompile census and HBM estimate —
    agrees with what ``plan_stages`` actually fuses)."""

    name = "capsfilter"
    host_post = None

    def stop(self) -> None:
        pass


def _capsfilter_trace(graph, node, out_caps) -> Optional[_NodeTrace]:
    """Transparent-identity trace for a mid-chain caps pin: the planner
    fuses THROUGH capsfilters on static tensor streams (they are
    negotiation-time constraints, not runtime transforms), so the census
    walk must see them as zero-param, zero-new-activation chain links —
    not as chain breaks that would split one fused program into two and
    double-count its bucket ladder."""
    ins = graph.in_edges(node.id)
    outs = graph.out_edges(node.id)
    if len(ins) != 1 or ins[0].dst_pad != SINK:
        return None
    up = out_caps.get((ins[0].src, ins[0].src_pad))
    spec = up.spec if up is not None else None
    if spec is None or spec.is_flexible:
        return None  # nothing static to pin: stays a host pass-through
    down = out_caps.get((node.id, SRC))
    out_spec = (down.spec if down is not None else None) or spec
    linear = (len(outs) <= 1 and all(e.src_pad == SRC for e in outs))
    return _NodeTrace(
        node=node, element=_CapsIdentity(), in_bytes=spec.nbytes,
        out_bytes=int(out_spec.nbytes), param_bytes=0, batchable=False,
        host_post=False, linear=linear)


def _pspec_audit(params, pspecs, model_par: int, label, pos,
                 diags: List[Diagnostic]) -> None:
    """Audit a bundle's ``param_pspecs`` against its leaves under a
    ``model_parallel=model_par`` plan, as the runtime's placement checks
    them (``parallel.sharding.check_pspecs``): appends
    ``mesh-axis-missing`` (a spec names an axis the ``(data x model)``
    mesh lacks) and ``model-divisibility`` (a cut dim does not divide),
    both only when the plan cuts over ``model``.  Pairing and axes ride
    the runtime's walk (``parallel.sharding.iter_param_specs``)."""
    from ..parallel.sharding import iter_param_specs, spec_entry_axes

    bad_axes: set = set()
    bad_dims: List[str] = []
    for path, p, s in iter_param_specs(params, pspecs):
        shape = tuple(getattr(p, "shape", ()) or ())
        for i, entry in enumerate(s or ()):
            for a in spec_entry_axes(entry):
                if a == "model":
                    if i < len(shape) and shape[i] % model_par:
                        bad_dims.append(f"{path}[{i}]={shape[i]}")
                elif a != "data":
                    bad_axes.add(str(a))
    if model_par > 1 and bad_axes:
        diags.append(Diagnostic(
            "mesh-axis-missing", WARNING,
            f"param_pspecs name mesh axes {sorted(bad_axes)} that the "
            "pipeline's (data x model) mesh does not carry — those "
            "leaves cannot place at the first sharded dispatch "
            "(valid placement axes: 'data', 'model')",
            path=label, pos=pos))
    if model_par > 1 and bad_dims:
        shown = ", ".join(bad_dims[:4]) + (", ..." if len(bad_dims) > 4
                                           else "")
        diags.append(Diagnostic(
            "model-divisibility", ERROR,
            f"param dims sharded over 'model' do not divide "
            f"model_parallel={model_par}: {shown} — placement will fail",
            path=label, pos=pos))


def _trace_node(graph, node, out_caps, diags,
                model_par: int = 1) -> Optional[_NodeTrace]:
    """Abstractly execute one node's device path; returns its trace record
    (for resource accounting) or None when the node has no device path."""
    if node.kind == "capsfilter":
        return _capsfilter_trace(graph, node, out_caps)
    cls = _element_class(node.kind)
    if cls is None or cls.device_fn is Element.device_fn:
        return None
    ins = graph.in_edges(node.id)
    if len(ins) != 1 or ins[0].dst_pad != SINK:
        return None  # device paths are single-sink by construction
    up = out_caps.get((ins[0].src, ins[0].src_pad))
    spec = up.spec if up is not None else None
    if spec is None:
        return None  # nothing negotiated to derive abstract inputs from
    label = node_label(node)
    if spec.is_flexible or bool(node.props.get("invoke_dynamic", False)):
        diags.append(Diagnostic(
            "recompile-unbounded", WARNING,
            "flexible/per-buffer shapes re-specialize the compiled program "
            "per signature — the recompile census cannot bound this stage "
            "(bucket flexible streams, or declare a static spec)",
            path=label, pos=node.pos))
        return None
    if node.kind not in SAFE_CONFIGURE and node.kind != "tensor_filter":
        return None  # configure touches the outside world: not traceable
    try:
        with abstract_build():
            el = cls(dict(node.props),
                     name=node.name or f"{node.kind}{node.id}")
    except Exception:  # noqa: BLE001 - capsflow already diagnosed this
        return None
    out_pads = sorted(
        {e.src_pad for e in graph.out_edges(node.id)}) or [SRC]
    try:
        # the framework opens on the meta device: its model is built
        # there, no storage anywhere
        with abstract_build():
            produced = el.configure({SINK: up}, list(out_pads))
    except Exception:  # noqa: BLE001 - capsflow already diagnosed this
        return None
    # The real configure is strictly better informed than capsflow's
    # static transfer (it loads the framework and learns model I/O the
    # props never declared) — feed ITS caps to downstream nodes so the
    # whole deep walk sees what the runtime would negotiate.
    for pad in out_pads:
        got = produced.get(pad)
        if got is not None:
            out_caps[(node.id, pad)] = got

    try:
        with abstract_build():
            got = el.abstract_invoke(spec)
    except Exception as e:  # noqa: BLE001 - the finding, not a crash
        diags.append(Diagnostic(
            "trace-error", ERROR,
            f"abstract execution failed: {_trace_msg(e)}",
            path=label, pos=node.pos))
        return None
    if got is None:
        return None
    traced_sds, declared = got
    try:
        traced = TensorsSpec(tuple(
            TensorSpec.from_shape(tuple(s.shape), s.dtype)
            for s in traced_sds))
    except Exception as e:  # noqa: BLE001 - not tensors: the finding
        diags.append(Diagnostic(
            "trace-error", ERROR,
            f"abstract execution returned no tensors: {_trace_msg(e)}",
            path=label, pos=node.pos))
        return None

    # The contract: what the trace produces must be what capsflow told
    # downstream to expect (falling back to the element's own declared
    # out spec when propagation had nothing static).
    down = out_caps.get((node.id, SRC))
    ref = (down.spec if down is not None else None) or declared
    if ref is not None and not ref.is_flexible \
            and not traced.is_compatible(_static(ref)):
        diags.append(Diagnostic(
            "trace-shape-mismatch", ERROR,
            "traced output disagrees with the negotiated downstream spec: "
            + explain_mismatch(Caps.tensors(traced), Caps.tensors(_static(ref))),
            path=f"{label}:src", pos=node.pos))

    try:
        params = int(el.param_bytes())
    except Exception:  # noqa: BLE001 - accounting probe only
        params = 0
    # the placement audit: the axis / divisibility diagnostics, on the
    # meta tree (the params are priced whole: the runtime places them so)
    try:
        bundle = getattr(getattr(el, "fw", None), "bundle", None)
        pspecs = getattr(bundle, "param_pspecs", None)
        if pspecs is not None and bundle.params is not None:
            _pspec_audit(bundle.params, pspecs, model_par,
                         node_label(node), node.pos, diags)
    except Exception:  # noqa: BLE001 - accounting probe only
        pass
    try:
        batchable = bool(el.batch_capable())
    except Exception:  # noqa: BLE001 - capability probe only
        batchable = False
    outs = graph.out_edges(node.id)
    linear = (len(outs) <= 1 and all(e.src_pad == SRC for e in outs))
    return _NodeTrace(
        node=node, element=el, in_bytes=spec.nbytes, out_bytes=traced.nbytes,
        param_bytes=params, batchable=batchable,
        host_post=getattr(el, "host_post", None) is not None, linear=linear)


def _resources(graph, traces: Dict[int, _NodeTrace], *, batch_max, buckets,
               replicas, model_par, dispatch_depth, hbm_budget, max_variants,
               adaptive: bool = False) -> ResourceReport:
    """Merge traced nodes into planner-shaped stages (maximal linear chains
    fuse into ONE program, exactly the plan_stages rule) and multiply the
    per-stage estimates over the bucket ladder / replication plan."""
    lad = bucket_ladder(batch_max, buckets)
    chains: List[List[_NodeTrace]] = []
    consumed: set = set()
    for nid in traces:
        if nid in consumed:
            continue
        chain = [traces[nid]]
        consumed.add(nid)
        cur = nid
        while True:
            t = traces[cur]
            outs = graph.out_edges(cur)
            if not t.linear or len(outs) != 1:
                break
            nxt = outs[0].dst
            nt = traces.get(nxt)
            if (nt is None or nxt in consumed or not nt.linear
                    or outs[0].dst_pad != SINK
                    or len(graph.in_edges(nxt)) != 1):
                break
            chain.append(nt)
            consumed.add(nxt)
            cur = nxt
        chains.append(chain)

    stages: List[StageResource] = []
    for chain in chains:
        fused = len(chain) > 1
        # an unfused element without a batch path runs .process on HOST —
        # it compiles nothing and keeps nothing in HBM
        device = fused or chain[0].batchable \
            or chain[0].node.kind == "tensor_filter"
        if not device:
            continue
        batchable = fused or chain[0].batchable
        host_post = chain[-1].host_post
        shard_eligible = batchable and not host_post
        # the mesh reaches shardable stages only with batching on (the
        # runtime attaches it to runners with batch_max > 1)
        sharded = shard_eligible and batch_max > 1 and (
            replicas > 1 or model_par > 1)
        # a lone element outside the batching path runs its invoke
        # eagerly (ROADMAP Queue B 5): nothing is captured for it
        n_buckets = 1 if fused else 0
        rows = 1
        window = 1
        if batchable and batch_max > 1:
            window = dispatch_depth  # in-flight micro-batches per runner
            if sharded:
                # one captured step per bucket and slot with rows (the
                # JAX package: one program per bucket); rows per slot
                sb = sorted({shard_bucket_for(b, replicas, buckets)
                             for b in lad})
                n_buckets = sum(replicas * sum(1 for k in split_runs(
                    b // replicas, model_par) if k) for b in sb)
                rows = split_runs(sb[-1] // replicas, model_par)[0]
            else:
                n_buckets = len(lad)
                rows = lad[-1]
        stages.append(StageResource(
            label="+".join(t.element.name for t in chain),
            param_bytes=sum(t.param_bytes for t in chain),
            act_row_bytes=max(t.in_bytes + t.out_bytes for t in chain),
            rows_per_device=rows * window,
            variants=n_buckets,
            batchable=batchable, shard_eligible=shard_eligible,
            sharded=sharded, pos=chain[0].node.pos))
    ladder_budget = 0
    if adaptive and batch_max > 1:
        # Worst-case census under the adaptive ladder: every batchable
        # stage priced at its full mint budget — the SAME arithmetic the
        # runtime hands each stage's AdaptiveLadder (plan.py), so minting
        # can never compile past what this report charged.  Minted sizes
        # never exceed the ladder top, so rows/HBM are unchanged.
        ladder_budget = adaptive_variant_budget(
            len(lad), sum(1 for s in stages if s.batchable),
            int(max_variants or 0))
        for s in stages:
            if s.batchable:
                s.variants = max(s.variants, ladder_budget)
    return ResourceReport(
        stages=stages, batch_max=batch_max, data_parallel=replicas,
        model_parallel=model_par, dispatch_depth=dispatch_depth, ladder=lad,
        hbm_budget_bytes=int(hbm_budget or 0),
        max_compiled_variants=int(max_variants or 0),
        adaptive_buckets=adaptive, ladder_budget=ladder_budget)


def _fetch_check(graph, traces: Dict[int, _NodeTrace], out_caps,
                 report: ResourceReport) -> List[Diagnostic]:
    """Price each sink edge's planned D2H bytes against the calibrated
    link (``Config.link_d2h_mbps`` / ``NNS_TPU_LINK_D2H_MBPS``, the bench
    ``link_calibration`` row) and flag ``fetch-bound`` pipelines — where
    the planned transfer time per buffer exceeds even the producing
    stages' HBM-roofline compute FLOOR, so no amount of compute overlap
    can hide the link — statically, before a chip is touched.

    The payload per edge is what the residency planner would actually
    ship: a producer whose device tail pairs ``device_fn`` with
    ``host_post`` crosses only its tiny traced device outputs (argmax ids,
    kept boxes); anything else crosses the negotiated spec.  The deep pass
    prices the pipeline AS WRITTEN — the runtime's reduced-output
    auto-selection can only shrink these numbers further (docs/FETCH.md).
    """
    diags: List[Diagnostic] = []
    # per-buffer compute floor: the slowest device stage bounds a
    # pipelined graph; each stage's floor is streaming its params + one
    # buffer's activations through HBM once
    floor_ms = max((compute_floor_ms(s.param_bytes + s.act_row_bytes)
                    for s in report.stages), default=0.0)
    for node in graph.nodes.values():
        cls = _element_class(node.kind)
        if cls is None or not getattr(cls, "is_sink", False):
            continue
        sink_label = node_label(node)
        for e in graph.in_edges(node.id):
            src_node = graph.nodes[e.src]
            t = traces.get(e.src)
            if t is not None:
                nbytes = t.out_bytes
                reduced = "fused host_post" if t.host_post else None
            else:
                up = out_caps.get((e.src, e.src_pad))
                spec = up.spec if up is not None else None
                nbytes = (-1 if spec is None or spec.is_flexible
                          else int(spec.nbytes))
                reduced = None
            edge = FetchEdge(sink=sink_label, producer=node_label(src_node),
                             bytes_per_buffer=nbytes, reduced=reduced,
                             compute_floor_ms=floor_ms)
            if report.link_d2h_mbps > 0 and nbytes >= 0:
                # bandwidth term ONLY: the RTT amortizes behind the async
                # fetch window (the whole point of fetch_depth), but link
                # OCCUPANCY is serial — bytes/bandwidth is the floor no
                # overlap can hide
                edge.d2h_ms = fetch_ms(nbytes, report.link_d2h_mbps)
                if report.stages and edge.d2h_ms > floor_ms:
                    diags.append(Diagnostic(
                        "fetch-bound", WARNING,
                        f"planned sink fetch of {nbytes} bytes/buffer "
                        f"occupies the calibrated d2h link for "
                        f"{edge.d2h_ms:.2f} ms ({report.link_d2h_mbps:g} "
                        f"MB/s), above the device stages' HBM-roofline "
                        f"compute floor of {floor_ms:.2f} ms — the "
                        "pipeline is fetch-bound: shrink what crosses "
                        "(fused sink reduction, reduced/native-stride "
                        "output, tensors/classmap decode modes) or "
                        "accept link-bound throughput",
                        path=sink_label, pos=node.pos))
            report.fetch_edges.append(edge)
    return diags


def _budget_diags(report: ResourceReport) -> List[Diagnostic]:
    """Budget checks, anchored at the dominant stage so the diagnostic
    carets point at the element to fix, not at the whole pipeline."""
    diags: List[Diagnostic] = []
    if report.hbm_budget_bytes and report.stages \
            and report.hbm_estimate > report.hbm_budget_bytes:
        top = max(report.stages, key=lambda s: s.hbm_bytes)
        diags.append(Diagnostic(
            "hbm-budget", WARNING,
            f"estimated HBM high-water {_mib(report.hbm_estimate)} exceeds "
            f"budget {_mib(report.hbm_budget_bytes)} (largest stage: "
            f"{_mib(top.hbm_bytes)} = params {_mib(top.param_bytes)} + "
            + (f"kv pool {_mib(top.pool_bytes)} + " if top.pool_bytes
               else "")
            + (f"train state {_mib(top.train_bytes)} + " if top.train_bytes
               else "")
            + f"{top.rows_per_device} row(s) x {_mib(top.act_row_bytes)}); "
            "shrink batch_max/buckets, raise data_parallel, or raise "
            "Config.hbm_budget_bytes"
            + (" (paged pools: shrink kv_blocks/slots — a smaller pool "
               "defers admission instead of overflowing)"
               if top.pool_bytes else "")
            + (" (training: shrink batch-size — the streaming window — "
               "or pick a lighter optimizer; sgd carries no moments)"
               if top.train_bytes else ""),
            path=top.label, pos=top.pos))
    if report.max_compiled_variants and report.stages \
            and report.compiled_variants > report.max_compiled_variants:
        top = max(report.stages, key=lambda s: s.variants)
        diags.append(Diagnostic(
            "recompile-budget", WARNING,
            f"{report.compiled_variants} distinct compiled signatures "
            f"(buckets x stages) exceed max_compiled_variants="
            f"{report.max_compiled_variants} (largest stage: {top.label} "
            f"with {top.variants}); trim batch_buckets or lower batch_max",
            path=top.label, pos=top.pos))
    return diags


# ---------------------------------------------------------------------------
# deep dogfood: abstract-trace the zoo our own plugin modules ship
# ---------------------------------------------------------------------------

#: zoo models the deep dogfood traces, at full width on meta (no memory):
#: every bundled model family that builds hermetically, the LLM presets
#: included (their bundles take token ids and give logits)
ZOO_DOGFOOD = (
    "passthrough", "scaler", "average",
    "mobilenet_v1", "ssd_mobilenet", "posenet", "deeplab_mobilenet",
    "yolov5", "yolov8", "yolov5s", "speech_commands", "wav2vec2",
    "llama_tiny", "llama2_7b",
)

#: build options of a dogfood entry (the 7B at its int4 serving width)
ZOO_DOGFOOD_OPTS = {"llama2_7b": {"quant": "int4"}}


def trace_zoo_models(names: Optional[Tuple[str, ...]] = None
                     ) -> Tuple[List[Diagnostic], int, int]:
    """Abstractly execute bundled zoo models against their own declared
    I/O specs: each built on the meta device (params too) and its
    ``apply_fn`` run on meta inputs, the output diffed against
    ``bundle.out_spec``.  Returns (diagnostics, traced count, skipped
    count)."""
    from ..elements.base import meta_inputs
    from ..models import zoo

    diags: List[Diagnostic] = []
    traced = skipped = 0
    for name in names or ZOO_DOGFOOD:
        opts = dict(ZOO_DOGFOOD_OPTS.get(name, {}))
        try:
            bundle = zoo.build(name, opts, device="meta")
        except Exception:  # noqa: BLE001 - optional deps may be absent
            skipped += 1
            continue
        if bundle.in_spec is None or bundle.out_spec is None:
            skipped += 1
            continue
        where = f"zoo:{name}"
        traced += 1
        try:
            out = bundle.apply_fn(bundle.params, *meta_inputs(bundle.in_spec))
            out = out if isinstance(out, (tuple, list)) else (out,)
            got = TensorsSpec(tuple(
                TensorSpec.from_shape(tuple(s.shape), s.dtype) for s in out))
        except Exception as e:  # noqa: BLE001 - the finding
            diags.append(Diagnostic(
                "trace-error", ERROR,
                f"abstract execution failed: {_trace_msg(e)}", path=where))
            continue
        declared = bundle.out_spec
        if not declared.is_flexible \
                and not got.is_compatible(_static(declared)):
            diags.append(Diagnostic(
                "trace-shape-mismatch", ERROR,
                "traced output disagrees with the bundle's declared "
                "out_spec: " + explain_mismatch(
                    Caps.tensors(got), Caps.tensors(_static(declared))),
                path=where))
    return diags, traced, skipped
