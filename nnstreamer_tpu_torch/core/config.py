"""Global configuration registry.

Port of ``nnstreamer_tpu/core/config.py`` (reference: ``nnstreamer_conf.c``
+ ``nnstreamer.ini``), cut to the settings this package reads: the
user's plugin modules (``NNS_TPU_PLUGINS``, ``[common] plugin_modules``,
which the registry imports), the filter priority, queue capacity, prompt bucketing and latency switch of
the LLM paths, the flight recorder's mode and ring size, which the
query front door and the runtime's trace hooks read, the sinks' fetch
window, the runtime's bound on elastic stage restarts, and the
micro-batching knobs (``batch_max``, the bucket ladder and its adaptive
refinement, the dispatch window, ingress donation; ``[ladders]`` holds
warm-start ladders by stage name), the deep pass's budgets and link
pricing (``hbm_budget_bytes``, ``link_d2h_mbps``, ``link_fetch_rtt_ms``),
xray's switch, ledger tolerance and peak (``xray``,
``xray_hbm_tolerance``, ``peak_tflops``), the pipeline mesh's axes
(``data_parallel``, ``model_parallel``: ``parallel/mesh.py``,
``pipeline/plan.mesh_plan``), and each framework's free-form options
(the ini's ``[filter-<name>]`` sections, ``framework_options``, parsed as
the JAX package parses them; like it, nothing else reads them).
Populated
from (in priority order) :func:`set_config` > environment > the ini file
named by ``NNS_TPU_CONF`` > defaults.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import threading
from typing import Dict, List, Optional

_ENV_CONF = "NNS_TPU_CONF"
_ENV_PLUGINS = "NNS_TPU_PLUGINS"
_ENV_FW_PRIORITY = "NNS_TPU_FILTER_PRIORITY"
_ENV_BUCKETING = "NNS_TPU_SHAPE_BUCKETING"
_ENV_TRACE = "NNS_TPU_TRACE"
_ENV_TRACE_RING = "NNS_TPU_TRACE_RING"
_ENV_REDUCE_OUTPUTS = "NNS_TPU_REDUCE_OUTPUTS"
_ENV_FETCH_DEPTH = "NNS_TPU_FETCH_DEPTH"
_ENV_STAGE_RESTARTS = "NNS_TPU_MAX_STAGE_RESTARTS"
_ENV_BATCH_MAX = "NNS_TPU_BATCH_MAX"
_ENV_ADAPTIVE = "NNS_TPU_ADAPTIVE_BUCKETS"
_ENV_LADDERS = "NNS_TPU_BUCKET_LADDERS"
_ENV_DATA_PARALLEL = "NNS_TPU_DATA_PARALLEL"
_ENV_MODEL_PARALLEL = "NNS_TPU_MODEL_PARALLEL"
_ENV_DISPATCH_DEPTH = "NNS_TPU_DISPATCH_DEPTH"
_ENV_DONATE_INGRESS = "NNS_TPU_DONATE_INGRESS"
_ENV_MAX_VARIANTS = "NNS_TPU_MAX_COMPILED_VARIANTS"
_ENV_HBM_BUDGET = "NNS_TPU_HBM_BUDGET"
_ENV_LINK_D2H_MBPS = "NNS_TPU_LINK_D2H_MBPS"
_ENV_LINK_RTT_MS = "NNS_TPU_LINK_RTT_MS"
_ENV_XRAY = "NNS_TPU_XRAY"
_ENV_XRAY_HBM_TOL = "NNS_TPU_XRAY_HBM_TOLERANCE"
_ENV_PEAK_TFLOPS = "NNS_TPU_PEAK_TFLOPS"

#: the card's device-to-host rate into pinned memory, MB/s, the default of
#: ``link_d2h_mbps``: H100 80GB HBM3 at a 700.00 W limit, the median of
#: five 256 MiB copies timed with CUDA events (``chip_smoke.py``'s ``xray``
#: phase, which measures it again on every run: 54,723.1 and 54,959.7 in
#: two full runs, 42,286.4 on one machine)
H100_D2H_MBPS = 54959.7


@dataclasses.dataclass
class Config:
    #: extra plugin modules the registry imports at its first lookup
    #: (comma or colon separated in the env and the ini file)
    plugin_modules: List[str] = dataclasses.field(default_factory=list)
    #: framework priority for tensor_filter framework=auto
    filter_priority: List[str] = dataclasses.field(
        default_factory=lambda: ["llm"])
    #: default queue capacity between pipeline stages (buffers)
    queue_capacity: int = 4
    #: micro-batching (``pipeline/batching.py``): most already-queued
    #: buffers a batchable stage drains into one bucketed dispatch
    #: (1 = off, one buffer per dispatch)
    batch_max: int = 1
    #: allowed stacked batch sizes; empty = the default ladder (powers of
    #: two), ladder-rounded above its top
    batch_buckets: List[int] = dataclasses.field(default_factory=list)
    #: wait (ms) for more buffers once one is in hand; 0 = drain only what
    #: is already queued, never trading latency for occupancy
    batch_linger_ms: float = 0.0
    #: refine each batchable stage's ladder from the occupancies it
    #: drains (``AdaptiveLadder``), within ``max_compiled_variants``
    adaptive_buckets: bool = False
    #: warm-start ladders by stage name (a ``Pipeline.ladder_snapshot()``):
    #: ini ``[ladders]`` (``f = 1,2,4,6,8``) or env
    #: ``NNS_TPU_BUCKET_LADDERS=f:1|2|4|6|8;g:...``
    bucket_ladders: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    #: data-parallel replicas a bucketed micro-batch is sharded over (the
    #: mesh's ``data`` axis): 0 = every slot of one device once
    #: batch_max > 1 (``NNS_TPU_DEVICE_SLOTS`` unset: one replica; no run
    #: over distinct cards exists, so only a knob spans them), 1 = one
    #: slot, N = exactly N slots.  Only shardable stages see the mesh.
    data_parallel: int = 0
    #: tensor-parallel ways over the mesh's ``model`` axis: 1 = off, N =
    #: exactly N (the llm filter runs tensor-parallel on it; shardable
    #: stages keep their params whole and split rows over it too), 0 =
    #: every slot the ``data`` axis leaves.  Not gated on batch_max.
    model_parallel: int = 1
    #: dispatch window of a batching stage: micro-batches dispatched but
    #: not yet emitted downstream (1 = drain, dispatch, emit in lockstep)
    dispatch_depth: int = 2
    #: a fused stage that solely owns its host-fed input (an appsrc whose
    #: only consumer it is) stages frames through a reused pinned slot
    #: (``pipeline/plan.py``)
    donate_ingress: bool = True
    #: bound on the captured steps an adaptive ladder may add, split over
    #: the batchable stages (``plan.adaptive_variant_budget``; 0 = the
    #: base ladder plus ``ADAPTIVE_EXTRA_DEFAULT`` each)
    max_compiled_variants: int = 0
    #: pad flexible shapes up to the next bucket (the llm filter pads
    #: prompts to power-of-two lengths)
    shape_bucketing: bool = True
    #: emit per-stage latency measurements
    enable_latency: bool = True
    #: flight-recorder trace mode (utils/tracing.py): ``off`` = no
    #: recorder installed (hot paths pay one pointer check), ``ring`` =
    #: bounded ring of span events, ``full`` = unbounded capture
    trace_mode: str = "off"
    #: span capacity of the ``ring`` trace mode
    trace_ring_capacity: int = 65536
    #: residency planner (``pipeline/residency.py``): let a filter switch
    #: to its model's reduced output (deeplab's native-stride score map)
    #: when every consumer below it admits any geometry
    reduce_outputs: bool = True
    #: sink fetch window (``elements/sink.py``): up to this many buffers
    #: resolve their device-to-host copy or deferred ``host_post`` on a
    #: pool while the app pops earlier ones, in FIFO order
    fetch_depth: int = 2
    #: elastic stage restarts: a restartable (pure) stage whose
    #: ``process()`` raises is re-entered in place this many times,
    #: losing the one buffer, before the pipeline fails (0 = fail fast)
    max_stage_restarts: int = 0
    #: device-to-host link rate in MB/s: the deep pass (``analysis/
    #: tracecheck.py``) prices each sink edge's planned fetch bytes in
    #: milliseconds and flags ``fetch-bound`` pipelines (0 = never priced)
    link_d2h_mbps: float = H100_D2H_MBPS
    #: small-fetch roundtrip (ms) shown beside the bandwidth term in the
    #: deep pass's fetch report; not part of the ``fetch-bound`` decision
    link_fetch_rtt_ms: float = 0.0
    #: deep-pass budget: the estimated device-memory high-water mark a
    #: pipeline may plan for before ``hbm-budget`` warns (0 = no budget)
    hbm_budget_bytes: int = 0
    #: predicted-against-actual reconciliation (``utils/xray.py``): every
    #: captured step registers with the program census, its replays are
    #: timed with CUDA events, and the memory ledger is held against the
    #: deep pass's estimate.  False: no hook runs (one pointer check)
    xray: bool = False
    #: memory-ledger tolerance: a category past this factor of its
    #: estimate (above the 1 MiB floor) warns once and fails explain()
    xray_hbm_tolerance: float = 2.0
    #: peak dense TFLOP/s of the device for the MFU gauges (0: the table
    #: in ``utils/xray.py``, by device name)
    peak_tflops: float = 0.0
    #: free-form options by framework name: the ini's ``[filter-<name>]``
    #: sections (``[filter-jax]`` -> ``framework_options["jax"]``)
    framework_options: Dict[str, Dict[str, str]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def load(cls) -> "Config":
        cfg = cls()
        path = os.environ.get(_ENV_CONF)
        if path and os.path.exists(path):
            ini = configparser.ConfigParser()
            ini.read(path)
            if ini.has_option("common", "plugin_modules"):
                cfg.plugin_modules = _split(ini.get("common", "plugin_modules"))
            if ini.has_option("filter", "priority"):
                cfg.filter_priority = _split(ini.get("filter", "priority"))
            if ini.has_option("common", "queue_capacity"):
                cfg.queue_capacity = ini.getint("common", "queue_capacity")
            if ini.has_option("common", "shape_bucketing"):
                cfg.shape_bucketing = ini.getboolean("common",
                                                     "shape_bucketing")
            if ini.has_option("common", "batch_max"):
                cfg.batch_max = ini.getint("common", "batch_max")
            if ini.has_option("common", "batch_buckets"):
                cfg.batch_buckets = [
                    int(v) for v in _split(ini.get("common", "batch_buckets"))]
            if ini.has_option("common", "batch_linger_ms"):
                cfg.batch_linger_ms = ini.getfloat("common",
                                                   "batch_linger_ms")
            if ini.has_option("common", "adaptive_buckets"):
                cfg.adaptive_buckets = ini.getboolean("common",
                                                      "adaptive_buckets")
            if ini.has_section("ladders"):
                # stage names keep their case (ladder_snapshot() exports
                # them verbatim); configparser lowercases keys by default
                cased = configparser.ConfigParser()
                cased.optionxform = str
                cased.read(path)
                cfg.bucket_ladders = {
                    stage: [int(v) for v in _split(sizes)]
                    for stage, sizes in cased.items("ladders")}
            if ini.has_option("common", "data_parallel"):
                cfg.data_parallel = ini.getint("common", "data_parallel")
            if ini.has_option("common", "model_parallel"):
                cfg.model_parallel = ini.getint("common", "model_parallel")
            if ini.has_option("common", "dispatch_depth"):
                cfg.dispatch_depth = ini.getint("common", "dispatch_depth")
            if ini.has_option("common", "donate_ingress"):
                cfg.donate_ingress = ini.getboolean("common",
                                                    "donate_ingress")
            if ini.has_option("common", "max_compiled_variants"):
                cfg.max_compiled_variants = ini.getint(
                    "common", "max_compiled_variants")
            if ini.has_option("common", "trace_mode"):
                cfg.trace_mode = ini.get("common",
                                         "trace_mode").strip().lower()
            if ini.has_option("common", "trace_ring_capacity"):
                cfg.trace_ring_capacity = ini.getint(
                    "common", "trace_ring_capacity")
            if ini.has_option("common", "reduce_outputs"):
                cfg.reduce_outputs = ini.getboolean("common",
                                                    "reduce_outputs")
            if ini.has_option("common", "fetch_depth"):
                cfg.fetch_depth = ini.getint("common", "fetch_depth")
            if ini.has_option("common", "max_stage_restarts"):
                cfg.max_stage_restarts = ini.getint(
                    "common", "max_stage_restarts")
            for key in ("link_d2h_mbps", "link_fetch_rtt_ms",
                        "xray_hbm_tolerance", "peak_tflops"):
                if ini.has_option("common", key):
                    setattr(cfg, key, ini.getfloat("common", key))
            if ini.has_option("common", "hbm_budget_bytes"):
                cfg.hbm_budget_bytes = ini.getint("common", "hbm_budget_bytes")
            if ini.has_option("common", "xray"):
                cfg.xray = ini.getboolean("common", "xray")
            for sec in ini.sections():
                if sec.startswith("filter-"):
                    cfg.framework_options[sec[len("filter-"):]] = dict(ini.items(sec))
        if os.environ.get(_ENV_PLUGINS):
            cfg.plugin_modules = _split(os.environ[_ENV_PLUGINS])
        if os.environ.get(_ENV_FW_PRIORITY):
            cfg.filter_priority = _split(os.environ[_ENV_FW_PRIORITY])
        if os.environ.get(_ENV_BUCKETING):
            cfg.shape_bucketing = os.environ[_ENV_BUCKETING].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_TRACE):
            cfg.trace_mode = os.environ[_ENV_TRACE].strip().lower()
        if os.environ.get(_ENV_TRACE_RING):
            cfg.trace_ring_capacity = int(os.environ[_ENV_TRACE_RING])
        if os.environ.get(_ENV_REDUCE_OUTPUTS):
            cfg.reduce_outputs = os.environ[_ENV_REDUCE_OUTPUTS].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_FETCH_DEPTH):
            cfg.fetch_depth = int(os.environ[_ENV_FETCH_DEPTH])
        if os.environ.get(_ENV_STAGE_RESTARTS):
            cfg.max_stage_restarts = int(os.environ[_ENV_STAGE_RESTARTS])
        if os.environ.get(_ENV_BATCH_MAX):
            cfg.batch_max = int(os.environ[_ENV_BATCH_MAX])
        if os.environ.get(_ENV_DATA_PARALLEL):
            cfg.data_parallel = int(os.environ[_ENV_DATA_PARALLEL])
        if os.environ.get(_ENV_MODEL_PARALLEL):
            cfg.model_parallel = int(os.environ[_ENV_MODEL_PARALLEL])
        if os.environ.get(_ENV_DISPATCH_DEPTH):
            cfg.dispatch_depth = int(os.environ[_ENV_DISPATCH_DEPTH])
        if os.environ.get(_ENV_MAX_VARIANTS):
            cfg.max_compiled_variants = int(os.environ[_ENV_MAX_VARIANTS])
        if os.environ.get(_ENV_DONATE_INGRESS):
            cfg.donate_ingress = os.environ[_ENV_DONATE_INGRESS].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_ADAPTIVE):
            cfg.adaptive_buckets = os.environ[_ENV_ADAPTIVE].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_HBM_BUDGET):
            cfg.hbm_budget_bytes = int(os.environ[_ENV_HBM_BUDGET])
        if os.environ.get(_ENV_LINK_D2H_MBPS):
            cfg.link_d2h_mbps = float(os.environ[_ENV_LINK_D2H_MBPS])
        if os.environ.get(_ENV_LINK_RTT_MS):
            cfg.link_fetch_rtt_ms = float(os.environ[_ENV_LINK_RTT_MS])
        if os.environ.get(_ENV_XRAY):
            cfg.xray = os.environ[_ENV_XRAY].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_XRAY_HBM_TOL):
            cfg.xray_hbm_tolerance = float(os.environ[_ENV_XRAY_HBM_TOL])
        if os.environ.get(_ENV_PEAK_TFLOPS):
            cfg.peak_tflops = float(os.environ[_ENV_PEAK_TFLOPS])
        if os.environ.get(_ENV_LADDERS):
            cfg.bucket_ladders = parse_ladders(os.environ[_ENV_LADDERS])
        return cfg


def parse_ladders(s: str) -> Dict[str, List[int]]:
    """``"f:1|2|4|6;g:1|2|8"`` -> ``{"f": [1, 2, 4, 6], "g": [1, 2, 8]}``:
    the env encoding of a ladder snapshot (':' splits the stage from its
    sizes, '|' the sizes; both survive a shell unquoted)."""
    out: Dict[str, List[int]] = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        stage, _, sizes = part.partition(":")
        out[stage.strip()] = [int(v) for v in sizes.split("|") if v.strip()]
    return out


def _split(s: str) -> List[str]:
    return [p.strip() for p in s.replace(":", ",").split(",") if p.strip()]


_config: Optional[Config] = None
_lock = threading.Lock()


def get_config() -> Config:
    global _config
    if _config is None:
        with _lock:
            if _config is None:
                _config = Config.load()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    with _lock:
        _config = cfg


def reset_config() -> None:
    global _config
    with _lock:
        _config = None
