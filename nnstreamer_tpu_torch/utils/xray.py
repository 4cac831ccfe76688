"""xray: predicted against actual for the running pipeline.

Port of ``nnstreamer_tpu/utils/xray.py``.  The deep lint
(``analysis/tracecheck.py``) predicts a pipeline's census of captured
steps and its device memory by category; with ``Pipeline(xray=True)`` (or
``NNS_TPU_XRAY=1``) the runtime holds the running pipeline to them:

* **The census.**  A program here is a captured step
  (``pipeline/graphs.py``): :meth:`~..pipeline.graphs.Census.capture`
  registers each capture with :data:`registry` under ``(stage, kind)``
  (``kind``: ``stage`` for a fused stage's single-buffer step, ``batch``
  for a bucket step, the loop's ``continuous`` / ``propose`` /
  ``verify``, the trainer's ``step`` / ``eval``).  The runtime installs
  the predicted budget of every key before its threads start (the bucket
  ladder, the adaptive budget, ``serving_plan()["programs"]``,
  ``TRAINER_PROGRAMS``); a capture past the budget, or a bucket outside
  the ladder, fires ``census-drift`` with the signature diff and dumps the
  flight recorder's ring.  Work that runs uncaptured (a lone
  ``tensor_filter``, the loop's prefill chunks) has nothing to count and
  is listed as eager.
* **Device time.**  A tracked step's replay records a pair of CUDA events
  on the step's own stream around ``graph.replay()``, outside the
  captured region.  Only the reconciler thread (or :func:`explain`) reads
  ``elapsed_time``, and only for pairs whose end event has completed; a
  bounded ring keeps the pairs, so the serving thread never synchronizes
  or reads the card.  On the CPU a step runs eagerly and its wall time is
  its compute.  FLOPs and bytes come from the step's eager warm-up
  (``ops/cost.py``: torch ops by formula, each hand-written kernel by its
  own analytic count) plus what the caller adds per replay
  (``Step.add_work``: the paged KV rows a decode step reads); with the
  card's peak (:func:`peak_flops`, :func:`peak_bw`) they give each
  stage's ``mfu`` and ``roofline_fraction`` gauges and the bucket
  ladder's ``pad_waste_flops``.
* **Memory ledger.**  Per category (params, KV pool, sampler PRNG state,
  aggregator rings, training state, in-flight activations) from the
  port's own structures, beside ``torch.cuda.memory_allocated()`` (and
  ``memory_reserved()``), held against the deep lint's estimate for the
  same knobs within ``Config.xray_hbm_tolerance``.
* :func:`explain` / ``python -m nnstreamer_tpu_torch.tools.doctor`` join
  plan, residency, census, ledger, device time and the SLO verdict into
  one JSON-serializable report.

With xray off no hook runs: elements hold None, a census has no registry,
a step replays as before.  Pinned by ``tests/test_torch_xray.py`` (the
registry's entry points monkeypatched to raise under an xray-off run).
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

from ..core.log import logger, metrics
from ..pipeline.residency import HBM_GBPS

log = logger(__name__)

#: memory-ledger categories (the deep lint's ``ResourceReport.by_category``)
HBM_CATEGORIES: Tuple[str, ...] = ("params", "kv_pool", "agg_rings",
                                   "activations", "train_state",
                                   "prng_state")

#: categories below this are never drift-warned (transient windows read 0
#: between dispatches; byte-level noise is not an estimate failure)
HBM_WARN_FLOOR = 1 << 20

#: peak dense bf16 TFLOP/s and memory GB/s by device-name substring.  The
#: H100 SXM (80GB HBM3): 989 TFLOP/s from NVIDIA's data sheet and the
#: residency planner's 3,350 GB/s, the figures ``PERF.md`` §6's bounds use
#: (H100 80GB HBM3, 700.00 W).  The CPU's row makes MFU on the host
#: indicative only (the gauge still proves the attribution plumbing).
_PEAKS_BY_NAME: Tuple[Tuple[str, float, float], ...] = (
    ("H100", 989.0, HBM_GBPS),
    ("cpu", 0.1, 50.0),
)

_peak_cache: Dict[str, Tuple[float, float]] = {}


def _device_peaks() -> Tuple[float, float]:
    got = _peak_cache.get("peaks")
    if got is not None:
        return got
    name = "cpu"
    try:
        import torch

        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - attribution must not crash
        pass
    tf, gb = _PEAKS_BY_NAME[-1][1:]
    for sub, t, g in _PEAKS_BY_NAME:
        if sub.lower() in name.lower():
            tf, gb = t, g
            break
    _peak_cache["peaks"] = (tf * 1e12, gb * 1e9)
    return _peak_cache["peaks"]


def peak_flops() -> float:
    """Peak FLOP/s of the device: ``Config.peak_tflops`` when set
    (``NNS_TPU_PEAK_TFLOPS``), else the table above by device name."""
    from ..core.config import get_config

    cfg = get_config()
    if cfg.peak_tflops > 0:
        return cfg.peak_tflops * 1e12
    return _device_peaks()[0]


def peak_bw() -> float:
    """Peak device-memory bytes/s, the table's by device name."""
    return _device_peaks()[1]


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def render_signature(sig) -> str:
    return repr(sig)


def explain_signature_drift(actual, predicted) -> str:
    """Field-level diff between a drifted census signature and the key's
    first one: the arity, else the first field that differs."""
    if predicted is None:
        return "no predicted signature to diff against"
    if not (isinstance(actual, tuple) and isinstance(predicted, tuple)):
        return f"{actual!r} ⊄ predicted {predicted!r}"
    if len(actual) != len(predicted):
        return (f"arity {len(actual)} ⊄ predicted {len(predicted)} "
                f"({actual!r} vs {predicted!r})")
    for i, (la, lp) in enumerate(zip(actual, predicted)):
        if la != lp:
            return f"arg {i}: {la!r} ⊄ predicted {lp!r}"
    return "same signature captured again"


# ---------------------------------------------------------------------------
# tracked steps
# ---------------------------------------------------------------------------

#: event pairs a tracked step keeps before the oldest unread one is dropped
EVENT_RING = 256


class TrackedStep:
    """One captured step's attribution: its analytic FLOPs and bytes per
    replay, and its replays' device time.

    On the card :meth:`begin` / :meth:`end` record a pair of CUDA events on
    the step's stream around the replay; :meth:`collect` (the reconciler
    thread, or :func:`explain`) reads the pairs whose end event completed.
    On the CPU :meth:`add_time` adds the eager run's wall time."""

    def __init__(self, stage: str, kind: str, flops: float, bytes_: float,
                 rec=None):
        self.stage = stage
        self.kind = kind
        self._rec = rec
        #: the step's static cost per replay (its warm-up's count)
        self.flops = float(flops)
        self.bytes_ = float(bytes_)
        #: data-dependent work added per replay (Step.add_work)
        self.extra_flops = 0.0
        self.extra_bytes = 0.0
        self.disp_n = 0
        self.disp_ns = 0
        self.replays = 0
        self.dropped = 0
        self._pending: collections.deque = collections.deque()
        self._free: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def begin(self, stream):
        """Before a replay, on the step's stream: its start event."""
        try:
            pair = self._free.popleft()
        except IndexError:
            import torch

            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        return pair

    def end(self, pair, stream) -> None:
        """After the replay: its end event, and the pair into the ring."""
        pair[1].record(stream)
        self.replays += 1
        self._pending.append((pair, time.monotonic_ns()))
        if len(self._pending) > EVENT_RING:
            try:
                self._pending.popleft()
                self.dropped += 1
            except IndexError:
                pass

    def add_time(self, ns: int) -> None:
        self.replays += 1
        with self._lock:
            self.disp_n += 1
            self.disp_ns += int(ns)
        self._device_span(time.monotonic_ns() - int(ns), int(ns))

    def add_work(self, flops: float, nbytes: float) -> None:
        self.extra_flops += float(flops)
        self.extra_bytes += float(nbytes)

    def collect(self) -> None:
        """Read the completed pairs, oldest first (never on the serving
        thread: ``query`` and ``elapsed_time`` are CUDA API calls)."""
        with self._lock:
            while self._pending:
                (ev0, ev1), host_ns = self._pending[0]
                if not ev1.query():
                    break
                self._pending.popleft()
                ns = int(ev0.elapsed_time(ev1) * 1e6)
                self.disp_n += 1
                self.disp_ns += ns
                self._free.append((ev0, ev1))
                self._device_span(host_ns, ns)

    def _device_span(self, t0_ns: int, dur_ns: int) -> None:
        rec = self._rec() if callable(self._rec) else self._rec
        if rec is not None and rec.active:
            rec.record("device", f"device:{self.stage}", None, t0_ns, dur_ns,
                       program=self.kind, flops=self.flops)

    @property
    def flops_total(self) -> float:
        """FLOPs of the timed replays (the static count each, plus the added
        work spread evenly over all replays)."""
        if not self.replays:
            return 0.0
        return self.disp_n * (self.flops + self.extra_flops / self.replays)

    @property
    def bytes_total(self) -> float:
        if not self.replays:
            return 0.0
        return self.disp_n * (self.bytes_ + self.extra_bytes / self.replays)


class ProgramRegistry:
    """The process-wide census of captured steps (one per process, like
    ``core.log.metrics``).  :meth:`expect` installs a predicted budget per
    ``(stage, kind)``; :meth:`register` records one capture, returns its
    :class:`TrackedStep`, and fires ``census-drift`` when the live set
    escapes the prediction."""

    _GUARDED_BY = {"_expected": "_lock", "_live": "_lock",
                   "_trackers": "_lock", "_drifts": "_lock",
                   "_drift_dumped": "_lock", "_eager": "_lock"}

    #: drift records kept: a capture storm must not grow the singleton
    #: without bound (past it only the counter advances)
    MAX_DRIFT_RECORDS = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._expected: Dict[Tuple[str, str],
                             Tuple[int, Optional[FrozenSet[int]], str]] = {}
        self._live: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._trackers: List[weakref.ref] = []
        self._drifts: List[Dict[str, Any]] = []
        self._drift_dumped: set = set()
        self._eager: Dict[Tuple[str, str], str] = {}

    # -- install -----------------------------------------------------------
    def expect(self, stage: str, kind: str, budget: int = 0, allow=None,
               note: str = "") -> None:
        """The predicted census of ``(stage, kind)``: at most ``budget``
        captures (0 = unbounded), their trigger batch dims within
        ``allow`` (the bucket ladder) when given.  Installing resets the
        key's live count and retires its past drifts: a second pipeline
        reusing a stage name is measured against its own warm-up."""
        with self._lock:
            self._expected[(stage, kind)] = (
                int(budget), frozenset(allow) if allow else None, note)
            self._live.pop((stage, kind), None)
            self._drifts = [d for d in self._drifts
                            if (d["stage"], d["kind"]) != (stage, kind)]
            self._drift_dumped.discard((stage, kind))

    def note_eager(self, stage: str, what: str) -> None:
        """Record device work of ``stage`` that runs uncaptured (nothing to
        count in the census; :func:`explain` lists it)."""
        with self._lock:
            self._eager[(stage, what)] = what

    # -- the census --------------------------------------------------------
    def register(self, stage: str, kind: str, sig, *, compile_s: float = 0.0,
                 flops: float = 0.0, bytes_: float = 0.0,
                 rows: Optional[int] = None, rec=None) -> TrackedStep:
        """Record one capture; return the tracker its step replays through."""
        key = (stage, kind)
        tracker = TrackedStep(stage, kind, flops, bytes_, rec=rec)
        with self._lock:
            ent = self._live.setdefault(key, {"compiles": 0, "sigs": {}})
            ent["compiles"] += 1
            compiles = ent["compiles"]
            baseline = next(iter(ent["sigs"]), None)
            if sig not in ent["sigs"]:
                ent["sigs"][sig] = {"compile_s": compile_s, "flops": flops,
                                    "bytes": bytes_, "rows": rows,
                                    "ts": time.monotonic()}
            exp = self._expected.get(key)
            self._trackers.append(weakref.ref(tracker))
        metrics.count(f"{stage}.compiles")
        if exp is not None:
            budget, allow, _note = exp
            reason = None
            if allow is not None and rows is not None and rows not in allow:
                reason = (f"trigger batch dim {rows} is not in the predicted "
                          f"bucket ladder {sorted(allow)}")
            elif budget and compiles > budget:
                reason = (f"{compiles} captured step(s) exceed the "
                          f"predicted census of {budget}")
            if reason is not None:
                self._fire_drift(stage, kind, sig, baseline, reason)
        return tracker

    def _fire_drift(self, stage: str, kind: str, sig, baseline,
                    reason: str) -> None:
        diff = explain_signature_drift(sig, baseline)
        drift = {"stage": stage, "kind": kind, "reason": reason,
                 "signature": render_signature(sig),
                 "predicted_signature": (render_signature(baseline)
                                         if baseline is not None else None),
                 "diff": diff}
        with self._lock:
            if len(self._drifts) < self.MAX_DRIFT_RECORDS:
                self._drifts.append(drift)
            first = (stage, kind) not in self._drift_dumped
            self._drift_dumped.add((stage, kind))
        # distinct from the reconciler's `xray.census_drift` gauge twin, so
        # neither family changes type between scrapes
        metrics.count("xray.census_drifts")
        from . import tracing

        if tracing.recorder.active:
            tracing.recorder.record("xray.drift", stage, None,
                                    time.monotonic_ns(), 0, program=kind,
                                    reason=reason)
        if not first:
            log.debug("census-drift (repeat): %s/%s: %s", stage, kind, reason)
            return
        log.warning("census-drift: stage %s (%s): %s — signature [%s]; diff "
                    "vs predicted: %s", stage, kind, reason,
                    drift["signature"], diff)
        tracing.dump_recent_to_log(
            log, reason=f"census-drift at {stage}/{kind}: {reason}")

    # -- accessors ---------------------------------------------------------
    def has_compiles(self) -> bool:
        """True once any step was captured (the ledger's under-prediction
        warning waits for it: an idle loop's pool is not drift)."""
        with self._lock:
            return bool(self._live)

    def drifts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(d) for d in self._drifts]

    def drift_count(self) -> int:
        with self._lock:
            return len(self._drifts)

    def eager(self) -> List[Dict[str, str]]:
        with self._lock:
            return [{"stage": s, "what": w} for (s, w) in sorted(self._eager)]

    def census(self) -> Dict[str, Dict[str, Any]]:
        """Predicted against live, keyed ``"<stage>/<kind>"``."""
        with self._lock:
            expected = dict(self._expected)
            live = {k: (v["compiles"],
                        [render_signature(s) for s in v["sigs"]])
                    for k, v in self._live.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for key in sorted(set(expected) | set(live)):
            stage, kind = key
            budget, allow, note = expected.get(key, (0, None, ""))
            compiles, sigs = live.get(key, (0, []))
            out[f"{stage}/{kind}"] = {
                "stage": stage, "kind": kind,
                "predicted": budget or None,
                "allow": sorted(allow) if allow else None,
                "live_compiles": compiles,
                "live_signatures": sigs,
                "within": (not budget) or compiles <= budget,
                "note": note,
            }
        return out

    def _live_trackers(self) -> List[TrackedStep]:
        with self._lock:
            self._trackers = [r for r in self._trackers if r() is not None]
            return [t for t in (r() for r in self._trackers) if t is not None]

    def collect(self) -> None:
        """Read every tracker's completed event pairs."""
        for tp in self._live_trackers():
            tp.collect()

    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-stage device time over the timed replays: dispatches,
        device ns, FLOPs and bytes (with each step's static count per
        replay), ``mfu``, ``bw_fraction`` and ``roofline_fraction``."""
        self.collect()
        pk, bw = peak_flops(), peak_bw()
        agg: Dict[str, Dict[str, float]] = {}
        for tp in self._live_trackers():
            if tp.disp_n == 0:
                continue
            st = agg.setdefault(tp.stage, {
                "dispatches": 0.0, "device_ns": 0.0, "flops_total": 0.0,
                "bytes_total": 0.0, "ideal_s": 0.0, "static_flops": 0.0,
                "static_bytes": 0.0, "dropped": 0.0})
            # each step's warm-up count (per replay), and replays whose
            # events the ring dropped before they were read
            st["static_flops"] += tp.flops
            st["static_bytes"] += tp.bytes_
            st["dropped"] += tp.dropped
            st["dispatches"] += tp.disp_n
            st["device_ns"] += tp.disp_ns
            st["flops_total"] += tp.flops_total
            st["bytes_total"] += tp.bytes_total
            st["ideal_s"] += max(tp.flops_total / pk if pk else 0.0,
                                 tp.bytes_total / bw if bw else 0.0)
        for st in agg.values():
            secs = st["device_ns"] / 1e9
            if secs <= 0:
                st["mfu"] = st["roofline_fraction"] = st["bw_fraction"] = 0.0
                continue
            st["mfu"] = st["flops_total"] / (pk * secs) if pk else 0.0
            st["bw_fraction"] = st["bytes_total"] / (bw * secs) if bw else 0.0
            st["roofline_fraction"] = min(1.0, st["ideal_s"] / secs)
        return agg

    def publish(self) -> None:
        """One reconciler tick's gauges: per-stage ``mfu`` and
        ``roofline_fraction``, and the census-drift total."""
        for stage, st in self.stage_stats().items():
            metrics.gauge(f"{stage}.mfu", st["mfu"])
            metrics.gauge(f"{stage}.roofline_fraction",
                          st["roofline_fraction"])
        metrics.gauge("xray.census_drift", float(self.drift_count()))

    def reset(self) -> None:
        with self._lock:
            self._expected.clear()
            self._live.clear()
            self._trackers.clear()
            self._drifts.clear()
            self._drift_dumped.clear()
            self._eager.clear()


#: THE process-wide registry (``Pipeline(xray=True)`` hands it to every
#: instrumentation site as ``element._xray``; off pipelines hold None)
registry = ProgramRegistry()


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) if hasattr(t, "element_size") \
        else int(getattr(t, "nbytes", 0) or 0)


def measure_hbm(pipeline) -> Dict[str, int]:
    """The ledger per category from the port's own structures, plus
    ``device_bytes_in_use`` (``torch.cuda.memory_allocated()``) and
    ``device_bytes_reserved`` on the card."""
    out: Dict[str, int] = {c: 0 for c in HBM_CATEGORIES}
    for el in {id(e): e for e in pipeline.elements.values()}.values():
        # a stopped tensor_filter holds fw=None: param_bytes() would reload
        # the model just to read a byte count
        if not (hasattr(el, "fw") and el.fw is None):
            try:
                out["params"] += int(el.param_bytes() or 0)
            except Exception:  # noqa: BLE001 - accounting probe only
                pass
        fw = getattr(el, "fw", None)
        loop = getattr(fw, "_serve", None) if fw is not None else None
        if loop is not None:
            out["kv_pool"] += int(getattr(loop, "_pool_nbytes", 0) or 0)
            out["prng_state"] += int(getattr(loop, "_prng_nbytes", 0) or 0)
        rings = getattr(el, "_rings", None)
        if rings is not None:
            out["agg_rings"] += _nbytes(rings)
        train_fn = getattr(el, "train_state_bytes", None)
        if train_fn is not None:
            try:
                out["train_state"] += int(train_fn() or 0)
            except Exception:  # noqa: BLE001 - accounting probe only
                pass
    act = 0
    for r in {id(r): r for r in pipeline._runners.values()}.values():
        try:
            # a lock-free copy of a deque the stage thread mutates
            items = list(r._inflight)
        except RuntimeError:
            continue
        for item in items:
            for _pad, o in item[0]:
                for t in getattr(o, "tensors", None) or ():
                    act += _nbytes(t)
    out["activations"] = act
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            out["device_bytes_in_use"] = int(torch.cuda.memory_allocated())
            out["device_bytes_reserved"] = int(torch.cuda.memory_reserved())
    except Exception:  # noqa: BLE001 - a bonus, not a contract
        pass
    return out


def predicted_hbm(pipeline) -> Optional[Dict[str, int]]:
    """The deep lint's per-category estimate for this pipeline's knobs
    (cached on the pipeline; None when the deep pass cannot run)."""
    rep = getattr(pipeline, "_xray_deep", False)
    if rep is False:
        rep = None
        try:
            from ..analysis import analyze

            got = analyze(pipeline.graph, deep=True,
                          batch_max=pipeline.batch_max,
                          batch_buckets=pipeline.batch_buckets,
                          adaptive_buckets=pipeline.adaptive_buckets,
                          data_parallel=pipeline.data_parallel,
                          model_parallel=pipeline.model_parallel,
                          dispatch_depth=pipeline.dispatch_depth)
            rep = getattr(got, "resources", None)
        except Exception:  # noqa: BLE001 - prediction is best-effort
            log.exception("xray: deep-lint prediction failed")
        pipeline._xray_deep = rep
    if rep is None:
        return None
    return rep.by_category()


class XrayReconciler:
    """The predicted-against-actual loop (a 0.5 s daemon): reads the step
    trackers' events, publishes the MFU and roofline gauges and the
    ledger (measured, predicted, ratio), and warns once per category past
    ``Config.xray_hbm_tolerance``.  ``Pipeline.stop()`` stops and joins
    it."""

    def __init__(self, pipeline, period_s: float = 0.5):
        self.pipeline = pipeline
        self.period_s = period_s
        self._stop = threading.Event()
        self._warned: set = set()
        self._act_peak = 0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "XrayReconciler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="nns-xray",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - must never die loud
                log.exception("xray reconciler tick failed")

    def tick(self) -> None:
        registry.publish()
        measured = measure_hbm(self.pipeline)
        # the window is transient: its peak is what the estimate bounds
        self._act_peak = max(self._act_peak, measured["activations"])
        measured["activations"] = self._act_peak
        predicted = predicted_hbm(self.pipeline)
        from ..core.config import get_config

        tol = float(get_config().xray_hbm_tolerance)
        for cat in HBM_CATEGORIES:
            m = measured.get(cat, 0)
            metrics.gauge(f"xray.hbm.{cat}", float(m))
            p = (predicted or {}).get(cat, 0)
            if not p:
                continue
            metrics.gauge(f"xray.hbm_predicted.{cat}", float(p))
            ratio = m / p
            metrics.gauge(f"xray.hbm_drift.{cat}", ratio)
            if cat in self._warned:
                continue
            if (m > p * tol and m > HBM_WARN_FLOOR) or \
                    (p > m * tol and p > HBM_WARN_FLOOR
                     and registry.has_compiles()):
                self._warned.add(cat)
                log.warning(
                    "hbm-drift: category %s measured %.1f MiB vs deep-lint "
                    "estimate %.1f MiB (%.2fx, tolerance %gx)",
                    cat, m / 2**20, p / 2**20, ratio, tol)


# ---------------------------------------------------------------------------
# the doctor report
# ---------------------------------------------------------------------------

def explain(pipeline) -> Dict[str, Any]:
    """One predicted-against-actual report for a running or finished
    pipeline: plan, residency, census (budgets against the live steps,
    drifts, eager work), memory ledger by category, per-stage device time,
    and the SLO verdict when an engine is attached.  JSON-serializable."""
    from ..core.config import get_config

    plan = {
        "stages": [{
            "stage": s.element.name,
            "elements": [pipeline.graph.nodes[n].kind for n in s.node_ids],
            "batchable": s.batchable,
            "restartable": getattr(s, "restartable", False),
        } for s in pipeline.stages],
        "batch_max": pipeline.batch_max,
        "dispatch_depth": pipeline.dispatch_depth,
        "fetch_depth": pipeline.fetch_depth,
        "adaptive_buckets": pipeline.adaptive_buckets,
    }
    res = pipeline.residency
    residency = {
        "resident_edges": res.resident_edges,
        "reduced_outputs": list(res.reduced_outputs),
        "fetch": [{"sink": e.sink, "producer": e.producer,
                   "bytes_per_buffer": e.bytes_per_buffer,
                   "reduced": e.reduced} for e in res.fetch],
    }
    census = {
        "programs": registry.census(),
        "drift": registry.drifts(),
        "drift_total": registry.drift_count(),
        "eager": registry.eager(),
    }
    tol = float(get_config().xray_hbm_tolerance)
    measured = measure_hbm(pipeline)
    recon = getattr(pipeline, "_xray_recon", None)
    if recon is not None:
        measured["activations"] = max(measured["activations"],
                                      recon._act_peak)
    predicted = predicted_hbm(pipeline)
    hbm: Dict[str, Any] = {"tolerance": tol, "categories": {}}
    for cat in HBM_CATEGORIES:
        m = measured.get(cat, 0)
        p = (predicted or {}).get(cat) if predicted else None
        hbm["categories"][cat] = {
            "predicted": p, "measured": m,
            "ratio": (m / p) if p else None,
            # over-use is what the budget exists to catch; a window that
            # never filled, or noise under the floor, never fails a gate
            "ok": (p is None) or m <= max(p * tol, HBM_WARN_FLOOR),
        }
    for key in ("device_bytes_in_use", "device_bytes_reserved"):
        if key in measured:
            hbm[key] = measured[key]
    hbm["categories_total"] = sum(
        c["measured"] for c in hbm["categories"].values())
    slo = None
    if getattr(pipeline, "_slo_policy", None) is not None:
        try:
            slo = pipeline.slo_report()
        except Exception:  # noqa: BLE001 - verdict is best-effort here
            pass
    ok = (census["drift_total"] == 0
          and all(c["ok"] for c in hbm["categories"].values()))
    return {
        "xray": pipeline.xray,
        "plan": plan, "residency": residency,
        "census": census, "hbm": hbm,
        "device_time": registry.stage_stats() if pipeline.xray else {},
        "peak": {"flops": peak_flops(), "bytes_per_s": peak_bw()},
        "slo": slo, "ok": ok,
    }


def _mib(n) -> str:
    return "-" if n is None else f"{n / 2**20:.2f} MiB"


def render_report(rep: Dict[str, Any]) -> str:
    """Human rendering of :func:`explain`: the doctor CLI's columns."""
    lines = [
        "pipeline doctor — predicted vs actual",
        f"  plan: {len(rep['plan']['stages'])} stage(s), "
        f"batch_max={rep['plan']['batch_max']}, "
        f"dispatch_depth={rep['plan']['dispatch_depth']}",
        f"  residency: {rep['residency']['resident_edges']} device-"
        f"resident edge(s), {len(rep['residency']['fetch'])} fetch edge(s)",
        "  census (captured steps, predicted vs live):",
    ]
    progs = rep["census"]["programs"]
    if not progs:
        lines.append("    (no tracked steps — xray off or nothing captured)")
    for key in sorted(progs):
        e = progs[key]
        pred = e["predicted"] if e["predicted"] else "unbounded"
        mark = "OK" if e["within"] else "DRIFT"
        lines.append(f"    {key}: predicted {pred}, live "
                     f"{e['live_compiles']} [{mark}]")
    for e in rep["census"].get("eager", ()):
        lines.append(f"    eager: {e['stage']}: {e['what']}")
    for d in rep["census"]["drift"]:
        lines.append(f"    drift: {d['stage']}/{d['kind']}: {d['reason']}"
                     f" — {d['diff']}")
    lines.append(f"  memory ledger (tolerance {rep['hbm']['tolerance']:g}x):")
    for cat, c in rep["hbm"]["categories"].items():
        ratio = "-" if c["ratio"] is None else f"{c['ratio']:.2f}x"
        mark = "OK" if c["ok"] else "DRIFT"
        lines.append(f"    {cat}: predicted {_mib(c['predicted'])}, "
                     f"measured {_mib(c['measured'])} ({ratio}) [{mark}]")
    if "device_bytes_in_use" in rep["hbm"]:
        lines.append(f"    device memory_allocated: "
                     f"{_mib(rep['hbm']['device_bytes_in_use'])} "
                     f"(reserved {_mib(rep['hbm'].get('device_bytes_reserved'))}"
                     f"; categories {_mib(rep['hbm']['categories_total'])})")
    if rep["device_time"]:
        lines.append("  device time (CUDA events on the replay streams):")
        for stage in sorted(rep["device_time"]):
            st = rep["device_time"][stage]
            lines.append(
                f"    {stage}: {int(st['dispatches'])} replay(s), "
                f"{st['device_ns'] / 1e6:.3f} ms, mfu {st['mfu']:.4f}, "
                f"bandwidth {st['bw_fraction']:.4f}, "
                f"roofline {st['roofline_fraction']:.4f}")
    if rep["slo"] is not None:
        ok = rep["slo"].get("ok")
        lines.append(f"  slo: {'green' if ok else 'BREACHING'} "
                     f"(breaches: {rep['slo'].get('breaches')})")
    lines.append(f"  verdict: {'OK' if rep['ok'] else 'DRIFT'} "
                 f"(census drift {rep['census']['drift_total']})")
    return "\n".join(lines)


def verdict_lines(rep: Dict[str, Any]) -> List[str]:
    """The timing-insensitive verdicts a CI gate pins: the drift total,
    each budgeted key within or over, each category ok or drifted."""
    lines = [f"census drift {rep['census']['drift_total']}"]
    for key in sorted(rep["census"]["programs"]):
        e = rep["census"]["programs"][key]
        if e["predicted"]:
            lines.append(f"{key}: {'within budget' if e['within'] else 'OVER'}")
    for cat in HBM_CATEGORIES:
        c = rep["hbm"]["categories"][cat]
        lines.append(f"hbm {cat}: {'ok' if c['ok'] else 'DRIFT'}")
    lines.append(f"doctor: {'OK' if rep['ok'] else 'DRIFT'}")
    return lines
