"""nns-slo: per-tenant SLO accounting over the live metrics registry.

Port of ``nnstreamer_tpu/utils/slo.py``.  "Is tenant X inside its p99
budget right now, and if not, which stage is burning it?":

* **Policy** (:class:`SLOPolicy` / :class:`TenantSLO`): declarative
  per-tenant objectives — p50/p99 end-to-end latency, minimum
  throughput, p99 time to first token, and an error budget (the
  fraction of requests allowed to violate latency or be shed before the
  tenant counts as breaching).  Loaded from a dict, a JSON file, or
  built in code; validated by :func:`validate_policy`.
* **Engine** (:class:`SLOEngine`): evaluates the policy continuously off
  the live per-tenant labeled histograms (``<sink>.e2e_latency`` — fed
  by the runtime when ``trace_mode != off``) and shed counters,
  publishing ``slo.burn_rate`` / ``slo.breach`` gauges per tenant into
  the same registry Prometheus scrapes (the autoscaler of
  ``utils/elastic.py`` reads the burn rate).  ``Pipeline(slo=...)``
  starts one; ``Pipeline.slo_report()`` is the on-demand verdict.
* **Attribution** (:func:`dominant_span`): for a breaching tenant, the
  span kind (queue/stage/batch/inflight/shard/fetch) that accounts for
  the most recorded time in the flight-recorder ring.

Burn rate follows the classic error-budget formulation: with budget
``b`` (default 1%), ``burn = bad_fraction / b`` where a request is bad
if its e2e latency exceeded the p99 objective OR it was shed at
admission.  ``burn == 1.0`` means the tenant is consuming exactly its
budget; sustained ``> 1`` means the budget exhausts early — the engine
flags it alongside hard p50/p99/fps violations.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.log import Metrics, logger
from ..core.log import metrics as _global_metrics
from . import tracing

log = logger(__name__)

#: span kinds that count toward dominant-span attribution: the
#: per-stage WORK/WAIT decomposition of an e2e latency (e2e itself,
#: ingress instants, and admission instants are excluded — they either
#: cover everything or have no duration)
ATTRIBUTABLE_KINDS = ("queue", "stage", "batch", "inflight", "shard",
                      "fetch")


@dataclasses.dataclass
class TenantSLO:
    """One tenant's objectives.  A zero objective means "not set" —
    only explicit objectives are enforced."""

    tenant: str
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    min_fps: float = 0.0
    #: serving-timeline objective: p99 time-to-first-token, evaluated off
    #: the tenant's ``llm.serve.ttft_ms`` reservoir (millisecond-valued)
    ttft_p99_ms: float = 0.0
    #: fraction of requests allowed to violate p99 latency or be shed
    #: before burn_rate reads 1.0
    error_budget: float = 0.01

    @classmethod
    def from_dict(cls, d: dict) -> "TenantSLO":
        return cls(tenant=str(d["tenant"]),
                   p50_ms=float(d.get("p50_ms", 0.0)),
                   p99_ms=float(d.get("p99_ms", 0.0)),
                   min_fps=float(d.get("min_fps", 0.0)),
                   ttft_p99_ms=float(d.get("ttft_p99_ms", 0.0)),
                   error_budget=float(d.get("error_budget", 0.01)))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SLOPolicy:
    """The declarative config: per-tenant objectives + the series the
    engine reads.  ``sinks`` defaults to whatever the owning Pipeline
    reports; ``shed_series`` is the admission-control counter family
    (docs/SERVING.md)."""

    tenants: List[TenantSLO] = dataclasses.field(default_factory=list)
    sinks: List[str] = dataclasses.field(default_factory=list)
    shed_series: str = "query_server.shed"

    def for_tenant(self, tenant: str) -> Optional[TenantSLO]:
        for t in self.tenants:
            if t.tenant == tenant:
                return t
        return None

    def to_dict(self) -> dict:
        return {"tenants": [t.to_dict() for t in self.tenants],
                "sinks": list(self.sinks),
                "shed_series": self.shed_series}


def validate_policy(d: dict) -> List[str]:
    """Schema problems of a policy dict (empty list = valid)."""
    problems: List[str] = []
    if not isinstance(d, dict):
        return ["policy must be a JSON object"]
    tenants = d.get("tenants")
    if not isinstance(tenants, list) or not tenants:
        problems.append("'tenants' must be a non-empty list")
        tenants = []
    seen = set()
    for i, t in enumerate(tenants):
        if not isinstance(t, dict):
            problems.append(f"tenants[{i}]: must be an object")
            continue
        name = t.get("tenant")
        if not name or not isinstance(name, str):
            problems.append(f"tenants[{i}]: 'tenant' (non-empty string) "
                            "required")
        elif name in seen:
            problems.append(f"tenants[{i}]: duplicate tenant {name!r}")
        else:
            seen.add(name)
        for key in ("p50_ms", "p99_ms", "min_fps", "ttft_p99_ms",
                    "error_budget"):
            v = t.get(key, 0)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(
                    f"tenants[{i}].{key}: must be a number >= 0")
        eb = t.get("error_budget", 0.01)
        if isinstance(eb, (int, float)) and eb > 1:
            problems.append(
                f"tenants[{i}].error_budget: a fraction in [0, 1], "
                f"got {eb}")
        unknown = set(t) - {"tenant", "p50_ms", "p99_ms", "min_fps",
                            "ttft_p99_ms", "error_budget"}
        if unknown:
            problems.append(
                f"tenants[{i}]: unknown keys {sorted(unknown)}")
    if "sinks" in d and not (isinstance(d["sinks"], list) and all(
            isinstance(s, str) for s in d["sinks"])):
        problems.append("'sinks' must be a list of sink element names")
    if "shed_series" in d and not isinstance(d["shed_series"], str):
        problems.append("'shed_series' must be a string")
    unknown = set(d) - {"tenants", "sinks", "shed_series"}
    if unknown:
        problems.append(f"unknown top-level keys {sorted(unknown)}")
    return problems


def load_policy(obj) -> SLOPolicy:
    """Accepts an :class:`SLOPolicy`, a policy dict, or a JSON file path;
    ``None`` yields an empty policy (every tenant informational-only).
    Raises ``ValueError`` naming every schema problem at once."""
    if obj is None:
        return SLOPolicy()
    if isinstance(obj, SLOPolicy):
        return obj
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(
            f"slo policy must be SLOPolicy | dict | path, got {type(obj)}")
    problems = validate_policy(obj)
    if problems:
        raise ValueError("invalid SLO policy: " + "; ".join(problems))
    return SLOPolicy(
        tenants=[TenantSLO.from_dict(t) for t in obj["tenants"]],
        sinks=list(obj.get("sinks", [])),
        shed_series=str(obj.get("shed_series", "query_server.shed")))


def dominant_span(tenant: str,
                  rec: Optional[tracing.FlightRecorder] = None
                  ) -> Optional[Tuple[str, float]]:
    """(span kind, total milliseconds) of the kind that accounts for the
    most recorded time for ``tenant`` in the flight-recorder ring, or
    None when the ring holds nothing attributable.  This is the "which
    stage is burning the budget" answer — the same spans a watchdog/
    error ring dump shows.

    Single-buffer spans carry a ``tenant`` arg and credit their full
    duration; batched spans carry a row-aligned ``tenants`` list and
    credit the tenant its ROW SHARE of the amortized duration."""
    evs = (rec or tracing.recorder).events()
    sums: Dict[str, float] = {}
    for e in evs:
        if not e.args or e.kind not in ATTRIBUTABLE_KINDS or e.dur <= 0:
            continue
        if e.args.get("tenant") == tenant:
            sums[e.kind] = sums.get(e.kind, 0.0) + e.dur
        else:
            rows = e.args.get("tenants")
            if rows and tenant in rows:
                share = e.dur * rows.count(tenant) / len(rows)
                sums[e.kind] = sums.get(e.kind, 0.0) + share
    if not sums:
        return None
    kind = max(sums, key=sums.get)
    return kind, sums[kind] / 1e6


class SLOEngine:
    """Continuous per-tenant SLO evaluation off the live registry.

    ``evaluate()`` computes one verdict dict per tenant (the union of
    policy tenants and tenants observed on the sinks' labeled e2e
    histograms) and publishes ``slo.burn_rate`` / ``slo.breach`` gauges;
    ``report()`` additionally attributes each breaching tenant's
    dominant span kind from the ring.  ``start(period_s)`` runs
    ``evaluate`` on a daemon thread (what ``Pipeline(slo=...)`` uses).

    Throughput is a RATE over a sliding window: every evaluation
    snapshots per-tenant request counts into a bounded history, and
    ``fps`` derives against the newest snapshot at least
    :data:`MIN_RATE_WINDOW_S` old (the run start until that much history
    exists) — an on-demand ``report()`` landing milliseconds after a
    daemon tick never computes a rate over a near-zero window and
    spuriously flags ``min_fps``.  Evaluation state is lock-guarded, so
    the daemon loop and ad-hoc callers interleave safely."""

    #: minimum seconds a throughput window must span
    MIN_RATE_WINDOW_S = 2.0

    _GUARDED_BY = {"_history": "_eval_lock"}

    def __init__(self, policy: SLOPolicy, sinks: Sequence[str] = (),
                 metrics: Optional[Metrics] = None,
                 recorder: Optional[tracing.FlightRecorder] = None):
        self.policy = policy
        self.sinks = list(policy.sinks or sinks)
        self.metrics = metrics if metrics is not None else _global_metrics
        self.recorder = recorder
        self._t0 = time.monotonic()
        #: (t, {tenant: requests}) snapshots, oldest first (~32 s of
        #: history at the daemon cadence)
        self._history: collections.deque = collections.deque(maxlen=64)
        self._eval_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- data sources ------------------------------------------------------
    def _e2e_series(self) -> List[str]:
        return [f"{s}.e2e_latency" for s in self.sinks]

    def _observed_tenants(self) -> List[str]:
        seen = set()
        for series in self._e2e_series():
            seen.update(self.metrics.tenants(series))
        seen.update(self.metrics.tenants(self.policy.shed_series))
        return sorted(seen)

    def _tenant_latency(self, tenant: str, q: float) -> Optional[float]:
        """q-th percentile (ms) over the tenant's e2e reservoirs, merged
        across sinks."""
        samples: List[float] = []
        for series in self._e2e_series():
            samples.extend(self.metrics.reservoir(series, tenant=tenant))
        if not samples:
            return None
        samples.sort()
        idx = min(len(samples) - 1,
                  max(0, math.ceil(q / 100.0 * len(samples)) - 1))
        return samples[idx] * 1e3

    def _tenant_ttft(self, tenant: str, q: float) -> Optional[float]:
        """q-th percentile (ms) of the tenant's time-to-first-token off
        the ``llm.serve.ttft_ms`` labeled reservoir (already
        millisecond-valued — no unit conversion)."""
        samples = list(self.metrics.reservoir("llm.serve.ttft_ms",
                                              tenant=tenant))
        if not samples:
            return None
        samples.sort()
        idx = min(len(samples) - 1,
                  max(0, math.ceil(q / 100.0 * len(samples)) - 1))
        return samples[idx]

    def _tenant_counts(self, tenant: str, threshold_ms: float
                       ) -> Tuple[int, int]:
        """(requests, requests over threshold) summed across sinks from
        the labeled histograms.  threshold 0 = nothing counted over."""
        total = over = 0
        for series in self._e2e_series():
            frac, n = self.metrics.fraction_over(
                series, threshold_ms / 1e3, tenant=tenant)
            total += n
            over += round(frac * n)
        return total, (over if threshold_ms > 0 else 0)

    def _rate_base(self, now: float) -> Tuple[float, Dict[str, int]]:
        """The newest history snapshot at least MIN_RATE_WINDOW_S old —
        or the run start when no snapshot is old enough yet.  Call with
        ``_eval_lock`` held."""
        base_t, base_n = self._t0, {}
        for t, n in self._history:
            if now - t >= self.MIN_RATE_WINDOW_S:
                base_t, base_n = t, n
            else:
                break
        return base_t, base_n

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> dict:
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> dict:
        now = time.monotonic()
        base_t, base_n = self._rate_base(now)
        window = max(1e-9, now - base_t)
        sheds = self.metrics.labeled_counters()
        verdicts: Dict[str, dict] = {}
        tenants = sorted({t.tenant for t in self.policy.tenants}
                         | set(self._observed_tenants()))
        new_last: Dict[str, int] = {}
        for tenant in tenants:
            slo = self.policy.for_tenant(tenant)
            p99_target = slo.p99_ms if slo else 0.0
            requests, lat_bad = self._tenant_counts(tenant, p99_target)
            shed_n = int(sheds.get((self.policy.shed_series, tenant), 0))
            new_last[tenant] = requests
            fps = (requests - base_n.get(tenant, 0)) / window
            p50 = self._tenant_latency(tenant, 50.0)
            p99 = self._tenant_latency(tenant, 99.0)
            ttft_p99 = (self._tenant_ttft(tenant, 99.0)
                        if slo is not None and slo.ttft_p99_ms > 0
                        else None)
            budget = slo.error_budget if slo else 0.01
            attempts = requests + shed_n
            bad = lat_bad + shed_n
            burn = ((bad / attempts) / budget
                    if attempts and budget > 0 else 0.0)
            violations: List[str] = []
            if slo is not None:
                if slo.p50_ms > 0 and p50 is not None and p50 > slo.p50_ms:
                    violations.append(
                        f"p50 {p50:.1f}ms > {slo.p50_ms:g}ms")
                if slo.p99_ms > 0 and p99 is not None and p99 > slo.p99_ms:
                    violations.append(
                        f"p99 {p99:.1f}ms > {slo.p99_ms:g}ms")
                if slo.min_fps > 0 and fps < slo.min_fps:
                    violations.append(
                        f"throughput {fps:.1f}fps < {slo.min_fps:g}fps")
                if slo.ttft_p99_ms > 0 and ttft_p99 is not None \
                        and ttft_p99 > slo.ttft_p99_ms:
                    violations.append(
                        f"ttft p99 {ttft_p99:.1f}ms > "
                        f"{slo.ttft_p99_ms:g}ms")
                if burn > 1.0:
                    violations.append(
                        f"error budget burning at {burn:.2f}x "
                        f"({bad}/{attempts} bad vs budget {budget:g})")
            ok = not violations
            self.metrics.gauge("slo.burn_rate", burn, tenant=tenant)
            self.metrics.gauge("slo.breach", 0.0 if ok else 1.0,
                               tenant=tenant)
            verdicts[tenant] = {
                "tenant": tenant,
                "ok": ok,
                "violations": violations,
                "p50_ms": p50,
                "p99_ms": p99,
                "ttft_p99_ms": ttft_p99,
                "fps": fps,
                "requests": requests,
                "sheds": shed_n,
                "burn_rate": burn,
                "objectives": slo.to_dict() if slo else None,
            }
        self._history.append((now, new_last))
        breaches = [t for t, v in verdicts.items() if not v["ok"]]
        return {"window_s": window, "ok": not breaches,
                "breaches": breaches, "tenants": verdicts}

    def report(self) -> dict:
        """``evaluate()`` + dominant-span attribution for every breaching
        tenant (the :meth:`Pipeline.slo_report` payload)."""
        rep = self.evaluate()
        for tenant in rep["breaches"]:
            dom = dominant_span(tenant, self.recorder)
            v = rep["tenants"][tenant]
            v["dominant_span_kind"] = dom[0] if dom else None
            v["dominant_span_ms"] = dom[1] if dom else None
        return rep

    # -- continuous mode ---------------------------------------------------
    def start(self, period_s: float = 0.5) -> "SLOEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 - must never die loud
                    log.exception("slo evaluation tick failed")

        self._thread = threading.Thread(target=loop, name="nns-slo",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
