"""nns-elastic: the stream registry, chaos hooks, the reconfig knob table
and the burn-rate autoscaler of continuous serving (docs/SERVING.md
"Elastic serving").

Port of ``nnstreamer_tpu/utils/elastic.py``:

* **Stream registry** — every continuous-serving stream
  (``filters/llm.py _ContinuousLoop``) registers a process-unique
  ``stream_id`` here at submit; the id rides every emitted token's meta
  (:data:`META_STREAM_ID`) all the way to the query wire.  Downstream
  failure detectors (``tensor_query_serversink`` on a dead connection)
  call :func:`cancel_stream`, a host-value backchannel that lets the
  serve loop release the orphaned stream's KV blocks and slot after a
  ``stream_idle_timeout`` grace instead of leaking pool capacity until
  ``max_new`` runs out; the grace lets a drain still pick it up
  (:meth:`Pipeline.drain_stream`).  This module is the one place a
  stream id is minted in the process.
* **Chaos hooks** — test-only injection points (:func:`chaos_slow_stage`)
  for the soak harness; no production element reads them.
* **Reconfig knob table** — :data:`SERVE_KNOB_SIGNATURE` says, for every
  continuous-serving knob, whether changing it changes a captured step
  (slots, block_size, ...: drain, restart with the new config, adopt) or
  only host values (quotas, budgets, timeouts); :func:`signature_changes`
  applies it.
* **Autoscaler** — a 0.5 s daemon loop that reads the SLO engine's
  ``slo.burn_rate{tenant=}`` gauges and applies a policy table with
  hysteresis and a cooldown: shed a tenant at the query front door,
  cap its KV blocks on the serve loops, or spill one of its live streams
  to a second pipeline by drain/adopt (span ``elastic.scale``).

Everything here is host-side value movement: no captured step changes
under any action this module takes.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.log import logger
from ..core.log import metrics as _global_metrics
#: buffer-meta key carrying the continuous-serving stream id.  App data
#: (JSON-safe int), stamped at submit regardless of trace mode: the
#: dead-connection backchannel must work in untraced deployments too.
#: Declared in the shared protocol registry (core/meta_keys.py).
from ..core.meta_keys import META_STREAM_ID  # noqa: F401  (re-export)
from . import tracing

log = logger(__name__)


_stream_ids = itertools.count(1)
_streams: Dict[int, Callable[[str, bool], None]] = {}
_streams_lock = threading.Lock()


def next_stream_id() -> int:
    """GLOBALLY-unique continuous-serving stream id (minted at submit):
    epoch-prefixed like trace ids, so ids minted by two processes never
    collide.  Sampler seeds are a function of the admission number, not
    this id, so determinism is unaffected."""
    return (tracing.trace_epoch() << 32) | (next(_stream_ids) & 0xFFFFFFFF)


def register_stream(stream_id: int,
                    cancel_cb: Callable[[str, bool], None]) -> None:
    """Register a live/queued serve stream.  ``cancel_cb(reason, force)``
    must be safe to call from any thread (the serve loop consumes the
    mark at its next chunk boundary)."""
    with _streams_lock:
        _streams[stream_id] = cancel_cb


def unregister_stream(stream_id: int) -> None:
    with _streams_lock:
        _streams.pop(stream_id, None)


def cancel_stream(stream_id, reason: str = "cancelled",
                  force: bool = False) -> bool:
    """Mark one serve stream dead.  ``force=False`` (the dead-connection
    default) gives the stream its loop's ``stream_idle_timeout`` grace
    before its blocks/slot are reaped; ``force=True`` reaps at the next
    chunk boundary.  Returns False for an unknown/already-finished id
    (idempotent: a serversink retrying failed sends may call this once
    per failed token)."""
    if stream_id is None:
        return False
    try:
        stream_id = int(stream_id)
    except (TypeError, ValueError):
        return False  # not a server-minted id: nothing to cancel
    with _streams_lock:
        cb = _streams.get(stream_id)
    if cb is None:
        return False
    try:
        cb(reason, force)
    except Exception:  # noqa: BLE001 - backchannel must never throw upward
        log.exception("cancel_stream(%s) callback failed", stream_id)
        return False
    return True


def live_stream_ids() -> List[int]:
    """Registered (queued or live) serve stream ids, for tests/tools."""
    with _streams_lock:
        return sorted(_streams)


# ---------------------------------------------------------------------------
# chaos hooks (test-only)
# ---------------------------------------------------------------------------

_slow_stages: Dict[str, float] = {}
_slow_lock = threading.Lock()


def chaos_slow_stage(name: str, extra_s: float) -> None:
    """TEST-ONLY fault injection: add ``extra_s`` seconds of latency to
    the named stage's work function.  Consulted by soak work functions
    (tools/soak.py ``slow_stage`` profile) — no production element reads
    this.  ``extra_s <= 0`` clears the injection."""
    with _slow_lock:
        if extra_s > 0:
            _slow_stages[name] = float(extra_s)
        else:
            _slow_stages.pop(name, None)


def chaos_slow_delay(name: str) -> float:
    """Injected extra latency for ``name`` (0.0 = none)."""
    with _slow_lock:
        return _slow_stages.get(name, 0.0)


def chaos_clear() -> None:
    with _slow_lock:
        _slow_stages.clear()


# ---------------------------------------------------------------------------
# reconfig knob table
# ---------------------------------------------------------------------------

#: continuous-serving knobs (``custom=`` options) mapped to whether
#: changing them changes a captured step (True: the drain, restart with
#: the new config, adopt path) or only host values (False: safe to change
#: on a running loop).  ``temperature``/``top_k``/``top_p`` are captured
#: into the decode step; ``kv_blocks`` is the pool's shape; ``slots`` is
#: the step's row count; ``stream_chunk`` the replays per host sync.
SERVE_KNOB_SIGNATURE: Dict[str, bool] = {
    "slots": True,
    "block_size": True,
    "kv_blocks": True,
    "prefill_chunk": True,
    "stream_chunk": True,
    "temperature": True,
    "top_k": True,
    "top_p": True,
    "dtype": True,
    # speculative decoding: the draft model's geometry and the verify
    # step's k+1 width are captured step structure
    "draft": True,
    "spec_k": True,
    "draft_seed": True,
    "max_new": False,
    "prefill_budget": False,
    "admit_timeout": False,
    "stream_idle_timeout": False,
    "seed": False,
    # prefix sharing is host-only state (refcounts + the hash index):
    # flipping it changes admission behavior, never a captured step
    "prefix_cache": False,
}


#: defaults of the serving knobs (``LLMFramework.open``'s): a reconfig of
#: an UNSET knob compares against these, so proposing the value a loop
#: already runs with is a no-op, not a spurious signature change.  ``prefill_budget`` has no static
#: default (it tracks prefill_chunk) — omitted; it is a host-value knob
#: anyway.
SERVE_KNOB_DEFAULTS: Dict[str, object] = {
    "slots": 4, "block_size": 16, "kv_blocks": 0, "prefill_chunk": 32,
    "stream_chunk": 8, "temperature": 0.0, "top_k": 0, "top_p": 1.0,
    "dtype": "bfloat16", "max_new": 32, "admit_timeout": 30.0,
    "stream_idle_timeout": 5.0, "seed": 0,
    "draft": "", "spec_k": 4, "draft_seed": 0, "prefix_cache": 1,
}


def _knob_equal(a, b) -> bool:
    try:
        return float(a) == float(b)
    except (TypeError, ValueError):
        return str(a) == str(b)


def signature_changes(current: Dict[str, object],
                      reconfig: Dict[str, object]
                      ) -> List[Tuple[str, object, object]]:
    """``(knob, old, new)`` for every requested reconfig knob that
    changes a captured step.  ``current`` holds the parsed ``custom=`` options;
    missing keys compare against :data:`SERVE_KNOB_DEFAULTS` (numeric
    comparison where possible, so ``0`` == ``0.0``)."""
    out: List[Tuple[str, object, object]] = []
    for knob, new in (reconfig or {}).items():
        if not SERVE_KNOB_SIGNATURE.get(knob, False):
            continue
        old = current.get(knob, SERVE_KNOB_DEFAULTS.get(knob))
        if old is None or not _knob_equal(old, new):
            out.append((knob, current.get(knob), new))
    return out


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScaleRule:
    """One policy-table row: when ``tenant``'s burn rate crosses
    ``burn_above``, ENGAGE ``action``; when it falls back under
    ``burn_below``, RELAX it.  ``cooldown_s`` rate-limits both edges, and
    the two bands are the hysteresis that keeps the loop from flapping.

    Actions:

    * ``admission:shed`` / ``admission:downgrade`` — override the query
      front door's admission policy for this tenant (the
      ``_ServerCore.tenant_admission`` map); relax removes the override
      (back to the element's configured policy, typically ``block``).
    * ``kv_quota:N`` — cap the tenant's paged-KV block reservations on
      every continuous serve loop at N blocks (a host-value quota the
      admission step enforces); relax clears the quota.
    * ``spill`` — drain ONE of the tenant's live serve streams and adopt
      it on the autoscaler's ``spill_to`` pipeline.  Re-fires once per
      cooldown while the burn stays above the band (no relax edge —
      adopted streams stay where they landed).
    """

    tenant: str = "*"
    burn_above: float = 1.5
    burn_below: float = 0.5
    action: str = "admission:shed"
    cooldown_s: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "ScaleRule":
        return cls(tenant=str(d.get("tenant", "*")),
                   burn_above=float(d.get("burn_above", 1.5)),
                   burn_below=float(d.get("burn_below", 0.5)),
                   action=str(d.get("action", "admission:shed")),
                   cooldown_s=float(d.get("cooldown_s", 2.0)))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_ACTION_KINDS = ("admission", "kv_quota", "spill")


def validate_autoscale_policy(d: dict) -> List[str]:
    """Schema problems of an autoscale policy dict (empty = valid)."""
    problems: List[str] = []
    if not isinstance(d, dict):
        return ["policy must be a JSON object"]
    rules = d.get("rules")
    if not isinstance(rules, list) or not rules:
        problems.append("'rules' must be a non-empty list")
        rules = []
    for i, r in enumerate(rules):
        if not isinstance(r, dict):
            problems.append(f"rules[{i}]: must be an object")
            continue
        action = str(r.get("action", "admission:shed"))
        kind = action.split(":", 1)[0]
        if kind not in _ACTION_KINDS:
            problems.append(
                f"rules[{i}].action: {action!r} (expected one of "
                f"admission:shed|admission:downgrade|kv_quota:N|spill)")
        elif kind == "admission" and action.split(":", 1)[1] not in (
                "shed", "downgrade"):
            problems.append(
                f"rules[{i}].action: admission override must be "
                f"shed|downgrade, got {action!r}")
        elif kind == "kv_quota":
            try:
                if int(action.split(":", 1)[1]) < 0:
                    raise ValueError
            except (IndexError, ValueError):
                problems.append(
                    f"rules[{i}].action: kv_quota needs a block count "
                    f">= 0, got {action!r}")
        for key in ("burn_above", "burn_below", "cooldown_s"):
            v = r.get(key, 1.0)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(f"rules[{i}].{key}: must be a number >= 0")
        ab, bb = r.get("burn_above", 1.5), r.get("burn_below", 0.5)
        if isinstance(ab, (int, float)) and isinstance(bb, (int, float)) \
                and bb >= ab:
            problems.append(
                f"rules[{i}]: burn_below ({bb}) must be < burn_above "
                f"({ab}) — the hysteresis band must have width")
        unknown = set(r) - {"tenant", "burn_above", "burn_below",
                            "action", "cooldown_s"}
        if unknown:
            problems.append(f"rules[{i}]: unknown keys {sorted(unknown)}")
    unknown = set(d) - {"rules"}
    if unknown:
        problems.append(f"unknown top-level keys {sorted(unknown)}")
    return problems


def load_autoscale_policy(obj) -> List[ScaleRule]:
    """Accepts a list of :class:`ScaleRule`, a ``{"rules": [...]}`` dict,
    or a JSON file path.  Raises ``ValueError`` naming every schema
    problem at once (the ``Pipeline(slo=)`` construction-time contract)."""
    if obj is None:
        return []
    if isinstance(obj, list) and all(isinstance(r, ScaleRule) for r in obj):
        return list(obj)
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(
            f"autoscale policy must be rules | dict | path, got {type(obj)}")
    problems = validate_autoscale_policy(obj)
    if problems:
        raise ValueError("invalid autoscale policy: " + "; ".join(problems))
    return [ScaleRule.from_dict(r) for r in obj["rules"]]


class Autoscaler:
    """Burn-rate-driven control loop over one pipeline's front door.

    Reads ``slo.burn_rate{tenant=}`` from the live registry (published by
    the SLO engine's own 0.5 s loop — ``Pipeline(slo=...)`` must be
    active) and applies the policy table with hysteresis.  Every action
    is recorded in :attr:`actions` (the soak row's audit trail) and
    span-stamped ``elastic.scale`` on the flight recorder; spill rides
    the pipeline's own ``elastic.drain``/``elastic.adopt`` spans.

    >>> scaler = Autoscaler(srv, {"rules": [
    ...     {"tenant": "*", "burn_above": 1.5, "action": "admission:shed"},
    ... ]})
    >>> scaler.start()   # 0.5 s daemon, like the SLO engine
    """

    _GUARDED_BY = {"_state": "_lock", "actions": "_lock"}

    def __init__(self, pipeline, policy, *, spill_to=None,
                 metrics=None, recorder: Optional[tracing.FlightRecorder]
                 = None):
        self.pipeline = pipeline
        self.rules = load_autoscale_policy(policy)
        self.spill_to = spill_to
        self.metrics = metrics if metrics is not None else _global_metrics
        self.recorder = recorder
        #: audit trail: dicts {t, tenant, action, edge, burn}
        self.actions: List[dict] = []
        #: per-(rule index, tenant) state: {"engaged": bool, "last": t}
        self._state: Dict[Tuple[int, str], dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- target discovery --------------------------------------------------
    def _server_cores(self) -> list:
        cores = []
        for el in getattr(self.pipeline, "elements", {}).values():
            core = getattr(el, "_core", None)
            if core is not None and hasattr(core, "tenant_admission"):
                cores.append(core)
        return cores

    def _serve_loops(self, pipeline=None) -> list:
        loops = []
        for el in getattr(pipeline or self.pipeline,
                          "elements", {}).values():
            fw = getattr(el, "fw", None)
            if fw is not None and getattr(fw, "continuous", False):
                loop = getattr(fw, "_serve", None)
                if loop is not None:
                    loops.append(loop)
        return loops

    # -- evaluation --------------------------------------------------------
    def _burns(self) -> Dict[str, float]:
        return {tenant: v for (name, tenant), v
                in self.metrics.labeled_gauges().items()
                if name == "slo.burn_rate"}

    def _span(self, action: str, tenant: str, burn: float,
              edge: str) -> None:
        rec = self.recorder if self.recorder is not None \
            else (tracing.recorder if tracing.recorder.active else None)
        if rec is not None:
            rec.record("elastic.scale", "elastic", None,
                       time.monotonic_ns(), 0, action=action,
                       tenant=tenant, burn=round(burn, 3), edge=edge)

    def _record(self, action: str, tenant: str, burn: float,
                edge: str) -> None:
        self.actions.append({"t": time.monotonic(), "tenant": tenant,
                             "action": action, "edge": edge,
                             "burn": burn})
        self._span(action, tenant, burn, edge)
        log.info("autoscaler: %s %s for tenant %s (burn %.2f)",
                 edge, action, tenant, burn)

    def _apply(self, rule: ScaleRule, tenant: str, burn: float,
               engage: bool) -> bool:
        """One action edge; returns True when it took effect."""
        kind, _, arg = rule.action.partition(":")
        if kind == "admission":
            cores = self._server_cores()
            if not cores:
                return False
            for core in cores:
                if engage:
                    core.tenant_admission[tenant] = arg
                else:
                    core.tenant_admission.pop(tenant, None)
            return True
        if kind == "kv_quota":
            loops = self._serve_loops()
            if not loops:
                return False
            quota = int(arg) if engage else None
            for loop in loops:
                loop.set_tenant_quota(tenant, quota)
            return True
        if kind == "spill":
            if not engage or self.spill_to is None:
                return False
            return self._spill_one(tenant)
        return False

    def _spill_one(self, tenant: str) -> bool:
        """Drain one of ``tenant``'s live serve streams from the primary
        pipeline and adopt it on ``spill_to``."""
        try:
            streams = self.pipeline.serve_streams()
        except Exception:  # noqa: BLE001 - no serve surface: nothing to do
            return False
        for sid, info in sorted(streams.items()):
            if info.get("state") != "live":
                continue
            if tenant not in ("*", info.get("tenant")):
                continue
            try:
                snap = self.pipeline.drain_stream(sid, timeout=10.0)
            except Exception:  # noqa: BLE001 - next candidate
                log.exception("autoscaler: drain of stream %s failed", sid)
                continue
            try:
                self.spill_to.adopt_stream(snap, timeout=10.0)
                return True
            except Exception:  # noqa: BLE001 - spill target refused
                # the snapshot is the ONLY copy of the stream now: put
                # it back where it came from (its slot was just freed,
                # so the home pipeline can re-admit it) rather than
                # letting a full spill target silently kill the client
                log.exception(
                    "autoscaler: spill target refused stream %s; "
                    "re-adopting at home", sid)
                try:
                    self.pipeline.adopt_stream(snap, timeout=10.0)
                except Exception:  # noqa: BLE001 - truly lost
                    log.critical(
                        "autoscaler: stream %s lost in spill (drain "
                        "succeeded, both adopts failed)", sid)
                # a refusing target is almost certainly FULL: back off
                # until the next cooldown instead of bouncing every
                # remaining stream through a drain/re-adopt hiccup
                return False
        return False

    def evaluate(self) -> int:
        """One control tick; returns the number of action edges taken."""
        burns = self._burns()
        now = time.monotonic()
        edges = 0
        with self._lock:
            for i, rule in enumerate(self.rules):
                tenants = (sorted(burns) if rule.tenant == "*"
                           else [rule.tenant])
                for tenant in tenants:
                    burn = burns.get(tenant, 0.0)
                    # no edge yet: the cooldown holds nothing back (the
                    # JAX package starts the clock at 0.0, so on a host
                    # up for less than cooldown_s no rule ever fires)
                    st = self._state.setdefault(
                        (i, tenant), {"engaged": False, "last": float("-inf")})
                    if now - st["last"] < rule.cooldown_s:
                        continue
                    if burn >= rule.burn_above and (
                            not st["engaged"]
                            or rule.action == "spill"):
                        if self._apply(rule, tenant, burn, engage=True):
                            st.update(engaged=True, last=now)
                            self._record(rule.action, tenant, burn,
                                         "engage")
                            edges += 1
                    elif st["engaged"] and burn <= rule.burn_below:
                        if self._apply(rule, tenant, burn, engage=False):
                            st.update(engaged=False, last=now)
                            self._record(rule.action, tenant, burn,
                                         "relax")
                            edges += 1
        return edges

    # -- continuous mode ---------------------------------------------------
    def start(self, period_s: float = 0.5) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 - must never die loud
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=loop, name="nns-elastic",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
