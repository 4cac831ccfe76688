"""nns-proto model checker: bounded explicit-state exploration of the
distributed serving protocols.

Port of ``nnstreamer_tpu/analysis/statemachine.py``, copied whole (pure
Python): the five shipped models read their alphabets from the port's
own ``core/meta_keys.py``, and explore to the same state counts and
verdicts as the JAX package's.

The runtime protocols (elements/query.py exactly-once delivery,
filters/llm.py drain→adopt handover, utils/armor.py quarantine,
utils/elastic.py spill hysteresis) are exercised dynamically by the
chaos soak (docs/ROBUSTNESS.md); this module gives each one a
compile-time twin: a small declarative state machine whose FULL state
graph is explored under the same fault vocabulary the soak injects —
message drop / duplication / reordering and crash-before-ack — checking
safety invariants on every reachable state and liveness (every reachable
state can still reach an accepting state) by backward reachability over
the explored graph.  Violations come back with the complete transition
trace from the initial state, so a counterexample reads like a soak log.

DSL
---
A :class:`Model` is a dict-shaped initial state, a list of :class:`Rule`
transitions (``guard(state) -> bool``, ``effect(state) -> state | [state]``;
the effect receives a private mutable copy), named safety ``invariants``,
an ``accepting`` predicate (the "done / healthy" states liveness must
keep reachable), and the protocol ``alphabet`` the model covers (checked
against the AST-extracted code alphabet by analysis/protocol.py).  State
keys whose value is a tuple and that are listed in ``channels`` are
lossy/reordering message channels: the explorer auto-generates
drop/dup/reorder fault rules for them, budgeted by the ``_drop`` /
``_dup`` / ``_reorder`` counters in the initial state.  Crash faults are
ordinary model rules (what survives a crash — the journal, the free
list — is protocol knowledge, not harness knowledge).

This module imports only the standard library and the key registry: it
runs inside the ``lint --proto`` gate on machines with no card.

See docs/ANALYSIS.md "Protocol pass" for the model inventory and a
counterexample reading guide.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..core import meta_keys

__all__ = [
    "Rule", "Model", "Violation", "CheckResult", "check",
    "exactly_once_model", "handover_model", "quarantine_model",
    "hysteresis_model", "weave_clock_model", "SHIPPED_MODELS",
    "shipped_alphabet",
]


# ---------------------------------------------------------------------------
# state freezing (dict states -> hashable canonical form)
# ---------------------------------------------------------------------------

def _freeze(v):
    if isinstance(v, dict):
        return ("d", tuple(sorted(((k, _freeze(x)) for k, x in v.items()),
                                  key=repr)))
    if isinstance(v, (set, frozenset)):
        return ("s", tuple(sorted((_freeze(x) for x in v), key=repr)))
    if isinstance(v, (list, tuple)):
        return ("t", tuple(_freeze(x) for x in v))
    return v


def _thaw(v):
    if isinstance(v, tuple) and len(v) == 2 and v[0] in ("d", "s", "t"):
        tag, items = v
        if tag == "d":
            return {k: _thaw(x) for k, x in items}
        if tag == "s":
            return frozenset(_thaw(x) for x in items)
        return tuple(_thaw(x) for x in items)
    return v


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named transition: fires when ``guard`` holds, producing the
    state(s) returned by ``effect`` (which may mutate its private copy
    in place and return it, or return a list for nondeterminism)."""
    name: str
    guard: Callable[[dict], bool]
    effect: Callable[[dict], object]
    fault: bool = False  # injected fault, not protocol behavior


@dataclasses.dataclass
class Model:
    name: str
    init: dict
    rules: List[Rule]
    invariants: Dict[str, Callable[[dict], bool]]
    accepting: Callable[[dict], bool]
    #: protocol meta keys / message kinds this model covers — compared
    #: against the AST-extracted code alphabet by the drift gate
    alphabet: FrozenSet[str]
    #: state keys holding message channels (tuples) subject to faults
    channels: Sequence[str] = ()
    #: per-channel length cap (dup is disabled at the cap)
    channel_cap: int = 3


@dataclasses.dataclass
class Violation:
    kind: str              # "safety" | "deadlock" | "wedge"
    prop: str              # invariant name / accepting-property name
    trace: List[Tuple[str, dict]]  # (rule fired, resulting state) from init
    state: dict

    def render(self) -> str:
        lines = [f"{self.kind} violation: {self.prop}",
                 f"  trace ({len(self.trace)} steps from init):"]
        for step, (rule, state) in enumerate(self.trace):
            lines.append(f"    {step:3d}. {rule:<28s} -> {_fmt_state(state)}")
        lines.append(f"  violating state: {_fmt_state(self.state)}")
        return "\n".join(lines)


def _fmt_state(s: dict) -> str:
    parts = []
    for k in sorted(s, key=repr):
        v = s[k]
        if isinstance(v, frozenset):
            v = "{" + ",".join(sorted(map(str, v))) + "}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


@dataclasses.dataclass
class CheckResult:
    model: str
    ok: bool
    states: int
    transitions: int
    elapsed_s: float
    violation: Optional[Violation] = None
    bounded_out: bool = False  # hit max_states before exhausting the graph

    def render(self) -> str:
        verdict = "OK" if self.ok else "FAIL"
        head = (f"[{verdict}] {self.model}: {self.states} states, "
                f"{self.transitions} transitions, {self.elapsed_s*1e3:.1f} ms"
                + (" (STATE BOUND HIT)" if self.bounded_out else ""))
        if self.violation is None:
            return head
        return head + "\n" + self.violation.render()


# ---------------------------------------------------------------------------
# auto-generated channel fault rules
# ---------------------------------------------------------------------------

def _channel_fault_rules(channels: Sequence[str], cap: int) -> List[Rule]:
    rules: List[Rule] = []
    for ch in channels:
        def mk(ch=ch):
            def drop(s):
                out = []
                for i in range(len(s[ch])):
                    t = dict(s)
                    t[ch] = t[ch][:i] + t[ch][i + 1:]
                    t["_drop"] -= 1
                    out.append(t)
                return out

            def dup(s):
                out = []
                for i in range(len(s[ch])):
                    t = dict(s)
                    t[ch] = t[ch][:i + 1] + t[ch][i:]
                    t["_dup"] -= 1
                    out.append(t)
                return out

            def reorder(s):
                out = []
                for i in range(len(s[ch]) - 1):
                    t = dict(s)
                    c = list(t[ch])
                    c[i], c[i + 1] = c[i + 1], c[i]
                    t[ch] = tuple(c)
                    t["_reorder"] -= 1
                    out.append(t)
                return out

            return [
                Rule(f"fault.drop[{ch}]",
                     lambda s: s.get("_drop", 0) > 0 and len(s[ch]) > 0,
                     drop, fault=True),
                Rule(f"fault.dup[{ch}]",
                     lambda s: s.get("_dup", 0) > 0
                     and 0 < len(s[ch]) < cap,
                     dup, fault=True),
                Rule(f"fault.reorder[{ch}]",
                     lambda s: s.get("_reorder", 0) > 0 and len(s[ch]) > 1,
                     reorder, fault=True),
            ]
        rules.extend(mk())
    return rules


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------

def check(model: Model, max_states: int = 200_000) -> CheckResult:
    """Exhaustively explore ``model``'s state graph (BFS), checking every
    invariant on every reachable state, deadlock-freedom (a quiescent
    state must be accepting), and liveness (every reachable state can
    still reach an accepting state — computed by backward reachability
    once the graph is exhausted).  Returns the first violation with its
    full transition trace."""
    t0 = time.monotonic()
    rules = list(model.rules) + _channel_fault_rules(
        model.channels, model.channel_cap)
    init_f = _freeze(model.init)
    # pred: state -> (predecessor, rule name) for trace reconstruction
    pred: Dict[object, Optional[Tuple[object, str]]] = {init_f: None}
    rev: Dict[object, List[object]] = collections.defaultdict(list)
    frontier = collections.deque([init_f])
    accepting: List[object] = []
    n_trans = 0
    bounded_out = False

    def trace_to(sf) -> List[Tuple[str, dict]]:
        steps = []
        cur = sf
        while pred[cur] is not None:
            prev, rule = pred[cur]
            steps.append((rule, _thaw(cur)))
            cur = prev
        steps.reverse()
        return steps

    while frontier:
        sf = frontier.popleft()
        s = _thaw(sf)
        for prop, inv in model.invariants.items():
            if not inv(s):
                return CheckResult(
                    model.name, False, len(pred), n_trans,
                    time.monotonic() - t0,
                    Violation("safety", prop, trace_to(sf), s))
        if model.accepting(s):
            accepting.append(sf)
        quiescent = True
        for rule in rules:
            if not rule.guard(s):
                continue
            succs = rule.effect(_thaw(sf))
            if succs is None:
                succs = []
            elif isinstance(succs, dict):
                succs = [succs]
            for t in succs:
                quiescent = False
                n_trans += 1
                tf = _freeze(t)
                rev[tf].append(sf)
                if tf not in pred:
                    if len(pred) >= max_states:
                        bounded_out = True
                        continue
                    pred[tf] = (sf, rule.name)
                    frontier.append(tf)
        if quiescent and not model.accepting(s):
            return CheckResult(
                model.name, False, len(pred), n_trans,
                time.monotonic() - t0,
                Violation("deadlock", "quiescent-non-accepting",
                          trace_to(sf), s))

    # liveness: states that can NOT reach any accepting state are wedges
    co = set(accepting)
    work = collections.deque(accepting)
    while work:
        tf = work.popleft()
        for sf in rev[tf]:
            if sf not in co:
                co.add(sf)
                work.append(sf)
    for sf in pred:
        if sf not in co:
            return CheckResult(
                model.name, False, len(pred), n_trans,
                time.monotonic() - t0,
                Violation("wedge", "accepting-unreachable",
                          trace_to(sf), _thaw(sf)))
    return CheckResult(model.name, not bounded_out, len(pred), n_trans,
                       time.monotonic() - t0, None, bounded_out)


# ---------------------------------------------------------------------------
# shipped model 1: client reconnect/resend x journal dedupe/replay
# ---------------------------------------------------------------------------

def exactly_once_model(n_requests: int = 2, *, journal: bool = True,
                       client_dedupe: bool = True,
                       resend: bool = True) -> Model:
    """Exactly-once delivery (docs/ROBUSTNESS.md "Durable request
    journal" + elements/query.py client resend): every request is
    answered exactly once at the client app despite drop/dup/reorder on
    both wire directions and a server crash before the journal ack.

    ``client_dedupe=False`` (client counts duplicate answers) and
    ``resend=False`` (fire-and-forget client: each request is sent once)
    are the known-bad mutations used by the tests: the first answers a
    request twice (safety), the second wedges on any dropped frame
    (liveness — no path back to all-answered).  ``journal=False``
    disables append-before-admission/replay; the model still verifies
    because client resend alone re-covers a crashed queue — the journal
    is what answers a request whose CLIENT is gone (replay acks), which
    is outside this model's client-visible property.
    """
    rids = tuple(range(n_requests))
    init = {
        "pending": frozenset(rids),      # client: not yet answered
        "answers": {r: 0 for r in rids},  # app-visible answer count
        # fire-and-forget clients preload the wire; resending clients
        # (re)issue pending requests from the resend rule instead
        "c2s": () if resend else tuple(("req", r) for r in rids),
        "s2c": (),                       # wire channels
        "srv_q": (),                     # admitted in-memory work (lost on crash)
        "journal": frozenset(),          # durable: appended seqnos (rids)
        "acked": frozenset(),            # durable: answered seqnos
        "_drop": 1, "_dup": 1, "_reorder": 1, "_crash": 1,
    }

    def do_resend(s):
        # timeout/reconnect resend of every still-pending request id
        out = []
        for r in sorted(s["pending"]):
            if s["c2s"].count(("req", r)) == 0 and len(s["c2s"]) < 3:
                t = dict(s)
                t["c2s"] = t["c2s"] + (("req", r),)
                out.append(t)
        return out

    def srv_recv(s):
        (kind, r), rest = s["c2s"][0], s["c2s"][1:]
        t = dict(s)
        t["c2s"] = rest
        if journal:
            t["journal"] = t["journal"] | {r}
        if r in t["acked"]:
            # journal dedupe: already answered — re-answer from the
            # durable record instead of re-admitting the work
            if len(t["s2c"]) < 3:
                t["s2c"] = t["s2c"] + (("resp", r),)
        elif t["srv_q"].count(r) == 0:
            t["srv_q"] = t["srv_q"] + (r,)
        return t

    def srv_answer(s):
        r, rest = s["srv_q"][0], s["srv_q"][1:]
        t = dict(s)
        t["srv_q"] = rest
        t["s2c"] = t["s2c"] + (("resp", r),)
        t["acked"] = t["acked"] | {r}
        return t

    def crash(s):
        # crash-before-ack: in-memory queue and both wire channels are
        # lost; the journal and its acks survive
        t = dict(s)
        t["srv_q"] = ()
        t["c2s"] = ()
        t["s2c"] = ()
        t["_crash"] -= 1
        return t

    def replay(s):
        # recovery: journalled-but-unacked requests re-enter admission
        out = []
        for r in sorted(s["journal"] - s["acked"]):
            if s["srv_q"].count(r) == 0:
                t = dict(s)
                t["srv_q"] = t["srv_q"] + (r,)
                out.append(t)
        return out

    def cli_recv(s):
        (kind, r), rest = s["s2c"][0], s["s2c"][1:]
        t = dict(s)
        t["s2c"] = rest
        if client_dedupe and r not in t["pending"]:
            return t  # duplicate answer: dropped at the client cursor
        t["pending"] = t["pending"] - {r}
        t["answers"] = dict(t["answers"])
        t["answers"][r] += 1
        return t

    return Model(
        name="exactly-once",
        init=init,
        rules=[
            Rule("client.resend",
                 lambda s: resend and bool(s["pending"]), do_resend),
            Rule("server.recv", lambda s: len(s["c2s"]) > 0
                 and len(s["srv_q"]) < 3, srv_recv),
            Rule("server.answer", lambda s: len(s["srv_q"]) > 0
                 and len(s["s2c"]) < 3, srv_answer),
            Rule("server.crash", lambda s: s["_crash"] > 0, crash,
                 fault=True),
            Rule("journal.replay",
                 lambda s: bool(s["journal"] - s["acked"]), replay),
            Rule("client.recv", lambda s: len(s["s2c"]) > 0, cli_recv),
        ],
        invariants={
            "answered-at-most-once":
                lambda s: all(n <= 1 for n in s["answers"].values()),
        },
        accepting=lambda s: not s["pending"]
        and all(n == 1 for n in s["answers"].values()),
        alphabet=frozenset({
            meta_keys.META_QUERY_MSG, meta_keys.META_QUERY_CONN,
            meta_keys.META_JOURNAL_SEQ, meta_keys.META_JOURNAL_REPLAY,
            meta_keys.META_QUERY_BATCH, meta_keys.META_SHED,
            meta_keys.META_WIRE_REJECT, meta_keys.META_ERROR,
            meta_keys.ABORT_REASON_WIRE, meta_keys.ABORT_REASON_INTERNAL,
            meta_keys.CTRL_HELLO, meta_keys.CTRL_ACK, meta_keys.CTRL_NACK,
            # journal record magics + the wire frame magic: the journal
            # rules below model exactly their append/replay lifecycle
            "record:REQ", "record:ACK", "record:FRAME",
        }),
        channels=("c2s", "s2c"),
    )


# ---------------------------------------------------------------------------
# shipped model 2: drain -> adopt handover
# ---------------------------------------------------------------------------

def handover_model(n_streams: int = 2, *, adopt_guard: bool = True,
                   release_on_drain: bool = True) -> Model:
    """Elastic handover (filters/llm.py drain_stream/adopt_stream,
    docs/SERVING.md §4d): every live stream drained from the source
    serve loop is adopted exactly once at the target, KV blocks return
    to the free list on every path — including a crash that loses the
    snapshot mid-transfer (the orchestrator retains it and retries).

    ``adopt_guard=False`` lets a duplicated snapshot adopt twice
    (safety); ``release_on_drain=False`` leaks the source block when the
    transfer crashes (wedge: blocks never all return).
    """
    sids = tuple(range(n_streams))
    total = n_streams  # one KV block per stream, per side
    init = {
        "src_live": frozenset(sids),
        "src_used": n_streams,          # blocks held by source slots
        "orch": frozenset(),            # snapshots the orchestrator holds
        "xfer": (),                     # adopt calls in flight
        "dst_live": frozenset(),
        "dst_used": 0,
        "done": frozenset(),
        "_drop": 1, "_dup": 1, "_reorder": 1,
    }

    def drain(s):
        out = []
        for sid in sorted(s["src_live"]):
            t = dict(s)
            t["src_live"] = t["src_live"] - {sid}
            if release_on_drain:
                # snapshot MATERIALIZES host copies; pool blocks free now
                t["src_used"] -= 1
            t["orch"] = t["orch"] | {sid}
            out.append(t)
        return out

    def submit(s):
        out = []
        for sid in sorted(s["orch"]):
            if s["xfer"].count(("snap", sid)) == 0 and len(s["xfer"]) < 3:
                t = dict(s)
                t["xfer"] = t["xfer"] + (("snap", sid),)
                out.append(t)
        return out

    def adopt(s):
        (kind, sid), rest = s["xfer"][0], s["xfer"][1:]
        t = dict(s)
        t["xfer"] = rest
        if adopt_guard and (sid in t["dst_live"] or sid in t["done"]):
            return t  # duplicate snapshot: already adopted — rejected
        t["dst_live"] = t["dst_live"] | {sid}
        t["dst_used"] += 1
        t["orch"] = t["orch"] - {sid}
        return t

    def finish(s):
        out = []
        for sid in sorted(s["dst_live"]):
            t = dict(s)
            t["dst_live"] = t["dst_live"] - {sid}
            t["dst_used"] -= 1
            t["done"] = t["done"] | {sid}
            out.append(t)
        return out

    return Model(
        name="drain-adopt",
        init=init,
        rules=[
            Rule("src.drain", lambda s: bool(s["src_live"]), drain),
            Rule("orch.submit", lambda s: bool(s["orch"]), submit),
            Rule("dst.adopt", lambda s: len(s["xfer"]) > 0, adopt),
            Rule("dst.finish", lambda s: bool(s["dst_live"]), finish),
        ],
        invariants={
            "no-duplicate-stream":
                lambda s: not (s["src_live"] & s["dst_live"])
                and not (s["dst_live"] & s["done"])
                and s["dst_used"] == len(s["dst_live"]),
            "block-accounting":
                lambda s: 0 <= s["src_used"] <= total
                and 0 <= s["dst_used"] <= total,
        },
        accepting=lambda s: s["done"] == frozenset(sids)
        and s["src_used"] == 0 and s["dst_used"] == 0,
        alphabet=frozenset({
            meta_keys.META_STREAM_ID, meta_keys.META_STREAM_INDEX,
            meta_keys.META_STREAM_LAST,
            # live-stream snapshot version tag carried by drain->adopt
            "snapshot:v2",
        }),
        channels=("xfer",),
    )


# ---------------------------------------------------------------------------
# shipped model 3: DLQ / circuit-breaker quarantine
# ---------------------------------------------------------------------------

def quarantine_model(n_requests: int = 2, *, dlq_guard: bool = True,
                     max_retries: int = 1) -> Model:
    """Poison armor (utils/armor.py, docs/ROBUSTNESS.md "Poison armor"):
    a request that keeps failing is quarantined to the DLQ and its
    client receives the typed ``abort_reason=poison`` terminator; a
    quarantined id NEVER re-enters the live path, even when the fault
    injector re-delivers a stale duplicate of it.

    ``dlq_guard=False`` is the known-bad mutation: a duplicated message
    of an already-quarantined id is re-admitted (safety violation).
    """
    rids = tuple(range(n_requests))
    init = {
        "live": tuple(("req", r) for r in rids),
        "attempts": {r: 0 for r in rids},
        "dlq": frozenset(),
        "answered": frozenset(),   # poison terminator delivered
        "relive": frozenset(),     # quarantined id seen live again (bug)
        "_drop": 0, "_dup": 1, "_reorder": 1,
    }

    def process(s):
        (kind, r), rest = s["live"][0], s["live"][1:]
        t = dict(s)
        t["live"] = rest
        if r in t["dlq"]:
            if dlq_guard:
                return t  # stale duplicate of a quarantined id: dropped
            t["relive"] = t["relive"] | {r}
            return t
        t["attempts"] = dict(t["attempts"])
        t["attempts"][r] += 1
        if t["attempts"][r] > max_retries:
            # quarantine: DLQ record + typed poison terminator
            t["dlq"] = t["dlq"] | {r}
            t["answered"] = t["answered"] | {r}
        elif t["live"].count(("req", r)) == 0 and len(t["live"]) < 3:
            t["live"] = t["live"] + (("req", r),)  # retry
        return t

    return Model(
        name="dlq-quarantine",
        init=init,
        rules=[
            Rule("armor.process", lambda s: len(s["live"]) > 0, process),
        ],
        invariants={
            "quarantined-never-relive": lambda s: not s["relive"],
            "bounded-retries":
                lambda s: all(n <= max_retries + 1
                              for n in s["attempts"].values()),
        },
        accepting=lambda s: not s["live"]
        and s["answered"] == frozenset(rids),
        alphabet=frozenset({
            meta_keys.META_POISON, meta_keys.META_DLQ,
            meta_keys.META_ABORT_REASON, meta_keys.ABORT_REASON_POISON,
            meta_keys.META_STREAM_ABORTED, meta_keys.META_TRACE_ID,
            meta_keys.META_INGRESS_NS,
            # DLQ record magic: the quarantine rule models its lifecycle
            "record:DLQ",
        }),
        channels=("live",),
    )


# ---------------------------------------------------------------------------
# shipped model 4: autoscaler spill hysteresis
# ---------------------------------------------------------------------------

def hysteresis_model(cooldown: int = 2, *, honor_cooldown: bool = True,
                     horizon: int = 6) -> Model:
    """Autoscaler admission spill (utils/elastic.ScaleRule engage/relax
    edges): once a tenant class is flipped to shed, it may not relax
    before the cooldown elapses — and vice versa — no matter how the
    burn-rate signal flaps, so admission never oscillates faster than
    the cooldown window.

    ``honor_cooldown=False`` removes the guard: a flapping burn signal
    produces a shed->relax flip inside the window (safety violation).
    """
    init = {
        "burn_high": False,   # environment: SLO burn above the edge?
        "mode": "ok",         # admission override: ok | shed
        "since_flip": cooldown,  # ticks since the last mode change
        "tick": 0,            # bounded time horizon
        "early_flip": False,  # a flip fired inside the cooldown window
    }

    def env_flap(s):
        t = dict(s)
        t["burn_high"] = not t["burn_high"]
        return t

    def tick(s):
        t = dict(s)
        t["tick"] += 1
        t["since_flip"] = min(t["since_flip"] + 1, cooldown)
        return t

    def flip(s, to):
        t = dict(s)
        if t["since_flip"] < cooldown:
            t["early_flip"] = True
        t["mode"] = to
        t["since_flip"] = 0
        return t

    def guard_flip(s, want_burn, frm):
        if s["mode"] != frm or s["burn_high"] is not want_burn:
            return False
        return s["since_flip"] >= cooldown if honor_cooldown else True

    return Model(
        name="spill-hysteresis",
        init=init,
        rules=[
            Rule("env.flap", lambda s: s["tick"] < horizon, env_flap),
            Rule("clock.tick", lambda s: s["tick"] < horizon, tick),
            Rule("scale.engage-shed",
                 lambda s: guard_flip(s, True, "ok"),
                 lambda s: flip(s, "shed")),
            Rule("scale.relax",
                 lambda s: guard_flip(s, False, "shed"),
                 lambda s: flip(s, "ok")),
        ],
        invariants={
            "no-flip-inside-cooldown": lambda s: not s["early_flip"],
        },
        accepting=lambda s: True,
        alphabet=frozenset({
            meta_keys.META_TENANT, meta_keys.META_SHED,
        }),
        channels=(),
    )


def weave_clock_model(retries: int = 2, *, dedup_guard: bool = True
                      ) -> Model:
    """nns-weave clock probe/ack exchange (elements/query.py client rx
    loop + _ServerCore._reader; docs/OBSERVABILITY.md "Distributed
    tracing"): the client sends ``clock`` probes stamped t0, the server
    answers each with a ``clock_ack`` echoing t0, and the client applies
    ONE offset sample per outstanding probe — a duplicated or replayed
    ack (the channels are lossy AND duplicating) must never double-apply,
    or the refresh-timestamp bookkeeping would claim more samples than
    probes were ever sent.  The distributed parent context
    (``_tparent``) rides the same connection's data frames; its
    scrub-then-adopt step has no protocol state beyond what
    exactly-once already covers, so this model carries it in the
    alphabet only.

    ``dedup_guard=False`` removes the outstanding-probe check: a
    duplicated ack double-applies (safety counterexample).
    """
    init = {
        "retries": retries,      # probes the client may still send
        "probes": 0,             # probes sent so far (t0 = probe index)
        "outstanding": frozenset(),  # t0s sent but not yet applied
        "synced": 0,             # distinct probes that produced a sample
        "applied": 0,            # offset applications (must <= probes)
        "c2s": (),               # clock probes in flight
        "s2c": (),               # clock_acks in flight
        "_drop": 1, "_dup": 1, "_reorder": 1,
    }

    def send_probe(s):
        t = dict(s)
        t0 = t["probes"]
        t["retries"] -= 1
        t["probes"] += 1
        t["outstanding"] = t["outstanding"] | {t0}
        t["c2s"] = t["c2s"] + (t0,)
        return t

    def server_echo(s):
        t = dict(s)
        t0, t["c2s"] = t["c2s"][0], t["c2s"][1:]
        t["s2c"] = t["s2c"] + (("ack", t0),)
        return t

    def client_apply(s):
        t = dict(s)
        (_, t0), t["s2c"] = t["s2c"][0], t["s2c"][1:]
        if t0 in t["outstanding"] or not dedup_guard:
            if t0 in t["outstanding"]:
                t["outstanding"] = t["outstanding"] - {t0}
                t["synced"] += 1
            t["applied"] += 1
        return t

    return Model(
        name="weave-clock",
        init=init,
        rules=[
            Rule("clock.send-probe", lambda s: s["retries"] > 0,
                 send_probe),
            Rule("server.echo", lambda s: bool(s["c2s"]), server_echo),
            Rule("client.apply", lambda s: bool(s["s2c"]), client_apply),
        ],
        invariants={
            "applies-bounded-by-probes":
                lambda s: s["applied"] <= s["probes"],
        },
        accepting=lambda s: s["synced"] >= 1 or (
            s["retries"] == 0 and not s["c2s"] and not s["s2c"]),
        alphabet=frozenset({
            meta_keys.CTRL_CLOCK, meta_keys.CTRL_CLOCK_ACK,
            meta_keys.META_TRACE_PARENT,
        }),
        channels=("c2s", "s2c"),
    )


#: name -> zero-arg factory for every model shipped (and CI-checked)
SHIPPED_MODELS: Dict[str, Callable[[], Model]] = {
    "exactly-once": exactly_once_model,
    "drain-adopt": handover_model,
    "dlq-quarantine": quarantine_model,
    "spill-hysteresis": hysteresis_model,
    "weave-clock": weave_clock_model,
}


def shipped_alphabet() -> FrozenSet[str]:
    """Union of every shipped model's declared alphabet — what the
    models collectively claim to cover; the drift gate in
    analysis/protocol.py compares this against the code's alphabet."""
    out: FrozenSet[str] = frozenset()
    for factory in SHIPPED_MODELS.values():
        out = out | factory().alphabet
    return out
