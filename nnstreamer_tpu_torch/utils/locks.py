"""nns-tsan dynamic side: opt-in tracked lock primitives.

Port of ``nnstreamer_tpu/utils/locks.py`` (stdlib only): the port's
metrics registry, request journal, sink window, stage queues and
capture census construct their locks through :func:`make_lock`.
:func:`report` also lists the names of the tracked locks taken.

The threaded runtime's lock discipline is checked twice, from two
directions that meet in the middle:

* **statically** — :mod:`..analysis.concurrency` reads the package
  source and verifies the ``_GUARDED_BY`` contract, the nested
  ``with`` lock-order graph, and thread join lifecycles (``lint
  --threads``);
* **dynamically** — this module's :class:`TrackedLock` /
  :class:`TrackedRLock` / :class:`TrackedCondition` record every
  *actual* per-thread acquisition into a process-wide order graph
  (:data:`graph`) and detect, live: lock-order inversions (an A→B edge
  observed after B→A), same-thread re-entry of a non-reentrant lock
  (certain self-deadlock — reported *before* blocking forever), and
  guarded-field access without the declared lock
  (:func:`assert_guarded`).

Opt-in and zero-overhead off.  The hot lock owners construct their
primitives through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`; with ``NNS_TPU_TSAN`` unset those factories
return **plain** ``threading`` primitives, so the off path is the
untracked code path — there is no "tracking that discards", exactly the
trace-off structural pin (tools/tracing_gate.py).  CI pins this by
monkeypatching :meth:`LockOrderGraph.acquired` to raise and running the
suite with the env unset.  With ``NNS_TPU_TSAN=1`` a detected inversion
always counts ``tsan.inversions``, fires a ``tsan.inversion`` span and a
flight-ring dump; it additionally **raises** :class:`LockOrderError`
when ``NNS_TPU_TSAN_RAISE=1`` (tests) — soak chaos runs record-only and
assert zero after the fact via :func:`report`.

Lock *names* are class-level identities (``"StageQueue._lock"``): the
order graph deliberately keys edges by name, not instance, so an
inversion between any two instances of the same two lock classes is the
same finding the static pass would report.  Same-name edges are ignored
(two _StageQueue instances nest by pipeline topology, a hierarchy the
name key cannot order), except same-*instance* re-entry, which is a
hard error for non-reentrant locks.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "NNS_TPU_TSAN"
ENV_RAISE = "NNS_TPU_TSAN_RAISE"

#: flips True the first time a factory vends a tracked primitive; the
#: cheap early-out for assert_guarded() call sites in untracked runs
_active = False


def enabled() -> bool:
    """True when ``NNS_TPU_TSAN=1`` — read at *factory call* time, so a
    test can flip the env and construct a fresh tracked owner without
    re-importing anything."""
    return os.environ.get(ENV_FLAG, "") == "1"


class LockOrderError(RuntimeError):
    """A live lock-order inversion or non-reentrant self-deadlock."""


class GuardViolation(RuntimeError):
    """A guarded field touched without its declared lock held."""


def _site() -> str:
    """``file:line`` of the acquiring *user* frame: nearest caller that
    is neither this module nor threading.py (Condition wait()/notify()
    route re-acquires through stdlib frames).  Cheap enough in tsan
    mode; never runs when tracking is off."""
    try:
        skip = (__file__, threading.__file__)
        f = sys._getframe(2)
        for _ in range(12):
            if f is None:
                break
            if f.f_code.co_filename not in skip:
                return (f"{os.path.basename(f.f_code.co_filename)}"
                        f":{f.f_lineno}")
            f = f.f_back
    except Exception:  # noqa: BLE001 - bookkeeping must never break locks
        pass
    return "?"


class LockOrderGraph:
    """Process-wide acquisition-order graph + per-thread held stacks.

    Edges are ``(outer name, inner name) -> first site`` observed; a new
    edge whose reverse path already exists is an inversion.  All graph
    state is guarded by its own private mutex (``_mu``), which is always
    innermost and therefore can never participate in an inversion."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: (outer, inner) -> "file:line (thread)" of first observation
        self._edges: Dict[Tuple[str, str], str] = {}
        self._tls = threading.local()
        self._inversions: List[dict] = []
        self._guard_violations: List[dict] = []
        self._seen: set = set()  # dedup key per reported cycle
        #: total first-entry acquisitions — the "tsan actually engaged"
        #: liveness signal (edges stay 0 when no two tracked locks nest)
        self._acquisitions = 0
        #: the names of the tracked locks taken so far (the report's
        #: census of what the order graph covers)
        self._names: set = set()

    # -- per-thread stack --------------------------------------------------
    def _stack(self) -> List[list]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st  # entries: [name, lock_obj, count]

    def held_names(self) -> List[str]:
        return [e[0] for e in self._stack()]

    def holds(self, lock: object) -> bool:
        return any(e[1] is lock for e in self._stack())

    # -- acquisition hooks -------------------------------------------------
    def before_acquire(self, name: str, lock: object, reentrant: bool,
                       blocking: bool) -> None:
        """Called BEFORE blocking: same-instance re-entry of a plain
        Lock would deadlock this thread forever, so it must be caught
        while we can still raise.  Non-blocking probes are exempt —
        Condition's ``_is_owned`` fallback deliberately try-acquires
        the lock its owner already holds."""
        if blocking and not reentrant and self.holds(lock):
            raise LockOrderError(
                f"self-deadlock: thread {threading.current_thread().name!r}"
                f" re-acquiring non-reentrant lock {name!r} it already"
                f" holds (at {_site()})")

    def acquired(self, name: str, lock: object) -> None:
        st = self._stack()
        for e in st:
            if e[1] is lock:  # reentrant re-acquire: count, no new edges
                e[2] += 1
                return
        site = (f"{_site()} "
                f"(thread {threading.current_thread().name!r})")
        new_edges = [(e[0], name) for e in st if e[0] != name]
        st.append([name, lock, 1])
        if not new_edges:
            with self._mu:
                self._acquisitions += 1
                self._names.add(name)
            return
        with self._mu:
            self._acquisitions += 1
            self._names.add(name)
            for a, b in new_edges:
                self._edges.setdefault((a, b), site)
            cycles = [self._find_cycle(a, b) for a, b in new_edges]
        for (a, b), cyc in zip(new_edges, cycles):
            if cyc:
                self._report_inversion(a, b, site, cyc)

    def released(self, name: str, lock: object) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][1] is lock:
                st[i][2] -= 1
                if st[i][2] <= 0:
                    del st[i]
                return

    # -- cycle detection (caller holds _mu) --------------------------------
    def _find_cycle(self, a: str, b: str) -> Optional[List[str]]:
        """Path b →* a in the edge set means edge (a, b) closed a cycle;
        returns the node chain ``[b, ..., a]`` or None."""
        stack, parent = [b], {b: None}
        while stack:
            cur = stack.pop()
            if cur == a:
                chain = [cur]
                while parent[chain[-1]] is not None:
                    chain.append(parent[chain[-1]])
                return chain[::-1]
            for (x, y) in self._edges:
                if x == cur and y not in parent:
                    parent[y] = cur
                    stack.append(y)
        return None

    # -- reporting ---------------------------------------------------------
    def _report_inversion(self, a: str, b: str, site: str,
                          chain: List[str]) -> None:
        key = frozenset(chain) | {a}
        with self._mu:
            if key in self._seen:
                return
            self._seen.add(key)
            back = " -> ".join(chain + [b])
            back_site = self._edges.get((chain[0], chain[1]), "?") \
                if len(chain) > 1 else self._edges.get((b, a), "?")
            rec = {"edge": f"{a} -> {b}", "at": site,
                   "reverse": back, "reverse_at": back_site}
            self._inversions.append(rec)
        msg = (f"lock-order inversion: {a} -> {b} at {site}, but the"
               f" reverse path {back} was first taken at {back_site}")
        self._emit("tsan.inversion", "tsan.inversions", msg)
        if os.environ.get(ENV_RAISE, "") == "1":
            raise LockOrderError(msg)

    def report_guard(self, owner: str, attr: str, lock_name: str) -> None:
        msg = (f"guarded field {owner}.{attr} accessed without"
               f" {lock_name} held (at {_site()}, thread"
               f" {threading.current_thread().name!r})")
        with self._mu:
            self._guard_violations.append({"field": f"{owner}.{attr}",
                                           "lock": lock_name,
                                           "at": _site()})
        self._emit("tsan.inversion", "tsan.guard_violations", msg)
        if os.environ.get(ENV_RAISE, "") == "1":
            raise GuardViolation(msg)

    def _emit(self, span_kind: str, metric: str, msg: str) -> None:
        """Cold path: metric + span + ring dump.  Imports are lazy so
        this module stays stdlib-only at import time (core.log imports
        us for Metrics' own lock)."""
        try:
            from ..core.log import logger, metrics
            metrics.count(metric)
            logger(__name__).error(msg)
        except Exception:  # noqa: BLE001
            pass
        try:
            import time

            from ..core.log import logger
            from . import tracing
            if tracing.recorder.active:
                tracing.recorder.record(span_kind, "tsan", None,
                                        time.time_ns(), 0,
                                        reason=msg[:400])
                tracing.dump_recent_to_log(
                    logger(__name__), reason="tsan inversion")
        except Exception:  # noqa: BLE001
            pass

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": len(self._edges),
                "acquisitions": self._acquisitions,
                "locks": sorted(self._names),
                "inversions": list(self._inversions),
                "guard_violations": list(self._guard_violations),
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._inversions.clear()
            self._guard_violations.clear()
            self._seen.clear()
            self._acquisitions = 0
            self._names.clear()


#: the process-wide order graph (one per process, like core.log.metrics)
graph = LockOrderGraph()


class TrackedLock:
    """``threading.Lock`` with acquisition-order bookkeeping.  Exposes
    acquire/release/__enter__/__exit__/locked, which is exactly the
    surface ``threading.Condition`` needs — a Condition built over a
    TrackedLock routes its wait()-time release/re-acquire through the
    wrapper, so the held stack stays truthful across waits."""

    __slots__ = ("_raw", "name")
    _reentrant = False

    def __init__(self, name: str = "lock") -> None:
        self._raw = threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        graph.before_acquire(self.name, self, self._reentrant, blocking)
        got = self._raw.acquire(blocking, timeout)
        if got:
            try:
                graph.acquired(self.name, self)
            except BaseException:
                # raise-mode inversion: leave no half-held state behind
                graph.released(self.name, self)
                self._raw.release()
                raise
        return got

    def release(self) -> None:
        graph.released(self.name, self)
        self._raw.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def held_by_me(self) -> bool:
        return graph.holds(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<TrackedLock {self.name} locked={self.locked()}>"


class TrackedRLock(TrackedLock):
    """``threading.RLock`` twin: re-entry by the owner is legal and
    counted, only the first acquisition records order edges."""

    __slots__ = ()
    _reentrant = True

    def __init__(self, name: str = "rlock") -> None:
        super().__init__(name)
        self._raw = threading.RLock()

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        if self._raw.acquire(blocking=False):
            self._raw.release()
            return False
        return True


class TrackedCondition:
    """``threading.Condition`` over a (shared) :class:`TrackedLock`.

    CPython's Condition detects that the wrapper is not one of its
    known lock types and falls back to plain ``release()`` /
    ``acquire()`` for the wait()-time handoff — both of which are the
    wrapper's tracked methods, so a thread blocked in ``wait()``
    correctly shows as NOT holding the lock."""

    def __init__(self, lock=None, name: str = "cond") -> None:
        if lock is None:
            lock = TrackedLock(f"{name}.lock")
        self.name = name
        self._lock = lock
        self._cond = threading.Condition(lock)

    def __enter__(self):
        return self._cond.__enter__()

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# -- factories (the adoption surface) --------------------------------------

def make_lock(name: str):
    """A mutex: :class:`TrackedLock` under ``NNS_TPU_TSAN=1``, else a
    plain ``threading.Lock`` (the structurally-untracked off path)."""
    global _active
    if enabled():
        _active = True
        return TrackedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    global _active
    if enabled():
        _active = True
        return TrackedRLock(name)
    return threading.RLock()


def make_condition(lock=None, name: str = "cond"):
    """A condition variable over ``lock`` (which may be shared by
    several conditions, the _StageQueue shape).  Tracked iff the lock
    is tracked — callers build the lock with :func:`make_lock`, so one
    env read decides the whole owner."""
    global _active
    if isinstance(lock, (TrackedLock, TrackedRLock)) or \
            (lock is None and enabled()):
        _active = True
        return TrackedCondition(lock, name)
    return threading.Condition(lock)


def assert_guarded(obj, attr: str) -> None:
    """Live twin of the static ``unguarded-write`` check: verify the
    calling thread holds the lock that ``type(obj)._GUARDED_BY``
    declares for ``attr``.  No-op unless a tracked primitive exists in
    the process (i.e. free in untracked runs), and only enforceable
    when the owner's lock came from :func:`make_lock`."""
    if not _active:
        return
    gb = getattr(type(obj), "_GUARDED_BY", None)
    if not gb or attr not in gb:
        return
    lock = getattr(obj, gb[attr], None)
    if isinstance(lock, TrackedLock) and not graph.holds(lock):
        graph.report_guard(type(obj).__name__, attr, gb[attr])


def report() -> dict:
    """Process-wide tsan summary (the soak row surface)."""
    snap = graph.snapshot()
    snap["enabled"] = enabled()
    return snap


def reset() -> None:
    graph.reset()
