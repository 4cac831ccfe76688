"""nns-tsan static side: lock-discipline lint for the threaded runtime.

Port of ``nnstreamer_tpu/analysis/concurrency.py``, copied whole.
Pure-AST pass (no imports of the code it checks — files are *read*,
never executed) behind ``lint --threads``; ``package_root()`` is the
port's tree.
Four checks, each a stable kebab-case diagnostic:

``unguarded-write`` (error)
    A class declares its lock discipline as data::

        class TensorSink:
            _GUARDED_BY = {"_outstanding": "_win_lock", ...}

    and every write / read-modify-write / mutating method call on a
    guarded attribute must happen inside ``with self.<lock>:`` — either
    lexically, or in a helper whose every in-class call site holds the
    lock (one level deep: the ``_write_locked`` convention).
    ``__init__`` is exempt (no aliasing before publication), and so are
    helpers called *only* from ``__init__``.  Conditions constructed
    over a lock (``self._not_empty = Condition(self._lock)``) alias it.

``lock-order-inversion`` (error)
    A package-wide acquisition-order graph built from nested ``with``
    blocks (plus one level of helper / known-singleton calls made while
    holding a lock: ``metrics.count(...)`` under ``self._win_lock`` is
    an edge to ``Metrics._lock``).  A cycle names both acquisition
    paths.  Locks are keyed ``Class.attr`` / ``module.attr`` — the same
    class-level identity the dynamic twin
    (:mod:`..utils.locks`) uses, so the two sides report
    the same finding.

``unjoined-thread`` (error) / ``daemon-thread`` (warning)
    Every non-daemon ``threading.Thread(...)`` constructed in the
    package must have a ``join()`` reachable from the owning object's
    ``stop()``/``close()``-family methods (one call level deep; local
    threads must join in the same function).  Every ``daemon=True`` is
    a warning that must be explicitly baselined — daemons opt out of
    join-on-exit, which is a decision, not a default.

``cond-wait-no-predicate`` (warning)
    ``cond.wait()`` on a known Condition outside a ``while`` predicate
    loop: bare waits miss spurious wakeups and notify-before-wait
    races.  ``wait_for`` carries its own loop and is exempt.

The faults it is for: a gauge written outside its window lock, a
check-then-create pool race with ``stop()``, journal ack-vs-GC ordering
— each a finding before the code ever runs.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import ERROR, WARNING, Diagnostic, Report

CODES = {
    "unguarded-write": ERROR,
    "lock-order-inversion": ERROR,
    "unjoined-thread": ERROR,
    "daemon-thread": WARNING,
    "cond-wait-no-predicate": WARNING,
}

#: container methods that MUTATE their receiver (a call on a guarded
#: attribute through one of these is a write)
MUTATORS = frozenset({
    "append", "appendleft", "add", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "setdefault",
    "sort", "reverse", "rotate", "difference_update",
    "intersection_update", "symmetric_difference_update",
})

#: method names from which a thread join must be reachable
_STOPLIKE = ("stop", "close", "shutdown", "join", "finish", "teardown",
             "__exit__", "__del__", "wait")

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "cond",
               "make_lock": "lock", "make_rlock": "rlock",
               "make_condition": "cond"}


def _pos(line_starts: List[int], node: ast.AST) -> int:
    """Global char offset of ``node`` (the Report caret contract)."""
    return line_starts[node.lineno - 1] + node.col_offset


def _line_starts(source: str) -> List[int]:
    starts, n = [0], 0
    for ln in source.splitlines(keepends=True):
        n += len(ln)
        starts.append(n)
    return starts


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _const_kwarg(call: ast.Call, key: str):
    for kw in call.keywords:
        if kw.arg == key and isinstance(kw.value, ast.Constant):
            return kw.value.value
    return None


class _ModuleFacts:
    """Everything one file contributes to the package-wide passes."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.line_starts = _line_starts(source)
        self.threading_aliases: Set[str] = set()  # `threading`, `_threading`
        self.threaded = False
        self.classes: Dict[str, "_ClassFacts"] = {}
        self.module_locks: Dict[str, str] = {}  # name -> kind
        #: module-level ``NAME = ClassName()`` singletons
        self.singletons: Dict[str, str] = {}
        self._scan_imports()
        self._scan_toplevel()

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        self.threading_aliases.add(a.asname or "threading")
            elif isinstance(node, ast.ImportFrom):
                if node.module and node.module.endswith("threading"):
                    self.threaded = True
        if self.threading_aliases:
            self.threaded = True

    def lock_ctor_kind(self, call: ast.Call) -> Optional[str]:
        """'lock'|'rlock'|'cond' when ``call`` constructs a (possibly
        tracked) lock primitive, else None."""
        f = call.func
        if isinstance(f, ast.Attribute):
            name = f.attr
            if isinstance(f.value, ast.Name) and (
                    f.value.id in self.threading_aliases
                    or f.value.id == "locks"):
                return _LOCK_CTORS.get(name)
            return None
        if isinstance(f, ast.Name):
            return _LOCK_CTORS.get(f.id)
        return None

    def thread_ctor(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute):
            return (f.attr == "Thread" and isinstance(f.value, ast.Name)
                    and f.value.id in self.threading_aliases)
        return isinstance(f, ast.Name) and f.id == "Thread" \
            and self.threaded

    def _scan_toplevel(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = _ClassFacts(self, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if isinstance(node.value, ast.Call):
                    kind = self.lock_ctor_kind(node.value)
                    if kind:
                        self.module_locks[name] = kind
                    elif isinstance(node.value.func, ast.Name):
                        self.singletons[name] = node.value.func.id


class _ClassFacts:
    """Per-class lock/guard/thread facts."""

    def __init__(self, mod: _ModuleFacts, node: ast.ClassDef):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.guarded: Dict[str, str] = {}
        self.lock_attrs: Dict[str, str] = {}  # attr -> kind
        self.aliases: Dict[str, str] = {}  # cond attr -> backing lock attr
        self.methods: Dict[str, ast.FunctionDef] = {}
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "_GUARDED_BY" \
                    and isinstance(stmt.value, ast.Dict):
                try:
                    self.guarded = {
                        str(k): str(v)
                        for k, v in ast.literal_eval(stmt.value).items()}
                except (ValueError, TypeError):
                    pass
        for meth in self.methods.values():
            for sub in ast.walk(meth):
                if not (isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1
                        and isinstance(sub.value, ast.Call)):
                    continue
                attr = _is_self_attr(sub.targets[0])
                if attr is None:
                    continue
                kind = mod.lock_ctor_kind(sub.value)
                if kind is None:
                    continue
                self.lock_attrs[attr] = kind
                if kind == "cond" and sub.value.args:
                    backing = _is_self_attr(sub.value.args[0])
                    if backing:
                        self.aliases[attr] = backing
        # guard names are locks even when their construction was not
        # recognized (injected locks, test doubles)
        for lk in self.guarded.values():
            self.lock_attrs.setdefault(lk, "lock")

    def canon(self, attr: str) -> str:
        seen = set()
        while attr in self.aliases and attr not in seen:
            seen.add(attr)
            attr = self.aliases[attr]
        return attr

    def lock_id(self, attr: str) -> str:
        return f"{self.name}.{self.canon(attr)}"


class _FuncWalk(ast.NodeVisitor):
    """One function/method traversal with a lexical held-lock stack.

    Collects, in source order: guarded-attr writes (with held set),
    with-acquisition edges, calls made while holding locks, thread
    constructions, joins, and bare condition waits."""

    def __init__(self, mod: _ModuleFacts, cls: Optional[_ClassFacts],
                 func: ast.FunctionDef):
        self.mod = mod
        self.cls = cls
        self.func = func
        self.held: List[str] = []  # canonical lock ids, outermost first
        self.writes: List[Tuple[str, ast.AST, Tuple[str, ...]]] = []
        self.order_edges: List[Tuple[str, str, ast.AST]] = []
        self.calls: List[Tuple[str, str, Tuple[str, ...], ast.AST]] = []
        self.acquired: Set[str] = set()
        self.threads: List[dict] = []
        self.joins: Set[str] = set()  # self attrs joined here
        self.local_joins: Set[str] = set()
        self.bare_waits: List[Tuple[str, ast.AST]] = []
        self._while_depth = 0
        self._thread_locals: Dict[str, dict] = {}
        self._local_from_selfattr: Dict[str, str] = {}
        for stmt in func.body:
            self.visit(stmt)
        for rec in self._thread_locals.values():
            if rec["var"] not in self.local_joins:
                self.threads.append(rec)

    # -- lock expression resolution ---------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _is_self_attr(expr)
        if attr is not None and self.cls is not None \
                and attr in self.cls.lock_attrs:
            return self.cls.lock_id(attr)
        if isinstance(expr, ast.Name) and \
                expr.id in self.mod.module_locks:
            return f"{self.mod.relpath}:{expr.id}"
        return None

    # -- traversal ---------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        got = []
        for item in node.items:
            self.generic_visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                for h in self.held:
                    if h != lock:
                        self.order_edges.append((h, lock,
                                                 item.context_expr))
                self.acquired.add(lock)
                self.held.append(lock)
                got.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in got:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_While(self, node: ast.While) -> None:
        self._while_depth += 1
        self.generic_visit(node)
        self._while_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def may run on another thread: its body is walked
        # with an EMPTY held stack (conservative), its writes count
        inner = _FuncWalk(self.mod, self.cls, node)
        self.writes.extend(inner.writes)
        self.order_edges.extend(inner.order_edges)
        self.acquired.update(inner.acquired)
        self.bare_waits.extend(inner.bare_waits)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # no statements inside

    def _note_write(self, attr: str, node: ast.AST) -> None:
        if self.cls is not None and attr in self.cls.guarded:
            self.writes.append((attr, node, tuple(self.held)))

    def _target_attr(self, tgt: ast.AST) -> Optional[str]:
        """self.X in plain / subscript / tuple-element target position."""
        attr = _is_self_attr(tgt)
        if attr is not None:
            return attr
        if isinstance(tgt, (ast.Subscript, ast.Starred)):
            return self._target_attr(tgt.value)
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for el in elts:
                attr = self._target_attr(el)
                if attr is not None:
                    self._note_write(attr, el)
        # dataflow for join detection: t = self._thread (incl. tuple
        # form `t, self._thread = self._thread, None`)
        tgt0 = node.targets[0]
        pairs = []
        if isinstance(tgt0, ast.Name):
            pairs = [(tgt0, node.value)]
        elif isinstance(tgt0, ast.Tuple) and \
                isinstance(node.value, ast.Tuple) and \
                len(tgt0.elts) == len(node.value.elts):
            pairs = list(zip(tgt0.elts, node.value.elts))
        for t, v in pairs:
            if isinstance(t, ast.Name):
                src = _is_self_attr(v)
                if src is not None:
                    self._local_from_selfattr[t.id] = src
        self._scan_thread_ctor(node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._target_attr(node.target)
        if attr is not None:
            self._note_write(attr, node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            attr = self._target_attr(node.target)
            if attr is not None:
                self._note_write(attr, node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            attr = self._target_attr(tgt)
            if attr is not None:
                self._note_write(attr, tgt)
        self.generic_visit(node)

    def _scan_thread_ctor(self, assign: ast.Assign) -> None:
        if not isinstance(assign.value, ast.Call) or \
                not self.mod.thread_ctor(assign.value):
            return
        call = assign.value
        rec = {
            "node": call,
            "daemon": bool(_const_kwarg(call, "daemon")),
            "tname": _const_kwarg(call, "name"),
            "attr": None, "var": None,
            "method": self.func.name,
        }
        tgt = assign.targets[0]
        attr = _is_self_attr(tgt)
        if attr is not None:
            rec["attr"] = attr
            self.threads.append(rec)
        elif isinstance(tgt, ast.Name):
            rec["var"] = tgt.id
            self._thread_locals[tgt.id] = rec

    def visit_Expr(self, node: ast.Expr) -> None:
        # bare `threading.Thread(...).start()`
        v = node.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                and v.func.attr == "start" \
                and isinstance(v.func.value, ast.Call) \
                and self.mod.thread_ctor(v.func.value):
            call = v.func.value
            self.threads.append({
                "node": call,
                "daemon": bool(_const_kwarg(call, "daemon")),
                "tname": _const_kwarg(call, "name"),
                "attr": None, "var": None, "method": self.func.name,
            })
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            recv_attr = _is_self_attr(f.value)
            # mutator call on a guarded attr: self._dq.append(...)
            if recv_attr is not None and f.attr in MUTATORS:
                self._note_write(recv_attr, f.value)
            # join bookkeeping
            if f.attr == "join":
                if recv_attr is not None:
                    self.joins.add(recv_attr)
                elif isinstance(f.value, ast.Name):
                    n = f.value.id
                    self.local_joins.add(n)
                    if n in self._local_from_selfattr:
                        self.joins.add(self._local_from_selfattr[n])
            # bare condition wait
            if f.attr == "wait" and recv_attr is not None \
                    and self.cls is not None \
                    and self.cls.lock_attrs.get(recv_attr) == "cond" \
                    and self._while_depth == 0:
                self.bare_waits.append((recv_attr, f.value))
            # singleton calls under a lock (order-graph input)
            if self.held and recv_attr is None \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id != "self":
                self.calls.append(("name." + f.value.id, f.attr,
                                   tuple(self.held), node))
            # self.helper() / self._attr.method() — the call-site map
            # the guard pass and order graph reason over
            if recv_attr is not None or (isinstance(f.value, ast.Name)
                                         and f.value.id == "self"):
                self.calls.append(("self", f.attr, tuple(self.held),
                                   node))
            # daemon set post-construction: self.X.daemon = True handled
            # in visit_Assign via _target_attr? (Attribute of Attribute
            # — rare; the kwarg form dominates this codebase)
        self.generic_visit(node)


def _guard_pass(mod: _ModuleFacts, rep: Report) -> None:
    """unguarded-write over every class with a ``_GUARDED_BY``."""
    for cls in mod.classes.values():
        if not cls.guarded:
            continue
        walks = {name: _FuncWalk(mod, cls, fn)
                 for name, fn in cls.methods.items()}
        # call sites: method -> list of (caller, held lock ids)
        call_sites: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        for caller, w in walks.items():
            for kind, meth, held, _ in w.calls:
                if kind == "self":
                    call_sites.setdefault(meth, []).append((caller, held))
        # fixpoint: method -> locks provably held on EVERY non-__init__
        # entry (each caller holds the lock lexically at the call or is
        # itself proven) — extends the call-site rule through
        # ``_locked``-style helper chains of any depth
        proven: Dict[str, Set[str]] = {m: set() for m in walks}
        all_locks = {cls.lock_id(g) for g in cls.guarded.values()}
        changed = True
        while changed:
            changed = False
            for mname in walks:
                sites = [s for s in call_sites.get(mname, ())
                         if s[0] != "__init__"]
                if not sites:
                    continue
                for lock_id in all_locks - proven[mname]:
                    if all(lock_id in held
                           or lock_id in proven.get(caller, ())
                           for caller, held in sites):
                        proven[mname].add(lock_id)
                        changed = True
        reported: Set[Tuple[str, str]] = set()
        for mname, w in walks.items():
            if mname == "__init__":
                continue
            for attr, node, held in w.writes:
                lock_id = cls.lock_id(cls.guarded[attr])
                if lock_id in held or lock_id in proven[mname]:
                    continue
                sites = [s for s in call_sites.get(mname, ())
                         if s[0] != "__init__"]
                init_only = (not sites
                             and bool(call_sites.get(mname)))
                if init_only:
                    continue
                key = (mname, attr)
                if key in reported:
                    continue
                reported.add(key)
                bad = next((c for c, h in sites
                            if lock_id not in h
                            and lock_id not in proven.get(c, ())),
                           None)
                why = (f"called without it from {cls.name}.{bad}()"
                       if bad else "and no guarded call path proves it")
                rep.add(
                    "unguarded-write", CODES["unguarded-write"],
                    f"self.{attr} is _GUARDED_BY "
                    f"{cls.guarded[attr]!r} but {cls.name}.{mname}() "
                    f"writes it outside `with self."
                    f"{cls.guarded[attr]}:` ({why})",
                    path=f"{mod.relpath}:{cls.name}.{mname}.{attr}",
                    pos=_pos(mod.line_starts, node),
                )


def _thread_pass(mod: _ModuleFacts, rep: Report) -> None:
    """unjoined-thread / daemon-thread over classes AND module funcs."""
    def flag(rec, owner: str, joined: bool) -> None:
        label = f" ({rec['tname']!r})" if rec.get("tname") else ""
        loc = f"{mod.relpath}:{owner}"
        if rec["daemon"]:
            rep.add(
                "daemon-thread", CODES["daemon-thread"],
                f"daemon thread{label} started in {owner}(): daemons "
                f"skip join-on-exit — baseline this only with a "
                f"documented shutdown story",
                path=f"{loc}{'.' + rec['tname'] if rec.get('tname') else ''}",
                pos=_pos(mod.line_starts, rec["node"]))
        if not joined and not rec["daemon"]:
            rep.add(
                "unjoined-thread", CODES["unjoined-thread"],
                f"thread{label} started in {owner}() has no join() "
                f"reachable from a stop()/close()-family method",
                path=f"{loc}.unjoined",
                pos=_pos(mod.line_starts, rec["node"]))

    for cls in mod.classes.values():
        walks = {name: _FuncWalk(mod, cls, fn)
                 for name, fn in cls.methods.items()}
        threads = [t for w in walks.values() for t in w.threads]
        if not threads:
            continue
        # join closure over stop-like methods, one call level deep
        joined: Set[str] = set()
        for mname, w in walks.items():
            if not (mname.startswith("stop") or mname.startswith("close")
                    or mname in _STOPLIKE):
                continue
            joined |= w.joins
            for kind, meth, _, _ in w.calls:
                if kind == "self" and meth in walks:
                    joined |= walks[meth].joins
        for rec in threads:
            ok = (rec["attr"] in joined if rec["attr"] is not None
                  else rec["var"] is None and False
                  or rec.get("var") in
                  walks.get(rec["method"],
                            _FuncWalk(mod, cls,
                                      cls.methods[rec["method"]])
                            ).local_joins)
            # locals joined in the same method were filtered already;
            # a surviving local/bare thread is unjoined by construction
            if rec["attr"] is None:
                ok = False
            flag(rec, f"{cls.name}.{rec['method']}", ok)

    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _FuncWalk(mod, None, node)
            for rec in w.threads:
                joined = (rec["attr"] is None and rec["var"] is None
                          and False)
                flag(rec, node.name, joined)


def _cond_pass(mod: _ModuleFacts, rep: Report) -> None:
    for cls in mod.classes.values():
        for mname, fn in cls.methods.items():
            if mname in ("wait", "wait_for"):
                continue  # a delegating wait wrapper IS the primitive;
                # its callers own the predicate loop
            w = _FuncWalk(mod, cls, fn)
            for attr, node in w.bare_waits:
                rep.add(
                    "cond-wait-no-predicate",
                    CODES["cond-wait-no-predicate"],
                    f"{cls.name}.{mname}() calls self.{attr}.wait() "
                    f"outside a `while <predicate>` loop — bare waits "
                    f"miss spurious wakeups and notify-before-wait "
                    f"races (use a predicate loop or wait_for)",
                    path=f"{mod.relpath}:{cls.name}.{mname}.{attr}",
                    pos=_pos(mod.line_starts, node))


class _OrderGraph:
    """Package-wide static acquisition-order graph."""

    def __init__(self) -> None:
        self.edges: Dict[Tuple[str, str], str] = {}
        #: class name -> method -> locks acquired (any depth, own file)
        self.acquires: Dict[str, Dict[str, Set[str]]] = {}
        #: singleton variable name -> class name (package-wide)
        self.singletons: Dict[str, str] = {}
        self.pending_calls: List[Tuple[str, str, str,
                                       Tuple[str, ...], str]] = []

    def add_module(self, mod: _ModuleFacts) -> None:
        for var, clsname in mod.singletons.items():
            self.singletons.setdefault(var, clsname)
        for cls in mod.classes.values():
            acq = self.acquires.setdefault(cls.name, {})
            for mname, fn in cls.methods.items():
                w = _FuncWalk(mod, cls, fn)
                acq[mname] = set(w.acquired)
                for a, b, node in w.order_edges:
                    site = f"{mod.relpath}:{cls.name}.{mname}:" \
                           f"{node.lineno}"
                    self.edges.setdefault((a, b), site)
                for kind, meth, held, node in w.calls:
                    if not held:
                        continue
                    site = f"{mod.relpath}:{cls.name}.{mname}:" \
                           f"{node.lineno}"
                    self.pending_calls.append(
                        (kind, meth, cls.name, held, site))
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = _FuncWalk(mod, None, node)
                for a, b, n in w.order_edges:
                    site = f"{mod.relpath}:{node.name}:{n.lineno}"
                    self.edges.setdefault((a, b), site)

    def resolve_calls(self) -> None:
        """One level of call propagation: a helper / known-singleton
        method invoked while holding S contributes S → (its acquires)."""
        for kind, meth, clsname, held, site in self.pending_calls:
            if kind == "self":
                targets = self.acquires.get(clsname, {}).get(meth, ())
            elif kind.startswith("name."):
                var = kind[5:]
                tcls = self.singletons.get(var)
                targets = self.acquires.get(tcls, {}).get(meth, ()) \
                    if tcls else ()
            else:
                targets = ()
            for lock in targets:
                for h in held:
                    if h != lock:
                        self.edges.setdefault((h, lock),
                                              site + " (via call)")

    def cycles(self) -> List[List[str]]:
        """One representative cycle per strongly-connected component."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strong(v: str) -> None:  # iterative Tarjan
            work = [(v, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on.add(node)
                recurse = False
                for i in range(pi, len(adj[node])):
                    u = adj[node][i]
                    if u not in index:
                        work[-1] = (node, i + 1)
                        work.append((u, 0))
                        recurse = True
                        break
                    if u in on:
                        low[node] = min(low[node], index[u])
                if recurse:
                    continue
                if low[node] == index[node]:
                    comp = []
                    while True:
                        u = stack.pop()
                        on.discard(u)
                        comp.append(u)
                        if u == node:
                            break
                    if len(comp) > 1:
                        sccs.append(comp)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for v in list(adj):
            if v not in index:
                strong(v)

        out = []
        for comp in sccs:
            cset = set(comp)
            # walk one actual cycle inside the component
            start = comp[0]
            path, seen = [start], {start}
            cur = start
            while True:
                nxt = next((u for u in adj[cur]
                            if u in cset and u not in seen), None)
                if nxt is None:
                    nxt = next(u for u in adj[cur] if u in cset)
                    path.append(nxt)
                    break
                path.append(nxt)
                seen.add(nxt)
                cur = nxt
            # trim to the repeated node
            first = path.index(path[-1])
            out.append(path[first:])
        return out

    def diagnose(self, rep: Report) -> None:
        self.resolve_calls()
        for cyc in self.cycles():
            hops = []
            for a, b in zip(cyc, cyc[1:]):
                hops.append(f"{a} -> {b} at "
                            f"{self.edges.get((a, b), '?')}")
            nodes = sorted(set(cyc))
            rep.add(
                "lock-order-inversion", CODES["lock-order-inversion"],
                "lock-order inversion: " + "; but ".join(hops),
                path="order:" + "->".join(nodes))


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_py(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return out


def lint_paths(paths: List[str], *, root: Optional[str] = None
               ) -> Tuple[List[Report], dict]:
    """Run all four passes over ``paths``; the lock-order graph spans
    the whole set.  Returns per-file Reports (source attached for caret
    rendering) plus a trailing package-level Report carrying the
    cross-file order-cycle findings, and a stats dict."""
    mods: List[_ModuleFacts] = []
    reports: List[Report] = []
    base = root or os.path.commonpath([os.path.dirname(p)
                                       for p in paths]) if paths else ""
    for path in paths:
        with open(path) as f:
            source = f.read()
        rel = os.path.relpath(path, base) if base else \
            os.path.basename(path)
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:  # pragma: no cover - repo parses
            rep = Report(source)
            rep.add("unguarded-write", ERROR, f"unparsable: {e}",
                    path=rel)
            reports.append(rep)
            continue
        mods.append(_ModuleFacts(path, rel, source, tree))

    graph = _OrderGraph()
    stats = {"files": len(paths), "threaded": 0, "guarded_classes": 0,
             "locks": 0, "edges": 0}
    for mod in mods:
        rep = Report(mod.source)
        if mod.threaded:
            stats["threaded"] += 1
        stats["guarded_classes"] += sum(
            1 for c in mod.classes.values() if c.guarded)
        stats["locks"] += sum(len(c.lock_attrs)
                              for c in mod.classes.values()) \
            + len(mod.module_locks)
        _guard_pass(mod, rep)
        _thread_pass(mod, rep)
        _cond_pass(mod, rep)
        graph.add_module(mod)
        reports.append(rep)
    pkg_rep = Report()
    graph.diagnose(pkg_rep)
    stats["edges"] = len(graph.edges)
    reports.append(pkg_rep)
    return reports, stats


def lint_package(root: Optional[str] = None) -> Tuple[List[Report], dict]:
    root = root or package_root()
    return lint_paths(_iter_py(root), root=root)


def baseline_key(d: Diagnostic) -> str:
    """Stable baseline key: no line numbers (they drift), the path
    component already pins file + class.method + attr / cycle nodes."""
    return f"threads:{d.code}:{d.path}"
