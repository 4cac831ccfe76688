"""nns-proto: message-alphabet lint + model drift gate for the
distributed serving protocols.

Port of ``nnstreamer_tpu/analysis/protocol.py``, copied whole (pure
``ast``).  ``package_root()`` is the port's tree, so
``PROTOCOL_MODULES`` and the registry (``core/meta_keys.py``) are read
from ``nnstreamer_tpu_torch/``, and the drift gate holds the port's
code against the port's :mod:`.statemachine` models.

The wire/handshake surface (elements/query.py, utils/net.py,
utils/wire.py, utils/journal.py, utils/elastic.py, utils/armor.py,
filters/llm.py streaming terminators) speaks a closed vocabulary:
protocol meta keys (core/meta_keys.py — the registry this lint treats
as ground truth), JSON control-frame types (hello/ack/nack), typed
``abort_reason`` values, journal/DLQ record magics and snapshot version
tags.  This pass extracts that vocabulary from the AST — every kind the
code CONSTRUCTS or SENDS and every kind it DISPATCHES on or HANDLES —
and reports:

``meta-key-drift`` (error)
    a protocol meta literal (or control kind / abort reason) used in a
    meta context that is not declared in the core/meta_keys.py registry.
``unhandled-message`` (error)
    a registered kind the linted set sends/stamps but never reads —
    a message nobody is listening for.
``dead-handler`` (warning)
    a registered kind the linted set reads/dispatches on but never
    sends — handler code for a message that cannot arrive.
``unanswered-path`` (error)
    reusing the nns-tsan fixpoint call-proof: a server-side handler
    path that can exit — return, fall through, or raise — after it has
    touched a request's routing meta, without answering, shedding,
    aborting (typed), quarantining, or at least accounting the drop.
    Each such path is a client timeout waiting to happen.
``model-alphabet-drift`` (error) / ``model-alphabet-surplus`` (warning)
    the model-vs-code gate: the union of the shipped protocol models'
    declared alphabets (analysis/statemachine.py) must equal the
    AST-extracted one, so a new message kind (e.g. future kv-transfer
    frames) without a model update is a CI failure, not a latent gap.

Conventions the proof understands (mirrors how the runtime answers):

* answering calls: a method named ``send``, ``quarantine``,
  ``cancel_stream`` or ``poison_terminator``, or containing ``answer``,
  ``reply``, ``abort``, ``shed``, ``reject``, ``ack_journal`` or
  ``send_failed`` — or any local function PROVEN all-paths-answering by
  the fixpoint;
* accounted drops: ``metrics.count(...)`` whose metric name contains
  ``dropped`` or ``shed`` (the path is visible on a dashboard, which is
  the lint's bar for "not a silent strand");
* the obligation ARMS at the first read of a routing meta key
  (``_query_msg`` / ``_query_conn`` / ``_query_batch``): exits before
  the handler has a message in hand (config guards, pre-admission
  rejects) are exempt;
* a loop whose body answers on every path satisfies the obligation for
  the code after it (per-row batch fan-out: each message is answered
  inside its iteration).

Handlers are methods named ``process`` on classes whose name contains
``ServerSink``, plus any function named ``handle_*`` (the explicit
convention for fixtures and future protocol servers).

This module is pure ``ast``, like concurrency.py: it reads the files it
lints and never imports them.  See
docs/ANALYSIS.md "Protocol pass".
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .diagnostics import ERROR, WARNING, Diagnostic, Report

__all__ = [
    "CODES", "PROTOCOL_MODULES", "Registry", "load_registry",
    "lint_paths", "lint_package", "package_root", "baseline_key",
    "extracted_alphabet",
]

CODES = {
    "meta-key-drift": ERROR,
    "unhandled-message": ERROR,
    "dead-handler": WARNING,
    "unanswered-path": ERROR,
    "model-alphabet-drift": ERROR,
    "model-alphabet-surplus": WARNING,
}

#: the protocol surface, relative to the package root — the dogfood set
PROTOCOL_MODULES = (
    "elements/query.py",
    "utils/net.py",
    "utils/wire.py",
    "utils/journal.py",
    "utils/elastic.py",
    "utils/armor.py",
    "filters/llm.py",
)

#: reading one of these arms the unanswered-path obligation: the
#: handler now holds a routed message it owes a verdict
_ROUTING_KEYS = ("_query_msg", "_query_conn", "_query_batch")

_ANSWER_EXACT = frozenset({"send", "quarantine", "cancel_stream",
                           "poison_terminator"})
_ANSWER_SUBSTR = ("answer", "reply", "abort", "shed", "reject",
                  "ack_journal", "send_failed")
_DROP_METRIC = re.compile(r"dropped|shed")

_META_NAME = re.compile(r"^(meta|metas|m|out_meta|in_meta|resp_meta"
                        r"|meta_\w+|\w+_meta)$")
_MAGIC_NAME = re.compile(r"^(MAGIC_(?P<suf>\w+)|(?P<pre>\w+)_MAGIC|MAGIC)$")


def _pos(line_starts: List[int], node: ast.AST) -> int:
    """Global char offset of ``node`` (the Report caret contract)."""
    return line_starts[node.lineno - 1] + node.col_offset


def _line_starts(source: str) -> List[int]:
    starts, n = [0], 0
    for ln in source.splitlines(keepends=True):
        n += len(ln)
        starts.append(n)
    return starts


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the registry (core/meta_keys.py), loaded by AST so fixtures can ship
# their own and the lint never imports runtime code
# ---------------------------------------------------------------------------

class Registry:
    def __init__(self):
        self.names: Dict[str, str] = {}      # constant name -> value
        self.meta_keys: Set[str] = set()     # PROTOCOL_META_KEYS values
        self.control: Set[str] = set()       # CONTROL_TYPES values
        self.abort: Set[str] = set()         # ABORT_REASONS values
        self.external: Set[str] = set()      # EXTERNAL_META_KEYS values


def load_registry(root: Optional[str] = None) -> Registry:
    """Parse ``<root>/core/meta_keys.py`` (falling back to the real
    package's) into a :class:`Registry`.  Only simple forms are
    understood — ``NAME = "literal"`` and ``NAME = frozenset({...})`` —
    which is exactly what the registry module restricts itself to."""
    path = os.path.join(root or package_root(), "core", "meta_keys.py")
    if not os.path.exists(path):
        path = os.path.join(package_root(), "core", "meta_keys.py")
    reg = Registry()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    sets = {"PROTOCOL_META_KEYS": reg.meta_keys,
            "CONTROL_TYPES": reg.control,
            "ABORT_REASONS": reg.abort,
            "EXTERNAL_META_KEYS": reg.external}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name, val = node.targets[0].id, node.value
        if isinstance(val, ast.Constant) and isinstance(val.value, str):
            reg.names[name] = val.value
        elif isinstance(val, ast.Call) and isinstance(val.func, ast.Name) \
                and val.func.id == "frozenset" and val.args \
                and isinstance(val.args[0], ast.Set) and name in sets:
            for el in val.args[0].elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    sets[name].add(el.value)
                elif isinstance(el, ast.Name) and el.id in reg.names:
                    sets[name].add(reg.names[el.id])
    return reg


# ---------------------------------------------------------------------------
# per-file extraction
# ---------------------------------------------------------------------------

def _is_meta_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "meta":
        return True
    if isinstance(node, ast.Name) and _META_NAME.match(node.id):
        return True
    if isinstance(node, ast.Subscript) \
            and isinstance(node.slice, ast.Constant) \
            and node.slice.value == "meta":
        return True
    return False


class _Use:
    __slots__ = ("kind", "value", "pos", "func")

    def __init__(self, kind: str, value: str, pos: int, func: str):
        self.kind = kind    # meta-write|meta-read|ctrl-send|ctrl-handle|
        self.value = value  # abort-send|abort-handle
        self.pos = pos
        self.func = func


class _FileFacts(ast.NodeVisitor):
    """One linted file: symbol table, every alphabet use site, every
    function body (for the unanswered-path proof)."""

    def __init__(self, path: str, rel: str, source: str, tree: ast.Module,
                 reg: Registry):
        self.path, self.rel, self.source = path, rel, source
        self.reg = reg
        self.line_starts = _line_starts(source)
        self.syms: Dict[str, str] = {}          # local alias -> key value
        self.uses: List[_Use] = []
        self.records: Set[str] = set()          # record:<NAME> kinds
        self.snapshots: Set[str] = set()        # snapshot:v<N> tags
        #: qualname -> (FunctionDef, class name or "")
        self.funcs: Dict[str, Tuple[ast.AST, str]] = {}
        self._stack: List[str] = []
        self._class: List[str] = []
        self._module_consts(tree)
        self.visit(tree)

    # -- symbol table -----------------------------------------------------
    def _module_consts(self, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in getattr(node, "names", []):
                    tgt = alias.asname or alias.name
                    if alias.name in self.reg.names:
                        self.syms[tgt] = self.reg.names[alias.name]
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                val = self._resolve(node.value)
                if val is not None:
                    self.syms[name] = val
                m = _MAGIC_NAME.match(name)
                if m and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, int):
                    suf = m.group("suf") or m.group("pre") or "FRAME"
                    self.records.add(f"record:{suf}")

    def _resolve(self, node: ast.AST) -> Optional[str]:
        """Resolve an expression to a protocol string: literal, local
        alias, or an attribute of the registry (``meta_keys.META_X`` —
        or any module re-exporting a registry name)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.syms.get(node.id)
        if isinstance(node, ast.Attribute):
            return self.reg.names.get(node.attr)
        return None

    # -- use collection ---------------------------------------------------
    def _fn(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def _use(self, kind: str, node: ast.AST, key: ast.AST) -> None:
        val = self._resolve(key)
        if val is not None:
            self.uses.append(_Use(kind, val,
                                  _pos(self.line_starts, key), self._fn()))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()
        self._class.pop()

    def _visit_func(self, node) -> None:
        self._stack.append(node.name)
        qual = self._fn()
        self.funcs[qual] = (node, self._class[-1] if self._class else "")
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if _is_meta_expr(node.value):
            kind = "meta-write" if isinstance(node.ctx, ast.Store) \
                else "meta-read"
            self._use(kind, node, node.slice)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        # K in <meta>  /  K not in <meta>
        if len(node.ops) == 1 and isinstance(node.ops[0],
                                             (ast.In, ast.NotIn)) \
                and _is_meta_expr(node.comparators[0]):
            self._use("meta-read", node, node.left)
        # <x>.get("type") == "kind"  (control dispatch)
        if len(node.ops) == 1 and isinstance(node.ops[0],
                                             (ast.Eq, ast.NotEq, ast.In,
                                              ast.NotIn)):
            if self._is_type_get(node.left):
                comp = node.comparators[0]
                elts = comp.elts if isinstance(comp, (ast.Tuple, ast.List,
                                                      ast.Set)) else [comp]
                for el in elts:
                    self._use("ctrl-handle", node, el)
            # abort-reason dispatch: meta.get("abort_reason") == "wire"
            if self._is_abort_get(node.left):
                self._use("abort-handle", node, node.comparators[0])
        self.generic_visit(node)

    def _is_type_get(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and node.args
                and self._resolve(node.args[0]) == "type")

    def _is_abort_get(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and node.args
                and self._resolve(node.args[0]) == "abort_reason")

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and _is_meta_expr(fn.value):
            if fn.attr in ("get", "pop", "setdefault") and node.args:
                self._use("meta-read", node, node.args[0])
                if fn.attr == "setdefault":
                    self._use("meta-write", node, node.args[0])
            elif fn.attr == "update":
                for arg in node.args:
                    if isinstance(arg, ast.Dict):
                        self._dict_keys("meta-write", arg)
                for kw in node.keywords:
                    if kw.arg is not None:
                        self.uses.append(_Use(
                            "meta-write", kw.arg,
                            _pos(self.line_starts, kw.value), self._fn()))
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if name == "client_handshake" and len(node.args) >= 2:
            self._use("ctrl-send", node, node.args[1])
        elif name == "server_handshake" and len(node.args) >= 2:
            self._ctrl_expect(node.args[1])
        elif name == "finish_server_handshake" and len(node.args) >= 3:
            self._ctrl_expect(node.args[2])
        for kw in node.keywords:
            if kw.arg == "meta" and isinstance(kw.value, ast.Dict):
                self._dict_keys("meta-write", kw.value)
        self.generic_visit(node)

    def _ctrl_expect(self, arg: ast.AST) -> None:
        elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
        for el in elts:
            self._use("ctrl-handle", el, el)

    def visit_Dict(self, node: ast.Dict) -> None:
        # {"type": "kind", ...} constructs a control message
        for k, v in zip(node.keys, node.values):
            if k is None:
                continue
            kv = self._resolve(k)
            if kv == "type" and self._resolve(v) is not None:
                self._use("ctrl-send", node, v)
            if kv == "version" and isinstance(v, ast.Constant) \
                    and isinstance(v.value, int):
                self.snapshots.add(f"snapshot:v{v.value}")
            if kv == "abort_reason" and self._resolve(v) is not None:
                self._use("abort-send", node, v)
        # {**meta, "k": v}: an updated meta dict rides on
        if any(k is None and _is_meta_expr(v)
               for k, v in zip(node.keys, node.values)):
            self._dict_keys("meta-write", node)
        self.generic_visit(node)

    def _dict_keys(self, kind: str, node: ast.Dict) -> None:
        for k, v in zip(node.keys, node.values):
            if k is None:
                continue
            self._use(kind, node, k)
            if self._resolve(k) == "abort_reason" \
                    and self._resolve(v) is not None:
                self._use("abort-send", node, v)

    def visit_Assign(self, node: ast.Assign) -> None:
        # meta[K] = <abort reason constant>?
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript) and _is_meta_expr(tgt.value) \
                    and self._resolve(tgt.slice) == "abort_reason" \
                    and self._resolve(node.value) is not None:
                self._use("abort-send", node, node.value)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# unanswered-path: fixpoint call-proof over explicit exits
# ---------------------------------------------------------------------------

class _Exit:
    __slots__ = ("kind", "pos", "answered", "armed")

    def __init__(self, kind, pos, answered, armed):
        self.kind, self.pos = kind, pos
        self.answered, self.armed = answered, armed


class _PathState:
    __slots__ = ("answered", "armed")

    def __init__(self, answered=False, armed=False):
        self.answered, self.armed = answered, armed

    def copy(self):
        return _PathState(self.answered, self.armed)


def _is_answering_call(node: ast.Call, proven: Set[str]) -> bool:
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    if name in _ANSWER_EXACT or name in proven:
        return True
    if any(s in name for s in _ANSWER_SUBSTR):
        return True
    if name == "count":
        # metrics.count("...dropped"): an accounted drop
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and _DROP_METRIC.search(arg.value):
                return True
            if isinstance(arg, ast.JoinedStr):
                for part in arg.values:
                    if isinstance(part, ast.Constant) \
                            and _DROP_METRIC.search(str(part.value)):
                        return True
    return False


class _FuncProof:
    """Walk one function's statements tracking, per path, whether the
    obligation is armed (a routing meta key was read) and answered (an
    answering call happened).  Explicit exits — return / raise / falling
    off the end — while armed and unanswered are the findings."""

    def __init__(self, facts: _FileFacts, fndef, proven: Set[str]):
        self.facts = facts
        self.fndef = fndef
        self.proven = proven
        self.exits: List[_Exit] = []

    def run(self) -> List[_Exit]:
        st = _PathState()
        fall = self._block(self.fndef.body, st)
        if fall is not None:
            self.exits.append(_Exit("fall-through",
                                    _pos(self.facts.line_starts,
                                         self.fndef.body[-1]),
                                    fall.answered, fall.armed))
        return self.exits

    # -- expression effects ----------------------------------------------
    def _expr_effects(self, node: ast.AST, st: _PathState) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and _is_answering_call(sub, self.proven):
                st.answered = True
            key = None
            if isinstance(sub, ast.Subscript) \
                    and _is_meta_expr(sub.value):
                key = self.facts._resolve(sub.slice)
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and _is_meta_expr(sub.func.value) \
                    and sub.func.attr in ("get", "pop") and sub.args:
                key = self.facts._resolve(sub.args[0])
            elif isinstance(sub, ast.Compare) and len(sub.ops) == 1 \
                    and isinstance(sub.ops[0], (ast.In, ast.NotIn)) \
                    and _is_meta_expr(sub.comparators[0]):
                key = self.facts._resolve(sub.left)
            if key in _ROUTING_KEYS:
                st.armed = True

    # -- statement walk ---------------------------------------------------
    def _block(self, stmts, st: _PathState) -> Optional[_PathState]:
        """Returns the fall-through state, or None if every path in the
        block diverged (return/raise/continue/break)."""
        cur: Optional[_PathState] = st
        for stmt in stmts:
            if cur is None:
                break  # unreachable tail
            cur = self._stmt(stmt, cur)
        return cur

    def _merge(self, states) -> Optional[_PathState]:
        live = [s for s in states if s is not None]
        if not live:
            return None
        return _PathState(all(s.answered for s in live),
                          any(s.armed for s in live))

    def _stmt(self, stmt, st: _PathState) -> Optional[_PathState]:
        ls = self.facts.line_starts
        if isinstance(stmt, ast.Return):
            self._expr_effects(stmt.value, st)
            self.exits.append(_Exit("return", _pos(ls, stmt),
                                    st.answered, st.armed))
            return None
        if isinstance(stmt, ast.Raise):
            self._expr_effects(stmt.exc, st)
            self.exits.append(_Exit("raise", _pos(ls, stmt),
                                    st.answered, st.armed))
            return None
        if isinstance(stmt, (ast.Continue, ast.Break)):
            self.exits.append(_Exit("loop-exit", _pos(ls, stmt),
                                    st.answered, st.armed))
            return None
        if isinstance(stmt, ast.If):
            self._expr_effects(stmt.test, st)
            a = self._block(stmt.body, st.copy())
            b = self._block(stmt.orelse, st.copy()) if stmt.orelse \
                else st.copy()
            return self._merge([a, b])
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr_effects(stmt.iter, st)
            # per-iteration obligation: a body that answers on every
            # path covers the items it consumed; the post-loop state
            # keeps the pre-loop answered unless the body is total
            body_exits_before = len(self.exits)
            bst = self._block(stmt.body, st.copy())
            body_exits = self.exits[body_exits_before:]
            loop_total = all(
                e.answered for e in body_exits if e.kind == "loop-exit")
            if bst is not None:
                loop_total = loop_total and bst.answered
            # loop-exit records inside this loop are resolved here, not
            # at function level
            del self.exits[body_exits_before:]
            self.exits.extend(e for e in body_exits
                              if e.kind != "loop-exit")
            out = st.copy()
            if loop_total and (bst is not None or body_exits):
                out.answered = True
            if bst is not None:
                out.armed = out.armed or bst.armed
            if stmt.orelse:
                return self._block(stmt.orelse, out)
            return out
        if isinstance(stmt, ast.While):
            self._expr_effects(stmt.test, st)
            body_exits_before = len(self.exits)
            bst = self._block(stmt.body, st.copy())
            body_exits = self.exits[body_exits_before:]
            del self.exits[body_exits_before:]
            self.exits.extend(e for e in body_exits
                              if e.kind != "loop-exit")
            out = st.copy()
            if bst is not None:
                out.armed = out.armed or bst.armed
                out.answered = out.answered or bst.answered is True \
                    and st.answered
            return out
        if isinstance(stmt, ast.Try):
            before = len(self.exits)
            bst = self._block(stmt.body, st.copy())
            body_exits = self.exits[before:]
            raises = [e for e in body_exits if e.kind == "raise"]
            if stmt.handlers and raises:
                # raises may be caught: route the least-answered raise
                # state through every handler instead of escaping
                del self.exits[before:]
                self.exits.extend(e for e in body_exits
                                  if e.kind != "raise")
                hst_in = _PathState(
                    all(e.answered for e in raises),
                    any(e.armed for e in raises) or st.armed)
                h_falls = []
                for h in stmt.handlers:
                    h_falls.append(self._block(h.body, hst_in.copy()))
                broad = any(
                    h.type is None
                    or (isinstance(h.type, ast.Name)
                        and h.type.id in ("Exception", "BaseException"))
                    for h in stmt.handlers)
                if not broad:
                    # narrow handlers: the raise can still escape
                    self.exits.extend(raises)
            else:
                h_falls = [self._block(h.body, st.copy())
                           for h in stmt.handlers]
            tail = self._merge([bst] + h_falls) if stmt.handlers else bst
            if tail is not None and stmt.orelse:
                tail = self._block(stmt.orelse, tail)
            if stmt.finalbody:
                fin_in = tail.copy() if tail is not None else st.copy()
                fin = self._block(stmt.finalbody, fin_in)
                if tail is not None:
                    tail = fin
            return tail
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr_effects(item.context_expr, st)
            return self._block(stmt.body, st)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return st  # nested defs are proven separately
        # plain statement: scan for answering calls / arming reads
        self._expr_effects(stmt, st)
        return st


def _prove_file(facts: _FileFacts) -> Tuple[Set[str], Dict[str, List[_Exit]]]:
    """Fixpoint: grow the set of local functions proven all-paths-
    answering (callable names, so ``self._send_batched`` counts once
    ``_send_batched`` is proven).  Returns (proven names, per-handler
    violating exits)."""
    proven: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for qual, (fndef, _cls) in facts.funcs.items():
            name = fndef.name
            if name in proven:
                continue
            exits = _FuncProof(facts, fndef, proven).run()
            if exits and all(e.answered for e in exits):
                proven.add(name)
                changed = True
    handler_exits: Dict[str, List[_Exit]] = {}
    for qual, (fndef, cls) in facts.funcs.items():
        is_handler = fndef.name.startswith("handle_") or (
            fndef.name == "process" and "ServerSink" in cls)
        if not is_handler:
            continue
        exits = _FuncProof(facts, fndef, proven).run()
        bad = [e for e in exits if e.armed and not e.answered]
        if bad:
            handler_exits[qual] = bad
    return proven, handler_exits


# ---------------------------------------------------------------------------
# lint entry points
# ---------------------------------------------------------------------------

def _iter_protocol_paths(root: str) -> List[str]:
    return [os.path.join(root, m) for m in PROTOCOL_MODULES
            if os.path.exists(os.path.join(root, m))]


def extracted_alphabet(all_facts: List[_FileFacts],
                       reg: Registry) -> Set[str]:
    """The code's protocol vocabulary: registered meta keys, control
    kinds and abort reasons actually used, plus record magics and
    snapshot version tags.  EXTERNAL_META_KEYS are excluded — their
    lifecycle crosses the lint boundary, so no shipped model owns
    their delivery properties."""
    out: Set[str] = set()
    for facts in all_facts:
        for u in facts.uses:
            if u.kind in ("meta-write", "meta-read") \
                    and u.value in reg.meta_keys \
                    and u.value not in reg.external:
                out.add(u.value)
            elif u.kind in ("ctrl-send", "ctrl-handle") \
                    and u.value in reg.control:
                out.add(u.value)
            elif u.kind in ("abort-send", "abort-handle") \
                    and u.value in reg.abort:
                out.add(u.value)
        out |= facts.records
        out |= facts.snapshots
    return out


def lint_paths(paths: List[str], *, root: Optional[str] = None,
               registry: Optional[Registry] = None,
               drift_gate: bool = False) -> Tuple[List[Report], dict]:
    """Run the protocol passes over ``paths``.  Returns per-file Reports
    (source attached for caret rendering) plus a trailing package-level
    Report carrying the cross-file totality and drift findings, and a
    stats dict.  ``drift_gate=True`` additionally compares the extracted
    alphabet against the shipped models' declared union."""
    base = root or (os.path.commonpath([os.path.dirname(p)
                                        for p in paths]) if paths else "")
    reg = registry or load_registry(root)
    all_facts: List[_FileFacts] = []
    reports: List[Report] = []
    stats = {"files": len(paths), "keys": 0, "kinds": 0,
             "handlers": 0, "proven": 0, "models": 0}
    for path in paths:
        with open(path) as f:
            source = f.read()
        rel = os.path.relpath(path, base) if base else \
            os.path.basename(path)
        rep = Report(source)
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:  # pragma: no cover - repo parses
            rep.add("meta-key-drift", ERROR, f"unparsable: {e}", path=rel)
            reports.append(rep)
            continue
        facts = _FileFacts(path, rel, source, tree, reg)
        all_facts.append(facts)
        # pass 1a: registry drift at every use site
        seen_drift = set()
        for u in facts.uses:
            known = (u.value in reg.meta_keys
                     if u.kind.startswith("meta") else
                     u.value in reg.control
                     if u.kind.startswith("ctrl") else
                     u.value in reg.abort)
            if not known and (u.value, u.func) not in seen_drift:
                seen_drift.add((u.value, u.func))
                what = {"meta": "meta key", "ctrl": "control kind",
                        "abor": "abort reason"}[u.kind[:4]]
                rep.add("meta-key-drift", ERROR,
                        f"protocol {what} {u.value!r} is not declared in "
                        "core/meta_keys.py (the registry is the lint's "
                        "alphabet source of truth)",
                        path=f"{rel}:{u.func}", pos=u.pos)
        # pass 1c: unanswered-path
        proven, handler_exits = _prove_file(facts)
        handlers = [q for q, (fd, cls) in facts.funcs.items()
                    if fd.name.startswith("handle_")
                    or (fd.name == "process" and "ServerSink" in cls)]
        stats["handlers"] += len(handlers)
        stats["proven"] += len(handlers) - len(handler_exits)
        for qual, exits in handler_exits.items():
            for e in exits:
                rep.add("unanswered-path", ERROR,
                        f"handler can {e.kind} after reading routing "
                        "meta without answering, shedding, aborting "
                        "(typed) or quarantining the request — a client "
                        "timeout waiting to happen",
                        path=f"{rel}:{qual}", pos=e.pos)
        reports.append(rep)

    # package-level: handler totality + model drift
    pkg = Report()
    sent: Dict[str, List[str]] = {}
    handled: Dict[str, List[str]] = {}
    for facts in all_facts:
        for u in facts.uses:
            if u.kind in ("meta-write", "ctrl-send"):
                sent.setdefault(u.value, []).append(
                    f"{facts.rel}:{u.func}")
            elif u.kind in ("meta-read", "ctrl-handle"):
                handled.setdefault(u.value, []).append(
                    f"{facts.rel}:{u.func}")
    registered = reg.meta_keys | reg.control
    stats["keys"] = len([k for k in sent.keys() | handled.keys()
                         if k in reg.meta_keys])
    stats["kinds"] = len([k for k in sent.keys() | handled.keys()
                          if k in reg.control])
    for kind in sorted(sent.keys() - handled.keys()):
        if kind not in registered or kind in reg.external:
            continue
        pkg.add("unhandled-message", ERROR,
                f"{kind!r} is sent/stamped (by {sent[kind][0]}"
                + (f" +{len(sent[kind]) - 1}" if len(sent[kind]) > 1
                   else "") + ") but no linted module ever reads or "
                "dispatches on it",
                path=f"alphabet:{kind}")
    for kind in sorted(handled.keys() - sent.keys()):
        if kind not in registered or kind in reg.external:
            continue
        pkg.add("dead-handler", WARNING,
                f"{kind!r} is handled (by {handled[kind][0]}"
                + (f" +{len(handled[kind]) - 1}"
                   if len(handled[kind]) > 1 else "")
                + ") but no linted module ever sends it",
                path=f"alphabet:{kind}")
    if drift_gate:
        from . import statemachine  # deferred: fixture lint
        code_alpha = extracted_alphabet(all_facts, reg)
        model_alpha = statemachine.shipped_alphabet() - reg.external
        stats["models"] = len(statemachine.SHIPPED_MODELS)
        for kind in sorted(code_alpha - model_alpha):
            pkg.add("model-alphabet-drift", ERROR,
                    f"message kind {kind!r} is in the code's alphabet "
                    "but no shipped protocol model "
                    "(analysis/statemachine.py) declares it — extend a "
                    "model (or add one) so the kind's delivery "
                    "properties stay machine-checked",
                    path=f"model:{kind}")
        for kind in sorted(model_alpha - code_alpha):
            pkg.add("model-alphabet-surplus", WARNING,
                    f"shipped model declares {kind!r} but the code "
                    "never uses it — stale model alphabet",
                    path=f"model:{kind}")
    reports.append(pkg)
    return reports, stats


def lint_package(root: Optional[str] = None) -> Tuple[List[Report], dict]:
    root = root or package_root()
    return lint_paths(_iter_protocol_paths(root), root=root,
                      drift_gate=True)


def baseline_key(d: Diagnostic) -> str:
    """Stable baseline key: no line numbers (they drift); the path
    component pins file + function / alphabet kind."""
    return f"proto:{d.code}:{d.path}"
