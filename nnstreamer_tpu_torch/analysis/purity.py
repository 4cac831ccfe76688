"""Graph-break and host-sync lint: an AST pass over the code a captured
step runs.

Port of ``nnstreamer_tpu/analysis/purity.py``.  A ``device_fn`` hands
the planner a pure ``tensors -> tensors`` callable that a fused stage
captures as a CUDA graph (``pipeline/graphs.py``); a ``custom-easy``
model registered with ``jax_traceable=True`` makes the same promise.
ROADMAP Queue C's rules for code inside a captured step forbid what a
capture cannot hold: a host read of a card value (``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()`` / ``int()`` /
``bool()`` of a tensor, a tensor in an ``if``, ``torch.multinomial``'s
checks, ``torch.cuda.synchronize``), a host-to-card copy
(``torch.tensor`` / ``as_tensor`` / ``from_numpy``, ``.cuda()``,
``.pin_memory()``), ``np.*`` math, ``time.*``, Python or numpy RNG and
``print`` (each runs once, at capture, and is baked in or lost).  On the
card the capture raises on a host read; on the CPU the step runs
eagerly and nothing fails, so this lint is what finds them there.

The codes keep the JAX package's names where the meaning is the same
(``jit-host-sync``, ``jit-host-call``, ``jit-rng``, ``jit-host-time``,
``jit-print``, ``jit-global-mutation``, ``jit-state-mutation``) and add
``jit-host-copy``, ``jit-host-branch`` and ``jit-multinomial``.

The pass never calls the functions: it reads source via ``inspect``,
resolves module aliases (``import numpy as np``) from the function's
globals and closure, and walks the AST of the *captured parts*:

* for a ``device_fn`` method: every function defined INSIDE it (the
  returned closures) — the method body itself runs on the host at plan
  time (spec math, prop parsing);
* for a registered traceable callable: the whole function.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import types
import weakref
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .diagnostics import Diagnostic, ERROR, WARNING

#: code -> severity for everything this pass can emit
CODES = {
    "jit-host-call": ERROR,      # numpy math / open() inside a captured fn
    "jit-host-sync": ERROR,      # .item() / .cpu() / float() of a tensor
    "jit-host-copy": ERROR,      # a host-to-card copy inside a captured fn
    "jit-host-branch": WARNING,  # a tensor reduction as an if/while test
    "jit-multinomial": ERROR,    # torch.multinomial's checks read the card
    "jit-rng": ERROR,            # Python or numpy RNG (use a torch.Generator)
    "jit-host-time": WARNING,    # time.* baked in at capture
    "jit-print": WARNING,        # fires once, at capture
    "jit-global-mutation": ERROR,  # global/nonlocal writes from a captured fn
    "jit-state-mutation": WARNING,  # self.* assignment inside a captured fn
}

#: tensor methods that read a card value to the host
_SYNC_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
#: tensor methods that copy host memory to the card
_COPY_METHODS = frozenset({"cuda", "pin_memory"})
#: torch functions that make a card tensor out of host data
_COPY_FUNCS = frozenset({"tensor", "as_tensor", "from_numpy"})
#: tensor methods whose result, tested by an ``if``, is a host read
_REDUCTIONS = frozenset({"any", "all", "sum", "max", "min", "mean", "eq",
                         "ne", "gt", "lt", "ge", "le", "isnan", "isfinite",
                         "equal", "allclose", "count_nonzero", "norm"})


def _classify_module(mod: str) -> Optional[str]:
    """Module name -> alias kind the linter's rules key on (None = a
    module we have no opinion about)."""
    if mod == "numpy":
        return "numpy"
    if mod == "numpy.random":
        return "rng"
    if mod == "time":
        return "time"
    if mod == "random":
        return "rng"
    if mod == "torch" or mod.startswith("torch."):
        # torch is what a captured fn is made of; the few torch calls that
        # read or copy through the host are named below
        return "torch"
    return None


def _module_aliases(namespace: Dict[str, object]) -> Dict[str, str]:
    """Names in ``namespace`` bound to host modules we care about."""
    out: Dict[str, str] = {}
    for nm, val in namespace.items():
        if not isinstance(val, types.ModuleType):
            continue
        kind = _classify_module(val.__name__)
        if kind is not None:
            out[nm] = kind
    return out


def _root_and_chain(expr) -> Tuple[Optional[str], List[str]]:
    """``np.random.default_rng`` -> ("np", ["random", "default_rng"])."""
    chain: List[str] = []
    while isinstance(expr, ast.Attribute):
        chain.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id, list(reversed(chain))
    return None, list(reversed(chain))


class _PureFnLinter(ast.NodeVisitor):
    def __init__(self, aliases: Dict[str, str], where: str,
                 base_line: int = 0):
        # copy: function-local imports SHADOW the module-level aliases for
        # this fn only
        self.aliases = dict(aliases)
        self.where = where
        self.base_line = base_line
        #: (code, msg, line, severity-override-or-None)
        self.found: List[Tuple[str, str, int, Optional[str]]] = []

    def _bind(self, name: str, mod: str) -> None:
        kind = _classify_module(mod)
        if kind is not None:
            self.aliases[name] = kind
        else:
            self.aliases.pop(name, None)  # shadowed by an unrelated module

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            # plain ``import a.b`` binds the ROOT name; ``as`` binds the alias
            self._bind(a.asname or a.name.split(".")[0],
                       a.name if a.asname else a.name.split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if not node.module:
            return
        for a in node.names:
            self._bind(a.asname or a.name, f"{node.module}.{a.name}")

    def _hit(self, code: str, msg: str, node,
             severity: Optional[str] = None) -> None:
        self.found.append(
            (code, msg, self.base_line + node.lineno, severity))

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id == "print":
                self._hit("jit-print",
                          "print() fires once, at capture, not per buffer",
                          node)
            elif f.id == "open":
                self._hit("jit-host-call", "file I/O inside a captured fn",
                          node)
            elif f.id in ("float", "int", "bool") and node.args and \
                    not isinstance(node.args[0], ast.Constant):
                # a warning: statically a tensor cannot be told from a
                # host scalar (len(), shape math); only the former syncs
                self._hit("jit-host-sync",
                          f"{f.id}() reads a card value to the host if its "
                          "argument is a tensor (the capture raises)",
                          node, severity=WARNING)
        elif isinstance(f, ast.Attribute):
            root, chain = _root_and_chain(f)
            kind = self.aliases.get(root) if root else None
            if kind == "torch":
                dotted = ".".join(chain)
                if chain[-1] == "multinomial":
                    self._hit("jit-multinomial",
                              "torch.multinomial checks its input on the "
                              "host — draw with a registered generator and "
                              "pick by argmax", node)
                elif dotted in ("cuda.synchronize", "cuda.current_stream."
                                "synchronize"):
                    self._hit("jit-host-sync",
                              f"'{root}.{dotted}' waits for the card inside "
                              "a captured fn", node)
                elif len(chain) == 1 and chain[0] in _COPY_FUNCS:
                    self._hit("jit-host-copy",
                              f"'{root}.{dotted}' copies host data to the "
                              "card inside a captured fn — make the constant "
                              "at build time", node)
            elif kind == "numpy":
                if "random" in chain[:-1] or chain[-1].startswith("random"):
                    self._hit("jit-rng",
                              f"numpy RNG '{root}.{'.'.join(chain)}' runs on "
                              "the host once, at capture — use a "
                              "torch.Generator", node)
                else:
                    self._hit("jit-host-call",
                              f"host numpy call '{root}.{'.'.join(chain)}' "
                              "inside a captured fn (runs once, at capture) "
                              "— use torch", node)
            elif kind == "rng":
                self._hit("jit-rng",
                          f"host RNG '{root}.{'.'.join(chain)}' — use a "
                          "torch.Generator", node)
            elif kind == "time":
                self._hit("jit-host-time",
                          f"'{root}.{'.'.join(chain)}' is evaluated ONCE, at "
                          "capture, and baked into the step", node)
            elif f.attr in _SYNC_METHODS:
                self._hit("jit-host-sync",
                          f".{f.attr}() reads a card value to the host: a "
                          "captured step cannot hold it", node)
            elif f.attr in _COPY_METHODS:
                self._hit("jit-host-copy",
                          f".{f.attr}() copies host memory to the card "
                          "inside a captured fn", node)
        self.generic_visit(node)

    def _branch(self, test, node) -> None:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
                root, chain = _root_and_chain(sub.func)
                kind = self.aliases.get(root) if root else None
                if kind == "torch" or (kind is None
                                       and sub.func.attr in _REDUCTIONS):
                    self._hit("jit-host-branch",
                              "a tensor tested by a Python branch is read "
                              "to the host — use torch.where", node)
                    return

    def visit_If(self, node: ast.If) -> None:
        self._branch(node.test, node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._branch(node.test, node)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._branch(node.test, node)
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self._hit("jit-global-mutation",
                  f"global {', '.join(node.names)} mutated from a traced fn",
                  node)

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._hit("jit-global-mutation",
                  f"nonlocal {', '.join(node.names)} mutated from a traced "
                  "fn", node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute):
                root, chain = _root_and_chain(tgt)
                if root == "self":
                    self._hit("jit-state-mutation",
                              f"assignment to self.{'.'.join(chain)} inside "
                              "a traced fn runs at trace time only", node)
        self.generic_visit(node)


def _lint_fn_node(fn_node, aliases: Dict[str, str], where: str,
                  base_line: int) -> List[Tuple[str, str, int]]:
    linter = _PureFnLinter(aliases, where, base_line)
    body = fn_node.body if not isinstance(fn_node, ast.Lambda) \
        else [ast.Expr(fn_node.body)]
    for stmt in body:
        linter.visit(stmt)
    return linter.found


def _dedupe(found: Iterable[Tuple[str, str, int, Optional[str]]],
            where: str, pos: Optional[int] = None) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    seen: Set[Tuple[str, str, int]] = set()
    for code, msg, line, severity in found:
        key = (code, msg, line)
        if key in seen:
            continue
        seen.add(key)
        out.append(Diagnostic(code, severity or CODES[code],
                              f"{msg} [line {line}]", path=where, pos=pos))
    return out


def _source_tree(obj) -> Optional[Tuple[ast.AST, int]]:
    """(parsed AST, 1-based first line) of ``obj``'s source, or None when
    source is unavailable/unparseable (builtins, REPL lambdas, ...)."""
    try:
        src, line = inspect.getsourcelines(obj)
    except (OSError, TypeError):
        return None
    try:
        tree = ast.parse(textwrap.dedent("".join(src)))
    except SyntaxError:
        return None
    return tree, line - 1


#: source parsing + AST walk results per function/class — Pipeline
#: construction with validate=True must not re-read files every time.
#: Weak keys: unregistered test callables don't pin their modules alive.
_fn_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_cls_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _closure_aliases(fn, aliases: Dict[str, str]) -> Dict[str, str]:
    """Overlay closure-cell bindings onto the global alias map: a free
    variable bound in an enclosing scope SHADOWS the module-level name,
    so resolve it from the live cell — module identity decides, not the
    alias name."""
    code = getattr(fn, "__code__", None)
    cells = getattr(fn, "__closure__", None)
    if code is None or not cells:
        return aliases
    out = dict(aliases)
    for name, cell in zip(code.co_freevars, cells):
        try:
            val = cell.cell_contents
        except ValueError:  # pragma: no cover - still-unbound cell
            continue
        if isinstance(val, types.ModuleType):
            kind = _classify_module(val.__name__)
            if kind is not None:
                out[name] = kind
            else:
                out.pop(name, None)
        else:
            out.pop(name, None)  # free var shadows a same-named module
    return out


def _callable_findings(fn) -> Tuple:
    try:
        return _fn_cache[fn]
    except (KeyError, TypeError):
        pass
    got = _source_tree(fn)
    found: Tuple = ()
    if got is not None:
        tree, base = got
        aliases = _closure_aliases(
            fn, _module_aliases(getattr(fn, "__globals__", {}) or {}))
        fns = [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda))]
        if fns:
            found = tuple(_lint_fn_node(fns[0], aliases, "", base))
    try:
        _fn_cache[fn] = found
    except TypeError:
        pass
    return found


def lint_callable(fn, where: str, *, pos: Optional[int] = None
                  ) -> List[Diagnostic]:
    """Lint a function that promises to be capturable (its WHOLE body is
    the captured part) — e.g. a custom-easy model with
    ``jax_traceable=True``."""
    return _dedupe(_callable_findings(fn), where, pos)


def _device_fn_findings(cls) -> Tuple:
    try:
        return _cls_cache[cls]
    except (KeyError, TypeError):
        pass
    found: Tuple = ()
    fn = cls.__dict__.get("device_fn")
    got = _source_tree(fn) if fn is not None else None
    if got is not None:
        tree, base = got
        mod = inspect.getmodule(cls)
        aliases = _module_aliases(vars(mod) if mod else {})
        outer = next((n for n in ast.walk(tree)
                      if isinstance(n, ast.FunctionDef)
                      and n.name == "device_fn"), None)
        if outer is not None:
            acc: List = []
            for n in ast.walk(outer):
                if n is outer:
                    continue
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                    acc.extend(_lint_fn_node(n, aliases, "", base))
            found = tuple(acc)
    try:
        _cls_cache[cls] = found
    except TypeError:
        pass
    return found


def lint_device_fn(cls, where: Optional[str] = None, *,
                   pos: Optional[int] = None) -> List[Diagnostic]:
    """Lint the pure closures a class's own ``device_fn`` builds.

    Only functions *defined inside* device_fn are checked: the method body
    itself runs host-side at plan time (spec math, prop parsing) and is
    allowed to use numpy.
    """
    where = where or f"{cls.__module__}.{cls.__name__}.device_fn"
    return _dedupe(_device_fn_findings(cls), where, pos)


def lint_graph(graph) -> List[Diagnostic]:
    """The lint over one pipeline: device_fns of every element kind in the
    graph, decoder sub-plugins selected by ``mode=``, and custom-easy
    models registered as traceable."""
    from ..core.registry import (
        KIND_DECODER, KIND_ELEMENT, lookup)
    from ..elements.base import Element

    diags: List[Diagnostic] = []
    seen: Set[object] = set()
    for node in graph.nodes.values():
        cls = lookup(KIND_ELEMENT, node.kind)
        if cls is None:
            continue
        if cls not in seen and cls.__dict__.get("device_fn") is not None \
                and cls.__dict__["device_fn"] is not Element.device_fn:
            seen.add(cls)
            diags.extend(lint_device_fn(cls, pos=node.pos))
        if node.kind == "tensor_decoder" and node.props.get("mode"):
            dcls = lookup(KIND_DECODER, str(node.props["mode"]))
            if dcls is not None and dcls not in seen \
                    and dcls.__dict__.get("device_fn") is not None:
                seen.add(dcls)
                diags.extend(lint_device_fn(dcls, pos=node.pos))
        if node.kind == "tensor_filter" and \
                str(node.props.get("framework", "")).lower() == "custom-easy":
            from ..filters.custom_easy import _models

            entry = _models.get(str(node.props.get("model")))
            if entry is not None:
                fn, traceable = entry[0], entry[3]
                if traceable and fn not in seen:
                    seen.add(fn)
                    diags.extend(lint_callable(
                        fn, f"custom-easy:{node.props.get('model')}",
                        pos=node.pos))
    return diags


def lint_module(module) -> List[Diagnostic]:
    """Dogfood entry point: lint every device_fn defined in ``module``
    (element classes, decoder sub-plugins), so that a host read creeping
    into a shipped element fails the gate."""
    diags: List[Diagnostic] = []
    for nm, obj in vars(module).items():
        if not isinstance(obj, type) or obj.__module__ != module.__name__:
            continue
        if "device_fn" in obj.__dict__:
            diags.extend(lint_device_fn(obj))
    return diags
