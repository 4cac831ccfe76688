"""nns-lint CLI: verify a pipeline string without running it.

Port of ``nnstreamer_tpu/tools/lint.py``:

    python -m nnstreamer_tpu_torch.tools.lint "videotestsrc ! tensor_converter ! tensor_sink"
    python -m nnstreamer_tpu_torch.tools.lint --strict "<pipeline>"  # warnings fail too
    python -m nnstreamer_tpu_torch.tools.lint --dogfood              # lint OUR device_fns
    python -m nnstreamer_tpu_torch.tools.lint --examples             # examples/torch_*.py
    python -m nnstreamer_tpu_torch.tools.lint --deep "<pipeline>"    # + abstract execution
    python -m nnstreamer_tpu_torch.tools.lint --threads --strict \
        --baseline tools/torch_tsan_baseline.txt                     # lock discipline
    python -m nnstreamer_tpu_torch.tools.lint --proto --strict \
        --baseline tools/torch_proto_baseline.txt                    # serving protocols

Exit codes: 0 clean/ok, 1 errors (or warnings with --strict), 2 usage.

Every caps incompatibility, topology hazard and host-sync or graph-break
construct in a captured step is reported in ONE run with element-path
locations and source carets.  Nothing runs on a device: ``--deep`` runs
each stage on meta tensors with its model built on meta (shapes only)
and prints the per-pipeline resource report; with ``--dogfood`` it also
runs the bundled zoo families on meta at full width, ``llama2_7b``
included.  ``--threads`` runs the concurrency pass over the port's tree
(``_GUARDED_BY`` discipline, the lock-order graph, thread lifecycle,
bare condition waits) and ``--proto`` the protocol pass (the message
alphabet against ``core/meta_keys.py``, handler totality, the
unanswered-path proof, the model checker's drift gate); with
``--files``, over those files instead.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Dict, List, Optional, Tuple


def _render(desc: str, report, *, verbose: bool) -> None:
    if report.clean:
        print(f"OK: {desc!r}")
    else:
        print(f"LINT: {desc!r}")
        print(report.render())
    if getattr(report, "resources", None) is not None:
        print(report.resources.render())


def extract_pipeline_strings(path: str) -> Tuple[List[str], List[Tuple[int, str]]]:
    """Pipeline strings passed to ``Pipeline(...)`` / ``parse_launch(...)``
    in a Python source file, resolved WITHOUT importing it (examples run
    pipelines at import time).

    f-string placeholders are resolved from module-level constant
    assignments (``SIZE = 224``) and function-call defaults where
    possible; calls whose first argument cannot be resolved statically are
    returned in the second list as ``(lineno, source snippet)`` so callers
    can report each un-lintable call BY NAME instead of silently skipping
    (the CI gate baselines them: a new unresolvable call fails).
    """
    with open(path) as f:
        source = f.read()
    tree = ast.parse(source, filename=path)

    consts: Dict[str, object] = {}
    for stmt in ast.walk(tree):  # any scope; first literal binding wins
        if not isinstance(stmt, ast.Assign):
            continue
        for tgt in stmt.targets:  # W = H = 96 has two targets
            if isinstance(tgt, ast.Name):
                try:
                    consts.setdefault(tgt.id, ast.literal_eval(stmt.value))
                except (ValueError, TypeError):
                    pass
            elif isinstance(tgt, ast.Tuple):
                try:
                    vals = ast.literal_eval(stmt.value)
                    for t, v in zip(tgt.elts, vals):
                        if isinstance(t, ast.Name):
                            consts.setdefault(t.id, v)
                except (ValueError, TypeError):
                    pass

    def resolve(node) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                elif isinstance(v, ast.FormattedValue):
                    if isinstance(v.value, ast.Name) \
                            and v.value.id in consts:
                        parts.append(str(consts[v.value.id]))
                    else:
                        return None
                else:
                    return None
            return "".join(parts)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left, right = resolve(node.left), resolve(node.right)
            if left is not None and right is not None:
                return left + right
        return None

    found: List[str] = []
    skipped: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if name not in ("Pipeline", "parse_launch", "parse"):
            continue
        got = resolve(node.args[0])
        if got is None:
            snippet = (ast.get_source_segment(source, node.args[0])
                       or f"{name}(...)")
            snippet = " ".join(snippet.split())
            if len(snippet) > 80:
                snippet = snippet[:77] + "..."
            skipped.append((node.lineno, snippet))
        else:
            found.append(got)
    return found, skipped


def _diag_key(prefix: str, d, desc: Optional[str] = None) -> str:
    """Stable baseline key: file/source prefix + a short hash of the
    pipeline string + code + element path.  The hash pins the acceptance
    to ONE pipeline string — element labels like ``out`` repeat across the
    many strings in one file, and a baseline entry must not swallow a new
    defect in a different pipeline that happens to reuse a name.  No
    message text — line numbers in messages drift with unrelated edits."""
    import hashlib

    h = ""
    if desc is not None:
        h = hashlib.sha1(desc.encode()).hexdigest()[:8] + ":"
    return f"{prefix}:{h}{d.code}:{d.path}"


def _unresolved_keys(fname: str, skipped: List[Tuple[int, str]]
                     ) -> List[str]:
    """Stable baseline keys for un-lintable ``Pipeline(...)`` calls: file +
    a hash of the (whitespace-normalized) argument source, so the key
    survives unrelated line drift; identical snippets in one file get an
    occurrence index.  No line numbers — those churn with every edit."""
    import hashlib

    seen: Dict[str, int] = {}
    keys = []
    for _, snippet in skipped:
        n = seen.get(snippet, 0)
        seen[snippet] = n + 1
        h = hashlib.sha1(f"{snippet}#{n}".encode()).hexdigest()[:8]
        keys.append(f"{fname}:unresolvable-pipeline:{h}")
    return keys


def lint_files(paths: List[str], *, strict: bool, verbose: bool,
               baseline: Optional[set] = None,
               collected: Optional[List[str]] = None,
               deep: bool = False, reconfig: Optional[dict] = None) -> int:
    from ..analysis import analyze

    rc = 0
    total = skipped_total = accepted = 0
    for path in paths:
        fname = os.path.basename(path)
        strings, skipped = extract_pipeline_strings(path)
        skipped_total += len(skipped)
        # Un-lintable calls are named findings, not a silent count: each
        # becomes a warning keyed into the baseline, so a NEW example the
        # analyzer cannot see fails the strict CI gate instead of
        # shrinking coverage.
        ukeys = _unresolved_keys(fname, skipped)
        if collected is not None:
            collected.extend(ukeys)
        for (lineno, snippet), k in zip(skipped, ukeys):
            is_new = baseline is None or k not in baseline
            accepted += 1 if (baseline is not None and k in baseline) else 0
            if strict and is_new:
                rc = 1
            if verbose or (strict and is_new):
                print(f"warning[unresolvable-pipeline] {fname}:{lineno}: "
                      f"Pipeline argument not statically resolvable: "
                      f"{snippet}")
        for desc in strings:
            total += 1
            report = analyze(desc, deep=deep, reconfig=reconfig)
            keys = [_diag_key(fname, d, desc) for d in report]
            if collected is not None:
                collected.extend(keys)
            fails = [
                d for d, k in zip(report.diagnostics, keys)
                if (d.severity == "error" or strict)
                and (baseline is None or k not in baseline)
            ]
            accepted += sum(
                1 for k in keys if baseline is not None and k in baseline)
            if fails or verbose:
                print(f"-- {fname}")
                _render(desc, report, verbose=verbose)
            elif deep and getattr(report, "resources", None) is not None:
                print(f"-- {fname}: deep: {report.resources.summary()}")
            if fails:
                rc = 1
    print(f"linted {total} pipeline string(s) from {len(paths)} file(s)"
          + (f"; {skipped_total} call(s) not statically resolvable"
             if skipped_total else "")
          + (f"; {accepted} baseline-accepted diagnostic(s)"
             if accepted else ""))
    return rc


def dogfood(*, strict: bool, baseline: Optional[set] = None,
            collected: Optional[List[str]] = None, deep: bool = False) -> int:
    """Lint the port's OWN device_fns (every built-in plugin module): a
    host read or a host-to-card copy creeping into a shipped element's
    captured callable fails here, before a capture on the card does.
    With ``deep``, also run the bundled zoo families on meta tensors
    against their declared I/O specs (:func:`~..analysis.tracecheck.
    trace_zoo_models`), at full width with no storage."""
    import importlib

    from ..analysis.purity import lint_module
    from ..core.registry import _BUILTIN_MODULES

    diags = []
    for modname in _BUILTIN_MODULES:
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            continue
        diags.extend(lint_module(mod))
    keys = [_diag_key("dogfood", d) for d in diags]
    zoo_note = ""
    if deep:
        from ..analysis.tracecheck import trace_zoo_models

        zdiags, traced, skipped = trace_zoo_models()
        diags.extend(zdiags)
        keys.extend(_diag_key("deep-zoo", d) for d in zdiags)
        zoo_note = (f", {traced} zoo model(s) abstract-traced"
                    + (f" ({skipped} skipped)" if skipped else ""))
    if collected is not None:
        collected.extend(keys)
    fails = [
        d for d, k in zip(diags, keys)
        if (d.severity == "error" or strict)
        and (baseline is None or k not in baseline)
    ]
    for d in fails:
        print(d)
    n_err = sum(1 for d in diags if d.severity == "error")
    n_warn = len(diags) - n_err
    print(f"dogfood: {len(_BUILTIN_MODULES)} modules{zoo_note}, "
          f"{n_err} error(s), {n_warn} warning(s), {len(fails)} new")
    return 1 if fails else 0


def _lint_package_pass(module, tag: str, summary, *, strict: bool,
                       verbose: bool, baseline: Optional[set],
                       collected: Optional[List[str]],
                       files: Optional[List[str]]) -> int:
    """Run one package-level pass (``module.lint_package`` or, with
    ``files``, ``module.lint_paths``), fail on diagnostics that are new
    against ``baseline`` (errors always, warnings under ``strict``) and
    print ``<tag>: <summary(stats)>; <counts>``."""
    if files:
        reports, stats = module.lint_paths(files)
    else:
        reports, stats = module.lint_package()
    rc = 0
    accepted = n_err = n_warn = n_new = 0
    for rep in reports:
        keys = [module.baseline_key(d) for d in rep]
        if collected is not None:
            collected.extend(keys)
        fails = []
        for d, k in zip(rep.diagnostics, keys):
            n_err += 1 if d.severity == "error" else 0
            n_warn += 1 if d.severity == "warning" else 0
            if baseline is not None and k in baseline:
                accepted += 1
                continue
            if d.severity == "error" or strict:
                fails.append(d)
        if fails:
            rc = 1
            n_new += len(fails)
            sub = type(rep)(rep.source)
            sub.extend(fails)
            print(sub.render())
        elif verbose and rep.diagnostics:
            print(rep.render())
    print(f"{tag}: {summary(stats)}; {n_err} error(s), {n_warn} warning(s), "
          f"{n_new} new"
          + (f", {accepted} baseline-accepted" if accepted else ""))
    return rc


def lint_threads(*, strict: bool, verbose: bool,
                 baseline: Optional[set] = None,
                 collected: Optional[List[str]] = None,
                 files: Optional[List[str]] = None) -> int:
    """nns-tsan static side: the concurrency passes (guarded-by,
    lock-order graph, thread lifecycle, bare condition waits) over the
    port's package (or ``files``)."""
    from ..analysis import concurrency

    return _lint_package_pass(
        concurrency, "threads",
        lambda st: (f"{st['files']} file(s), {st['threaded']} threaded "
                    f"module(s), {st['guarded_classes']} guarded class(es), "
                    f"{st['locks']} lock(s), {st['edges']} order edge(s)"),
        strict=strict, verbose=verbose, baseline=baseline,
        collected=collected, files=files)


def lint_proto(*, strict: bool, verbose: bool,
               baseline: Optional[set] = None,
               collected: Optional[List[str]] = None,
               files: Optional[List[str]] = None) -> int:
    """nns-proto: the message-alphabet and handler-totality lint and the
    model-vs-code drift gate over the port's serving protocol modules.
    With ``files``, lints those files (no drift gate: the gate is a
    claim about the whole surface)."""
    from ..analysis import protocol

    return _lint_package_pass(
        protocol, "proto",
        lambda st: (f"{st['files']} file(s), {st['keys']} meta key(s), "
                    f"{st['kinds']} control kind(s), {st['handlers']} "
                    f"handler(s) ({st['proven']} proven), {st['models']} "
                    "model(s)"),
        strict=strict, verbose=verbose, baseline=baseline,
        collected=collected, files=files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnstreamer_tpu_torch.tools.lint",
        description="Statically verify pipeline strings (caps propagation, "
                    "topology/deadlock, host-sync lint) without running "
                    "them.",
    )
    ap.add_argument("pipeline", nargs="*",
                    help="pipeline description string(s)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (exit 1)")
    ap.add_argument("--files", nargs="+", metavar="PY",
                    help="lint every Pipeline(...) string in python files")
    ap.add_argument("--examples", action="store_true",
                    help="lint examples/torch_*.py and "
                         "tests/test_pipeline_e2e.py")
    ap.add_argument("--dogfood", action="store_true",
                    help="lint nnstreamer_tpu_torch's own device_fns")
    ap.add_argument("--threads", action="store_true",
                    help="nns-tsan static side: lock discipline "
                         "(_GUARDED_BY), lock-order graph, thread "
                         "lifecycle, bare condition waits over the "
                         "package; with --files, over those files")
    ap.add_argument("--proto", action="store_true",
                    help="nns-proto: message-alphabet and "
                         "handler-totality lint, unanswered-path proof "
                         "and model-vs-code drift gate over the serving "
                         "protocol modules; with --files, over those "
                         "files")
    ap.add_argument("--deep", action="store_true",
                    help="also run every device stage on meta tensors "
                         "(shape/dtype contract checks, static memory "
                         "and census budgets; no device, no storage)")
    ap.add_argument("--reconfig", metavar="K:V[,K:V...]",
                    help="with --deep: propose a runtime config change "
                         "for continuous-serving stages (e.g. "
                         "slots:8,kv_blocks:256) — knobs whose change "
                         "would alter a captured step's signature warn "
                         "recompile-on-reconfig with the drain/restart "
                         "remediation")
    ap.add_argument("--baseline", metavar="FILE",
                    help="accepted-diagnostics file: only NEW diagnostics "
                         "fail (one key per line, '#' comments)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current diagnostics to --baseline")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print clean results")
    args = ap.parse_args(argv)

    if not args.pipeline and not args.files and not args.examples \
            and not args.dogfood and not args.threads and not args.proto:
        ap.print_usage(sys.stderr)
        return 2

    baseline: Optional[set] = None
    if args.baseline and os.path.exists(args.baseline) \
            and not args.update_baseline:
        with open(args.baseline) as f:
            baseline = {
                ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")
            }
    collected: List[str] = []

    reconfig = None
    if args.reconfig:
        if not args.deep:
            # the check lives in the deep pass
            print("--reconfig requires --deep", file=sys.stderr)
            return 2
        from ..filters.base import parse_custom_options

        reconfig = parse_custom_options(args.reconfig)

    rc = 0
    if args.pipeline:
        from ..analysis import analyze

        for desc in args.pipeline:
            report = analyze(desc, deep=args.deep, reconfig=reconfig)
            _render(desc, report, verbose=args.verbose)
            if report.errors or (args.strict and report.warnings):
                rc = 1

    files = list(args.files or [])
    if args.examples:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        ex_dir = os.path.join(repo, "examples")
        if os.path.isdir(ex_dir):
            files += sorted(
                os.path.join(ex_dir, f) for f in os.listdir(ex_dir)
                if f.startswith("torch_") and f.endswith(".py"))
        e2e = os.path.join(repo, "tests", "test_pipeline_e2e.py")
        if os.path.exists(e2e):
            files.append(e2e)
    if files and not args.threads and not args.proto:
        rc = max(rc, lint_files(files, strict=args.strict,
                                verbose=args.verbose, baseline=baseline,
                                collected=collected, deep=args.deep,
                                reconfig=reconfig))

    if args.threads:
        rc = max(rc, lint_threads(strict=args.strict, verbose=args.verbose,
                                  baseline=baseline, collected=collected,
                                  files=files or None))

    if args.proto:
        rc = max(rc, lint_proto(strict=args.strict, verbose=args.verbose,
                                baseline=baseline, collected=collected,
                                files=files or None))

    if args.dogfood:
        rc = max(rc, dogfood(strict=args.strict, baseline=baseline,
                             collected=collected, deep=args.deep))

    if args.update_baseline:
        if not args.baseline:
            print("--update-baseline needs --baseline FILE", file=sys.stderr)
            return 2
        with open(args.baseline, "w") as f:
            f.write("# nns-lint accepted diagnostics "
                    "(nnstreamer_tpu_torch.tools.lint --update-baseline)\n")
            for k in sorted(set(collected)):
                f.write(k + "\n")
        print(f"baseline updated: {len(set(collected))} accepted "
              f"diagnostic(s) -> {args.baseline}")
        return 0
    return rc


if __name__ == "__main__":
    sys.exit(main())
