"""The port's nns-proto: ``nnstreamer_tpu_torch.analysis.protocol`` and
``statemachine`` against the JAX package's on the same fixtures (meta-key
drift, an unhandled message, a dead handler, the unanswered-path proof,
the alphabet drift gate's drift and surplus), the port's own protocol
modules clean against ``tools/torch_proto_baseline.txt`` with their
alphabet equal to the shipped models', the model checker's state counts,
verdicts and counterexamples equal in both packages, and
``analyze(desc, proto=True)``."""

import os

import pytest

from nnstreamer_tpu import analysis as janalysis
from nnstreamer_tpu.analysis import protocol as jproto
from nnstreamer_tpu.analysis import statemachine as jsm
from nnstreamer_tpu_torch import analysis as tanalysis
from nnstreamer_tpu_torch.analysis import protocol as tproto
from nnstreamer_tpu_torch.analysis import statemachine as tsm
from nnstreamer_tpu_torch.tools import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "tools", "torch_proto_baseline.txt")

UNANSWERED = '''\
def handle_request(core, metrics, buf):
    mid = buf.meta.get("_query_msg")
    if mid is None:
        metrics.count("server.dropped")
        return
    if not core.ready:
        return            # strands the client: armed, no answer
    core.send(mid, b"ok")
'''

#: each fixture of tests/test_protocol_lint.py: (source, the codes both
#: passes must report)
FIXTURES = {
    "meta-key-drift": ('def stamp(buf):\n    buf.meta["_totally_new_key"] = 1\n',
                       ["meta-key-drift"]),
    "registered-key": ('from nnstreamer_tpu_torch.core.meta_keys import META_SHED\n'
                       'def stamp(buf):\n'
                       '    buf.meta[META_SHED] = True\n'
                       'def read(buf):\n'
                       '    return buf.meta.get(META_SHED)\n', []),
    "control-kind-drift": ('def hello():\n    return {"type": "teleport", "proto": 2}\n',
                           ["meta-key-drift"]),
    "abort-reason-drift": ('def abort(buf):\n'
                           '    buf.meta["abort_reason"] = "cosmic_ray"\n'
                           '    buf.meta["stream_aborted"] = True\n'
                           '    buf.meta.get("abort_reason")\n'
                           '    buf.meta.get("stream_aborted")\n', ["meta-key-drift"]),
    "unhandled-message": ('def stamp(buf):\n    buf.meta["shed"] = True\n',
                          ["unhandled-message"]),
    "dead-handler": ('def read(buf):\n    return buf.meta.get("wire_reject")\n',
                     ["dead-handler"]),
    "external-exempt": ('def read(buf):\n    return buf.meta.pop("_tq", None)\n', []),
    "unanswered-path": (UNANSWERED, ["dead-handler", "unanswered-path"]),
    "pre-arming-exit": ('def handle_request(core, buf):\n'
                        '    if core is None:\n'
                        '        raise RuntimeError("no core")\n'
                        '    mid = buf.meta.get("_query_msg")\n'
                        '    core.send(mid, b"ok")\n', None),
    "accounted-drop": ('def handle_request(metrics, buf):\n'
                       '    mid = buf.meta.get("_query_msg")\n'
                       '    if mid is None:\n'
                       '        metrics.count("server.dropped")\n'
                       '        return\n'
                       '    buf.reply(mid)\n', None),
    "fixpoint-helper": ('def _finish(core, mid):\n'
                        '    if core.up:\n'
                        '        core.send(mid, b"ok")\n'
                        '    else:\n'
                        '        core.send(mid, b"down")\n'
                        '\n'
                        'def handle_request(core, buf):\n'
                        '    mid = buf.meta.get("_query_msg")\n'
                        '    return _finish(core, mid)\n', None),
    "loop-body-answers": ('def handle_batch(core, buf):\n'
                          '    rows = buf.meta["_query_batch"]\n'
                          '    for m in rows:\n'
                          '        core.send(m, b"ok")\n', None),
    "raise-after-arming": ('def handle_request(core, buf):\n'
                           '    mid = buf.meta.get("_query_msg")\n'
                           '    raise RuntimeError("boom")\n', None),
    "broad-except": ('def handle_request(core, buf):\n'
                     '    mid = buf.meta.get("_query_msg")\n'
                     '    try:\n'
                     '        if core.bad:\n'
                     '            raise RuntimeError("boom")\n'
                     '        core.send(mid, b"ok")\n'
                     '    except Exception as e:\n'
                     '        core.abort_request(mid, e)\n'
                     '        raise\n', None),
}

FIXTURE_REGISTRY = '''\
META_KV_XFER = "_kv_xfer"
PROTOCOL_META_KEYS = frozenset({META_KV_XFER})
CONTROL_TYPES = frozenset({"hello", "ack", "nack"})
ABORT_REASONS = frozenset({"wire"})
EXTERNAL_META_KEYS = frozenset(set())
'''


def _diags(module, tmp_path, source, registry=None, drift=False):
    p = tmp_path / "fix.py"
    p.write_text(source)
    reports, stats = module.lint_paths([str(p)], root=str(tmp_path),
                                       registry=registry, drift_gate=drift)
    return [(d.code, d.severity, d.path, d.pos, d.message)
            for rep in reports for d in rep.diagnostics], stats


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_diagnostics_equal_the_jax_pass(name, tmp_path):
    source, codes = FIXTURES[name]
    got, got_stats = _diags(tproto, tmp_path, source)
    want, want_stats = _diags(jproto, tmp_path, source)
    assert got == want and got_stats == want_stats
    if codes is not None:
        assert sorted(d[0] for d in got) == sorted(codes)


def test_unanswered_path_caret_and_proof_counts(tmp_path):
    got, stats = _diags(tproto, tmp_path, UNANSWERED)
    [(code, _sev, path, pos, _msg)] = [d for d in got if d[0] == "unanswered-path"]
    assert "handle_request" in path and UNANSWERED[:pos].count("\n") + 1 == 7
    assert stats["handlers"] == 1 and stats["proven"] == 0


def test_alphabet_drift_gate_equal_the_jax_pass(tmp_path):
    """A registered kind no shipped model declares fails both gates."""
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "meta_keys.py").write_text(FIXTURE_REGISTRY)
    src = ('def move(buf):\n'
           '    buf.meta["_kv_xfer"] = 1\n'
           'def recv(buf):\n'
           '    return buf.meta.get("_kv_xfer")\n')
    treg, jreg = tproto.load_registry(str(tmp_path)), jproto.load_registry(str(tmp_path))
    assert treg.meta_keys == jreg.meta_keys == {"_kv_xfer"}
    got, _ = _diags(tproto, tmp_path, src, registry=treg, drift=True)
    want, _ = _diags(jproto, tmp_path, src, registry=jreg, drift=True)
    assert got == want
    drift = [d for d in got if d[0] == "model-alphabet-drift"]
    assert len(drift) == 1 and "_kv_xfer" in drift[0][4]


def test_alphabet_surplus_equal_the_jax_pass(tmp_path):
    """Kinds the models declare but the linted code never uses are
    surplus warnings, the same ones in both packages."""
    src = ('def stamp(buf):\n    buf.meta["shed"] = True\n'
           'def read(buf):\n    return buf.meta.get("shed")\n')
    got, got_stats = _diags(tproto, tmp_path, src, drift=True)
    want, want_stats = _diags(jproto, tmp_path, src, drift=True)
    assert got == want and got_stats == want_stats
    surplus = [d for d in got if d[0] == "model-alphabet-surplus"]
    external = tproto.load_registry().external
    assert len(surplus) == len(tsm.shipped_alphabet() - external) - 1 > 20


def test_port_protocol_modules_clean():
    reports, stats = tproto.lint_package()
    assert [d for rep in reports for d in rep.diagnostics] == []
    assert stats == {"files": 7, "keys": 21, "kinds": 5, "handlers": 1, "proven": 1,
                     "models": 5}
    assert tproto.package_root().endswith("nnstreamer_tpu_torch")
    assert len(tproto._iter_protocol_paths(tproto.package_root())) \
        == len(tproto.PROTOCOL_MODULES) == 7


def test_port_alphabet_equals_the_models_and_the_jax_one():
    root = tproto.package_root()
    reg = tproto.load_registry(root)
    facts = []
    for path in tproto._iter_protocol_paths(root):
        with open(path) as f:
            src = f.read()
        facts.append(tproto._FileFacts(path, os.path.relpath(path, root), src,
                                       __import__("ast").parse(src), reg))
    code = tproto.extracted_alphabet(facts, reg)
    assert tsm.shipped_alphabet() == jsm.shipped_alphabet()
    assert code == tsm.shipped_alphabet() - reg.external


def test_baseline_holds_no_key_the_pass_does_not_emit(capsys):
    """The baseline is empty on purpose; any key there would have to be
    one the pass still emits, and the CLI gate passes against it."""
    with open(BASELINE) as f:
        keys = {ln.strip() for ln in f if ln.strip() and not ln.startswith("#")}
    reports, _ = tproto.lint_package()
    emitted = {tproto.baseline_key(d) for rep in reports for d in rep.diagnostics}
    assert keys <= emitted and keys == set()
    assert lint.main(["--proto", "--strict", "--baseline", BASELINE]) == 0
    assert "proto: 7 file(s), 21 meta key(s)" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(tsm.SHIPPED_MODELS))
def test_shipped_model_explores_as_the_jax_one(name):
    got = tsm.check(tsm.SHIPPED_MODELS[name]())
    want = jsm.check(jsm.SHIPPED_MODELS[name]())
    assert (got.ok, got.states, got.transitions, got.bounded_out) \
        == (want.ok, want.states, want.transitions, want.bounded_out)
    assert got.ok and got.states > 10


#: each guard switched off, by model factory and keyword.  journal=False
#: verifies in both packages: client resend alone re-covers a crashed
#: queue (the model's docstring); the rest yield counterexamples
GUARDS_OFF = [
    ("exactly_once_model", "journal", None),
    ("exactly_once_model", "client_dedupe", "answered-at-most-once"),
    ("exactly_once_model", "resend", "deadlock"),
    ("handover_model", "adopt_guard", "no-duplicate-stream"),
    ("handover_model", "release_on_drain", "deadlock"),
    ("quarantine_model", "dlq_guard", "quarantined-never-relive"),
    ("hysteresis_model", "honor_cooldown", "no-flip-inside-cooldown"),
    ("weave_clock_model", "dedup_guard", "applies-bounded-by-probes"),
]


@pytest.mark.parametrize("factory,guard,prop", GUARDS_OFF,
                         ids=[f"{f}-{g}" for f, g, _ in GUARDS_OFF])
def test_guard_off_counterexample_equals_the_jax_one(factory, guard, prop):
    got = tsm.check(getattr(tsm, factory)(**{guard: False}))
    want = jsm.check(getattr(jsm, factory)(**{guard: False}))
    assert (got.ok, got.states, got.transitions) == (want.ok, want.states, want.transitions)
    if prop is None:
        assert got.ok and got.violation is None and want.violation is None
        return
    assert not got.ok
    gv, wv = got.violation, want.violation
    assert (gv.kind, gv.prop, len(gv.trace)) == (wv.kind, wv.prop, len(wv.trace))
    assert prop in (gv.prop, gv.kind)
    assert [r for r, _ in gv.trace] == [r for r, _ in wv.trace]
    assert gv.render() == wv.render()


def _drift_tree(tmp_path):
    """A package tree whose ``elements/query.py`` stamps an unregistered
    key, beside a copy of the port's registry."""
    for sub in ("elements", "core"):
        (tmp_path / sub).mkdir()
    (tmp_path / "elements" / "query.py").write_text(
        'def stamp(buf):\n    buf.meta["_totally_new_key"] = 1\n')
    with open(os.path.join(tproto.package_root(), "core", "meta_keys.py")) as f:
        (tmp_path / "core" / "meta_keys.py").write_text(f.read())
    return str(tmp_path)


def test_analyze_proto_adds_the_protocol_reports(tmp_path, monkeypatch):
    desc = "appsrc ! tensor_sink"
    assert tanalysis.analyze(desc, proto=True).clean
    assert [d.code for d in tanalysis.analyze(desc)] == []
    root = _drift_tree(tmp_path)
    monkeypatch.setattr(tproto, "package_root", lambda: root)
    monkeypatch.setattr(jproto, "package_root", lambda: root)
    got = tanalysis.analyze(desc, proto=True)
    want = janalysis.analyze(desc, proto=True)
    assert sorted((d.code, d.severity, d.path) for d in got) \
        == sorted((d.code, d.severity, d.path) for d in want)
    assert "meta-key-drift" in {d.code for d in got} and not got.ok
    assert tanalysis.analyze(desc).ok  # without proto=, no protocol pass
