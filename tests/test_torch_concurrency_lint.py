"""The port's nns-tsan: ``nnstreamer_tpu_torch.analysis.concurrency``
against the JAX package's pass on the same fixture files (every check,
each clean twin), the port's own tree clean against
``tools/torch_tsan_baseline.txt`` (no error baselined, no stale key),
the runtime's lock discipline (``_StageQueue`` and ``Census`` declare
``_GUARDED_BY`` and take their locks from ``utils/locks.py``), and the
dynamic twin: a planted inversion raises ``LockOrderError`` under
``NNS_TPU_TSAN=1`` and the static pass names the same two locks."""

import importlib.util
import os
import sys
import threading

import pytest

from nnstreamer_tpu.analysis import concurrency as jconc
from nnstreamer_tpu_torch.analysis import concurrency as tconc
from nnstreamer_tpu_torch.analysis.diagnostics import ERROR
from nnstreamer_tpu_torch.tools import lint
from nnstreamer_tpu_torch.utils import locks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "tools", "torch_tsan_baseline.txt")

UNGUARDED = '''\
import threading


class Counter:
    _GUARDED_BY = {"_n": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self):
        self._n += 1
'''

HELPER_CHAIN = '''\
import threading


class J:
    _GUARDED_BY = {"_n": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def append(self):
        with self._lock:
            self._write_locked()

    def _write_locked(self):
        self._rotate_locked()

    def _rotate_locked(self):
        self._n += 1
'''

UNLOCKED_CALLER = '''\
import threading


class J:
    _GUARDED_BY = {"_n": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def good(self):
        with self._lock:
            self._bump()

    def bad(self):
        self._bump()

    def _bump(self):
        self._n += 1
'''

INVERSION = '''\
import threading

A = threading.Lock()
B = threading.Lock()


def forward():
    with A:
        with B:
            pass


def backward():
    with B:
        with A:
            pass
'''

UNJOINED = '''\
import threading


class Owner:
    def start(self):
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        pass
'''

COND_WAIT = '''\
import threading


class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items = []

    def get(self):
        with self._cond:
            if not self._items:
                self._cond.wait()
            return self._items.pop()
'''

#: the planted inversion: two classes whose locks come from the factory,
#: taken in both orders through module singletons
PLANTED = '''\
from nnstreamer_tpu_torch.utils import locks


class Left:
    def __init__(self):
        self._lock = locks.make_lock("Left._lock")

    def forward(self):
        with self._lock:
            RIGHT.poke()

    def touch(self):
        with self._lock:
            pass


class Right:
    def __init__(self):
        self._lock = locks.make_lock("Right._lock")

    def poke(self):
        with self._lock:
            pass

    def backward(self):
        with self._lock:
            LEFT.touch()


LEFT = Left()
RIGHT = Right()
'''

#: each fixture of tests/test_concurrency_lint.py (and a factory-made
#: pair): (source, the codes both passes must report)
FIXTURES = {
    "unguarded-write": (UNGUARDED, ["unguarded-write"]),
    "guarded-write-clean": (UNGUARDED.replace(
        "    def bump(self):\n        self._n += 1\n",
        "    def bump(self):\n        with self._lock:\n"
        "            self._n += 1\n"), []),
    "mutator-call": (UNGUARDED.replace("self._n = 0", "self._n = []").replace(
        "self._n += 1", "self._n.append(1)"), ["unguarded-write"]),
    "locked-helper-chain": (HELPER_CHAIN, []),
    "unlocked-caller": (UNLOCKED_CALLER, ["unguarded-write"]),
    "lock-order-inversion": (INVERSION, ["lock-order-inversion"]),
    "consistent-order": (INVERSION.replace("    with B:\n        with A:",
                                           "    with A:\n        with B:"), []),
    "unjoined-thread": (UNJOINED, ["unjoined-thread"]),
    "joined-thread": (UNJOINED + '''
    def stop(self):
        self._thread.join()
''', []),
    "tuple-swap-join": (UNJOINED + '''
    def stop(self):
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
''', []),
    "daemon-thread": (UNJOINED.replace("target=self._run)",
                                       "target=self._run, daemon=True)"),
                      ["daemon-thread"]),
    "cond-wait-no-predicate": (COND_WAIT, ["cond-wait-no-predicate"]),
    "cond-wait-in-while": (COND_WAIT.replace("            if not self._items:",
                                             "            while not self._items:"), []),
    "factory-inversion": (PLANTED, ["lock-order-inversion"]),
}


def _diags(module, tmp_path, source, name="fix.py"):
    p = tmp_path / name
    p.write_text(source)
    reports, stats = module.lint_paths([str(p)], root=str(tmp_path))
    return [(d.code, d.severity, d.path, d.pos, d.message)
            for rep in reports for d in rep.diagnostics], stats


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_diagnostics_equal_the_jax_pass(name, tmp_path):
    source, codes = FIXTURES[name]
    got, got_stats = _diags(tconc, tmp_path, source)
    want, want_stats = _diags(jconc, tmp_path, source)
    assert got == want
    assert got_stats == want_stats
    assert sorted(d[0] for d in got) == sorted(codes)


def test_cross_file_inversion_equal_the_jax_pass(tmp_path):
    """The order graph spans the linted set: one edge per file."""
    (tmp_path / "a.py").write_text("import threading\nfrom b import B\nA = threading.Lock()\n\n"
                                   "def f():\n    with A:\n        with B:\n            pass\n")
    (tmp_path / "b.py").write_text("import threading\nfrom a import A\nB = threading.Lock()\n\n"
                                   "def g():\n    with B:\n        with A:\n            pass\n")
    paths = [str(tmp_path / "a.py"), str(tmp_path / "b.py")]
    got = [(d.code, d.path, d.message) for rep in tconc.lint_paths(paths, root=str(tmp_path))[0]
           for d in rep.diagnostics]
    want = [(d.code, d.path, d.message) for rep in jconc.lint_paths(paths, root=str(tmp_path))[0]
            for d in rep.diagnostics]
    assert got == want


def _baseline():
    with open(BASELINE) as f:
        return {ln.strip() for ln in f if ln.strip() and not ln.startswith("#")}


def test_port_tree_clean_against_its_baseline():
    reports, stats = tconc.lint_package()
    diags = [d for rep in reports for d in rep.diagnostics]
    assert [d for d in diags if d.severity == ERROR] == []
    keys = {tconc.baseline_key(d) for d in diags}
    assert keys <= _baseline(), keys - _baseline()
    assert stats["guarded_classes"] >= 12 and stats["threaded"] >= 30
    assert tconc.package_root().endswith("nnstreamer_tpu_torch")


def test_every_baseline_key_is_still_emitted():
    """A stale entry (a thread that went away or was fixed) fails here."""
    reports, _ = tconc.lint_package()
    emitted = {tconc.baseline_key(d): d.severity for rep in reports for d in rep.diagnostics}
    for key in _baseline():
        assert key in emitted, f"stale baseline entry {key}"
        assert emitted[key] != ERROR and key.startswith("threads:daemon-thread:")


def test_cli_threads_strict_against_the_port_baseline(capsys):
    assert lint.main(["--threads", "--strict", "--baseline", BASELINE]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out and "0 new" in out and "baseline-accepted" in out


def test_runtime_lock_discipline_is_declared():
    """The stage queue and the capture census declare their guards, take
    their locks from the factory, and the pass counts them."""
    root = tconc.package_root()
    facts = {}
    for rel, cls in (("pipeline/runtime.py", "_StageQueue"), ("pipeline/graphs.py", "Census")):
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        mod = tconc._ModuleFacts(path, rel, src, __import__("ast").parse(src))
        facts[cls] = mod.classes[cls]
    assert facts["_StageQueue"].guarded == {"_dq": "_lock", "_closed": "_lock"}
    assert facts["_StageQueue"].lock_attrs["_lock"] == "lock"
    assert facts["_StageQueue"].lock_attrs["_not_empty"] == "cond"
    assert set(facts["Census"].guarded) == {"signatures", "captures", "replays", "launches"}
    assert facts["Census"].lock_attrs["_lock"] == "lock"


def test_runtime_locks_plain_with_the_flag_unset(monkeypatch):
    from nnstreamer_tpu_torch.pipeline.graphs import Census
    from nnstreamer_tpu_torch.pipeline.runtime import _StageQueue

    monkeypatch.delenv(locks.ENV_FLAG, raising=False)
    q = _StageQueue(2)
    assert type(q._lock) is type(threading.Lock())
    assert type(q._not_empty) is threading.Condition
    assert type(Census("cpu")._lock) is type(threading.Lock())


@pytest.fixture
def tsan(monkeypatch):
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    monkeypatch.setenv(locks.ENV_RAISE, "1")
    locks.reset()
    yield
    locks.reset()


def test_runtime_locks_tracked_under_the_flag(tsan):
    from nnstreamer_tpu_torch.pipeline.graphs import Census
    from nnstreamer_tpu_torch.pipeline.runtime import _StageQueue

    q = _StageQueue(2)
    assert isinstance(q._lock, locks.TrackedLock)
    assert isinstance(q._not_full, locks.TrackedCondition)
    got = []

    def getter():
        got.append(q.get(timeout=10.0))

    t = threading.Thread(target=getter)
    t.start()
    assert q.put(("in", 1))
    t.join(timeout=10.0)
    assert got == [("in", 1)]
    c = Census("cpu")
    assert isinstance(c._lock, locks.TrackedLock)
    c._replayed(("sig",), {})
    rep = locks.report()
    assert {"StageQueue._lock", "Census._lock"} <= set(rep["locks"])
    assert rep["inversions"] == [] and rep["guard_violations"] == []


def test_planted_inversion_raises_and_the_static_pass_names_it(tsan, tmp_path):
    path = tmp_path / "planted.py"
    path.write_text(PLANTED)
    spec = importlib.util.spec_from_file_location("planted_inversion", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert isinstance(mod.LEFT._lock, locks.TrackedLock)
    mod.LEFT.forward()
    with pytest.raises(locks.LockOrderError) as ei:
        mod.RIGHT.backward()
    assert "Right._lock -> Left._lock" in str(ei.value)
    assert len(locks.report()["inversions"]) == 1
    assert not mod.LEFT._lock.locked() and not mod.RIGHT._lock.locked()
    diags, _ = _diags(tconc, tmp_path, PLANTED, name="planted.py")
    [(code, _sev, where, _pos, _msg)] = diags
    assert code == "lock-order-inversion"
    assert where == "order:Left._lock->Right._lock"
    assert "planted_inversion" not in sys.modules
