"""The port's command-line tools: ``lint`` (with ``--deep``, ``--strict``,
``--files``, ``--examples``, ``--dogfood``, ``--baseline``, ``--reconfig``,
``--threads`` and ``--proto`` against the port's baselines), ``doctor``
(``--gate``, ``--json``, ``--bench``, on the CPU here), ``inspect`` and
``parse``, each beside the JAX package's where their output is the same."""

import io
import json
import os

import pytest

# imported here, not under a test's capsys: ``list_all``'s default ``out``
# is the ``sys.stdout`` of the first import, and a captured stream closes
# with its test (a later ``inspect.main([])`` in this worker would write to it)
from nnstreamer_tpu.tools import inspect as jax_ins
from nnstreamer_tpu_torch.tools import doctor, inspect as ins, lint, parse
from nnstreamer_tpu_torch.utils.xray import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC = "accelerator=true:cpu"
GOOD = ("appsrc caps=other/tensors,dimensions=4:4,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:4:4 ! "
        "tensor_sink")
BAD = "videotestsrc ! tensor_transform mode=typecast option=float32 ! tensor_sink"
LLM = ("appsrc name=src ! tensor_filter name=llm framework=llm model=llama2_7b "
       "custom=quant:int4,param_dtype:bfloat16,max_seq:1024,serve:continuous,"
       "slots:8 invoke-dynamic=true ! tensor_sink name=out")


@pytest.fixture(autouse=True)
def _clean():
    registry.reset()
    yield
    registry.reset()


def test_lint_pipeline_and_its_exit_codes(capsys):
    assert lint.main([GOOD]) == 0
    assert "OK:" in capsys.readouterr().out
    assert lint.main([BAD]) == 1
    out = capsys.readouterr().out
    assert "caps-mismatch" in out and "^" in out


def test_lint_deep_prints_the_resource_report(capsys):
    assert lint.main(["--deep", LLM]) == 0
    out = capsys.readouterr().out
    assert "deep resource report" in out and "kv pool" in out and "programs 1" in out


def test_lint_reconfig_needs_deep_and_flags_signature_knobs(capsys):
    assert lint.main(["--reconfig", "slots:4", LLM]) == 2
    assert "--reconfig requires --deep" in capsys.readouterr().err
    assert lint.main(["--deep", "--strict", "--reconfig", "slots:4", LLM]) == 1
    assert "recompile-on-reconfig" in capsys.readouterr().out


@pytest.mark.parametrize("flag,baseline,head", [
    ("--threads", "torch_tsan_baseline.txt", "threads: "),
    ("--proto", "torch_proto_baseline.txt", "proto: 7 file(s)"),
])
def test_lint_threads_and_proto_pass_strict_on_the_port(flag, baseline, head, capsys):
    path = os.path.join(REPO, "tools", baseline)
    assert lint.main([flag, "--strict", "--baseline", path]) == 0
    out = capsys.readouterr().out
    assert out.startswith(head) and "0 error(s)" in out and "0 new" in out


@pytest.mark.parametrize("flag", ["--threads", "--proto"])
def test_lint_threads_and_proto_fail_without_the_baseline(flag, capsys):
    """Without a baseline, --strict fails on warnings only where the port
    has some: the daemon threads (--threads); the protocol pass has none."""
    rc = lint.main([flag, "--strict"])
    out = capsys.readouterr().out
    assert rc == (1 if flag == "--threads" else 0)
    assert ("daemon-thread" in out) == (flag == "--threads")


@pytest.mark.parametrize("flag", ["--threads", "--proto"])
def test_lint_threads_and_proto_over_files(flag, tmp_path, capsys):
    """With --files, the pass reads those files instead of the package."""
    f = tmp_path / "fix.py"
    f.write_text("import threading\n\n\nclass Owner:\n    def start(self):\n"
                 "        self._t = threading.Thread(target=print)\n"
                 "        self._t.start()\n" if flag == "--threads" else
                 'def stamp(buf):\n    buf.meta["_totally_new_key"] = 1\n')
    assert lint.main([flag, "--files", str(f)]) == 1
    out = capsys.readouterr().out
    assert ("unjoined-thread" if flag == "--threads" else "meta-key-drift") in out


def test_lint_update_baseline_round_trip(tmp_path, capsys):
    path = str(tmp_path / "b.txt")
    assert lint.main(["--threads", "--baseline", path, "--update-baseline"]) == 0
    assert "baseline updated: 11 accepted" in capsys.readouterr().out
    assert lint.main(["--threads", "--strict", "--baseline", path]) == 0


def test_lint_usage_without_input(capsys):
    assert lint.main([]) == 2


def test_lint_dogfood_deep_is_clean(capsys):
    assert lint.main(["--dogfood", "--deep"]) == 0
    out = capsys.readouterr().out
    assert "14 zoo model(s) abstract-traced" in out and "0 error(s)" in out


def test_lint_examples_lint_clean(capsys):
    rc = lint.main(["--examples", "--baseline", os.path.join(REPO, "tools", "lint_baseline.txt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "linted" in out


def test_lint_unresolved_calls_are_named_warnings(tmp_path, capsys):
    f = tmp_path / "ex.py"
    f.write_text("import nnstreamer_tpu_torch as ntt\n"
                 "def go(d):\n"
                 "    return ntt.Pipeline(d + ' ! tensor_sink')\n")
    assert lint.main(["--files", str(f), "--strict"]) == 1
    out = capsys.readouterr().out
    assert "unresolvable-pipeline" in out and "ex.py:3" in out
    assert lint.main(["--files", str(f)]) == 0


def test_lint_baseline_accepts_known_keys(tmp_path, capsys):
    f = tmp_path / "ex.py"
    f.write_text("import nnstreamer_tpu_torch as ntt\n"
                 f"ntt.Pipeline({BAD!r})\n")
    base = tmp_path / "baseline.txt"
    assert lint.main(["--files", str(f)]) == 1
    assert lint.main(["--files", str(f), "--baseline", str(base),
                      "--update-baseline"]) == 0
    assert lint.main(["--files", str(f), "--baseline", str(base)]) == 0
    assert "baseline-accepted" in capsys.readouterr().out


def test_unresolved_keys_stable_across_line_drift(tmp_path):
    from nnstreamer_tpu.tools.lint import _unresolved_keys as jax_keys

    a = tmp_path / "a.py"
    a.write_text("import nnstreamer_tpu_torch as ntt\nntt.Pipeline(desc)\n")
    _, sk1 = lint.extract_pipeline_strings(str(a))
    a.write_text("import nnstreamer_tpu_torch as ntt\n\n\n# moved\n"
                 "ntt.Pipeline(desc)\n")
    _, sk2 = lint.extract_pipeline_strings(str(a))
    assert sk1[0][0] != sk2[0][0]
    assert lint._unresolved_keys("a.py", sk1) == lint._unresolved_keys("a.py", sk2) \
        == jax_keys("a.py", sk1)


def test_doctor_gate_and_json_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = doctor.main(["--cpu", "--frames", "48", "--json", str(out), "--gate"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "census drift 0" and lines[-1] == "doctor: OK"
    assert "f/batch: within budget" in lines
    rep = json.load(open(out))
    assert rep["ok"] is True and rep["census"]["drift_total"] == 0
    for cat in ("params", "kv_pool", "agg_rings", "activations"):
        assert rep["hbm"]["categories"][cat]["ok"]


def test_doctor_report_and_bench(capsys):
    assert doctor.main(["--cpu", "--frames", "24"]) == 0
    out = capsys.readouterr().out
    assert "pipeline doctor — predicted vs actual" in out and "verdict: OK" in out
    assert doctor.main(["--cpu", "--frames", "16", "--bench"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "doctor_overhead_pct" and row["census_drift"] == 0


def test_doctor_self_driving_pipeline(capsys):
    rc = doctor.main(["videotestsrc num-buffers=4 width=8 height=8 ! "
                      "tensor_converter ! fakesink"])
    assert rc == 0
    assert "verdict: OK" in capsys.readouterr().out


def test_inspect_lists_and_shows_with_aliases(capsys):
    assert ins.main(["--kind", "filter"]) == 0
    out = capsys.readouterr().out
    assert "== filter" in out and "llm" in out and "custom-easy" in out
    assert ins.main(["jax"]) == 0
    out = capsys.readouterr().out
    assert "filter: jax" in out and "aliases: pjrt, tpu-xla, xla" in out
    assert "nnstreamer_tpu_torch.filters.device_fw" in out
    assert ins.main(["no_such_thing"]) == 1
    # the same element vocabulary as the JAX package's listing
    port, ref = io.StringIO(), io.StringIO()
    ins.list_all("element", out=port)
    jax_ins.list_all("element", out=ref)

    def names(buf):
        return [ln.split()[0] for ln in buf.getvalue().splitlines()[1:] if ln.strip()]

    assert names(port) == names(ref) and len(names(port)) > 40


def test_parse_validates_and_plans(capsys):
    from nnstreamer_tpu.tools import parse as jax_parse

    desc = "videotestsrc ! tensor_converter ! tensor_sink"
    assert parse.main([desc]) == 0
    port = capsys.readouterr().out
    jax_parse.main([desc])
    assert port == capsys.readouterr().out
    assert parse.main([desc, "--dot"]) == 0
    assert "digraph pipeline" in capsys.readouterr().out
    assert parse.main(["videotestsrc ! ! tensor_sink"]) == 1
    assert "INVALID" in capsys.readouterr().err
    plan = ("appsrc caps=other/tensors,dimensions=4,types=float32 ! "
            "tensor_transform mode=arithmetic option=mul:2.0 ! "
            f"tensor_filter framework=jax model=scaler custom=scale:2.0,dims:4 {ACC} ! "
            "tensor_sink")
    assert parse.main([plan, "--plan"]) == 0
    assert "fused:" in capsys.readouterr().out
