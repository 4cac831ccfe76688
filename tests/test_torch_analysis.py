"""The port's static analyzer (nnstreamer_tpu_torch.analysis) against the
JAX package's: the same pipeline strings give the same diagnostics (code,
severity, element path, caret offset), every shipped torch pipeline string
lints clean, and the host-sync lint catches each construct a captured step
cannot hold while passing the port's own device_fns."""

import os
import random as _random
import time as _time

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.analysis import analyze as jax_analyze
from nnstreamer_tpu.core import caps as jcaps
from nnstreamer_tpu.core.types import TensorsSpec as JSpec
from nnstreamer_tpu.filters.custom_easy import (
    register_custom_easy as jax_register, unregister_custom_easy as jax_unregister)
from nnstreamer_tpu_torch.analysis import PipelineLintError, analyze
from nnstreamer_tpu_torch.analysis.purity import lint_callable, lint_module
from nnstreamer_tpu_torch.core.caps import (
    Caps, MediaType, explain_mismatch, intersect_template)
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters.custom_easy import (
    register_custom_easy, unregister_custom_easy)
from nnstreamer_tpu_torch.pipeline.parser import ParseError, parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def codes(report):
    return set(report.codes())


def diag_list(report):
    return sorted((d.code, d.severity, d.path, d.pos) for d in report)


def assert_same_as_jax(desc, **kw):
    port, ref = analyze(desc, **kw), jax_analyze(desc, **kw)
    assert diag_list(port) == diag_list(ref), (port.render(), ref.render())
    return port


BAD_PIPELINES = [
    ("videotestsrc ! tensor_transform mode=typecast option=float32 ! "
     "tensor_sink", "caps-mismatch"),
    ("appsrc caps=other/tensors,dimensions=3:8:8:1,types=uint8 ! "
     "tensor_filter framework=custom-easy model=missing "
     "input=3:8:8:1 inputtype=float32 ! tensor_sink", "caps-mismatch"),
    ("videotestsrc width=8 height=8 ! video/x-raw,format=GRAY8 ! "
     "tensor_converter ! tensor_sink", "caps-mismatch"),
    ("videotestsrc name=v ! tensor_converter ! nosuch. ", "dangling-pad-ref"),
    ("appsrc name=a ! tee name=t "
     "t. ! tensor_mux name=m ! tensor_sink "
     "t. ! tensor_transform mode=typecast option=float32 ! m.",
     "tee-deadlock"),
    ("tensor_mux name=m ! tensor_transform mode=typecast option=float32 "
     "! m.", "cycle"),
    ("appsrc name=src ! tensor_transform mode=typecast option=float32 "
     "tensor_sink name=out", "no-input"),
    ("appsrc ! tensor_transfrom mode=typecast ! tensor_sink",
     "unknown-element"),
    ("appsrc caps=other/tensors,dimensions=4.4,types=float32.float32 "
     "name=a ! tensor_demux name=d "
     "d.src_0 ! tensor_sink name=s0 "
     "d.src_5 ! tensor_sink name=s5", "pad-arity"),
    ("appsrc name=a ! mux.sink_0 appsrc name=b ! mux.sink_3 "
     "tensor_mux name=mux ! tensor_sink", "pad-gap"),
    ("appsrc name=a caps=other/tensors,dimensions=4,types=float32 ! "
     "mux.sink_0 "
     "appsrc name=b caps=other/tensors,dimensions=4,types=float32 ! "
     "mux.sink_1 "
     "tensor_merge name=mux mode=linear option=7 ! tensor_sink",
     "caps-incompat"),
    ("videotestsrc ! videotestsrc ! tensor_sink", "source-has-input"),
    ("appsrc ! tensor_sink name=s ! tensor_sink", "sink-has-output"),
]


@pytest.mark.parametrize("desc,code", BAD_PIPELINES,
                         ids=[c for _, c in BAD_PIPELINES])
def test_bad_pipeline_diagnosed_as_jax(desc, code):
    report = assert_same_as_jax(desc)
    assert any(d.code == code and d.severity == "error" for d in report), \
        report.render()
    diag = next(d for d in report if d.code == code)
    assert diag.path or diag.pos is not None


def test_malformed_props_are_diagnostics_not_crashes():
    for desc in (
        "appsrc ! tensor_filter framework=custom-easy model=m "
        "input=garbage ! tensor_sink",
        "appsrc caps=other/tensors,dimensions=4,types=float32 ! "
        "tensor_filter input-combination=a,b input=4 ! tensor_sink",
        "appsrc caps=other/tensors,dimensions=4.4,types=float32.float32 "
        "name=a ! tensor_demux name=d tensorpick=x d.src_0 ! tensor_sink",
    ):
        report = assert_same_as_jax(desc)
        assert "caps-incompat" in codes(report), report.render()
        assert "analyzer-error" not in codes(report)


@pytest.mark.parametrize("desc", [
    "badref.src ! other.sink",
    "badname. ! tensor_sink",
    "appsrc name=a ! b.sink",
], ids=["both-dangling", "phantom-fed", "dangling-sink"])
def test_dangling_refs_as_jax(desc):
    report = assert_same_as_jax(desc)
    assert "dangling-pad-ref" in codes(report)
    assert not {"no-input", "unreachable", "leaf-not-sink"} & codes(report)


def test_multiline_source_caret_points_at_the_right_column():
    desc = "appsrc name=a !\n  tensor_transfrom ! tensor_sink"
    report = assert_same_as_jax(desc)
    lines = report.render().splitlines()
    caret = next((lines[i - 1], ln) for i, ln in enumerate(lines)
                 if ln.strip() == "^" and "tensor_transfrom" in lines[i - 1])
    src, mark = caret
    assert src[mark.index("^")] == "t"
    assert report.render() == jax_analyze(desc).render()


def test_parse_error_becomes_diagnostic_with_position():
    report = assert_same_as_jax("videotestsrc ! ! tensor_sink")
    assert codes(report) == {"parse-error"}
    assert report.diagnostics[0].pos == 15
    assert "^" in report.render()


def test_all_problems_reported_in_one_run():
    report = assert_same_as_jax(
        "videotestsrc ! tensor_transform mode=typecast option=float32 ! "
        "tensor_sink "
        "appsrc ! tensor_transfrom ! fakesink "
        "ghost. ! tensor_sink name=x")
    assert {"caps-mismatch", "unknown-element",
            "dangling-pad-ref"} <= codes(report)
    assert len(report.errors) >= 3


def test_dtype_mismatch_names_the_field():
    desc = ("appsrc caps=other/tensors,dimensions=3:8:8:1,types=uint8 ! "
            "tensor_filter framework=custom-easy model=missing "
            "input=3:8:8:1 inputtype=float32 ! tensor_sink")
    report = assert_same_as_jax(desc)
    msg = next(d.message for d in report if d.code == "caps-mismatch")
    assert msg == next(d.message for d in jax_analyze(desc)
                       if d.code == "caps-mismatch")
    assert "uint8" in msg and "float32" in msg and "⊄" in msg


@pytest.mark.parametrize("desc", [
    "appsrc name=a ! tee name=t "
    "t. ! queue ! tensor_mux name=m ! tensor_sink "
    "t. ! queue ! tensor_transform mode=typecast option=float32 ! m.",
    "appsrc name=src ! tensor_mux name=m ! tee name=t "
    "t. ! tensor_sink name=out "
    "t. ! queue ! tensor_reposink slot-name=loop "
    "tensor_reposrc slot-name=loop "
    "caps=other/tensors,dimensions=4,types=float32 ! m.",
], ids=["queue-on-every-branch", "cycle-through-repo"])
def test_legal_shapes_stay_clean_of_hazards(desc):
    report = assert_same_as_jax(desc)
    assert not {"tee-deadlock", "cycle"} & codes(report)


def _shipped_files():
    ex = os.path.join(REPO, "examples")
    return sorted(os.path.join(ex, f) for f in os.listdir(ex)
                  if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("path", _shipped_files() + [
    os.path.join(REPO, "tests", "test_pipeline_e2e.py")],
    ids=os.path.basename)
def test_shipped_pipeline_strings_lint_clean(path):
    from nnstreamer_tpu_torch.tools.lint import _diag_key, extract_pipeline_strings

    # the deliberate bad strings of the e2e tests, accepted by the JAX
    # package's own lint baseline
    with open(os.path.join(REPO, "tools", "lint_baseline.txt")) as f:
        baseline = {ln.strip() for ln in f if ln.strip() and not ln.startswith("#")}
    strings, _ = extract_pipeline_strings(path)
    bad = [(desc, str(d)) for desc in strings for d in analyze(desc).errors
           if _diag_key(os.path.basename(path), d, desc) not in baseline]
    assert not bad, bad


def test_dogfood_own_device_fns_pass_the_host_sync_lint():
    import importlib

    from nnstreamer_tpu_torch.core.registry import _BUILTIN_MODULES

    diags = []
    for modname in _BUILTIN_MODULES:
        diags.extend(lint_module(importlib.import_module(modname)))
    assert [str(d) for d in diags] == []


# ---------------------------------------------------------------------------
# the host-sync lint: one seeded closure per construct
# ---------------------------------------------------------------------------

_COUNTER = 0


def _impure_numpy(ins):
    return [np.argmax(np.asarray(ins[0]))]


def _impure_item(ins):
    return [ins[0] * ins[0].sum().item()]


def _impure_cast(ins):
    x = ins[0]
    return [x * float(x.sum())]


def _impure_cpu(ins):
    return [ins[0].cpu() + 1]


def _impure_tolist(ins):
    return [torch.zeros(len(ins[0].tolist()))]


def _impure_branch(ins):
    x = ins[0]
    if x.sum() > 0:
        return [x]
    return [-x]


def _impure_multinomial(ins):
    return [torch.multinomial(torch.softmax(ins[0], -1), 1)]


def _impure_copy(ins):
    return [ins[0] + torch.tensor([1.0, 2.0]).cuda()]


def _impure_from_numpy(ins):
    return [ins[0] + torch.from_numpy(np.ones(4, np.float32))]


def _impure_np_rng(ins):
    return [ins[0] + torch.as_tensor(np.random.default_rng(0).random(4))]


def _impure_py_rng(ins):
    return [ins[0] * _random.random()]


def _impure_time(ins):
    return [ins[0] * _time.time()]


def _impure_global(ins):
    global _COUNTER
    _COUNTER += 1
    print("invoked", _COUNTER)
    return [ins[0]]


def _impure_sync(ins):
    torch.cuda.synchronize()
    return [ins[0]]


@pytest.mark.parametrize("fn,code,severity", [
    (_impure_numpy, "jit-host-call", "error"),
    (_impure_item, "jit-host-sync", "error"),
    (_impure_cast, "jit-host-sync", "warning"),
    (_impure_cpu, "jit-host-sync", "error"),
    (_impure_tolist, "jit-host-sync", "error"),
    (_impure_branch, "jit-host-branch", "warning"),
    (_impure_multinomial, "jit-multinomial", "error"),
    (_impure_copy, "jit-host-copy", "error"),
    (_impure_from_numpy, "jit-host-copy", "error"),
    (_impure_np_rng, "jit-rng", "error"),
    (_impure_py_rng, "jit-rng", "error"),
    (_impure_time, "jit-host-time", "warning"),
    (_impure_global, "jit-global-mutation", "error"),
    (_impure_global, "jit-print", "warning"),
    (_impure_sync, "jit-host-sync", "error"),
], ids=lambda v: v if isinstance(v, str) else getattr(v, "__name__", v))
def test_lint_callable_flags_each_forbidden_construct(fn, code, severity):
    diags = lint_callable(fn, fn.__name__)
    hit = [d for d in diags if d.code == code]
    assert hit, [str(d) for d in diags]
    assert hit[0].severity == severity


@pytest.mark.parametrize("fn,code", [
    (_impure_numpy, "jit-host-call"), (_impure_cast, "jit-host-sync"),
    (_impure_time, "jit-host-time"), (_impure_global, "jit-global-mutation"),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_shared_codes_agree_with_the_jax_lint(fn, code):
    from nnstreamer_tpu.analysis.purity import lint_callable as jax_lint

    port = {(d.code, d.severity) for d in lint_callable(fn, "x")}
    ref = {(d.code, d.severity) for d in jax_lint(fn, "x")}
    assert (code, next(s for c, s in ref if c == code)) in port


def test_impure_registered_filter_fn_flagged_in_pipeline():
    spec = dict(in_spec=TensorsSpec.from_string("4", "float32"),
                out_spec=TensorsSpec.from_string("4", "float32"))
    jspec = dict(in_spec=JSpec.from_string("4", "float32"),
                 out_spec=JSpec.from_string("4", "float32"))
    register_custom_easy("lint-impure", _impure_np_rng, jax_traceable=True, **spec)
    jax_register("lint-impure", _impure_np_rng, jax_traceable=True, **jspec)
    try:
        desc = ("appsrc caps=other/tensors,dimensions=4,types=float32 ! "
                "tensor_filter framework=custom-easy model=lint-impure ! "
                "tensor_sink")
        report = analyze(desc)
        assert "jit-rng" in codes(report)
        assert any("custom-easy:lint-impure" in d.path for d in report)
        ref = jax_analyze(desc)
        assert [(d.code, d.path, d.pos) for d in report if d.code == "jit-rng"] \
            == [(d.code, d.path, d.pos) for d in ref if d.code == "jit-rng"]
    finally:
        unregister_custom_easy("lint-impure")
        jax_unregister("lint-impure")


def test_pure_torch_callable_is_clean():
    def pure(arrays):
        x = torch.tanh(arrays[0])
        return [torch.where(x > 0, x, torch.zeros_like(x)).sum(-1)]

    assert lint_callable(pure, "pure") == []


def test_torch_aliased_to_np_is_not_flagged():
    import torch as np  # noqa: F811 - module identity decides

    def pure(arrays):
        return [np.sqrt(np.abs(arrays[0]))]

    assert lint_callable(pure, "pure") == []


# ---------------------------------------------------------------------------
# the validate hook, parser positions, caps helpers
# ---------------------------------------------------------------------------

def test_pipeline_validate_hook_raises_with_all_errors():
    desc = ("videotestsrc ! tensor_transform mode=typecast option=float32 "
            "! tensor_sink appsrc ! tensor_transfrom ! fakesink")
    with pytest.raises(PipelineLintError) as ei:
        ntt.Pipeline(desc, validate=True)
    assert len(ei.value.report.errors) >= 2
    assert "caps-mismatch" in ei.value.report.codes()


def test_pipeline_validate_hook_passes_clean():
    p = ntt.Pipeline(
        "videotestsrc num-buffers=1 width=8 height=8 ! tensor_converter "
        "! tensor_sink name=out", validate=True)
    with p:
        p.pull("out", timeout=10)
        p.wait(timeout=10)


def test_parse_positions_equal_jax():
    from nnstreamer_tpu.pipeline.parser import parse as jax_parse

    with pytest.raises(ParseError) as ei:
        parse("videotestsrc ! ! tensor_sink")
    assert ei.value.pos == 15 and "at char 15" in str(ei.value)
    desc = "videotestsrc ! tensor_converter ! tensor_sink"
    assert {n.kind: n.pos for n in parse(desc).nodes.values()} == \
        {n.kind: n.pos for n in jax_parse(desc).nodes.values()} == \
        {"videotestsrc": 0, "tensor_converter": 15, "tensor_sink": 34}


def test_intersect_template_alternatives():
    video = Caps.new(MediaType.VIDEO, format="RGB")
    tmpl = (Caps.new(MediaType.AUDIO), Caps.new(MediaType.VIDEO))
    assert intersect_template(video, tmpl) is not None
    assert intersect_template(video, Caps.new(MediaType.TENSORS)) is None


@pytest.mark.parametrize("a,b", [
    (("3:8:8:1", "uint8"), ("3:8:8:1", "float32")),
    (("3:8:8:1", "uint8"), ("3:16:16:1", "uint8")),
    (("4,4", "float32,float32"), ("4", "float32")),
])
def test_explain_mismatch_equals_jax(a, b):
    port = explain_mismatch(Caps.tensors(TensorsSpec.from_string(*a)),
                            Caps.tensors(TensorsSpec.from_string(*b)))
    ref = jcaps.explain_mismatch(jcaps.Caps.tensors(JSpec.from_string(*a)),
                                 jcaps.Caps.tensors(JSpec.from_string(*b)))
    assert port == ref
    assert explain_mismatch(Caps.new(MediaType.VIDEO), Caps.new(MediaType.TENSORS)) \
        == "media video/x-raw ⊄ other/tensors"
