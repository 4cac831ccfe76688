"""The port's deep pass (analysis/tracecheck.py: every device stage run on
meta tensors, its model built on meta) against the JAX package's
``jax.eval_shape`` pass: the same seeded bad fixtures give the same codes
with path and caret, the same knobs give the same resource report in
integer bytes where the layouts match, ``serving_plan`` gives the JAX
package's integers (but ``programs``, the port's own census), and pricing
llama2_7b int4 at full width allocates nothing."""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.analysis import analyze as jax_analyze
from nnstreamer_tpu.core.types import TensorsSpec as JSpec
from nnstreamer_tpu.filters.custom_easy import register_custom_easy as jax_register
from nnstreamer_tpu.models.zoo import ModelBundle as JBundle, register_model as jax_model
from nnstreamer_tpu_torch.analysis import PipelineLintError, analyze
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.models.zoo import ModelBundle, register_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(name, torch_fn, jax_fn, in_dims, out_dims, in_dtype="float32",
          out_types="float32", param_bytes=0):
    register_custom_easy(
        name, torch_fn, in_spec=TensorsSpec.from_string(in_dims, in_dtype),
        out_spec=TensorsSpec.from_string(out_dims, out_types),
        jax_traceable=True, param_bytes=param_bytes)
    jax_register(
        name, jax_fn, in_spec=JSpec.from_string(in_dims, in_dtype),
        out_spec=JSpec.from_string(out_dims, out_types),
        jax_traceable=True, param_bytes=param_bytes)


_W_NET = np.zeros((32 * 32 * 3, 1001), np.float32)
_W_VOCAB = np.zeros((256, 128), np.float32)


def _jnp():
    import jax.numpy as jnp

    return jnp


_W_NET_T = torch.from_numpy(_W_NET)
_W_VOCAB_T = torch.from_numpy(_W_VOCAB)

_both("deeptorch_mobilenet",
      lambda ins: [ins[0].float().reshape(1, -1) @ _W_NET_T.to(ins[0].device)],
      lambda ins: [_jnp().dot(ins[0].astype(_jnp().float32).reshape((1, -1)), _W_NET)],
      "3:32:32:1", "1001:1", param_bytes=_W_NET.nbytes)
_both("deeptorch_ssd",
      lambda ins: [torch.zeros((1, 100, 4), device=ins[0].device) + ins[0].mean(),
                   torch.zeros((1, 100), device=ins[0].device) + ins[0].mean()],
      lambda ins: [_jnp().zeros((1, 100, 4), _jnp().float32) + _jnp().mean(ins[0]),
                   _jnp().zeros((1, 100), _jnp().float32) + _jnp().mean(ins[0])],
      "3:32:32:1", "4:100:1,100:1", out_types="float32,float32")
_both("deeptorch_posenet",
      lambda ins: [torch.zeros((1, 9, 9, 17), device=ins[0].device) + ins[0].mean()],
      lambda ins: [_jnp().zeros((1, 9, 9, 17), _jnp().float32) + _jnp().mean(ins[0])],
      "3:32:32:1", "17:9:9:1")
_both("deeptorch_llama",
      lambda ins: [_W_VOCAB_T.to(ins[0].device)[ins[0].reshape(-1).long()]],
      lambda ins: [_jnp().asarray(_W_VOCAB)[ins[0].reshape((-1,))]],
      "1:1", "128:1", in_dtype="int32", param_bytes=_W_VOCAB.nbytes)

# seeded bad twins: the declared spec contradicts the traced output
_both("deeptorch_bad_shape", lambda ins: [ins[0].reshape(1, -1)],
      lambda ins: [ins[0].reshape((1, -1))], "3:32:32:1", "1001:1")
_both("deeptorch_bad_dtype", lambda ins: [ins[0] > 0], lambda ins: [ins[0] > 0],
      "3:32:32:1", "3:32:32:1")
_both("deeptorch_bad_arity", lambda ins: [ins[0], ins[0]],
      lambda ins: [ins[0], ins[0]], "3:32:32:1", "3:32:32:1")
_both("deeptorch_bad_promote", lambda ins: [ins[0] + 0.5],
      lambda ins: [ins[0] + 0.5], "4:4", "4:4", in_dtype="int32",
      out_types="int32")
_both("deeptorch_bad_rank", lambda ins: [ins[0].mean(dim=(1, 2))],
      lambda ins: [_jnp().mean(ins[0], axis=(1, 2))], "3:32:32:1", "3:32:32:1")
_both("deeptorch_bad_datadep", lambda ins: [torch.nonzero(ins[0])[:, 0]],
      lambda ins: [_jnp().nonzero(ins[0])[0]], "4:4", "16")
_both("deeptorch_bad_hostsync", lambda ins: [ins[0] * float(ins[0].sum())],
      lambda ins: [ins[0] * float(ins[0].sum())], "4:4", "4:4")


def _zoo(name, cols):
    @register_model(name)
    def _port(opts, device):
        w = torch.zeros((32 * 32 * 3, cols), device=device)
        return ModelBundle(
            apply_fn=lambda p, x: x.float().reshape(1, -1) @ p["w"],
            params={"w": w}, in_spec=TensorsSpec.from_string("3:32:32:1", "float32"),
            out_spec=TensorsSpec.from_string("1001:1", "float32"), name=name)

    @jax_model(name)
    def _ref(opts):
        return JBundle(
            apply_fn=lambda p, x: _jnp().dot(
                x.astype(_jnp().float32).reshape((1, -1)), p["w"]),
            params={"w": np.zeros((32 * 32 * 3, cols), np.float32)},
            in_spec=JSpec.from_string("3:32:32:1", "float32"),
            out_spec=JSpec.from_string("1001:1", "float32"), name=name)


_zoo("deeptorch_zoo_net", 1001)
_zoo("deeptorch_zoo_badnet", 1000)  # 1000 != the declared 1001


def _pipe(model, dims="3:32:32:1", dtype="float32", fw="custom-easy", extra=""):
    return (f"appsrc caps=other/tensors,dimensions={dims},types={dtype} ! "
            f"tensor_filter framework={fw} model={model}{extra} ! tensor_sink")


def codes(report):
    return set(report.codes())


def _stage_ints(res):
    return [(s.param_bytes, s.act_row_bytes, s.rows_per_device, s.pool_bytes,
             s.ring_bytes, s.train_bytes, s.prng_bytes) for s in res.stages]


BAD_DEEP = [
    (_pipe("deeptorch_bad_shape"), "trace-shape-mismatch"),
    (_pipe("deeptorch_bad_dtype"), "trace-shape-mismatch"),
    (_pipe("deeptorch_bad_arity"), "trace-shape-mismatch"),
    (_pipe("deeptorch_bad_promote", dims="4:4", dtype="int32"),
     "trace-shape-mismatch"),
    (_pipe("deeptorch_bad_rank"), "trace-shape-mismatch"),
    (_pipe("deeptorch_bad_datadep", dims="4:4"), "trace-error"),
    (_pipe("deeptorch_bad_hostsync", dims="4:4"), "trace-error"),
    (_pipe("deeptorch_zoo_badnet", fw="jax"), "trace-shape-mismatch"),
    (_pipe("deeptorch_ssd", extra=" output=4:100:1,10:1 "
           "outputtype=float32,float32"), "trace-shape-mismatch"),
    (_pipe("deeptorch_posenet", extra=" output=17:17:9:1"),
     "trace-shape-mismatch"),
    (_pipe("deeptorch_llama", dims="1:1", dtype="int32", extra=" output=64:1"),
     "trace-shape-mismatch"),
]


@pytest.mark.parametrize("desc,code", BAD_DEEP,
                         ids=[f"{c}-{i}" for i, (_, c) in enumerate(BAD_DEEP)])
def test_seeded_fixture_caught_as_jax(desc, code):
    report = analyze(desc, deep=True)
    ref = jax_analyze(desc, deep=True)
    assert code in codes(report) and code in codes(ref), report.render()
    got = [(d.code, d.severity, d.path, d.pos) for d in report if d.code == code]
    want = [(d.code, d.severity, d.path, d.pos) for d in ref if d.code == code]
    assert got == want
    assert "^" in report.render()


@pytest.mark.parametrize("model,dims,dtype", [
    ("deeptorch_mobilenet", "3:32:32:1", "float32"),
    ("deeptorch_ssd", "3:32:32:1", "float32"),
    ("deeptorch_posenet", "3:32:32:1", "float32"),
    ("deeptorch_llama", "1:1", "int32"),
])
def test_good_families_trace_clean_with_jax_bytes(model, dims, dtype):
    desc = _pipe(model, dims=dims, dtype=dtype)
    report = analyze(desc, deep=True)
    assert report.ok, report.render()
    ref = jax_analyze(desc, deep=True).resources
    assert _stage_ints(report.resources) == _stage_ints(ref)
    assert report.resources.by_category() == ref.by_category()


def test_zoo_device_framework_traces_with_meta_params():
    desc = _pipe("deeptorch_zoo_net", fw="jax")
    report = analyze(desc, deep=True)
    assert report.ok, report.render()
    st = report.resources.stages[0]
    assert st.param_bytes == 32 * 32 * 3 * 1001 * 4
    assert st.param_bytes == jax_analyze(desc, deep=True).resources.stages[0].param_bytes


def test_shallow_analyze_has_no_resources_and_misses_trace_bugs():
    report = analyze(_pipe("deeptorch_bad_shape"))
    assert report.resources is None
    assert "trace-shape-mismatch" not in codes(report)


@pytest.mark.parametrize("kw", [
    dict(batch_max=8, dispatch_depth=2),
    dict(batch_max=8, batch_buckets=[8, 2, 4]),
    dict(batch_max=500),
    dict(batch_max=9, batch_buckets=[2, 4]),
    dict(batch_max=8, adaptive_buckets=True, max_compiled_variants=10),
], ids=["ladder", "unsorted", "rounded", "custom", "adaptive"])
def test_resource_report_equals_jax(kw):
    desc = _pipe("deeptorch_mobilenet")
    res = analyze(desc, deep=True, **kw).resources
    ref = jax_analyze(desc, deep=True, data_parallel=1, **kw).resources
    assert res.ladder == ref.ladder
    assert _stage_ints(res) == _stage_ints(ref)
    assert [s.variants for s in res.stages] == [s.variants for s in ref.stages]
    assert res.hbm_estimate == ref.hbm_estimate


def test_resource_report_multiplies_bucket_ladder():
    res = analyze(_pipe("deeptorch_mobilenet"), deep=True, batch_max=8,
                  dispatch_depth=2).resources
    assert res.ladder == (1, 2, 4, 8)
    st = res.stages[0]
    assert st.batchable and not st.sharded and st.variants == 4
    assert st.rows_per_device == 16
    assert st.act_row_bytes == 32 * 32 * 3 * 4 + 1001 * 4
    assert res.hbm_estimate == st.param_bytes + st.act_row_bytes * 16


def test_lone_filter_is_eager_without_batching():
    """A lone filter outside the batching path runs its invoke eagerly in
    the port: nothing is captured (the JAX package counts one program)."""
    desc = _pipe("deeptorch_mobilenet")
    assert analyze(desc, deep=True).resources.stages[0].variants == 0
    assert jax_analyze(desc, deep=True).resources.stages[0].variants == 1


@pytest.mark.parametrize("kw", [dict(data_parallel=4), dict(model_parallel=2)])
def test_multi_device_plans_raise_named_error(kw, monkeypatch):
    """The mesh is priced: on one slot (the default) these plans
    over-ask and the lint says so in the JAX package's words.  A
    tensor_trainer trains on its own mesh= (a pipeline model axis does
    not place it): it is priced whole under the plan, and its mesh=
    asking for more slots than there are is named."""
    monkeypatch.delenv("NNS_TPU_DEVICE_SLOTS", raising=False)
    report = analyze(_pipe("deeptorch_mobilenet"), deep=True, batch_max=8, **kw)
    diag = next(d for d in report if d.code == "data-parallel-devices")
    n = kw.get("data_parallel", kw.get("model_parallel"))
    assert f"needs {n} local devices, have 1" in diag.message
    trainer = ("appsrc name=src ! tensor_trainer framework=jax "
               "model=mlp:4:8:3 {mesh}! tensor_sink name=out")
    report = analyze(trainer.format(mesh=""), deep=True, **kw)
    [stage] = [s for s in report.resources.stages if "tensor_trainer" in s.label]
    assert stage.param_bytes == 4 * (4 * 8 + 8 + 8 * 3 + 3)
    report = analyze(trainer.format(mesh="mesh=data:2 "), deep=True)
    diag = next(d for d in report if d.code == "mesh-devices")
    assert "mesh 'data:2' needs 2 devices, have 1" in diag.message


def test_budget_warnings_anchor_dominant_stage():
    report = analyze(_pipe("deeptorch_mobilenet"), deep=True, batch_max=64,
                     hbm_budget_bytes=1 << 20)
    diag = next(d for d in report if d.code == "hbm-budget")
    assert diag.severity == "warning" and diag.path and diag.pos is not None
    assert "MiB" in diag.message
    report = analyze(_pipe("deeptorch_mobilenet"), deep=True, batch_max=256,
                     max_compiled_variants=3)
    assert next(d for d in report if d.code == "recompile-budget").severity == "warning"
    quiet = analyze(_pipe("deeptorch_mobilenet"), deep=True, batch_max=256)
    assert not {"hbm-budget", "recompile-budget"} & codes(quiet)


def test_invoke_dynamic_flagged_recompile_unbounded():
    desc = _pipe("deeptorch_mobilenet", extra=" invoke-dynamic=true")
    report = analyze(desc, deep=True)
    diag = next(d for d in report if d.code == "recompile-unbounded")
    ref = next(d for d in jax_analyze(desc, deep=True) if d.code == "recompile-unbounded")
    assert (diag.severity, diag.path, diag.pos) == (ref.severity, ref.path, ref.pos)


def test_example_pipeline_gets_resource_report():
    desc = ("videotestsrc num-buffers=8 width=224 height=224 device=true ! "
            "tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:127.5,add:-1.0 ! "
            "tensor_filter framework=jax model=mobilenet_v1 "
            "custom=dtype:float32 ! tensor_sink name=out")
    report = analyze(desc, deep=True, batch_max=4)
    assert report.ok, report.render()
    res = report.resources
    assert res.hbm_estimate > 0 and res.compiled_variants >= 1
    assert "deep resource report" in res.render()
    ref = jax_analyze(desc, deep=True, batch_max=4, data_parallel=1).resources
    assert res.by_category() == ref.by_category()


def test_fused_chain_merges_into_one_stage():
    desc = ("appsrc caps=other/tensors,dimensions=3:32:32:1,types=float32 ! "
            "tensor_transform mode=arithmetic option=div:2.0 ! "
            "tensor_filter framework=custom-easy model=deeptorch_mobilenet ! "
            "tensor_sink")
    report = analyze(desc, deep=True, batch_max=4)
    assert report.ok, report.render()
    (st,) = report.resources.stages
    assert "+" in st.label and st.variants == 3
    ref = jax_analyze(desc, deep=True, batch_max=4, data_parallel=1).resources
    assert _stage_ints(report.resources) == _stage_ints(ref)


#: storage off the meta device the deep pass may make (a model's computed
#: constants, yolov5s' 25200-row anchor grid the largest, go through the
#: host on their way to meta); a model's parameters never do
NO_STORAGE_LIMIT = 32 << 20


class _NoStorage(TorchDispatchMode):
    """Adds up the bytes of every tensor a torch op makes off the meta
    device inside the block; leaving it fails past ``NO_STORAGE_LIMIT``:
    what 'no allocation' means for the deep pass."""

    def __init__(self):
        super().__init__()
        self.made = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.made += t.numel() * t.element_size()
        return out

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None:
            assert self.made <= NO_STORAGE_LIMIT, f"{self.made} bytes off meta"


def test_deep_pass_allocates_no_model_storage():
    with _NoStorage():
        good = analyze(_pipe("deeptorch_zoo_net", fw="jax"), deep=True,
                       batch_max=8, hbm_budget_bytes=1)
        bad = analyze(_pipe("deeptorch_bad_shape"), deep=True)
    assert "analyzer-error" not in codes(good), good.render()
    assert "hbm-budget" in codes(good)
    assert "trace-shape-mismatch" in codes(bad)


LLAMA_7B = ("appsrc name=src ! tensor_filter name=llm framework=llm model=llama2_7b "
            "custom=quant:int4,param_dtype:bfloat16,max_seq:1024,serve:continuous,"
            "slots:8,block_size:16,prefill_chunk:32 invoke-dynamic=true ! "
            "tensor_sink name=out")


def test_llama2_7b_int4_priced_at_full_width_in_both_packages_without_storage():
    with _NoStorage():
        report = analyze(LLAMA_7B, deep=True)
    assert report.ok, report.render()
    ref = jax_analyze(LLAMA_7B, deep=True)
    assert ref.ok, ref.render()
    res, rres = report.resources, ref.resources
    assert _stage_ints(res) == _stage_ints(rres)
    assert res.by_category() == rres.by_category()
    (st,) = res.stages
    assert st.param_bytes == 3572315136  # int4 mats + f32 scales, bf16 embed
    assert st.decode_bytes_per_ctx_token == rres.stages[0].decode_bytes_per_ctx_token
    # the port's census: the loop's one captured decode step (JAX: 3)
    assert st.variants == 1 and rres.stages[0].variants == 3


def test_llama2_7b_filter_opens_on_meta_under_abstract_build():
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.filters.base import abstract_build

    el = TensorFilter({"framework": "llm", "model": "llama2_7b",
                       "custom": "quant:int4,param_dtype:bfloat16"})
    with _NoStorage(), abstract_build():
        el.configure({}, ["src"])
    assert el.fw.device.type == "meta"
    assert el.param_bytes() == 3572315136


@pytest.mark.parametrize("kw", [
    dict(slots=8, block_size=16, prefill_chunk=32),
    dict(slots=4, block_size=8, kv_blocks=40, prefill_chunk=16, temperature=0.7),
    dict(slots=3, block_size=16, draft="llama_tiny", spec_k=3),
    dict(slots=2, block_size=4, kv_blocks=10_000, dtype="float32"),
], ids=["7b-cell", "sampled", "draft", "clamped"])
def test_serving_plan_equals_jax_but_programs(kw):
    from nnstreamer_tpu.filters.llm import serving_plan as jax_plan
    from nnstreamer_tpu.models import llama as jl
    from nnstreamer_tpu_torch.filters.llm import (
        SERVE_PROGRAMS, SPEC_SERVE_PROGRAMS, serving_plan)
    from nnstreamer_tpu_torch.models import llama as tl

    kw = dict(kw)
    draft = kw.pop("draft", None)
    model = "llama_tiny" if draft else "llama2_7b"
    opts = {"max_seq": "1024"}
    port = serving_plan(tl.resolve_config(model, opts),
                        draft_cfg=tl.resolve_config(draft, {}) if draft else None, **kw)
    ref = jax_plan(jl.resolve_config(model, opts),
                   draft_cfg=jl.resolve_config(draft, {}) if draft else None, **kw)
    assert set(port) == set(ref)
    assert {k: v for k, v in port.items() if k != "programs"} == \
        {k: v for k, v in ref.items() if k != "programs"}
    # programs: the port captures the decode step (or propose + verify);
    # the JAX package also counts its prefill step and token setter
    assert port["programs"] == (SPEC_SERVE_PROGRAMS if draft else SERVE_PROGRAMS)
    assert ref["programs"] == port["programs"] + 2 + (1 if draft else 0)


def test_aggregator_ring_priced_as_the_port_allocates_it():
    desc = ("appsrc caps=other/tensors,dimensions=8,types=float32 ! "
            "tensor_aggregator frames_in=1 frames_out=4 frames_dim=0 "
            "device=true ! tensor_sink")
    (st,) = analyze(desc, deep=True).resources.stages
    (ref,) = jax_analyze(desc, deep=True).resources.stages
    # two slots of need + step frames (the JAX ring is one slot)
    assert st.ring_bytes == 2 * ref.ring_bytes == 2 * (4 + 1) * 8 * 4
    assert st.act_row_bytes == ref.act_row_bytes and st.variants == 0


@pytest.mark.parametrize("props", [
    dict(model="mlp:4:16:3", optimizer="adam", batch_size=8),
    dict(model="mlp:6:5", optimizer="momentum", batch_size=4, loss="mse"),
    dict(model="mlp:4:8:8:2", optimizer="sgd", batch_size=2),
])
def test_train_plan_equals_jax_param_and_window_bytes(props):
    from nnstreamer_tpu.trainer.subplugin import train_plan as jax_train_plan
    from nnstreamer_tpu_torch.trainer.subplugin import train_plan

    port, ref = train_plan(props), jax_train_plan(props)
    for k in ("param_bytes", "grad_bytes", "window_bytes", "batch_size"):
        assert port[k] == ref[k], k
    # torch.optim's state: Adam's two moments and a step count per leaf
    slots = {"adam": 2, "momentum": 1, "sgd": 0}[props["optimizer"]]
    leaves = 2 * (len(props["model"].split(":")) - 2)
    assert port["opt_bytes"] == slots * port["param_bytes"] + (
        4 * leaves if slots == 2 else 0)


def test_zoo_dogfood_families_trace_clean_on_meta():
    from nnstreamer_tpu_torch.analysis.tracecheck import trace_zoo_models

    with _NoStorage():
        diags, traced, skipped = trace_zoo_models()
    assert skipped == 0 and traced == 14
    assert [str(d) for d in diags] == []


def test_pipeline_validate_deep():
    with pytest.raises(PipelineLintError) as ei:
        ntt.Pipeline(_pipe("deeptorch_bad_shape"), validate="deep")
    assert "trace-shape-mismatch" in ei.value.report.codes()
    ntt.Pipeline(_pipe("deeptorch_bad_shape"), validate=True)  # stays shallow
    p = ntt.Pipeline(
        "appsrc name=src caps=other/tensors,dimensions=4:4,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:4:4 "
        "accelerator=true:cpu ! tensor_sink name=out", validate="deep")
    with p:
        p.push("src", [np.ones((4, 4), np.float32)])
        p.eos()
        buf = p.pull("out", timeout=10)
        p.wait(timeout=10)
    np.testing.assert_allclose(np.asarray(buf.tensors[0]),
                               np.full((4, 4), 2.0, np.float32))


def test_bucket_ladder_equals_jax():
    from nnstreamer_tpu.pipeline.batching import ladder as jax_ladder
    from nnstreamer_tpu_torch.pipeline.batching import ladder

    for args in ((1,), (8,), (6,), (3, [2, 4]), (500,), (9, [2, 4])):
        assert ladder(*args) == jax_ladder(*args)
