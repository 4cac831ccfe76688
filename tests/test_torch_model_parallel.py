"""2-D (data x model) placement in the port against the JAX package's
(``tests/test_model_parallel.py``), on the CPU.

``Pipeline(model_parallel=M, data_parallel=N)`` builds one ``(data=N,
model=M)`` mesh (here over eight slots of the CPU,
``NNS_TPU_DEVICE_SLOTS=8``).  A shardable stage checks its
``param_pspecs`` under a model axis, keeps its params whole on every
device (its forward is not written to compute on a cut, unlike the JAX
package's GSPMD program) and splits its batch over all the slots; the llm filter runs tensor-parallel on the model axis (weights by
heads and FFN columns, the KV cache and pool by kv head, the partials of
the o and down projections summed in slot order on the root slot).

Tolerances: mesh validation messages, mesh plans and lint messages equal
the JAX package's; rows of the sharded runner are bitwise the one-slot
runner's; tensor-parallel logits at float32 are within ``F32_TOL`` of the
JAX package's tensor-parallel program (GSPMD) and of the unsharded port
(the partial sums add in another order); greedy ids at float32 on
llama_tiny equal the JAX TP path's wherever the JAX top-1/top-2 gap is
wider than ``TIE`` (the ROADMAP's near-tie rule).  The JAX continuous
loop is timing-dependent on the CPU (ROADMAP Queue C), so the paged TP
loop is held step by step, teacher-forced, against the JAX paged model,
with its asynchronous dispatch off."""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.analysis import analyze as jax_analyze
from nnstreamer_tpu.core.types import TensorsSpec as JSpec
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.models.zoo import ModelBundle as JBundle
from nnstreamer_tpu.models.zoo import register_model as jregister_model
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.sharding import shard_params as jshard_params
from nnstreamer_tpu.pipeline import batching as jb
from nnstreamer_tpu.pipeline.plan import mesh_plan as jmesh_plan
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters.base import FrameworkError
from nnstreamer_tpu_torch.filters.llm import LLMFramework
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.models.zoo import ModelBundle, register_model
from nnstreamer_tpu_torch.parallel.mesh import (device_coords, local_devices,
                                                make_mesh, mesh_axis_size)
from nnstreamer_tpu_torch.parallel.sharding import P
from nnstreamer_tpu_torch.pipeline.batching import BatchRunner
from nnstreamer_tpu_torch.pipeline.plan import mesh_plan, replication_plan
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError

torch.set_num_threads(2)

#: float32 logits, two orders of the same sums
F32_TOL = 1e-4
#: near-tie gap of a float32 greedy step (test_torch_continuous.py's)
TIE = 1e-4
#: tanh in float32, torch against XLA
ROW_TOL = 1e-6


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """The JAX loop is timing-dependent with asynchronous dispatch on the
    CPU (ROADMAP Queue C); the JAX references here run it off."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _mesh(data=1, model=1):
    return make_mesh(data=data, model=model,
                     devices=local_devices("cpu")[:data * model])


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# -- a tiny zoo model with real model-axis pspecs, in both packages ------------

_D, _H = 16, 8
_rng = np.random.default_rng(11)
_W1 = (_rng.standard_normal((_D, _H)) / np.sqrt(_D)).astype(np.float32)
_W2 = (_rng.standard_normal((_H, _D)) / np.sqrt(_H)).astype(np.float32)
MLP = "torch-tp-test-mlp"


@register_model(MLP)
def _build_mlp(opts, device):
    params = {"w1": torch.from_numpy(_W1).to(device),
              "w2": torch.from_numpy(_W2).to(device)}

    def apply_fn(p, x):
        return torch.tanh(x @ p["w1"]) @ p["w2"]

    spec = TensorsSpec.from_string(str(_D), "float32")
    return ModelBundle(apply_fn, params, spec, spec,
                       param_pspecs={"w1": P(None, "model"), "w2": P("model", None)})


@jregister_model(MLP)
def _jbuild_mlp(opts):
    from jax.sharding import PartitionSpec as JP

    params = {"w1": jnp.asarray(_W1), "w2": jnp.asarray(_W2)}
    spec = JSpec.from_string(str(_D), "float32")
    return JBundle(lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"], params, spec, spec,
                   param_pspecs={"w1": JP(None, "model"), "w2": JP("model", None)})


DESC = (f"appsrc name=src caps=other/tensors,dimensions={_D},types=float32 ! "
        f"tensor_filter framework=jax model={MLP} name=f {{acc}}! "
        "tensor_sink name=out")


def _desc(pkg, desc=DESC):
    return desc.format(acc="accelerator=true:cpu " if pkg is ntt else "")


def _frames(n, dims=(_D,)):
    return [np.full(dims, float(i % 9) * 0.25, np.float32) for i in range(n)]


def _run(pkg, frames, desc=DESC, timeout=60, **kw):
    p = pkg.Pipeline(_desc(pkg, desc), **kw)
    outs = []
    with p:
        for i, x in enumerate(frames):
            p.push("src", pkg.Buffer([x], pts=i))
        for _ in frames:
            outs.append(p.pull("out", timeout=timeout))
        p.eos()
        p.wait(timeout=timeout)
    return outs


def _assert_rows_bitwise(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.pts == b.pts
        for x, y in zip(a.tensors, b.tensors):
            assert bytes(np.asarray(x)) == bytes(np.asarray(y)), f"row {i}"


# -- make_mesh validation: the JAX package's messages ---------------------------

def test_make_mesh_names_non_divisible_axis():
    msg = _err(lambda: make_mesh(model=3))
    assert msg == _err(lambda: jmake_mesh(model=3))
    assert "'model'" in msg and "3" in msg and "8" in msg


def test_make_mesh_rejects_zero_and_negative_axes():
    for kw in (dict(model=0), dict(seq=-2)):
        assert _err(lambda: make_mesh(**kw)) == _err(lambda: jmake_mesh(**kw))
    assert "'model' must be >= 1" in _err(lambda: make_mesh(model=0))


def test_make_mesh_explicit_plan_mismatch_names_axis():
    msg = _err(lambda: make_mesh(data=2, model=3))
    assert msg == _err(lambda: jmake_mesh(data=2, model=3))
    assert "'model'" in msg and "needs 6" in msg


def test_make_mesh_data_none_still_auto_absorbs():
    assert mesh_axis_size(make_mesh(data=None, model=2), "data") == 4


def test_make_mesh_degenerate_1x1():
    m = make_mesh(data=1, model=1, devices=[local_devices("cpu")[0]])
    assert mesh_axis_size(m, "data") == mesh_axis_size(m, "model") == 1


@pytest.mark.parametrize("model", [2, 4, 8])
def test_make_mesh_model_only_and_auto_absorb(model):
    m = make_mesh(model=model)
    assert mesh_axis_size(m, "model") == model
    assert mesh_axis_size(m, "data") == 8 // model
    assert [len(m.model_group(d)) for d in range(8 // model)] == [model] * (8 // model)


def test_device_coords_covers_the_grid():
    coords = device_coords(_mesh(data=2, model=2))
    assert sorted(coords.values()) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_mesh_plan_semantics():
    assert mesh_plan(0, 1, 8, 8) == (replication_plan(0, 8, 8), 1)
    assert mesh_plan(0, 2, 8, 8) == (4, 2)
    assert mesh_plan(4, 0, 8, 8) == (4, 2)
    for dp in (0, 1, 2, 4, 8, 16):
        for mp in (0, 1, 2, 4, 8):
            for bmax in (1, 8):
                for n in (1, 2, 8):
                    assert mesh_plan(dp, mp, bmax, n) == jmesh_plan(dp, mp, bmax, n)


# -- 2-D sharded dispatch -------------------------------------------------------

@pytest.mark.parametrize("data,model", [(2, 2), (4, 2), (2, 4)])
def test_2d_runner_rows_bit_identical_every_occupancy(rng, data, model):
    fn = lambda arrays: (torch.tanh(arrays[0] * 1.5 + 0.25),)  # noqa: E731
    jfn = lambda arrays: (jnp.tanh(arrays[0] * 1.5 + 0.25),)  # noqa: E731
    single = BatchRunner(fn)
    sharded = BatchRunner(fn, mesh=_mesh(data=data, model=model))
    jsharded = jb.BatchRunner(jfn, mesh=jmake_mesh(
        data=data, model=model, devices=jax.devices()[:data * model]))
    assert sharded.replicas == data and sharded.model_axis == model
    for n in range(1, 10):
        rows = [(rng.standard_normal((24,)).astype(np.float32),) for _ in range(n)]
        for (x,), (y,), (z,) in zip(single.run(list(rows)), sharded.run(list(rows)),
                                    jsharded.run(list(rows))):
            assert x.numpy().tobytes() == y.numpy().tobytes(), f"n={n}"
            np.testing.assert_allclose(y.numpy(), np.asarray(z), rtol=0, atol=ROW_TOL)


def test_model_only_mesh_engages_sharded_path():
    br = BatchRunner(lambda arrays: (arrays[0] * 2.0,), mesh=_mesh(data=1, model=2))
    assert br.mesh is not None and br.replicas == 1 and br.model_axis == 2
    rows = [(np.full((8,), float(i), np.float32),) for i in range(3)]
    plain = BatchRunner(lambda arrays: (arrays[0] * 2.0,))
    for (x,), (y,) in zip(plain.run(list(rows)), br.run(list(rows))):
        assert x.numpy().tobytes() == y.numpy().tobytes()


@pytest.mark.parametrize("data,model", [(2, 2), (2, 4), (4, 2)])
def test_pipeline_2d_bit_identical_vs_dp_only_every_occupancy(data, model):
    """The MLP on a (data x model) mesh, its rows split over every slot:
    every backlog occupancy byte-equal to the one-slot run, as the JAX
    test holds it (each slot's step runs at the one-slot bucket's row
    count, so the CPU's float32 GEMM, which picks its kernel by the row
    count, computes each row as the one-slot step does), and within
    ROW_TOL of the JAX package's 2-D run."""
    for n in (1, 3, 8, 13):
        frames = _frames(n)
        sharded = _run(ntt, frames, queue_capacity=16, batch_max=8,
                       data_parallel=data, model_parallel=model)
        one = _run(ntt, frames, queue_capacity=16, batch_max=8, data_parallel=1,
                   model_parallel=1)
        assert [a.pts for a in sharded] == [b.pts for b in one]
        for a, b in zip(sharded, one):
            assert np.asarray(a.tensors[0]).tobytes() == \
                np.asarray(b.tensors[0]).tobytes(), f"n={n}"
        want = _run(nt, frames, queue_capacity=16, batch_max=8,
                    data_parallel=data, model_parallel=model)
        for a, b in zip(sharded, want):
            np.testing.assert_allclose(np.asarray(a.tensors[0]),
                                       np.asarray(b.tensors[0]), rtol=0, atol=ROW_TOL)


def test_placement_counters_prove_model_axis_shards():
    """The JAX test of this name counts w1 and w2 as cut (GSPMD computes
    on the cut).  The port's counters say what the port places: under a
    model axis both leaves are whole on every device (``param_shards``
    0, ``param_replicas`` 2), and the shard-rows counters still name
    every slot by its (data, model) coordinate."""
    metrics.reset()
    _run(ntt, _frames(32), queue_capacity=64, batch_max=8,
         data_parallel=2, model_parallel=2)
    snap = metrics.snapshot()
    assert snap.get("f.param_replications") == 1.0
    assert snap.get("f.param_shards") == 0.0
    assert snap.get("f.param_replicas") == 2.0
    rows = {k: v for k, v in snap.items() if k.startswith("f.shard_rows.")}
    if not rows:
        pytest.skip("backlog never coalesced (single-buffer dispatches)")
    assert set(rows) == {f"f.shard_rows.d{d}m{m}" for d in range(2) for m in range(2)}
    assert all(v > 0 for v in rows.values())


def test_model_axis_keeps_generic_params_whole():
    """Under a model axis each device holds one whole copy of w1 and w2
    (slots on one device share it), and nothing is copied per dispatch;
    the pspecs are checked as the JAX placement checks them."""
    from nnstreamer_tpu_torch.parallel.sharding import check_pspecs, slot_tree

    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=2, model_parallel=2)
    with p:
        fw = p.element("f").fw
        assert fw.place_params(p.mesh) == (0, 2)
        w1 = fw._placed["w1"]
        assert [tuple(t.shape) for t in w1.shards] == [(_D, _H)] * 4
        assert len({t.data_ptr() for t in w1.shards}) == 1
        tree = slot_tree(fw._placed, p.mesh.flat[3])
        assert tree["w1"].numpy().tobytes() == _W1.tobytes()
        odd = {"w": torch.ones((_D, 5))}
        with pytest.raises(ValueError, match="does not divide"):
            check_pspecs(p.mesh, odd, {"w": P(None, "model")})
        with pytest.raises(ValueError, match="lacks"):
            check_pspecs(p.mesh, odd, {"w": P("tensor", None)})
        assert check_pspecs(p.mesh, odd, None) == 1
        p.eos()
        p.wait(timeout=30)


def test_deep_lint_prices_what_the_runtime_places():
    """The deep lint's per-slot param bytes of a shardable stage under a
    (data x model) plan equal the bytes the runtime holds for one slot
    (each of its leaves' piece), model axis or not."""
    for data, model in ((2, 1), (2, 2), (1, 4)):
        r = ntt.analyze(_desc(ntt), deep=True, batch_max=8, data_parallel=data,
                        model_parallel=model)
        [st] = [s for s in r.resources.stages if s.sharded]
        p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=data,
                         model_parallel=model)
        with p:
            fw = p.element("f").fw
            fw.place_params(p.mesh)
            for slot in p.mesh.flat:
                held = sum(x.for_slot(slot).nbytes for x in fw._placed.values())
                assert st.param_bytes == held == _W1.nbytes + _W2.nbytes
            p.eos()
            p.wait(timeout=30)


def test_dp_only_keeps_legacy_counter_names():
    metrics.reset()
    _run(ntt, _frames(24), queue_capacity=64, batch_max=8, data_parallel=4,
         model_parallel=1)
    snap = metrics.snapshot()
    assert "f.param_shards" not in snap
    rows = {k for k in snap if k.startswith("f.shard_rows.")}
    assert all("m" not in k.rsplit(".", 1)[1] for k in rows), rows


def test_mesh_shape_exposed_and_lazy():
    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=2, model_parallel=2)
    assert p.mesh is None
    with p:
        assert p.mesh_shape == (2, 2)
        assert p.mesh is not None
        p.eos()
        p.wait(timeout=60)


def test_2d_over_ask_fails_start_cleanly():
    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=4, model_parallel=4)
    with pytest.raises(PipelineError, match="model_parallel") as e:
        p.start()
    assert str(e.value) == ("data_parallel=4 x model_parallel=4 needs 16 local "
                            "devices, have 8")
    assert not any(r.thread.is_alive() for r in p._unique_runners())


def test_auto_data_axis_takes_one_devices_slots():
    """``data_parallel=0`` absorbs the slots of one device only: on eight
    slots of one device it takes them all (the JAX package's plan), over
    slots on distinct devices it takes the first device's; a knob that
    asks for more spans them."""
    assert mesh_plan(0, 1, 8, 8, absorb=8) == jmesh_plan(0, 1, 8, 8) == (8, 1)
    assert mesh_plan(0, 1, 8, 8, absorb=1) == (1, 1)
    assert mesh_plan(0, 1, 8, 8, absorb=2) == (2, 1)
    assert mesh_plan(0, 0, 8, 8, absorb=2) == (2, 1)
    assert mesh_plan(0, 2, 8, 8, absorb=1) == (1, 2)
    assert mesh_plan(4, 1, 8, 8, absorb=1) == (4, 1)
    assert mesh_plan(0, 0, 1, 8, absorb=1) == jmesh_plan(0, 0, 1, 8) == (1, 8)
    from nnstreamer_tpu_torch.parallel.mesh import Slot, one_device_slots

    mixed = [Slot(0, torch.device("cpu")), Slot(1, torch.device("cpu")),
             Slot(2, torch.device("meta")), Slot(3, torch.device("meta"))]
    assert one_device_slots(mixed) == 2
    assert one_device_slots(local_devices("cpu")) == 8


def test_slot_forward_binds_its_tables_on_the_slots_device():
    """A slot on another device than the bundle's gets the forward with
    the tensors its partial binds (ssd's anchors) copied to that device;
    the bundle keeps its own."""
    from nnstreamer_tpu_torch.filters.device_fw import _bound_on

    b = tzoo.build("ssd_mobilenet", {"size": "64", "classes": "3", "width": "0.25"},
                   device=torch.device("cpu"))
    meta = _bound_on(b.apply_fn, torch.device("meta"))
    assert meta.keywords["anchors"].device.type == "meta"
    assert b.apply_fn.keywords["anchors"].device.type == "cpu"
    assert meta.func is b.apply_fn.func and meta.keywords["classes"] == 3
    tables = (torch.ones(2), [torch.zeros(1)], {"a": torch.ones(1)})
    got = _bound_on(functools.partial(max, tables=tables), torch.device("meta"))
    t, lst, d = got.keywords["tables"]
    assert t.is_meta and lst[0].is_meta and d["a"].is_meta

    def plain(p, x):
        return x

    assert _bound_on(plain, torch.device("meta")) is plain


# -- llama tensor parallelism against the JAX package's -------------------------

def _cfg(kv):
    return dataclasses.replace(jl.PRESETS["llama_tiny"], n_kv_heads=kv)


@functools.lru_cache(maxsize=None)
def _jax_tree(kv=2, quant=""):
    cfg = _cfg(kv)
    tree = jl.init_params(cfg, seed=0)
    if quant == "int8":
        tree = jl.quantize_int8(tree)
    elif quant == "int4":
        tree = jl.quantize_int4_params(tree)
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg(kv):
    return dataclasses.replace(tl.PRESETS["llama_tiny"], n_kv_heads=kv)


TOKENS = np.array([[5, 9, 33, 7, 100, 2, 411, 18]], np.int32)


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("model", [2, 4])
def test_tp_forward_matches_jax_tp_program(model, quant):
    """The port's tensor-parallel forward against the JAX package's
    forward jitted over its ``param_pspecs`` placement (GSPMD), f32."""
    kv = 4 if model == 4 else 2
    cfg = _cfg(kv)
    tree = _jax_tree(kv, quant)
    jm = jmake_mesh(model=model, data=1, devices=jax.devices()[:model])
    sharded = jshard_params(jm, tree, jl.param_pspecs(quant=quant or False))
    want = np.asarray(jax.jit(functools.partial(jl.forward, cfg=cfg,
                                                compute_dtype="float32"))(
        sharded, jnp.asarray(TOKENS)))
    tp = tl.place_tp(tl.params_from_jax(tree, device="cpu"), _tcfg(kv), ["cpu"] * model)
    got = tl.forward(tp, torch.from_numpy(TOKENS), _tcfg(kv), "float32").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("model", [2, 4])
def test_int4_tp_matches_unsharded(model):
    """int4 at model 2 and 4: the per-shard layout of the fused groups and
    the repacked input-cut mats give the unsharded forward's logits."""
    kv = 4 if model == 4 else 2
    params = tl.params_from_jax(_jax_tree(kv, "int4"), device="cpu")
    tp = tl.place_tp(params, _tcfg(kv), ["cpu"] * model)
    H, Hkv, hd, F_ = 4, kv, 32, 256
    assert tp.shards[0]["layers"]["wqkv_p"].shape[-1] == (H + 2 * Hkv) * hd // model
    assert tp.shards[0]["layers"]["wo_p"].shape[-2] == H * hd // 2 // model
    assert tp.shards[0]["layers"]["wgu_p"].shape[-1] == 2 * F_ // model
    x = torch.from_numpy(TOKENS)
    want = tl.forward(params, x, _tcfg(kv), "float32")
    got = tl.forward(tp, x, _tcfg(kv), "float32")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=F32_TOL)


def test_naive_contiguous_cut_of_fused_int4_fails():
    """Cutting the fused q|k|v and gate|up axes (and the packed rows of o
    and down) contiguously, as their pspecs' shapes alone suggest, gives
    another function: the per-shard layout is what makes TP right."""
    from nnstreamer_tpu_torch.parallel.sharding import shard_params

    params = tl.params_from_jax(_jax_tree(2, "int4"), device="cpu")
    mesh = _mesh(model=2)
    naive = shard_params(mesh, params, tl.param_pspecs("int4"))
    group = mesh.model_group(0)

    def slot_tree(slot):
        def walk(t):
            return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.for_slot(slot))
        return walk(naive)

    bad = tl.TPParams([slot_tree(s) for s in group], ["cpu", "cpu"], _tcfg(2))
    good = tl.place_tp(params, _tcfg(2), ["cpu", "cpu"])
    x = torch.from_numpy(TOKENS)
    want = tl.forward(params, x, _tcfg(2), "float32")
    scale = want.abs().max()
    assert (tl.forward(good, x, _tcfg(2), "float32") - want).abs().max() <= F32_TOL
    assert (tl.forward(bad, x, _tcfg(2), "float32") - want).abs().max() > 0.1 * scale


def test_tp_divisibility_and_pspecs_equal_jax():
    for kw in (dict(), dict(n_kv_heads=4), dict(ffn_hidden=250), dict(vocab=511)):
        for tp in (1, 2, 3, 4, 8):
            jc = dataclasses.replace(jl.PRESETS["llama_tiny"], **kw)
            tc = dataclasses.replace(tl.PRESETS["llama_tiny"], **kw)
            assert tl.tp_divisibility_problems(tc, tp) == \
                jl.tp_divisibility_problems(jc, tp)
    for quant in ("", "int8", "int4"):
        mine = tl.param_pspecs(quant)
        ref = jl.param_pspecs(quant=quant or False)

        def flat(t, pre=""):
            if isinstance(t, dict):
                return {k2: v2 for k, v in t.items()
                        for k2, v2 in flat(v, f"{pre}.{k}").items()}
            return {pre: tuple(t)}

        assert flat(mine) == flat(ref)
    assert tuple(tl.paged_cache_pspecs()["k"]) == tuple(jl.paged_cache_pspecs()["k"])
    assert tuple(tl.cache_pspecs()["v"]) == tuple(jl.cache_pspecs()["v"])
    assert tl.param_bytes_split(tl.PRESETS["llama_small"], "int4") == \
        jl.param_bytes_split(jl.PRESETS["llama_small"], "int4")


# -- the llm filter on the shared mesh ------------------------------------------

JAX_TINY = "llama_tiny_jax_weights_tp"
LLM_BASE = "max_new:5,temperature:0.0,dtype:float32"


def _jax_tiny_builder(opts, device):
    cfg = tl.resolve_config("llama_tiny", opts)
    quant = str(opts.get("quant", ""))
    params = tl.params_from_jax(_jax_tree(cfg.n_kv_heads, quant), device=device)
    return tl.make_bundle(cfg, params, opts.get("dtype", "bfloat16"), JAX_TINY)


tzoo.register_model(JAX_TINY, _jax_tiny_builder)


def _llm_ids(pkg, custom, prompt="the quick brown fox", n=5, **kw):
    model = JAX_TINY if pkg is ntt else "llama_tiny"
    acc = "accelerator=true:cpu " if pkg is ntt else ""
    p = pkg.Pipeline("appsrc name=src ! "
                     f"tensor_filter framework=llm model={model} custom={custom} "
                     f"invoke-dynamic=true name=f {acc}! tensor_sink name=out", **kw)
    with p:
        fw = p.element("f").fw
        info = dict(tp=fw.tp if pkg is ntt else None, mesh=p.mesh)
        p.push("src", prompt)
        outs = [p.pull("out", timeout=180) for _ in range(n)]
        p.eos("src")
        p.wait(timeout=60)
    return p, info, [int(b.tensors[0][0]) for b in outs]


def _held_equal(got, want, prompt_ids, kv):
    """Token by token equal to the JAX ids wherever the JAX model's
    top-1/top-2 gap (teacher-forced on its own ids) exceeds TIE; the
    comparison stops at a near tie, where the two may part."""
    seq = np.asarray([list(prompt_ids) + list(want)], np.int32)
    logits = np.asarray(jax.jit(functools.partial(
        jl.forward, cfg=_cfg(kv), compute_dtype="float32"))(
        jax.tree_util.tree_map(jnp.asarray, _jax_tree(kv)), jnp.asarray(seq)))[0]
    T = len(prompt_ids)
    for j, (a, b) in enumerate(zip(got, want)):
        top = np.sort(logits[T - 1 + j])
        if top[-1] - top[-2] <= TIE:
            return
        assert a == b, f"step {j}: {a} != {b}"


@pytest.mark.parametrize("model", [2, 4])
def test_llm_model_parallel_streams_identical_ids(model):
    kv = 4 if model == 4 else 2
    base = LLM_BASE + (",n_kv_heads:4" if kv == 4 else "")
    _, _, ref = _llm_ids(ntt, base, model_parallel=1)
    p2, info, tp_ids = _llm_ids(ntt, base, model_parallel=model)
    assert info["mesh"] is p2.mesh and p2.mesh_shape == (1, model)
    assert info["tp"] is not None and info["tp"].ways == model
    assert tp_ids == ref
    _, _, jax_ids = _llm_ids(nt, base, model_parallel=model)
    prompt_ids = [1] + [b + 3 for b in b"the quick brown fox"]
    _held_equal(tp_ids, jax_ids, prompt_ids, kv)


def test_llm_tp_alias_promoted_to_pipeline_mesh():
    _, _, ref = _llm_ids(ntt, LLM_BASE)
    p, info, ids = _llm_ids(ntt, LLM_BASE + ",tp:2")
    assert p.model_parallel == 2 and p.mesh_shape == (1, 2)
    assert info["tp"].ways == 2
    assert ids == ref


def test_llm_explicit_model_parallel_wins_over_alias():
    p, _, ids = _llm_ids(ntt, LLM_BASE + ",tp:4", model_parallel=2)
    assert p.mesh_shape == (1, 2)
    assert ids == _llm_ids(ntt, LLM_BASE)[2]


def test_llm_int4_kernel_refcount_survives_tp_move(monkeypatch):
    """The JAX package turns its int4 kernel off process-wide under TP; the
    port has no such switch: each call chooses its route, and under TP
    every int4 projection runs per slot at the shard's shapes.  A TP
    filter and an unsharded one serve side by side."""
    shapes = []
    real = tl.matmul_int4

    def seen(h, packed, scale, out_dtype=None):
        shapes.append((tuple(packed.shape), out_dtype))
        return real(h, packed, scale, out_dtype=out_dtype)

    monkeypatch.setattr(tl, "matmul_int4", seen)
    _, _, ref = _llm_ids(ntt, LLM_BASE + ",quant:int4")
    shapes.clear()
    _, info, ids = _llm_ids(ntt, LLM_BASE + ",quant:int4", model_parallel=2)
    assert ids == ref
    # llama_tiny (dim 128, 4 heads and 2 kv heads of 32, ffn 256, vocab
    # 512) at model=2: one slot's packed shapes; the input-cut o and down
    # write float32 partials, the lm_head its float32 logits
    f32 = torch.float32
    assert set(shapes) == {((64, (4 + 2 + 2) * 32 // 2), None),   # [q_s|k_s|v_s]
                           ((128 // 2 // 2, 128), f32),             # o: rows / 2
                           ((64, 2 * 256 // 2), None),              # [gate_s|up_s]
                           ((256 // 2 // 2, 128), f32),             # down: rows / 2
                           ((64, 512 // 2), f32)}                   # lm_head / 2


SERVE = LLM_BASE + ",stream_chunk:2,serve:continuous,slots:3,block_size:8"


def _fw(custom, model=None, provider=None):
    fw = LLMFramework()
    if provider is not None:
        fw._mesh_provider = provider
    fw.open({"model": JAX_TINY, "custom": custom, "accelerator": "true:cpu"})
    return fw


def _serve_tokens(fw, prompts, timeout=120.0):
    got = {i: [] for i in range(len(prompts))}
    lock = threading.Lock()

    def emit_for(i):
        def emit(tensors, meta):
            with lock:
                got[i].append(int(tensors[0][0]))
        return emit

    for i, p in enumerate(prompts):
        fw.submit([p], {}, emit_for(i))
    assert fw.drain(timeout=timeout)
    return got


def _provider(model):
    return lambda device=None: _mesh(data=1, model=model)


def _jax_paged_logits(prompt, ids, chunk=32, bs=8, kv=2):
    """The JAX package's forward_paged over one row, teacher-forced:
    prefill in chunks, then a decode step per token of ids but the last."""
    cfg = _cfg(kv)
    T = len(prompt)
    Pn = -(-T // chunk) * chunk
    n_blocks = -(-(Pn + len(ids)) // bs)
    pool = jl.init_paged_cache(cfg, n_blocks, bs, dtype="float32")
    tables = jnp.arange(n_blocks, dtype=jnp.int32)[None]
    toks = np.zeros((1, Pn), np.int32)
    toks[0, :T] = prompt
    fwd = jax.jit(functools.partial(jl.forward_paged, cfg=cfg, compute_dtype="float32"))
    tree = jax.tree_util.tree_map(jnp.asarray, _jax_tree(kv))
    for p in range(0, Pn, chunk):
        logits, pool = fwd(tree, jnp.asarray(toks[:, p:p + chunk]), pool, tables,
                           jnp.asarray([p], jnp.int32),
                           logit_off=jnp.int32(T - 1 - p if p + chunk >= Pn else 0))
    rows = [np.asarray(logits)[0, -1]]
    for j, t in enumerate(ids[:-1]):
        logits, pool = fwd(tree, jnp.asarray([[t]], jnp.int32), pool, tables,
                           jnp.asarray([T + j], jnp.int32))
        rows.append(np.asarray(logits)[0, -1])
    return np.stack(rows)


def _held_paged(prompt, ids, kv=2):
    """Each token of a served stream is the JAX paged model's argmax,
    teacher-forced, up to the first near tie."""
    logits = _jax_paged_logits(prompt, ids, kv=kv)
    for j, t in enumerate(ids):
        top = np.sort(logits[j])
        if top[-1] - top[-2] <= TIE:
            return
        assert t == int(np.argmax(logits[j])), f"step {j}"


@pytest.mark.parametrize("model", [2, 4])
def test_tp_paged_decode_matches_dense_and_dp_only(model):
    """Every stream's greedy ids under model_parallel=2 and 4 equal the
    per-request dense-cache path's and the unsharded continuous loop's,
    and, step by step, the JAX paged model's choices (near-tie rule)."""
    kv = 4 if model == 4 else 2
    geo = ",n_kv_heads:4" if kv == 4 else ""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, (t,), dtype=np.int32) for t in (3, 7, 5)]
    dense = []
    for prompt in prompts:
        fw = _fw(LLM_BASE + ",stream_chunk:2" + geo)
        dense.append([int(ids[0]) for ids, *_ in fw.invoke_stream([prompt])])
        fw.close()
    fw1 = _fw(SERVE + geo)
    ref = _serve_tokens(fw1, prompts)
    fw1.close()
    fw2 = _fw(SERVE + geo, provider=_provider(model))
    try:
        got = _serve_tokens(fw2, prompts)
        spec = fw2._serve._pool_sharding
        assert spec is not None and "model" in str(spec.spec)
        pools = fw2._serve._pool
        assert [p["k"].shape[3] for p in pools] == [kv // model] * model
    finally:
        fw2.close()
    for i, prompt in enumerate(prompts):
        assert got[i] == ref[i] == dense[i], f"stream {i}"
        _held_paged(prompt, got[i], kv)


def test_tp_speculative_draft_rides_the_same_mesh():
    """With a draft the propose and verify steps run tensor-parallel too:
    the draft's weights are cut over the same slots, and the streams equal
    the unsharded speculative loop's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, (t,), dtype=np.int32) for t in (4, 9)]
    custom = SERVE + ",draft:llama_tiny,spec_k:2,draft_seed:5"
    fw1 = _fw(custom)
    ref = _serve_tokens(fw1, prompts)
    fw1.close()
    fw2 = _fw(custom, provider=_provider(2))
    try:
        assert isinstance(fw2.draft_bundle.params, tl.TPParams)
        got = _serve_tokens(fw2, prompts)
        assert len(fw2.census.signatures) == 2  # propose and verify
    finally:
        fw2.close()
    assert got == ref
    for i, prompt in enumerate(prompts):
        _held_paged(prompt, got[i])


def test_tp_zero_recompile_churn_pin():
    """The census stays at its one captured step under TP: joins, leaves
    and completions over a cut pool change values only."""
    fw = _fw(SERVE + ",prefill_chunk:4", provider=_provider(2))
    rng = np.random.default_rng(5)
    try:
        _serve_tokens(fw, [rng.integers(1, 500, (3,), np.int32)])
        warm = (sorted(map(str, fw.census.signatures)), fw.census.captures)
        assert warm[1] == 1
        _serve_tokens(fw, [rng.integers(1, 500, (t,), np.int32) for t in (1, 7, 13)])
        _serve_tokens(fw, [rng.integers(1, 500, (9,), np.int32)])
        after = (sorted(map(str, fw.census.signatures)), fw.census.captures)
    finally:
        fw.close()
    assert after == warm


def test_tp_geometry_rejected_with_named_dims():
    with pytest.raises(FrameworkError, match="n_kv_heads=2"):
        _fw(SERVE, provider=_provider(4))


def test_tp_weight_swap_is_refused():
    fw = _fw(LLM_BASE, provider=_provider(2))
    try:
        with pytest.raises(FrameworkError, match="tensor-parallel"):
            fw.swap_params({})
    finally:
        fw.close()


# -- deep lint: mesh plan, per-slot pricing, goldens ---------------------------

LLM_SERVE_DESC = (
    "appsrc name=src ! tensor_filter framework=llm model=llama_small "
    "custom=max_new:16,serve:continuous,slots:4,block_size:16 "
    "invoke-dynamic=true ! tensor_sink name=out"
)


def _codes(report):
    return [d.code for d in report.diagnostics]


def test_deep_lint_prices_tp_params_and_pool_per_chip():
    r1 = ntt.analyze(LLM_SERVE_DESC, deep=True, model_parallel=1)
    r4 = ntt.analyze(LLM_SERVE_DESC, deep=True, model_parallel=4)
    j4 = jax_analyze(LLM_SERVE_DESC, deep=True, model_parallel=4)
    assert not r1.errors and not r4.errors
    s1, s4 = r1.resources.stages[0], r4.resources.stages[0]
    assert r4.resources.model_parallel == 4
    assert s4.pool_bytes * 4 == s1.pool_bytes
    shard, repl = tl.param_bytes_split(tl.PRESETS["llama_small"])
    assert s4.param_bytes == shard // 4 + repl
    assert s4.param_bytes < s1.param_bytes / 2
    assert (s4.param_bytes, s4.pool_bytes) == (j4.resources.stages[0].param_bytes,
                                               j4.resources.stages[0].pool_bytes)
    assert s4.variants == 1  # the port's one captured step (JAX: 3 programs)
    assert "model_parallel=4" in r4.resources.render()


def test_deep_lint_model_divisibility_golden():
    bad = ("appsrc name=src ! tensor_filter framework=llm "
           "model=llama_tiny custom=max_new:4,serve:continuous,slots:2 "
           "invoke-dynamic=true ! tensor_sink name=out")
    msg = next(d.message for d in ntt.analyze(bad, deep=True, model_parallel=4)
               .diagnostics if d.code == "model-divisibility")
    want = next(d.message for d in jax_analyze(bad, deep=True, model_parallel=4)
                .diagnostics if d.code == "model-divisibility")
    assert msg == want
    assert "n_kv_heads=2" in msg and "model_parallel=4" in msg


def test_deep_lint_tp_alias_priced_like_model_parallel():
    desc = LLM_SERVE_DESC.replace("slots:4", "slots:4,tp:4")
    r = ntt.analyze(desc, deep=True, model_parallel=1)
    r4 = ntt.analyze(LLM_SERVE_DESC, deep=True, model_parallel=4)
    assert r.resources.stages[0].param_bytes == r4.resources.stages[0].param_bytes
    assert r.resources.stages[0].pool_bytes == r4.resources.stages[0].pool_bytes


def test_deep_lint_mesh_axis_missing_golden():
    name = "torch-tp-test-badaxis"

    @register_model(name)
    def _build(opts, device):
        params = {"w": torch.from_numpy(_W1).to(device)}
        spec = TensorsSpec.from_string(str(_D), "float32")
        return ModelBundle(lambda p, x: x @ p["w"] @ p["w"].T, params, spec, spec,
                           param_pspecs={"w": P("seq", None)})

    desc = (f"appsrc name=src caps=other/tensors,dimensions={_D},types=float32 ! "
            f"tensor_filter framework=jax model={name} name=f ! tensor_sink name=out")
    r = ntt.analyze(desc, deep=True, batch_max=4, model_parallel=2)
    assert "mesh-axis-missing" in _codes(r)
    msg = next(d.message for d in r.diagnostics if d.code == "mesh-axis-missing")
    assert msg == ("param_pspecs name mesh axes ['seq'] that the pipeline's "
                   "(data x model) mesh does not carry — those leaves cannot "
                   "place at the first sharded dispatch (valid placement axes: "
                   "'data', 'model')")
    r1 = ntt.analyze(desc, deep=True, batch_max=4, model_parallel=1)
    assert "mesh-axis-missing" not in _codes(r1)


def test_deep_lint_generic_stage_divisibility_golden():
    name = "torch-tp-test-odd"

    @register_model(name)
    def _build(opts, device):
        params = {"w": torch.ones((_D, 6), device=device)}
        return ModelBundle(lambda p, x: x @ p["w"], params,
                           TensorsSpec.from_string(str(_D), "float32"),
                           TensorsSpec.from_string("6", "float32"),
                           param_pspecs={"w": P(None, "model")})

    desc = (f"appsrc name=src caps=other/tensors,dimensions={_D},types=float32 ! "
            f"tensor_filter framework=jax model={name} name=f ! tensor_sink name=out")
    r = ntt.analyze(desc, deep=True, batch_max=4, model_parallel=4)
    hits = [d for d in r.diagnostics if d.code == "model-divisibility"]
    assert hits and hits[0].message == (
        "param dims sharded over 'model' do not divide model_parallel=4: "
        "w[1]=6 — placement will fail")


def test_deep_lint_model_parallel_over_ask():
    assert "data-parallel-devices" in _codes(
        ntt.analyze(LLM_SERVE_DESC, deep=True, model_parallel=16))


def test_deep_lint_combined_over_ask_without_shardable_stage():
    r = ntt.analyze(LLM_SERVE_DESC, deep=True, batch_max=8, data_parallel=8,
                    model_parallel=2)
    hits = [d for d in r.diagnostics if d.code == "data-parallel-devices"]
    j = jax_analyze(LLM_SERVE_DESC, deep=True, batch_max=8, data_parallel=8,
                    model_parallel=2)
    assert hits and hits[0].message == next(
        d.message for d in j.diagnostics if d.code == "data-parallel-devices")
    assert "data_parallel=8 x model_parallel=2" in hits[0].message
    with pytest.raises(PipelineError, match="model_parallel=2"):
        ntt.Pipeline(LLM_SERVE_DESC.replace("invoke-dynamic=true",
                                            "invoke-dynamic=true accelerator=true:cpu"),
                     batch_max=8, data_parallel=8, model_parallel=2)
    r1 = ntt.analyze(LLM_SERVE_DESC, deep=True, batch_max=8, data_parallel=8,
                     model_parallel=1)
    assert "data-parallel-devices" not in _codes(r1)


# -- the configuration ------------------------------------------------------------

def test_config_fields_and_mesh_knobs_equal_jax(monkeypatch, tmp_path):
    """The port's Config has the JAX package's 27 fields; data_parallel and
    model_parallel come from the same ini keys and environment variables
    with the same defaults."""
    from nnstreamer_tpu.core.config import Config as JConfig
    from nnstreamer_tpu_torch.core.config import Config

    assert sorted(f.name for f in dataclasses.fields(Config)) == \
        sorted(f.name for f in dataclasses.fields(JConfig))
    assert len(dataclasses.fields(Config)) == 27
    assert (Config().data_parallel, Config().model_parallel) == (0, 1) == \
        (JConfig().data_parallel, JConfig().model_parallel)
    ini = tmp_path / "nns.ini"
    ini.write_text("[common]\ndata_parallel = 4\nmodel_parallel = 2\n")
    monkeypatch.setenv("NNS_TPU_CONF", str(ini))
    for cls in (Config, JConfig):
        cfg = cls.load()
        assert (cfg.data_parallel, cfg.model_parallel) == (4, 2)
    monkeypatch.setenv("NNS_TPU_DATA_PARALLEL", "8")
    monkeypatch.setenv("NNS_TPU_MODEL_PARALLEL", "0")
    for cls in (Config, JConfig):
        cfg = cls.load()
        assert (cfg.data_parallel, cfg.model_parallel) == (8, 0)
