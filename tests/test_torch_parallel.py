"""The port's in-process mesh (``nnstreamer_tpu_torch/parallel/``) against
the JAX package's (``tests/test_parallel.py``), on the CPU.

The JAX tests run on eight virtual CPU devices (``tests/conftest.py``);
the port's twins run on eight slots of the CPU
(``NNS_TPU_DEVICE_SLOTS=8``, set per test).  Mesh shapes and validation
messages are compared with the JAX package's exactly; sharded values and
the ``mesh=data:N`` filter's outputs are compared bitwise with the
unsharded port and the JAX package (``x * c`` in float32 in both), and the
column-cut product within float32 rounding (``TOL``).  Ring attention
and the process group are held against the JAX package in
``tests/test_torch_ring.py`` and ``tests/test_torch_distributed.py``."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.parallel import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel import mesh_axis_size as jaxis
from nnstreamer_tpu.parallel import shard_params as jshard_params
from nnstreamer_tpu_torch import parallel as tpar
from nnstreamer_tpu_torch.parallel import sharding as tsh
from nnstreamer_tpu_torch.parallel.mesh import (device_coords, local_devices,
                                                make_mesh, mesh_axis_size)

#: float32 products summed in another order (a column cut)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(model=2), dict(model=4),
                                dict(axis_sizes={"seq": 8, "data": 1}),
                                dict(data=2, model=4), dict(data=8)])
def test_make_mesh_shapes(kw):
    m, j = make_mesh(**kw), jmake_mesh(**kw)
    for axis in ("data", "model", "seq", "expert", "pipe"):
        assert mesh_axis_size(m, axis) == jaxis(j, axis), axis
    assert m.size == 8 and [s.id for s in m.flat] == list(range(8))
    assert all(s.device == torch.device("cpu") for s in m.flat)


@pytest.mark.parametrize("kw", [dict(model=3), dict(data=3, model=2),
                                dict(model=0), dict(seq=-1),
                                dict(axis_sizes={"bogus": 2})])
def test_make_mesh_bad_divisor(kw):
    assert _err(lambda: make_mesh(**kw)) == _err(lambda: jmake_mesh(**kw))


def test_local_devices_follow_the_slot_setting(monkeypatch):
    assert len(local_devices("cpu")) == 8
    assert local_devices("cpu")[3] is local_devices("cpu")[3]
    monkeypatch.delenv("NNS_TPU_DEVICE_SLOTS")
    assert len(local_devices("cpu")) == 1
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        local_devices("cpu")


@pytest.mark.parametrize("data", [2, 4, 8])
def test_shard_batch_roundtrip(data):
    mesh = make_mesh(data=data, devices=local_devices("cpu")[:data])
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    y = tsh.shard_batch(mesh, x)
    assert y.sharding.num_devices == data
    assert [tuple(t.shape) for t in y.shards] == [(8 // data, 4)] * data
    assert y.full().numpy().tobytes() == x.tobytes()
    j = jax.device_put(x, jax.sharding.NamedSharding(
        jmake_mesh(data=data, devices=jax.devices()[:data]),
        jax.sharding.PartitionSpec("data")))
    assert [tuple(s.data.shape) for s in j.addressable_shards] == \
        [tuple(t.shape) for t in y.shards]


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_tp_matmul(model):
    """TP: w cut over 'model', each slot's columns of x @ w, joined: the
    JAX package's jitted product over its sharded w."""
    mesh = make_mesh(model=model)
    w = np.arange(16 * 8, dtype=np.float32).reshape(16, 8) / 64.0
    sharded = tsh.shard_params(mesh, {"w": w}, {"w": tsh.P(None, "model")})
    assert sharded["w"].spec == tsh.P(None, "model")
    x = np.linspace(-1.0, 1.0, 4 * 16, dtype=np.float32).reshape(4, 16)
    group = mesh.model_group(0)
    cols = [torch.from_numpy(x) @ sharded["w"].for_slot(s) for s in group]
    got = torch.cat(cols, dim=1).numpy()
    jm = jmake_mesh(model=model)
    from jax.sharding import NamedSharding, PartitionSpec as JP
    js = jshard_params(jm, {"w": w}, {"w": JP(None, "model")})
    want = np.asarray(jax.jit(lambda p, x: x @ p["w"])(
        js, jax.device_put(x, NamedSharding(jm, JP("data", None)))))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, x @ w, rtol=0, atol=TOL)


def test_replicate_is_one_tensor_per_device_and_sum_is_fixed_order():
    mesh = make_mesh(data=8)
    t = torch.arange(6.0)
    rep = tsh.replicate(mesh, {"t": t})["t"]
    assert all(s is t for s in rep.shards)  # every slot on the one CPU
    parts = [torch.full((3,), 0.1 * (i + 1)) for i in range(4)]
    a = tsh.fixed_order_sum(parts, "cpu")
    b = tsh.fixed_order_sum(parts, "cpu")
    assert a.numpy().tobytes() == b.numpy().tobytes()
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert a.numpy().tobytes() == want.numpy().tobytes()


def test_device_coords_name_each_slot():
    mesh = make_mesh(data=4, model=2)
    coords = device_coords(mesh)
    assert coords == {s.id: (s.id // 2, s.id % 2) for s in mesh.flat}


SCALER = ("appsrc name=src caps=other/tensors,dimensions=4:8,types=float32 ! "
          "tensor_filter framework=jax model=scaler custom=scale:3.0,dims:4:8 "
          "{mesh} {acc}! tensor_sink name=out")


def _scaler(pkg, mesh, x):
    acc = "accelerator=true:cpu " if pkg is ntt else ""
    p = pkg.Pipeline(SCALER.format(mesh=mesh, acc=acc))
    with p:
        p.push("src", x)
        out = p.pull("out", timeout=60)
        p.eos()
        p.wait(timeout=30)
    return np.asarray(out.tensors[0])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_jax_filter_data_parallel_mesh(n):
    """tensor_filter framework=jax mesh=data:N splits the batch dim over N
    slots: the same bytes as the unsharded port and the JAX package."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    got = _scaler(ntt, f"mesh=data:{n}", x)
    assert got.tobytes() == _scaler(ntt, "", x).tobytes()
    assert got.tobytes() == _scaler(nt, f"mesh=data:{n}", x).tobytes()
    assert got.tobytes() == (x * 3.0).tobytes()


@pytest.mark.parametrize("mesh,match", [("mesh=data:64", "devices"),
                                        ("mesh=model:2", "batch dim only"),
                                        ("mesh=data:x", "bad mesh spec")])
def test_jax_filter_mesh_too_big_rejected(mesh, match):
    from nnstreamer_tpu.elements.base import ElementError as JErr
    from nnstreamer_tpu_torch.elements.base import ElementError

    desc = ("appsrc ! tensor_filter framework=jax model=scaler custom=dims:4 "
            f"{mesh} {{acc}}! tensor_sink name=o")
    with pytest.raises(ElementError, match=match):
        ntt.Pipeline(desc.format(acc="accelerator=true:cpu "))
    with pytest.raises(JErr, match=match):
        nt.Pipeline(desc.format(acc=""))


def test_mesh_filter_fuses_its_split_step():
    """On slots of one device the fused stage captures the split step:
    the filter's pure callable runs each slot's rows."""
    p = ntt.Pipeline(
        "appsrc name=src caps=other/tensors,dimensions=4:8,types=float32 ! "
        "tensor_transform mode=arithmetic option=typecast:float32,add:1.0 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:4:8 "
        "mesh=data:4 accelerator=true:cpu ! tensor_sink name=out")
    assert any(s.element.kind == "fused" for s in p.stages)
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    with p:
        p.push("src", x)
        got = np.asarray(p.pull("out", timeout=60).tensors[0])
        p.eos()
        p.wait(timeout=30)
    assert got.tobytes() == ((x + 1.0) * 2.0).tobytes()


def test_ring_and_distributed_names_are_the_ported_modules():
    """The JAX ``parallel/__init__``'s names, aliases included, are the
    port's ``ring.py`` and ``distributed.py`` functions."""
    from nnstreamer_tpu_torch.parallel import distributed, ring

    assert tpar.ring_attention is ring.ring_attention
    assert tpar.ring_attention_local is ring.ring_attention_local
    assert tpar.distributed_initialize is distributed.initialize
    assert tpar.distributed_is_initialized is distributed.is_initialized
    for name in ("global_device_count", "global_mesh", "local_device_count"):
        assert getattr(tpar, name) is getattr(distributed, name)
    assert not hasattr(tpar, "NotPortedError")


def test_query_service_pod_sharded():
    """A tensor_query server whose filter shards the batch dim over eight
    slots; the client sees ordinary request/response, the JAX package's
    bytes."""
    srv = ntt.Pipeline(
        "tensor_query_serversrc name=ssrc port=0 id=177 ! "
        "tensor_filter framework=jax model=scaler "
        "custom=scale:4.0,dims:8:8 mesh=data:8 accelerator=true:cpu ! "
        "tensor_query_serversink id=177",
        fuse=False,
    )
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    with srv:
        port = srv.element("ssrc").bound_port
        cli = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} timeout=15 ! "
            "tensor_sink name=out")
        with cli:
            cli.push("src", x)
            out = cli.pull("out", timeout=15)
            cli.eos("src")
            cli.wait(timeout=10)
    got = np.asarray(out.tensors[0])
    assert got.tobytes() == (4.0 * x).tobytes()


def test_graft_dryrun_detection_dp():
    """The JAX package's DP detection dry run, in the port: what
    ``tensor_filter mesh=data:N`` and a fused ``tensor_decoder
    option7=device`` serve: ssd_mobilenet's batch of 16 split over eight
    slots, the device NMS behind it, every output equal to the unsharded
    pipeline's."""
    desc = ("appsrc name=src caps=other/tensors,dimensions=3:64:64:16,"
            "types=float32 ! tensor_filter framework=jax model=ssd_mobilenet "
            "custom=size:64,classes:5,batch:16,dtype:float32 {mesh} "
            "accelerator=true:cpu ! tensor_decoder mode=bounding_boxes "
            "option1=ssd option3=0.3 option4=64:64 option7=device "
            "option9=tensors ! tensor_sink name=out")
    x = np.random.default_rng(1).integers(0, 256, (16, 64, 64, 3)).astype(np.float32)

    def run(mesh):
        p = ntt.Pipeline(desc.format(mesh=mesh))
        with p:
            fw = [e for e in p.elements.values() if e.kind == "tensor_filter"][0].fw
            slots = fw.mesh.shape["data"] if fw.mesh is not None else 1
            p.push("src", x)
            out = p.pull("out", timeout=60)
            p.eos()
            p.wait(timeout=60)
        return slots, [np.asarray(t) for t in out.tensors]

    slots, sharded = run("mesh=data:8")
    _, plain = run("")
    assert slots == 8
    assert sharded[0].shape[0] == 16 and sharded[-1].dtype == np.uint8
    for a, b in zip(sharded, plain):
        assert a.tobytes() == b.tobytes()


def test_parallel_imports_without_jax():
    """The port's mesh modules import with ``'jax' not in sys.modules``."""
    code = ("import sys; import nnstreamer_tpu_torch.parallel, "
            "nnstreamer_tpu_torch.parallel.mesh, nnstreamer_tpu_torch.parallel.sharding, "
            "nnstreamer_tpu_torch.pipeline.batching; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('nnstreamer_tpu.') for m in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_local_batch_single_device_mesh_and_out_shardings():
    from nnstreamer_tpu.parallel.mesh import local_batch as jlocal_batch

    mesh = make_mesh(data=4, model=2)
    assert tpar.local_batch(mesh, 8) == 2 == jlocal_batch(jmake_mesh(data=4, model=2), 8)
    assert _err(lambda: tpar.local_batch(mesh, 6)) == \
        _err(lambda: jlocal_batch(jmake_mesh(data=4, model=2), 6))
    one = tpar.single_device_mesh()
    assert one.size == 1 and all(v == 1 for v in one.shape.values())
    outs = tsh.out_shardings_like(mesh, {"a": tsh.P("data"), "b": tsh.P(None, "model")})
    assert outs["a"].spec == tsh.P("data") and outs["b"].mesh is mesh


def test_spec_walk_equals_jax():
    """``spec_axes`` and ``placement_split`` over a partial spec tree (a
    leaf with no spec, a tuple entry, a ``model`` cut) equal the JAX
    package's on the same tree."""
    from jax.sharding import PartitionSpec as JP

    from nnstreamer_tpu.parallel import sharding as jsh

    params = {"a": np.zeros((4, 8), np.float32), "b": {"c": np.zeros((8,), np.float32),
                                                      "d": np.zeros((2, 4), np.float32)},
              "e": np.zeros((3,), np.float32)}
    t_specs = {"a": tsh.P(None, "model"), "b": {"c": tsh.P(("data", "model")),
                                                "d": tsh.P()}}
    j_specs = {"a": JP(None, "model"), "b": {"c": JP(("data", "model")), "d": JP()}}
    assert tsh.placement_split(params, t_specs) == jsh.placement_split(params, j_specs) \
        == (2, 2)
    assert tsh.placement_split(params, t_specs, "data") == \
        jsh.placement_split(params, j_specs, "data")
    assert tsh.spec_axes(t_specs["b"]["c"]) == jsh.spec_axes(j_specs["b"]["c"]) \
        == {"data", "model"}
