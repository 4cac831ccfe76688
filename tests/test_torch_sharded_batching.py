"""Mesh-sharded micro-batching in the port against the JAX package's
(``tests/test_sharded_batching.py``), on the CPU.

With ``data_parallel`` resolving to N > 1, a shardable stage's bucketed
micro-batch is split over the ``data`` axis of the pipeline's mesh (here
eight slots of the CPU, ``NNS_TPU_DEVICE_SLOTS=8``), and every observable
of the one-slot path stays: row values, strict order, pts and meta,
uneven tails, the EOS flush.  ``data_parallel=1`` is that path.

Tolerances: the scaler computes ``x * c`` in float32 in both packages, so
its rows are held bitwise, sharded against one slot and against the JAX
package; ``tanh`` rows are bitwise port against port and within float32
rounding (``TOL``) of the JAX package's.  Each replica's step is its own
capture: the port's census holds one step per bucket and slot where the
JAX package holds one program per bucket
(``test_census_is_one_step_per_bucket_and_slot``)."""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.pipeline import batching as jb
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.parallel.mesh import local_devices, make_mesh
from nnstreamer_tpu_torch.pipeline.batching import (BatchRunner, bucket_for,
                                                    shard_bucket_for)
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError

#: tanh in float32, torch against XLA
TOL = 1e-6

DESC = (
    "appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
    "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
    "name=f {acc}! tensor_sink name=out"
)


@pytest.fixture(autouse=True)
def _eight_slots(monkeypatch):
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")


def _desc(pkg, desc=DESC):
    return desc.format(acc="accelerator=true:cpu " if pkg is ntt else "")


def _mesh(n):
    return make_mesh(data=n, devices=local_devices("cpu")[:n])


def _frames(n, dims=(16,)):
    return [np.full(dims, float(i), np.float32) for i in range(n)]


def _run(pkg, desc, frames, timeout=60, **kw):
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


# -- primitives ----------------------------------------------------------------

def test_shard_bucket_rounds_to_replica_multiple():
    assert shard_bucket_for(1, 4) == 4
    assert shard_bucket_for(3, 4) == 4
    assert shard_bucket_for(5, 4) == 8
    assert shard_bucket_for(5, 3) == 9
    assert shard_bucket_for(8, 8) == 8
    assert shard_bucket_for(9, 8) == 16
    assert shard_bucket_for(7, 1) == bucket_for(7)
    assert shard_bucket_for(5, 4, [2, 6]) == 8
    for n in range(1, 300):
        for r in (1, 2, 3, 4, 8):
            for lad in (None, [2, 6], [1, 3, 5, 7]):
                assert shard_bucket_for(n, r, lad) == jb.shard_bucket_for(n, r, lad)


@pytest.mark.parametrize("data", [2, 4, 8])
def test_rows_bit_identical_every_occupancy(rng, data):
    """Every occupancy 1..9 (across a bucket boundary): sharded rows are
    byte-equal to the one-slot runner's and within TOL of the JAX
    package's sharded runner."""
    fn = lambda arrays: (torch.tanh(arrays[0] * 1.5 + 0.25),)  # noqa: E731
    jfn = lambda arrays: (jnp.tanh(arrays[0] * 1.5 + 0.25),)  # noqa: E731
    single = BatchRunner(fn)
    sharded = BatchRunner(fn, mesh=_mesh(data))
    jsharded = jb.BatchRunner(jfn, mesh=jmake_mesh(data=data,
                                                   devices=jax.devices()[:data]))
    assert sharded.replicas == data
    for n in range(1, 10):
        rows = [(rng.standard_normal((24,)).astype(np.float32),) for _ in range(n)]
        a = single.run(list(rows))
        b = sharded.run(list(rows))
        c = jsharded.run(list(rows))
        assert len(a) == len(b) == len(c) == n
        for (x,), (y,), (z,) in zip(a, b, c):
            assert x.numpy().tobytes() == y.numpy().tobytes(), f"n={n}"
            np.testing.assert_allclose(y.numpy(), np.asarray(z), rtol=0, atol=TOL)


def test_batch_runner_mesh_with_unit_data_axis_is_unsharded():
    br = BatchRunner(lambda arrays: (arrays[0] * 2.0,), mesh=_mesh(1))
    assert br.mesh is None and br.replicas == 1


def test_census_is_one_step_per_bucket_and_slot():
    """The port captures each replica's step on its own slot: bucket 8
    over 4 replicas is four steps of 2 rows, one per slot (the JAX
    package: one program per bucket)."""
    br = BatchRunner(lambda arrays: (arrays[0] * 2.0,), mesh=_mesh(4))
    br.run([(np.full((3,), float(i), np.float32),) for i in range(7)])
    assert sorted(k[2] for k in br._sets) == [0, 1, 2, 3]
    assert {k[0] for k in br._sets} == {8}
    assert all(st.bucket == 2 for st in br._sets.values())
    br.run([(np.full((3,), float(i), np.float32),) for i in range(5)])
    assert br.census.captures == 4  # the same bucket: replays only


def test_slots_steps_all_launch_before_any_join(monkeypatch):
    """A sharded dispatch starts every slot's replay before the caller
    waits on any, so the slots' streams run side by side on one card."""
    from nnstreamer_tpu_torch.pipeline.graphs import Step

    br = BatchRunner(lambda arrays: (arrays[0] * 2.0,), mesh=_mesh(4))
    rows = [(np.full((3,), float(i), np.float32),) for i in range(8)]
    br.run(rows)
    calls = []
    for name in ("launch", "join"):
        real = getattr(Step, name)

        def spy(self, real=real, name=name):
            calls.append(name)
            return real(self)

        monkeypatch.setattr(Step, name, spy)
    got = br.run(rows)
    assert calls == ["launch"] * 4 + ["join"] * 4
    assert [float(r[0][0]) for r in got] == [2.0 * i for i in range(8)]


# -- pipeline semantics --------------------------------------------------------

@pytest.mark.parametrize("data", [2, 4, 8])
def test_pipeline_uneven_tail_matches_single_device(data):
    frames = _frames(13)
    sharded = _run(ntt, DESC, frames, queue_capacity=16, batch_max=8,
                   data_parallel=data)
    _assert_rows_bitwise(sharded, _run(ntt, DESC, frames, queue_capacity=16,
                                       batch_max=8, data_parallel=1))
    _assert_rows_bitwise(sharded, _run(nt, DESC, frames, queue_capacity=16,
                                       batch_max=8, data_parallel=data))


def test_data_parallel_1_is_exact_fallback():
    frames = _frames(9)
    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=1)
    with p:
        assert all(getattr(s.element, "_shard_mesh", None) is None
                   for s in p.stages)
        for i, x in enumerate(frames):
            p.push("src", ntt.Buffer([x], pts=i))
        outs = [p.pull("out", timeout=60) for _ in frames]
        el = p.element("f")
        for entry in el._batchers.values():
            assert entry[1].mesh is None
        p.eos()
        p.wait(timeout=60)
    assert p.mesh is None
    _assert_rows_bitwise(outs, _run(ntt, DESC, frames, batch_max=8, data_parallel=8))


def test_default_data_parallel_on_one_slot_builds_no_mesh(monkeypatch):
    """data_parallel=0 (auto) on one slot (the setting unset) resolves to
    one replica: no mesh, the one-slot path."""
    monkeypatch.delenv("NNS_TPU_DEVICE_SLOTS")
    p = ntt.Pipeline(_desc(ntt), batch_max=8)
    with p:
        assert p.mesh is None and p.mesh_shape == (1, 1)
        p.eos()
        p.wait(timeout=30)


def test_param_replication_happens_once():
    metrics.reset()
    _run(ntt, DESC, _frames(48), queue_capacity=64, batch_max=8, data_parallel=4)
    snap = metrics.snapshot()
    assert snap.get("f.shard_dispatch", 0) >= 2, snap
    assert snap.get("f.param_replications") == 1.0


def test_per_replica_counters_prove_placement():
    from nnstreamer_tpu_torch.utils.profiler import metrics_text

    metrics.reset()
    _run(ntt, DESC, _frames(32), queue_capacity=64, batch_max=8, data_parallel=8)
    snap = metrics.snapshot()
    rows = {k: v for k, v in snap.items() if k.startswith("f.shard_rows.")}
    if not rows:
        pytest.skip("backlog never coalesced (single-buffer dispatches)")
    assert set(rows) == {f"f.shard_rows.d{i}" for i in range(8)}, rows
    assert all(v > 0 for v in rows.values())
    assert sum(rows.values()) % 8 == 0
    text = metrics_text()
    assert "shard_rows" in text and "shard_dispatch" in text


@pytest.mark.parametrize("data", [2, 4])
def test_fused_chain_shards_and_matches(data):
    desc = (
        "appsrc name=src caps=other/tensors,dimensions=4:4,types=float32 ! "
        "tensor_transform mode=arithmetic option=typecast:float32,div:2.0 ! "
        "tensor_filter framework=jax model=scaler custom=scale:4.0,dims:4:4 "
        "name=f {acc}! tensor_sink name=out"
    )
    p = ntt.Pipeline(_desc(ntt, desc), batch_max=4, data_parallel=data)
    fused = [s for s in p.stages if len(s.node_ids) > 1]
    assert fused and fused[0].batchable and fused[0].shardable
    frames = [np.full((4, 4), float(i + 1), np.float32) for i in range(11)]
    sharded = _run(ntt, desc, frames, queue_capacity=16, batch_max=4,
                   data_parallel=data)
    _assert_rows_bitwise(sharded, _run(ntt, desc, frames, queue_capacity=16,
                                       batch_max=4, data_parallel=1))
    _assert_rows_bitwise(sharded, _run(nt, desc, frames, queue_capacity=16,
                                       batch_max=4, data_parallel=data))


def test_mesh_only_reaches_shardable_stages():
    register_custom_easy("shard-flex-double", lambda ins: [ins[0] * 2],
                         jax_traceable=True)
    desc = ("appsrc name=src ! "
            "tensor_filter framework=custom-easy model=shard-flex-double "
            "name=f ! tensor_sink name=out")
    p = ntt.Pipeline(desc, batch_max=8, data_parallel=8)
    assert not any(s.shardable for s in p.stages)
    frames = [np.full((4 + (i % 2),), float(i), np.float32) for i in range(10)]
    outs = _run(ntt, desc, frames, queue_capacity=16, batch_max=8, data_parallel=8)
    for x, o in zip(frames, outs):
        np.testing.assert_array_equal(np.asarray(o.tensors[0]), x * 2.0)


def test_requesting_more_replicas_than_devices_fails():
    """Over-asking fails start(): the elements are torn down and the
    instance is dead (a retry raises)."""
    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=9)
    with pytest.raises(PipelineError, match="data_parallel") as e:
        p.start()
    assert str(e.value) == "data_parallel=9 needs 9 local devices, have 8"
    assert not any(r.thread.is_alive() for r in p._unique_runners())
    with pytest.raises(PipelineError, match="failed startup"):
        p.start()


def test_mixed_device_kinds_under_a_mesh_raise():
    """The mesh takes the shardable stages' accelerator= kind: a card
    stage cannot join a CPU mesh (here the pipeline's CPU mesh exists
    when a card-kind stage asks for it)."""
    p = ntt.Pipeline(_desc(ntt), batch_max=8, data_parallel=2)
    with p:
        assert p.mesh.kind == "cpu"
        with pytest.raises(PipelineError, match="one device kind"):
            p._shared_mesh({"cuda"})
        p.eos()
        p.wait(timeout=30)


# -- in-flight dispatch window -------------------------------------------------

def test_in_order_emission_under_dispatch_depth():
    delays = np.random.default_rng(7).uniform(0.0, 0.004, 64)

    def jitter(ins):
        time.sleep(float(delays[int(np.asarray(ins[0]).flat[0]) % 64]))
        return [np.asarray(ins[0])]

    register_custom_easy("shard-jitter", jitter)
    desc = (
        "appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
        "name=f accelerator=true:cpu ! "
        "tensor_filter framework=custom-easy model=shard-jitter name=j ! "
        "tensor_sink name=out"
    )
    frames = _frames(40)
    p = ntt.Pipeline(desc, queue_capacity=8, batch_max=8, data_parallel=4,
                     dispatch_depth=2)
    outs = []
    with p:
        pushed = 0
        for burst in (7, 1, 12, 3, 17):
            for _ in range(burst):
                p.push("src", ntt.Buffer([frames[pushed]], pts=pushed))
                pushed += 1
            time.sleep(0.002)
        for _ in range(pushed):
            outs.append(p.pull("out", timeout=60))
        p.eos()
        p.wait(timeout=60)
    assert [o.pts for o in outs] == list(range(len(frames)))
    for x, o in zip(frames, outs):
        np.testing.assert_array_equal(np.asarray(o.tensors[0]), x * 2.0)


def test_eos_flushes_open_dispatch_window():
    frames = _frames(5)
    outs = _run(ntt, DESC, frames, queue_capacity=16, batch_max=4,
                data_parallel=4, dispatch_depth=3)
    _assert_rows_bitwise(outs, _run(ntt, DESC, frames, batch_max=1))


def test_stage_failure_flushes_inflight_window():
    """A batch in the dispatch window when a later batch's dispatch raises
    is delivered before the error propagates (the window's depth 1
    behaviour), on a sharded stage."""
    p = ntt.Pipeline(_desc(ntt), queue_capacity=32, batch_max=4, data_parallel=2,
                     dispatch_depth=2)
    el = p.element("f")
    first_started, release = threading.Event(), threading.Event()
    orig_process, orig_batch = el.process, el.process_batch

    def gated(pad, buf):
        first_started.set()
        assert release.wait(10)
        return orig_process(pad, buf)

    def flaky(pad, bufs):  # drains run 4 then 3; the 3-batch blows up
        if len(bufs) == 3:
            raise RuntimeError("boom")
        return orig_batch(pad, bufs)

    el.process, el.process_batch = gated, flaky
    frames = _frames(8)
    with p:
        p.push("src", ntt.Buffer([frames[0]], pts=0))
        assert first_started.wait(10)
        for i in range(1, 8):
            p.push("src", ntt.Buffer([frames[i]], pts=i))
        runner = [r for r in p._unique_runners() if r.element is el][0]
        deadline = time.monotonic() + 30
        while len(runner.queue._dq) < 7:
            assert time.monotonic() < deadline, "buffers never queued"
            time.sleep(0.002)
        release.set()
        outs = [p.pull("out", timeout=60) for _ in range(5)]
        assert [o.pts for o in outs] == [0, 1, 2, 3, 4]
        for x, o in zip(frames, outs):
            np.testing.assert_array_equal(np.asarray(o.tensors[0]), x * 2.0)
        with pytest.raises(PipelineError, match="boom"):
            p.pull("out", timeout=10)


def test_dispatch_depth_1_keeps_lockstep_semantics():
    frames = _frames(16)
    a = _run(ntt, DESC, frames, queue_capacity=32, batch_max=8, data_parallel=4,
             dispatch_depth=1)
    b = _run(ntt, DESC, frames, queue_capacity=32, batch_max=8, data_parallel=4,
             dispatch_depth=2)
    _assert_rows_bitwise(a, b)
