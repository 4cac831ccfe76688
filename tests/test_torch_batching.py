"""Micro-batching in the port against the JAX package's
(``nnstreamer_tpu/pipeline/batching.py``, ``tests/test_batching.py``), on
the CPU: the bucket ladder, the row helpers, ``BatchRunner``, the
runner's drain (order, pts, padding, EOS, linger, signatures), the
dispatch window (``dispatch_depth``), the batch spans, the metric names,
and the per-frame README quick-start at a small size.

Tolerances: the scaler and custom-easy pipelines compute ``x * c`` in
float32 in both packages, so their outputs are compared exactly.  The
quick-start's scores may differ from the JAX package's by ``TOL`` of the
frame's largest |logit| (the fusion tests' float32 tolerance), and its
labels must be equal wherever the JAX top-1/top-2 gap exceeds that; the
port's batched run is held to its own ``batch_max=1`` run within the same
tolerance.  Several tests hold the stage on its first buffer until the
rest are queued, so the drains' occupancies are fixed, not timing."""

import functools
import random
import threading
import time

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core import buffer as jbuf
from nnstreamer_tpu.core.log import metrics as jmetrics
from nnstreamer_tpu.filters.custom_easy import register_custom_easy as jregister
from nnstreamer_tpu.models import mobilenet as jmob
from nnstreamer_tpu.pipeline import batching as jb
from nnstreamer_tpu_torch.core import buffer as tbuf
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.models import mobilenet as tmob, zoo as tzoo
from nnstreamer_tpu_torch.pipeline import batching as tb
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError, _StageQueue
from nnstreamer_tpu_torch.utils import tracing

torch.set_num_threads(2)

DESC = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
        "{acc}name=f ! tensor_sink name=out")
JDESC = DESC.format(acc="")
PDESC = DESC.format(acc="accelerator=true:cpu ")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    """An op without a batching rule raises instead of looping per row."""
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)


def _frames(n):
    return [np.full((16,), float(i), np.float32) for i in range(n)]


def _pipeline(pkg, desc, **kw):
    """The JAX package's pipelines on one device: the test process's
    eight virtual CPU devices would otherwise shard its batches.  The
    port's run on one slot (``NNS_TPU_DEVICE_SLOTS`` unset); its sharded
    mode is held in ``tests/test_torch_sharded_batching.py``."""
    if pkg is nt:
        kw.setdefault("data_parallel", 1)
    return pkg.Pipeline(desc, **kw)


def _run(pkg, desc, frames, timeout=60, **kw):
    p = _pipeline(pkg, desc, **kw)
    outs = []
    with p:
        for i, x in enumerate(frames):
            p.push("src", pkg.Buffer([x], pts=i))
        for _ in frames:
            outs.append(p.pull("out", timeout=timeout))
        p.eos()
        p.wait(timeout=timeout)
    return outs


def _vals(outs):
    return [np.asarray(o.tensors[0]) for o in outs]


def _batching_runner(p):
    runners = {id(r): r for r in p._runners.values()}.values()
    [runner] = [r for r in runners if r.batch_max > 1]
    return runner


def _gate(el):
    """Hold the stage's first buffer in process() until released, so the
    buffers pushed meanwhile are all queued when it drains next.
    Returns (started, release)."""
    started, release = threading.Event(), threading.Event()
    orig = el.process

    def gated(pad, buf):
        started.set()
        assert release.wait(30)
        el.process = orig
        return orig(pad, buf)

    el.process = gated
    return started, release


def _queued(runner, n, timeout=30):
    deadline = time.monotonic() + timeout
    while len(runner.queue._dq) < n:
        assert time.monotonic() < deadline, "buffers never queued"
        time.sleep(0.002)


def _run_gated(pkg, desc, frames, eos_early=False, **kw):
    """Buffer 0 alone, the rest queued behind it, then released: the
    drains are 1, then batch_max at a time, then the remainder."""
    p = _pipeline(pkg, desc, **kw)
    runner = _batching_runner(p)
    started, release = _gate(runner.element)
    with p:
        p.push("src", pkg.Buffer([frames[0]], pts=0))
        assert started.wait(30)
        for i in range(1, len(frames)):
            p.push("src", pkg.Buffer([frames[i]], pts=i))
        if eos_early:
            p.eos()
        _queued(runner, len(frames) - 1 + int(eos_early))
        release.set()
        outs = [p.pull("out", timeout=60) for _ in frames]
        if not eos_early:
            p.eos()
        p.wait(timeout=60)
    return outs, p


# -- the ladder and the row helpers: exactly the JAX package's -------------------

@pytest.mark.parametrize("buckets", [None, [2, 6], [1, 3, 5, 7], [4],
                                     [1, 2, 4, 8, 16, 24], [6, 2, 2, 10]])
def test_bucket_for_and_ladder_equal_jax(buckets):
    for n in range(1, 1101):
        assert tb.bucket_for(n, buckets and sorted(set(buckets))) == \
            jb.bucket_for(n, buckets and sorted(set(buckets))), n
        assert tb.ladder(n, buckets) == jb.ladder(n, buckets), n


def test_default_buckets_and_known_values():
    assert tb.DEFAULT_BUCKETS == jb.DEFAULT_BUCKETS
    assert tb.MINT_AFTER == jb.MINT_AFTER
    assert [tb.bucket_for(n) for n in (1, 3, 8, 9, 300, 1000)] == \
        [1, 4, 8, 16, 512, 1024]
    assert tb.bucket_for(5, [2, 6]) == 6 and tb.bucket_for(7, [2, 6]) == 12


def test_batch_signature_equal_jax():
    arrays = [np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32),
              np.zeros((2, 3), np.float64), np.zeros((3, 2), np.float32)]
    sigs = [tbuf.batch_signature(tbuf.Buffer([a])) for a in arrays]
    assert sigs == [jbuf.batch_signature(jbuf.Buffer([a])) for a in arrays]
    assert sigs[0] == sigs[1] and len(set(sigs)) == 3


@pytest.mark.parametrize("n,pad_to", [(3, 4), (1, 8), (5, 5), (6, 2)])
def test_pad_stack_split_round_trip_equal_jax(n, pad_to):
    rng = np.random.default_rng(n)
    rows = [tuple(rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2))
            for _ in range(n)]
    padded = tbuf.pad_rows(rows, pad_to)
    assert len(padded) == len(jbuf.pad_rows(rows, pad_to)) == max(n, pad_to)
    assert all(p is rows[min(i, n - 1)] for i, p in enumerate(padded))
    mine = tbuf.stack_tensors(rows, pad_to=pad_to)
    want = jbuf.stack_tensors(rows, pad_to=pad_to)
    for m, w in zip(mine, want):
        assert np.array_equal(m.numpy(), np.asarray(w))
    for got, row in zip(tbuf.split_rows(mine, n), rows):
        for g, r in zip(got, row):
            assert np.array_equal(g.numpy(), r)


# -- BatchRunner ------------------------------------------------------------------

def test_batch_runner_matches_per_row_fn_and_jax():
    rng = np.random.default_rng(42)
    rows = [(rng.standard_normal((8,)).astype(np.float32),) for _ in range(5)]
    br = tb.BatchRunner(lambda a: (a[0] * 2.0 + 1.0,))
    outs = br.run(rows)  # 5 -> bucket 8: three pad rows dropped
    want = jb.BatchRunner(lambda a: (a[0] * 2.0 + 1.0,)).run(rows)
    assert len(outs) == 5
    for (x,), (y,), (w,) in zip(rows, outs, want):
        assert np.array_equal(y.numpy(), x * 2.0 + 1.0)
        assert np.array_equal(y.numpy(), np.asarray(w))
    assert br.census.signatures == {(8, (((8,), "torch.float32"),))}
    assert br.census.device == torch.device("cpu")


def test_rows_bitwise_across_occupancies_of_one_bucket():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    br = tb.BatchRunner(lambda a: (torch.tanh(a[0] @ w),))
    rows = [(rng.standard_normal((16,)).astype(np.float32),) for _ in range(8)]
    five, seven = br.run(rows[:5]), br.run(rows[:7])
    for a, b in zip(five, seven):
        assert torch.equal(a[0], b[0])
    assert br.census.captures == 1 and br.census.replays == 2


def test_runner_outputs_outlive_the_next_dispatch():
    br = tb.BatchRunner(lambda a: (a[0] + 1.0,))
    first = br.run([(np.full((4,), 1.0, np.float32),)] * 3)
    br.run([(np.full((4,), 9.0, np.float32),)] * 3)
    assert all(torch.equal(r[0], torch.full((4,), 2.0)) for r in first)


# -- the runner: the JAX test contract --------------------------------------------

def test_occupancy_above_one_under_backlog():
    metrics.reset()
    outs, _ = _run_gated(ntt, PDESC, _frames(24), queue_capacity=32, batch_max=8)
    assert [o.pts for o in outs] == list(range(24))
    snap = metrics.snapshot()
    assert snap["f.batch_occupancy.n"] == 4  # 1 + 8 + 8 + 7
    assert snap["f.batch_occupancy.p99"] == 8.0


def test_strict_output_ordering_and_pts():
    frames = _frames(32)
    outs = _run(ntt, PDESC, frames, queue_capacity=32, batch_max=8)
    want = _run(nt, JDESC, frames, queue_capacity=32, batch_max=8)
    assert [o.pts for o in outs] == list(range(32))
    for o, w in zip(outs, want):
        assert np.array_equal(np.asarray(o.tensors[0]), np.asarray(w.tensors[0]))


def test_bucket_padding_matches_unbatched_reference():
    frames = _frames(13)
    batched, _ = _run_gated(ntt, PDESC, frames, queue_capacity=16, batch_max=8)
    reference = _run(ntt, PDESC, frames, queue_capacity=16, batch_max=1)
    want = _run(nt, JDESC, frames, queue_capacity=16, batch_max=8)
    for b, r, w in zip(_vals(batched), _vals(reference), _vals(want)):
        assert np.array_equal(b, r) and np.array_equal(b, w)


def test_partial_batch_flushes_at_eos():
    frames = _frames(3)
    outs = _run(ntt, PDESC, frames, queue_capacity=16, batch_max=8)
    assert [o.pts for o in outs] == [0, 1, 2]
    for x, o in zip(frames, outs):
        assert np.array_equal(np.asarray(o.tensors[0]), x * 2.0)


def test_batch_max_1_is_bit_identical_to_default():
    frames = _frames(6)
    explicit = _run(ntt, PDESC, frames, batch_max=1)
    default = _run(ntt, PDESC, frames)
    for a, b in zip(explicit, default):
        assert bytes(np.asarray(a.tensors[0])) == bytes(np.asarray(b.tensors[0]))
        assert a.pts == b.pts


def test_fused_stage_batches_and_matches():
    desc = ("appsrc name=src caps=other/tensors,dimensions=4:4,types=float32 ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:2.0 ! "
            "tensor_filter framework=jax model=scaler custom=scale:4.0,dims:4:4 "
            "{acc}name=f ! tensor_sink name=out")
    p = ntt.Pipeline(desc.format(acc="accelerator=true:cpu "), batch_max=4)
    jp = _pipeline(nt, desc.format(acc=""), batch_max=4)
    assert [(s.element.name, s.batchable) for s in p.stages] == \
        [(s.element.name, s.batchable) for s in jp.stages]
    assert [s.batchable for s in p.stages] == [False, True, False]
    frames = [np.full((4, 4), float(i + 1), np.float32) for i in range(9)]
    batched = _run(ntt, desc.format(acc="accelerator=true:cpu "), frames,
                   queue_capacity=16, batch_max=4)
    reference = _run(ntt, desc.format(acc="accelerator=true:cpu "), frames,
                     queue_capacity=16, batch_max=1)
    want = _run(nt, desc.format(acc=""), frames, queue_capacity=16, batch_max=4)
    for b, r, w in zip(_vals(batched), _vals(reference), _vals(want)):
        assert np.array_equal(b, r)
        # XLA folds div:2.0 into a multiply inside the program: 1 ulp
        np.testing.assert_allclose(b, w, rtol=1e-6)


@pytest.mark.parametrize("fuse", [True, False])
def test_host_stages_stay_unbatched(fuse):
    desc = ("videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter ! "
            "tensor_sink name=out")
    p = ntt.Pipeline(desc, fuse=fuse, batch_max=8)
    jp = _pipeline(nt, desc, fuse=fuse, batch_max=8)
    assert not any(s.batchable for s in p.stages)
    assert [s.batchable for s in p.stages] == [s.batchable for s in jp.stages]
    assert all(r.batch_max == 1 for r in p._unique_runners())


def test_mixed_spec_buffers_split_batches():
    register_custom_easy("batch-double", lambda ins: [ins[0] * 2],
                         jax_traceable=True)
    jregister("batch-double", lambda ins: [ins[0] * 2], jax_traceable=True)
    desc = ("appsrc name=src ! tensor_filter framework=custom-easy "
            "model=batch-double name=f ! tensor_sink name=out")
    frames = [np.full((4 + (i % 2),), float(i), np.float32) for i in range(10)]
    outs, _ = _run_gated(ntt, desc, frames, queue_capacity=16, batch_max=8)
    want = _run(nt, desc, frames, queue_capacity=16, batch_max=8)
    for x, o, w in zip(frames, outs, want):
        assert np.array_equal(np.asarray(o.tensors[0]), x * 2.0)
        assert np.array_equal(np.asarray(o.tensors[0]), np.asarray(w.tensors[0]))


def test_batch_linger_waits_for_stragglers():
    metrics.reset()
    p = ntt.Pipeline(PDESC, queue_capacity=32, batch_max=4, batch_linger_ms=200.0)
    frames = _frames(8)
    outs = []
    with p:
        for i in range(0, 8, 2):  # trickle pairs with small gaps
            p.push("src", frames[i])
            p.push("src", frames[i + 1])
            time.sleep(0.01)
        for _ in frames:
            outs.append(p.pull("out", timeout=60))
        p.eos()
        p.wait(timeout=60)
    assert len(outs) == 8
    assert metrics.snapshot()["f.batch_occupancy.p99"] > 1.0


def test_stop_wakes_blocked_batching_stages_immediately():
    p = ntt.Pipeline(
        "appsrc name=src caps=other/tensors,dimensions=4,types=float32 ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_sink name=out", fuse=False, batch_max=8, batch_linger_ms=500.0)
    p.start()
    time.sleep(0.05)  # every stage blocks on its queue
    t0 = time.monotonic()
    p.stop()
    assert time.monotonic() - t0 < 0.5
    assert not any(r.thread.is_alive() for r in p._unique_runners())


def test_queue_timed_get_and_get_nowait():
    q = _StageQueue(2)
    assert q.get_nowait() is None
    t0 = time.monotonic()
    assert q.get(timeout=0.05) is None
    assert time.monotonic() - t0 >= 0.04
    assert q.put(("p", 1)) and q.put(("p", 2))
    assert q.get_nowait() == ("p", 1) and q.get(timeout=1) == ("p", 2)
    q.close()
    assert q.get(timeout=0.01)[1] is not None  # the poison sentinel


def test_queue_many_producers_no_lost_wakeups():
    q = _StageQueue(3)
    n_prod, per = 8, 200

    def producer(k):
        for i in range(per):
            assert q.put(("pad", (k, i)))

    threads = [threading.Thread(target=producer, args=(k,), daemon=True)
               for k in range(n_prod)]
    for t in threads:
        t.start()
    got = []
    while len(got) < n_prod * per:
        item = q.get(timeout=20.0) if len(got) % 2 else q.get_nowait()
        if item is None and len(got) % 2 == 0:
            item = q.get(timeout=20.0)
        assert item is not None, f"consumer starved after {len(got)} items"
        got.append(item[1])
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    last = {}
    for k, i in got:  # per-producer FIFO survives the interleaving
        assert last.get(k, -1) == i - 1
        last[k] = i


def test_metric_names_and_histogram_equal_jax():
    """The same fixed drains (1, 8, 5) in both packages: the same snapshot
    keys for the stage, the same occupancy histogram and counts."""
    frames = _frames(14)
    metrics.reset()
    _run_gated(ntt, PDESC, frames, queue_capacity=16, batch_max=8)
    mine, mine_h = metrics.snapshot(), metrics.value_histograms()
    jmetrics.reset()
    _run_gated(nt, JDESC, frames, queue_capacity=16, batch_max=8)
    want, want_h = jmetrics.snapshot(), jmetrics.value_histograms()
    keys = {k for k in mine if k.startswith("f.")}
    assert keys == {k for k in want if k.startswith("f.")}
    assert {"f.batch_occupancy.n", "f.batch_pad_waste", "f.in", "f.out",
            "f.proc.n"} <= keys
    for k in ("f.in", "f.out", "f.batch_pad_waste", "f.batch_occupancy.n",
              "f.batch_occupancy.mean", "f.batch_occupancy.p99", "f.proc.n"):
        assert mine[k] == want[k], k
    assert mine_h["f.batch_occupancy"] == want_h["f.batch_occupancy"]
    assert mine_h["f.batch_occupancy"][1][:4] == [1, 0, 0, 2]  # le 1, 2, 4, 8
    assert mine["f.batch_pad_waste"] == 3.0  # 5 rows in bucket 8


# -- the slice's model: the per-frame quick-start --------------------------------

@functools.lru_cache(maxsize=None)
def _mobilenet_tree():
    tree = jmob.init_params(width=1.0, classes=1001, seed=0)
    return jax.tree_util.tree_map(np.asarray, tree)


def _mobilenet_ref(opts, device):
    return tmob.build_bundle(tmob.params_from_jax(_mobilenet_tree(), device), opts,
                             "mobilenet_v1_jax_weights")


tzoo.register_model("mobilenet_v1_jax_weights", _mobilenet_ref)

QUICKSTART = ("appsrc name=src caps=other/tensors,dimensions=3:32:32:1,types=uint8 ! "
              "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,"
              "div:127.5 ! tensor_filter framework=jax model={model} "
              "custom=size:32,batch:1,dtype:float32 {acc}! "
              "tensor_decoder mode=image_labeling ! tensor_sink name=out")


def test_per_frame_quickstart_against_jax():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8) for _ in range(13)]
    pdesc = QUICKSTART.format(model="mobilenet_v1_jax_weights",
                              acc="accelerator=true:cpu ")
    mine, p = _run_gated(ntt, pdesc, frames, queue_capacity=16, batch_max=8)
    [stage] = [s for s in p.stages if s.batchable]
    assert stage.element.kind == "fused" and len(stage.node_ids) == 3
    single = _run(ntt, pdesc, frames, queue_capacity=16, batch_max=1)
    want = _run(nt, QUICKSTART.format(model="mobilenet_v1", acc=""), frames,
                queue_capacity=16, batch_max=8)
    x = (np.concatenate(frames).astype(np.float32) + np.float32(-127.5)) / np.float32(127.5)
    logits = np.asarray(jax.jit(functools.partial(jmob.apply, compute_dtype="float32"))(
        _mobilenet_tree(), x))
    top = np.sort(logits, axis=1)
    tol = TOL * np.abs(logits).max(axis=1)
    held = (top[:, -1] - top[:, -2]) > tol
    assert held.sum() >= 10
    for i, (m, s, w) in enumerate(zip(mine, single, want)):
        assert m.pts == i
        assert abs(float(m.meta["score"]) - float(w.meta["score"])) <= tol[i]
        assert abs(float(m.meta["score"]) - float(s.meta["score"])) <= tol[i]
        if held[i]:
            assert int(m.meta["label_index"]) == int(w.meta["label_index"])
            assert int(m.meta["label_index"]) == int(s.meta["label_index"])


def test_per_frame_quickstart_buckets_in_the_stage_census():
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8) for _ in range(13)]
    desc = QUICKSTART.format(model="mobilenet_v1", acc="accelerator=true:cpu ")
    metrics.reset()
    outs, p = _run_gated(ntt, desc, frames, queue_capacity=16, batch_max=8)
    assert [o.pts for o in outs] == list(range(13))
    fused = _batching_runner(p).element
    # drains 1 (the one-buffer step), 8 and 4 (one bucket step each)
    buckets = sorted(sig[0] for sig in fused.census.signatures
                     if isinstance(sig[0], int))
    assert buckets == [4, 8]
    assert fused.census.captures == len(fused.census.signatures) == 3
    assert fused.census.replays == 3
    name = fused.name
    assert metrics.snapshot()[f"{name}.batch_occupancy.n"] == 3
    assert f"{name}.batch_pad_waste" not in metrics.snapshot()


# -- the dispatch window ----------------------------------------------------------

def _jitter(seed):
    """A traceable x * 2 that sleeps a seeded random while on the CPU (the
    port's bucket steps run eagerly there; the JAX package traces it)."""
    delays = random.Random(seed)

    def fn(ins):
        if isinstance(ins[0], torch.Tensor):
            time.sleep(delays.random() * 0.004)
        return [ins[0] * 2.0]

    return fn


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_window_depths_give_the_same_outputs_in_order(depth):
    name = f"window-jitter-{depth}"
    spec = TensorsSpec.from_string("16", "float32")
    register_custom_easy(name, _jitter(depth), in_spec=spec, out_spec=spec,
                         jax_traceable=True)
    jregister(name, lambda ins: [ins[0] * 2.0], jax_traceable=True)
    desc = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
            f"tensor_filter framework=custom-easy model={name} name=f ! "
            "tensor_sink name=out")
    frames = _frames(40)
    p = ntt.Pipeline(desc, queue_capacity=8, batch_max=8, dispatch_depth=depth)
    assert _batching_runner(p).dispatch_depth == depth
    outs = []
    with p:
        pushed = 0
        for burst in (7, 1, 12, 3, 17):  # bursty arrivals
            for _ in range(burst):
                p.push("src", ntt.Buffer([frames[pushed]], pts=pushed))
                pushed += 1
            time.sleep(0.002)
        outs = [p.pull("out", timeout=60) for _ in range(pushed)]
        p.eos()
        p.wait(timeout=60)
    want = _run(nt, desc, frames, queue_capacity=8, batch_max=8, dispatch_depth=depth)
    assert [o.pts for o in outs] == list(range(40))
    for o, w in zip(outs, want):
        assert np.array_equal(np.asarray(o.tensors[0]), np.asarray(w.tensors[0]))


def test_eos_flushes_the_window():
    frames = _frames(5)
    outs, p = _run_gated(ntt, PDESC, frames, eos_early=True, queue_capacity=16,
                         batch_max=2, dispatch_depth=3)
    assert [o.pts for o in outs] == list(range(5))
    assert all(np.array_equal(v, x * 2.0) for v, x in zip(_vals(outs), frames))
    assert not _batching_runner(p)._inflight


def test_stage_failure_delivers_the_window_before_the_error():
    """A batch held in the window when a later dispatch raises arrives
    before the error, as at depth 1."""
    p = ntt.Pipeline(PDESC, queue_capacity=32, batch_max=4, dispatch_depth=2)
    el = p.element("f")
    orig = el.process_batch

    def flaky(pad, bufs):  # drains run 4 then 3; the 3-batch fails
        if len(bufs) == 3:
            raise RuntimeError("boom")
        return orig(pad, bufs)

    el.process_batch = flaky
    started, release = _gate(el)
    frames = _frames(8)
    with p:
        p.push("src", ntt.Buffer([frames[0]], pts=0))
        assert started.wait(10)
        for i in range(1, 8):
            p.push("src", ntt.Buffer([frames[i]], pts=i))
        _queued(_batching_runner(p), 7)
        release.set()
        outs = [p.pull("out", timeout=60) for _ in range(5)]
        assert [o.pts for o in outs] == [0, 1, 2, 3, 4]
        for x, o in zip(frames, outs):
            assert np.array_equal(np.asarray(o.tensors[0]), x * 2.0)
        with pytest.raises(PipelineError, match="boom"):
            p.pull("out", timeout=10)


def _host_failing(name, fail_at):
    calls = {"n": 0}

    def work(ins):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected upstream fault")
        return [np.asarray(ins[0])]

    spec = TensorsSpec.from_string("16", "float32")
    register_custom_easy(name, work, in_spec=spec, out_spec=spec)
    return ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
            f"tensor_filter framework=custom-easy model={name} name=h ! "
            "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
            "accelerator=true:cpu name=f ! tensor_sink name=out")


def test_error_event_flushes_the_window_first():
    """An upstream stage fails on its 6th buffer: the error event reaches
    the batching stage behind five buffers, which all arrive first."""
    desc = _host_failing("window-upstream-fault", 6)
    p = ntt.Pipeline(desc, queue_capacity=16, batch_max=4, dispatch_depth=4)
    outs = []
    with p:
        src = p.element("src")
        for i, x in enumerate(_frames(8)):
            src.push(ntt.Buffer([x], pts=i))  # raw push: no error re-check
        for _ in range(5):
            outs.append(p.pull("out", timeout=30))
        time.sleep(0.2)
        with pytest.raises(PipelineError, match="injected"):
            p.check()
    assert [o.pts for o in outs] == [0, 1, 2, 3, 4]
    assert not _batching_runner(p)._inflight


def test_poison_terminator_flushes_the_window_first(tmp_path):
    """Under quarantine the failed buffer becomes a poison terminator that
    rides through the batching stage in its place: order holds."""
    desc = _host_failing("window-poison", 4)
    p = ntt.Pipeline(desc, queue_capacity=16, batch_max=4, dispatch_depth=4,
                     quarantine=str(tmp_path))
    frames = _frames(8)
    with p:
        for i, x in enumerate(frames):
            p.push("src", ntt.Buffer([x], pts=i))
        outs = [p.pull("out", timeout=30) for _ in frames]
        p.eos()
        p.wait(timeout=30)
    assert [o.pts for o in outs] == list(range(8))
    poisoned = [o.pts for o in outs if o.meta.get("abort_reason") == "poison"]
    assert poisoned == [3]
    for x, o in zip(frames, outs):
        if o.pts != 3:
            assert np.array_equal(np.asarray(o.tensors[0]), x * 2.0)


def test_restart_delivers_the_window_drops_one_batch_keeps_eos():
    metrics.reset()
    p = ntt.Pipeline(PDESC, queue_capacity=32, batch_max=4, dispatch_depth=2,
                     max_stage_restarts=2)
    runner = _batching_runner(p)
    assert runner.stage.restartable
    el = p.element("f")
    orig = el.process_batch
    failed = []

    def flaky(pad, bufs):  # drains 4 then 3 (+ the EOS carried): the 3 fail once
        if len(bufs) == 3 and not failed:
            failed.append(True)
            raise RuntimeError("injected batch fault")
        return orig(pad, bufs)

    el.process_batch = flaky
    started, release = _gate(el)
    frames = _frames(8)
    with p:
        p.push("src", ntt.Buffer([frames[0]], pts=0))
        assert started.wait(10)
        for i in range(1, 8):
            p.push("src", ntt.Buffer([frames[i]], pts=i))
        p.eos()
        _queued(runner, 8)  # seven buffers and the EOS
        release.set()
        p.wait(timeout=30)  # the carried EOS survived the restart
        outs = []
        while True:
            try:
                outs.append(p.pull("out", timeout=0.5))
            except TimeoutError:
                break
    assert [o.pts for o in outs] == [0, 1, 2, 3, 4]
    snap = metrics.snapshot()
    assert snap["f.restarts"] == 1 and snap["f.dropped"] == 3


# -- batch spans ------------------------------------------------------------------

@pytest.fixture
def recorder():
    tracing.recorder.configure("ring")
    tracing.recorder.clear()
    yield tracing.recorder
    tracing.recorder.configure("off")
    tracing.recorder.clear()


@pytest.mark.parametrize("k", list(range(1, 9)))
def test_batch_span_links_every_row_at_each_occupancy(recorder, k):
    outs, _ = _run_gated(ntt, PDESC, _frames(k + 1), queue_capacity=16,
                         batch_max=8, trace_mode="ring")
    pushed = {o.meta[tracing.META_TRACE_ID] for o in outs}
    assert len(pushed) == k + 1
    covered = set()
    linked_rows = []
    for e in recorder.events():
        if e.kind != "stage" or e.stage != "f":
            continue
        linked = (e.args or {}).get("trace_ids")
        if linked:
            assert len(linked) == e.args["rows"]
            assert e.args["per_row_ns"] * e.args["rows"] <= e.dur + 1
            covered |= set(linked)
            linked_rows.append(e.args["rows"])
        else:
            covered.add(e.tid)
    assert covered == pushed
    assert linked_rows == ([k] if k > 1 else [])
    batch = [e for e in recorder.events() if e.kind == "batch" and e.stage == "f"]
    assert [len(e.args["trace_ids"]) for e in batch] == linked_rows


def test_inflight_span_present_at_depth_above_1(recorder):
    _run_gated(ntt, PDESC, _frames(9), queue_capacity=16, batch_max=4,
               dispatch_depth=2, trace_mode="ring")
    spans = [e for e in recorder.events() if e.kind == "inflight" and e.stage == "f"]
    assert spans and sum(e.args["rows"] for e in spans) == 9


def test_traced_batched_run_equals_untraced(recorder):
    frames = _frames(13)
    traced, _ = _run_gated(ntt, PDESC, frames, queue_capacity=16, batch_max=8,
                           trace_mode="ring")
    recorder.configure("off")
    plain, _ = _run_gated(ntt, PDESC, frames, queue_capacity=16, batch_max=8)
    for a, b in zip(traced, plain):
        assert bytes(np.asarray(a.tensors[0])) == bytes(np.asarray(b.tensors[0]))
        assert a.pts == b.pts


# -- the vision chain under vmap --------------------------------------------------

def test_vmapped_mobilenet_feeds_every_conv_channels_last(monkeypatch):
    """cuDNN keeps its NHWC kernels only for channels_last inputs: under
    torch.func.vmap (the batch folded into N) and unbatched alike, every
    conv of the per-frame chain reads channels_last memory, and the
    vmapped rows' scores equal the per-row calls' within ``TOL`` (another
    batch size may take another conv algorithm: not bitwise)."""
    from torch._C._functorch import get_unwrapped, is_batchedtensor
    from torch.nn import functional as F

    p = ntt.Pipeline(QUICKSTART.format(model="mobilenet_v1", acc="accelerator=true:cpu "))
    [fused] = [s.element for s in p.stages if s.batchable]
    seen = []
    conv = F.conv2d

    def spy(x, w, *a, **k):
        if is_batchedtensor(x):
            phys = get_unwrapped(x).flatten(0, 1)  # [B, N, ...] folded as conv folds it
            seen.append(("vmap", phys.is_contiguous(memory_format=torch.channels_last)))
        else:
            seen.append(("row", x.is_contiguous(memory_format=torch.channels_last)))
        return conv(x, w, *a, **k)

    monkeypatch.setattr(F, "conv2d", spy)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (4, 1, 32, 32, 3), dtype=np.uint8))
    batched = torch.func.vmap(fused.composed)((x,))
    rows = [fused.composed((x[i],)) for i in range(4)]
    for i, (idx, score) in enumerate(rows):
        assert torch.allclose(batched[1][i], score, rtol=TOL, atol=0)
    assert {k for k, _ in seen} == {"vmap", "row"}
    assert len(seen) == 5 * 28 and all(ok for _, ok in seen), seen  # 28 convs a call


# -- the example and the chip script's phase, rehearsed on the CPU ------------------

def test_micro_batching_example_runs_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, str(repo / "examples" / "torch_micro_batching.py"),
                          "--cpu"], cwd=str(repo), env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("quick-start per frame") == 2
    assert "labels equal at batch_max 1 and 8: 64 of 64" in out.stdout
    assert "8 clients answered" in out.stdout


def test_chip_smoke_batching_phase_rehearses_on_the_cpu():
    """The chip script's batching phase at a tiny size on the CPU: every
    check it makes on the card holds here too (bitwise depths and ingress
    forms, batched within tolerance, the refined ladder)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    r = chip_smoke.phase_batching(torch.device("cpu"), size=32, frames_n=40,
                                  acc="accelerator=true:cpu", runs=1)
    assert r["against_unbatched"]["scores_within_tol"] == 40
    assert r["bucket_rows_bitwise"] == 17
    assert all(x["bitwise_equal"] for rs in r["window"].values() for x in rs)
    assert 6 in r["adaptive"]["adaptive"]["ladder"]
    assert r["cell"]["32"][0]["occupancy_max"] > 1
    assert torch._C._functorch._is_vmap_fallback_enabled()


_NORM = "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5"
_VIDEO = f"appsrc name=src caps=other/tensors,dimensions=3:64:64:2,types=uint8 ! {_NORM} ! "
CHAINS = {
    "ssd_device_nms": _VIDEO + "tensor_filter framework=jax model=ssd_mobilenet "
    "custom=size:64,classes:5,batch:2,width:0.25 accelerator=true:cpu ! tensor_decoder "
    "mode=bounding_boxes option1=ssd option3=0.0 option4=64:64 option6=4 option7=device "
    "option9=tensors ! tensor_sink name=out",
    "yolov5s": _VIDEO + "tensor_filter framework=jax model=yolov5s custom=size:64,batch:2,"
    "width:0.25 accelerator=true:cpu ! tensor_decoder mode=bounding_boxes option1=yolov5 "
    "option3=0.0 option4=64:64 option7=device option9=tensors ! tensor_sink name=out",
    "posenet": _VIDEO + "tensor_filter framework=jax model=posenet custom=size:64,batch:2 "
    "accelerator=true:cpu ! tensor_decoder mode=pose_estimation option2=64:64 "
    "option4=tensors ! tensor_sink name=out",
    "deeplab": _VIDEO + "tensor_filter framework=jax model=deeplab_mobilenet custom=size:64,"
    "batch:2,width:0.25 accelerator=true:cpu ! tensor_decoder mode=image_segment "
    "option1=classmap ! tensor_sink name=out",
    "wav2vec2_ctc": "appsrc name=src caps=other/tensors,dimensions=1600:2,types=float32 ! "
    "tensor_filter framework=jax model=wav2vec2 custom=batch:2,samples:1600,dim:32,"
    "n_layers:1 accelerator=true:cpu ! tensor_decoder mode=ctc ! tensor_sink name=out",
    "speech_commands": "appsrc name=src caps=other/tensors,dimensions=16000:2,"
    "types=float32 ! tensor_filter framework=jax model=speech_commands custom=batch:2 "
    "accelerator=true:cpu ! tensor_decoder mode=image_labeling ! tensor_sink name=out",
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_every_fused_model_chain_vmaps(name):
    """Each model family's fused chain is planned batchable, as in the JAX
    package, and vmaps with no per-row fallback: three rows through
    torch.func.vmap equal three per-row calls within ``TOL`` (relative,
    float32; integer outputs exactly)."""
    p = ntt.Pipeline(CHAINS[name], batch_max=4)
    [stage] = [s for s in p.stages if s.element.kind == "fused"]
    assert stage.batchable
    spec = stage.element.chain[0].in_caps["sink"].spec[0]
    rng = np.random.default_rng(0)
    if spec.dtype == np.uint8:
        x = rng.integers(0, 256, (3, *spec.shape), dtype=np.uint8)
    else:
        x = rng.standard_normal((3, *spec.shape)).astype(np.float32)
    x = torch.from_numpy(x)
    batched = torch.func.vmap(stage.element.composed)((x,))
    for i in range(3):
        for b, r in zip(batched, stage.element.composed((x[i],))):
            if r.is_floating_point():
                assert torch.allclose(b[i], r, rtol=TOL, atol=TOL * float(r.abs().max()))
            else:
                assert torch.equal(b[i], r)


def test_vmapped_yolov5s_feeds_every_conv_channels_last(monkeypatch):
    """yolov5s' SAME max-pool pad, its channel concats and its 2x
    upsampling move data on the NHWC view, so under torch.func.vmap, and
    unbatched alike, every one of its convs reads channels_last memory
    (on the NCHW view each of them returned NCHW memory under vmap); the
    vmapped rows equal the per-row calls within ``TOL``, and the
    unbatched output is bitwise the one the NCHW-view forms give."""
    from torch._C._functorch import get_unwrapped, is_batchedtensor
    from torch.nn import functional as F

    from nnstreamer_tpu_torch.models import yolo as tyolo

    b = tzoo.build("yolov5s", {"size": "64", "classes": "5", "batch": "1", "width": "0.25",
                               "dtype": "float32"}, device="cpu")
    fn = functools.partial(b.apply_fn, b.params)
    seen = []
    conv = F.conv2d

    def spy(x, w, *a, **k):
        if is_batchedtensor(x):
            phys = get_unwrapped(x).flatten(0, 1)
            seen.append(("vmap", phys.is_contiguous(memory_format=torch.channels_last)))
        else:
            seen.append(("row", x.is_contiguous(memory_format=torch.channels_last)))
        return conv(x, w, *a, **k)

    monkeypatch.setattr(F, "conv2d", spy)
    x = torch.from_numpy(np.random.default_rng(5).random((3, 1, 64, 64, 3), dtype=np.float32))
    batched = torch.func.vmap(fn)(x)
    rows = [fn(x[i]) for i in range(3)]
    n_conv = len(seen) // 4  # one vmapped call and three rows
    assert n_conv == 60 and {k for k, _ in seen} == {"vmap", "row"}
    assert all(ok for _, ok in seen), [i for i, (_, ok) in enumerate(seen) if not ok]
    for i, r in enumerate(rows):
        assert torch.allclose(batched[i], r, rtol=TOL, atol=TOL)
    monkeypatch.setattr(F, "conv2d", conv)

    def pool_nchw(t, k, stride):
        ph = tyolo.same_pads(t.shape[2], k, stride)
        pw = tyolo.same_pads(t.shape[3], k, stride)
        if any(ph + pw):
            t = F.pad(t, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        return F.max_pool2d(t, k, stride)

    monkeypatch.setattr(tyolo, "_maxpool_same", pool_nchw)
    monkeypatch.setattr(tyolo, "_cat_channels", lambda ts: torch.cat(ts, 1))
    monkeypatch.setattr(tyolo, "_up2", lambda t: t.repeat_interleave(2, dim=2)
                        .repeat_interleave(2, dim=3))
    for i, r in enumerate(rows):
        assert torch.equal(fn(x[i]), r)
