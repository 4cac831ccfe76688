"""Multi-pad collation and the routing elements in the port against the
JAX package's (``nnstreamer_tpu/elements/routing.py``, ``crop.py``,
``pipeline/runtime.py`` ``_try_groups``), on the CPU.

The counterparts of ``tests/test_routing.py`` (mux, demux, merge, split,
tee, crop and every ``sync-mode``), ``tests/test_stress.py`` (order
through tee and join), ``tests/test_parser.py`` (tee and mux pads) and
``tests/test_tracing.py`` / ``tests/test_slo.py`` (tee and collation
spans): each element or pipeline runs in both packages on the same
numpy inputs and the outputs are compared exactly (they are the inputs'
own values, moved).  Then the collation rules: the dead-pad drop count,
stop with a half-made group, an EOS on one pad with data pending on the
other, and ``max-inflight`` bounding what a pad holds.
"""

import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.log import metrics as jmetrics
from nnstreamer_tpu.elements import crop as jcrop
from nnstreamer_tpu.elements import routing as jrouting
from nnstreamer_tpu.pipeline.parser import parse as jparse
from nnstreamer_tpu.utils import tracing as jtracing
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.elements import crop as tcrop
from nnstreamer_tpu_torch.elements import routing as trouting
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.pipeline.parser import parse as tparse
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError
from nnstreamer_tpu_torch.utils import tracing

PKGS = {"jax": (nt, jrouting, jcrop), "port": (ntt, trouting, tcrop)}


@pytest.fixture(autouse=True)
def _clean_state():
    for m, rec in ((metrics, tracing.recorder), (jmetrics, jtracing.recorder)):
        m.reset()
        rec.configure("off")
        rec.clear()
    yield
    for m, rec in ((metrics, tracing.recorder), (jmetrics, jtracing.recorder)):
        rec.configure("off")
        rec.clear()
        m.reset()


def _host(t):
    return t.numpy() if hasattr(t, "numpy") and not isinstance(t, np.ndarray) else np.asarray(t)


def _summary(outs):
    """(pad, pts, tensors as host arrays) per output: what both sides must
    agree on."""
    return [(pad, b.pts, [_host(t) for t in b.tensors]) for pad, b in outs]


def _same(a, b):
    assert len(a) == len(b)
    for (pa, ta, xa), (pb, tb, xb) in zip(a, b):
        assert (pa, ta) == (pb, tb)
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert np.array_equal(u, v)


def _both(fn):
    """fn(pkg, routing, crop) on both packages -> the port's result, after
    checking it equals the JAX package's."""
    j = fn(*PKGS["jax"])
    t = fn(*PKGS["port"])
    _same(_summary(j), _summary(t))
    return t


# -- the elements, held against the JAX package's ----------------------------------

def test_mux_groups():
    def run(pkg, r, _c):
        m = r.TensorMux()
        m.configure({}, ["src"])
        a = pkg.Buffer([np.ones((2, 2), np.float32)], pts=10)
        b = pkg.Buffer([np.zeros((3,), np.int32)], pts=20)
        return m.process_group({"sink_0": a, "sink_1": b})

    outs = _both(run)
    assert len(outs) == 1 and len(outs[0][1].tensors) == 2
    assert outs[0][1].pts == 20  # slowest


@pytest.mark.parametrize("pick,pads", [("1", ["src_0"]), ("", ["src_0", "src_1", "src_2"]),
                                       ("2,0", ["src_0", "src_1"])],
                         ids=["pick", "all", "pick-two"])
def test_demux(pick, pads):
    def run(pkg, r, _c):
        d = r.TensorDemux({"tensorpick": pick} if pick else {})
        d.configure({}, pads)
        buf = pkg.Buffer([np.zeros(2), np.ones(3), np.full(4, 2.0)])
        return d.process("sink", buf)

    outs = _both(run)
    assert [o[0] for o in outs] == pads


@pytest.mark.parametrize("flag", [None, 0, 1, 7, "x"])
def test_demux_by_meta(flag):
    def run(pkg, r, _c):
        d = r.TensorDemux({"by-meta": "spec_draft"})
        d.configure({}, ["src_0", "src_1"])
        buf = pkg.Buffer([np.arange(3)])
        if flag is not None:
            buf.meta["spec_draft"] = flag
        return d.process("sink", buf)

    _both(run)


def test_merge_linear_and_split():
    def merge(pkg, r, _c):
        m = r.TensorMerge({"option": 0})
        m.configure({}, ["src"])
        a = pkg.Buffer([np.ones((2, 3), np.float32)], pts=3)
        b = pkg.Buffer([np.zeros((2, 2), np.float32)], pts=4)
        return m.process_group({"sink_0": a, "sink_1": b})

    def split(pkg, r, _c):
        s = r.TensorSplit({"tensorseg": "2,3", "dim": 0})
        s.configure({}, ["src_0", "src_1"])
        return s.process("sink", pkg.Buffer([np.arange(10, dtype=np.float32).reshape(2, 5)]))

    assert _both(merge)[0][1].tensors[0].shape == (2, 5)
    outs = _both(split)
    np.testing.assert_array_equal(outs[0][1].tensors[0], [[0, 1], [5, 6]])


def test_split_size_mismatch_raises_in_both():
    for pkg, r, _c in PKGS.values():
        s = r.TensorSplit({"tensorseg": "2,2", "dim": 0})
        s.configure({}, ["src_0", "src_1"])
        with pytest.raises(Exception, match="do not cover"):
            s.process("sink", pkg.Buffer([np.zeros((2, 5), np.float32)]))


def test_merge_concatenates_torch_tensors_where_they_lie():
    import torch

    m = trouting.TensorMerge({"option": 1})
    m.configure({}, ["src"])
    a, b = torch.ones(2, 3), torch.zeros(1, 3)
    [(_, out)] = m.process_group({"sink_0": ntt.Buffer([a]), "sink_1": ntt.Buffer([b])})
    assert isinstance(out.tensors[0], torch.Tensor)
    assert torch.equal(out.tensors[0], torch.cat([a, b], 0))


@pytest.mark.parametrize("info", [
    [[2, 3, 4, 5]],
    [[0, 0, 16, 16], [10, 12, 100, 100], [0, 0, 0, 0], [15, 15, 1, 1]],
    [[20, 20, 4, 4]],
], ids=["one", "clipped-and-empty", "outside"])
def test_crop_regions(info):
    raw_arr = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(1, 16, 16, 3)

    def run(pkg, _r, c):
        el = c.TensorCrop()
        el.configure({}, ["src"])
        raw = pkg.Buffer([raw_arr])
        return el.process_group({"sink_0": raw,
                                 "sink_1": pkg.Buffer([np.array(info, np.uint32)])})

    [(_, out)] = _both(run)
    assert len(out.tensors) == len(info)
    x, y, w, h = info[0]
    np.testing.assert_array_equal(out.tensors[0], raw_arr[0, y:y + h, x:x + w])
    # a copy, never a view of the frame
    assert not any(np.shares_memory(t, raw_arr) for t in out.tensors)


# -- sync modes: the same scripts through both packages' elements -----------------

def _script(kind, props, pads, steps):
    """Push ``steps`` ((pad, value, pts) or "finalize") through both
    packages' element -> the port's outputs, per step, checked equal."""
    results = {}
    for name, (pkg, r, _c) in PKGS.items():
        el = getattr(r, kind)(dict(props))
        el.configure({p: pkg.Caps.any() for p in pads}, ["src"])
        got = []
        for st in steps:
            if st == "finalize":
                got.append(el.finalize())
            else:
                pad, val, pts = st
                n = 3 if pad == "sink_1" and kind == "TensorMerge" else 2
                got.append(el.process(pad, pkg.Buffer([np.full((n,), val, np.float32)],
                                                      pts=pts)))
        results[name] = got
    for j, t in zip(results["jax"], results["port"]):
        _same(_summary(j), _summary(t))
    return results["port"]


def _vals(outs):
    return [(b.pts, [float(_host(t).ravel()[0]) for t in b.tensors]) for _, b in outs]


TWO = ["sink_0", "sink_1"]


def test_basepad_base_drives():
    got = _script("TensorMux", {"sync_mode": "basepad", "sync_option": "0"}, TWO, [
        ("sink_0", 1.0, 10), ("sink_1", 9.0, 12), ("sink_0", 2.0, 20),
        ("sink_1", 10.0, 21), ("sink_1", 11.0, 22), ("sink_0", 3.0, 30)])
    assert got[0] == [] and _vals(got[1]) == [(10, [1.0, 9.0])]
    assert _vals(got[2]) == [(20, [2.0, 9.0])]
    assert got[3] == [] and got[4] == []
    assert _vals(got[5]) == [(30, [3.0, 11.0])]  # latest wins


def test_basepad_duration_window_enforced():
    got = _script("TensorMux", {"sync_mode": "basepad", "sync_option": "0:5"}, TWO, [
        ("sink_1", 7.0, 2), ("sink_0", 1.0, 10), ("sink_1", 8.0, 4),
        ("sink_1", 9.0, 6), ("sink_0", 2.0, 11)])
    assert got[:3] == [[], [], []]
    assert _vals(got[3]) == [(10, [1.0, 9.0])]
    assert _vals(got[4]) == [(11, [2.0, 9.0])]


def test_basepad_duration_window_eos_flush():
    got = _script("TensorMux", {"sync_mode": "basepad", "sync_option": "0:5"}, TWO, [
        ("sink_1", 7.0, 0), ("sink_0", 1.0, 10), ("sink_0", 2.0, 20),
        "finalize", "finalize"])
    assert got[:3] == [[], [], []]
    assert _vals(got[3]) == [(10, [1.0, 7.0]), (20, [2.0, 7.0])]
    assert got[4] == []  # idempotent


def test_basepad_evicts_past_its_hold_and_counts():
    steps = [("sink_1", 0.0, 0)] + [("sink_0", float(i), 100 + i)
                                     for i in range(trouting.BASEPAD_HOLD + 3)]
    _script("TensorMux", {"sync_mode": "basepad", "sync_option": "0:5"}, TWO, steps)
    assert metrics.snapshot()["tensor_mux.basepad_evicted"] == 3
    assert jmetrics.snapshot()["tensor_mux.basepad_evicted"] == 3


def test_single_pad_slowest_process_passthrough():
    got = _script("TensorMux", {}, ["sink_0"], [("sink_0", 5.0, 7)])
    assert _vals(got[0]) == [(7, [5.0])]


def test_refresh_any_pad_triggers():
    got = _script("TensorMux", {"sync_mode": "refresh"}, TWO, [
        ("sink_0", 1.0, 10), ("sink_1", 5.0, 11), ("sink_0", 2.0, 20),
        ("sink_1", 6.0, 21)])
    assert got[0] == []
    assert [_vals(g) for g in got[1:]] == [[(11, [1.0, 5.0])], [(20, [2.0, 5.0])],
                                          [(21, [2.0, 6.0])]]


def test_merge_basepad():
    got = _script("TensorMerge", {"option": "0", "sync_mode": "basepad",
                                  "sync_option": "1"}, TWO,
                  [("sink_0", 0.0, 5), ("sink_1", 1.0, 7)])
    assert got[0] == [] and got[1][0][1].pts == 7
    assert got[1][0][1].tensors[0].shape == (5,)


@pytest.mark.parametrize("kind", ["TensorMux", "TensorMerge"])
def test_bad_sync_mode_rejected(kind):
    for _pkg, r, _c in PKGS.values():
        with pytest.raises(Exception, match="sync-mode"):
            getattr(r, kind)({"sync_mode": "nope"})


# -- pipelines, run in both packages ----------------------------------------------

def _pull_all(p, sinks, n, timeout=30):
    return {s: [p.pull(s, timeout=timeout) for _ in range(n)] for s in sinks}


def _run_both(desc, drive, **kw):
    """``drive(pkg, pipeline)`` -> a list of buffers, in both packages;
    the port's list, checked equal to the JAX package's."""
    got = {}
    for name, (pkg, _r, _c) in PKGS.items():
        p = pkg.Pipeline(desc, **kw)
        with p:
            got[name] = drive(pkg, p)
            p.eos()
            p.wait(timeout=30)
    _same(_summary([("", b) for b in got["jax"]]), _summary([("", b) for b in got["port"]]))
    return got["port"]


def test_mux_pipeline_e2e():
    desc = ("tensor_mux name=m ! tensor_sink name=out "
            "videotestsrc num-buffers=2 width=4 height=4 ! tensor_converter ! m.sink_0 "
            "videotestsrc num-buffers=2 width=2 height=2 ! tensor_converter ! m.sink_1")
    [b, _] = _run_both(desc, lambda pkg, p: _pull_all(p, ["out"], 2)["out"])
    assert [t.shape for t in b.tensors] == [(1, 4, 4, 3), (1, 2, 2, 3)]


def test_merge_split_roundtrip_pipeline():
    desc = ("appsrc name=src ! tensor_split tensorseg=2,2 dim=1 name=sp "
            "sp.src_0 ! tensor_sink name=a sp.src_1 ! tensor_sink name=b")
    x = np.arange(16, dtype=np.float32).reshape(4, 4)

    def drive(pkg, p):
        p.push("src", x)
        return [p.pull("a", timeout=10), p.pull("b", timeout=10)]

    a, b = _run_both(desc, drive)
    np.testing.assert_array_equal(np.concatenate([a.tensors[0], b.tensors[0]], axis=0), x)


def test_split_then_merge_restores_the_tensor():
    desc = ("appsrc name=src caps=other/tensors,dimensions=6:3,types=float32 ! "
            "tensor_split name=sp tensorseg=2,4 dim=0 "
            "sp.src_0 ! m.sink_0 sp.src_1 ! m.sink_1 "
            "tensor_merge name=m option=0 ! tensor_sink name=out")
    xs = [np.random.default_rng(i).normal(size=(3, 6)).astype(np.float32) for i in range(4)]

    def drive(pkg, p):
        for i, x in enumerate(xs):
            p.push("src", pkg.Buffer([x], pts=i))
        return [p.pull("out", timeout=10) for _ in xs]

    outs = _run_both(desc, drive)
    for x, b in zip(xs, outs):
        np.testing.assert_array_equal(b.tensors[0], x)


def test_demux_pipeline_tensorpick():
    desc = ("appsrc name=src ! tensor_demux name=d tensorpick=2,0 "
            "d.src_0 ! tensor_sink name=a d.src_1 ! tensor_sink name=b")

    def drive(pkg, p):
        p.push("src", [np.zeros(2, np.float32), np.ones(3, np.int32), np.full(4, 2.0)])
        return [p.pull("a", timeout=10), p.pull("b", timeout=10)]

    a, b = _run_both(desc, drive)
    np.testing.assert_array_equal(a.tensors[0], np.full(4, 2.0))
    np.testing.assert_array_equal(b.tensors[0], np.zeros(2, np.float32))


def test_tee_pipeline():
    desc = ("videotestsrc num-buffers=2 width=4 height=4 ! tensor_converter ! "
            "tee name=t t. ! tensor_sink name=a t. ! tensor_sink name=b")

    def drive(pkg, p):
        got = _pull_all(p, ["a", "b"], 2)
        return got["a"] + got["b"]

    outs = _run_both(desc, drive)
    np.testing.assert_array_equal(outs[0].tensors[0], outs[2].tensors[0])


def test_refresh_pipeline_uneven_rates():
    desc = ("tensor_mux name=m sync-mode=refresh ! tensor_sink name=out "
            "appsrc name=fast ! m.sink_0 appsrc name=slow ! m.sink_1")

    def drive(pkg, p):
        p.push("slow", np.full((1,), -1.0, np.float32))
        time.sleep(0.3)  # the slow buffer lands before the fast burst
        for i in range(3):
            p.push("fast", np.full((1,), float(i), np.float32))
        return [p.pull("out", timeout=15) for _ in range(3)]

    got = _run_both(desc, drive, fuse=False)
    assert [(b.tensors[0][0], b.tensors[1][0]) for b in got] == \
        [(0.0, -1.0), (1.0, -1.0), (2.0, -1.0)]


def test_ordering_preserved_through_tee_and_join():
    """tee fan-out -> join keeps each branch's order (tests/test_stress.py)."""
    desc = ("appsrc name=src ! tee name=t "
            "t. ! tensor_transform mode=arithmetic option=typecast:float32,mul:1.0 ! join name=j "
            "t. ! tensor_transform mode=arithmetic option=typecast:float32,mul:-1.0 ! j. "
            "j. ! tensor_sink name=out")
    n = 30
    for pkg, _r, _c in PKGS.values():
        p = pkg.Pipeline(desc, queue_capacity=4)
        with p:
            for i in range(n):
                p.push("src", np.full((4,), i + 1, np.int16))
            got = [float(np.asarray(p.pull("out", timeout=60).tensors[0])[0])
                   for _ in range(2 * n)]
            p.eos()
            p.wait(timeout=30)
        assert [v for v in got if v > 0] == [float(i + 1) for i in range(n)]
        assert [v for v in got if v < 0] == [-float(i + 1) for i in range(n)]


@pytest.mark.parametrize("desc", [
    "videotestsrc ! tee name=t t. ! tensor_converter ! tensor_sink name=a "
    "t. ! tensor_converter ! tensor_sink name=b",
    "tensor_mux name=m ! tensor_sink name=out videotestsrc ! tensor_converter ! m.sink_0 "
    "videotestsrc ! tensor_converter ! m.sink_1",
    "tensor_mux name=m ! tensor_sink videotestsrc ! tensor_converter ! m. "
    "videotestsrc ! tensor_converter ! m.",
], ids=["tee", "mux-named", "mux-auto"])
def test_parser_pads_equal_jax(desc):
    j, t = jparse(desc), tparse(desc)
    edges = lambda g: sorted((g.nodes[e.src].kind, e.src_pad, g.nodes[e.dst].kind, e.dst_pad)
                             for e in g.edges)
    assert edges(j) == edges(t)
    name = "t" if "tee" in desc else "m"
    node = t.by_name[name]
    pads = ({e.src_pad for e in t.out_edges(node.id)} if name == "t"
            else {e.dst_pad for e in t.in_edges(node.id)})
    assert pads == ({"src_0", "src_1"} if name == "t" else {"sink_0", "sink_1"})


# -- collation rules: drops, EOS, stop, backpressure --------------------------------

MUX2 = ("appsrc name=a caps=other/tensors,dimensions=4,types=float32 ! mux.sink_0 "
        "appsrc name=b caps=other/tensors,dimensions=4,types=float32 ! mux.sink_1 "
        "tensor_mux name=mux ! tensor_sink name=out")


def test_dead_pad_drop_count_equals_jax():
    """Three buffers on pad 0, one on pad 1, then EOS: one group, and the
    two that can never pair are dropped and counted in ``mux.dropped``."""
    x = np.ones((4,), np.float32)
    for (pkg, _r, _c), m in ((PKGS["jax"], jmetrics), (PKGS["port"], metrics)):
        p = pkg.Pipeline(MUX2)
        with p:
            for i in range(3):
                p.push("a", pkg.Buffer([x * i], pts=i))
            p.push("b", pkg.Buffer([x * 10], pts=0))
            out = p.pull("out", timeout=15)
            p.eos()
            p.wait(timeout=15)
        assert [float(np.asarray(t)[0]) for t in out.tensors] == [0.0, 10.0]
        assert m.snapshot()["mux.dropped"] == 2
        assert m.snapshot()["mux.out"] == 1


def test_eos_on_one_pad_pairs_what_is_pending_then_ends():
    """Pad 1 reaches EOS with pad 0's buffers still to come: the queued
    ones still pair, then the pipeline ends without a hang."""
    x = np.ones((4,), np.float32)
    p = ntt.Pipeline(MUX2)
    with p:
        for i in range(2):
            p.push("b", ntt.Buffer([x * (10 + i)], pts=i))
        p.eos("b")
        time.sleep(0.1)
        for i in range(3):
            p.push("a", ntt.Buffer([x * i], pts=i))
        got = [p.pull("out", timeout=15) for _ in range(2)]
        p.eos("a")
        p.wait(timeout=15)
    assert [[float(t[0]) for t in b.tensors] for b in got] == [[0.0, 10.0], [1.0, 11.0]]
    assert metrics.snapshot()["mux.dropped"] == 1


def test_stop_wakes_a_stage_holding_a_half_made_group():
    p = ntt.Pipeline(MUX2)
    p.start()
    p.push("a", np.ones((4,), np.float32))
    runner = [r for r in p._unique_runners() if r.element.name == "mux"][0]
    deadline = time.monotonic() + 10
    while not runner._pending.get("sink_0") and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(runner._pending["sink_0"]) == 1
    t0 = time.monotonic()
    p.stop()
    assert time.monotonic() - t0 < 5.0
    assert not any(r.thread.is_alive() for r in p._unique_runners())


def test_collator_never_batches():
    p = ntt.Pipeline(MUX2, batch_max=8)
    [runner] = [r for r in p._unique_runners() if r.element.name == "mux"]
    with p:
        for i in range(5):
            p.push("a", np.full((4,), i, np.float32))
            p.push("b", np.full((4,), -i, np.float32))
        got = [p.pull("out", timeout=15) for _ in range(5)]
        p.eos()
        p.wait(timeout=15)
    assert [float(b.tensors[1][0]) for b in got] == [0.0, -1.0, -2.0, -3.0, -4.0]
    assert "mux.batch_occupancy" not in metrics.snapshot()
    assert runner._pending_peak >= 1


def test_max_inflight_bounds_the_pending_frames():
    """The frame pad runs ahead of the slow info pad; appsrc max-inflight
    bounds how far, so ``_pending`` never holds more than that."""
    spec = TensorsSpec.from_string("4", "float32")

    def slow(ins):
        time.sleep(0.02)
        return [ins[0] * 2]

    register_custom_easy("slow_double", slow, spec, spec)
    desc = ("appsrc name=src caps=other/tensors,dimensions=4,types=float32 max-inflight=3 ! "
            "tee name=t t. ! tensor_filter framework=custom-easy model=slow_double ! "
            "mux.sink_1 t. ! mux.sink_0 "
            "tensor_mux name=mux ! tensor_sink name=out")
    p = ntt.Pipeline(desc)
    [runner] = [r for r in p._unique_runners() if r.element.name == "mux"]
    n = 20
    with p:
        def push():
            for i in range(n):
                p.push("src", np.full((4,), float(i), np.float32))

        th = threading.Thread(target=push)
        th.start()
        got = [p.pull("out", timeout=30) for _ in range(n)]
        th.join(timeout=30)
        p.eos()
        p.wait(timeout=30)
    assert not th.is_alive()
    assert [(float(b.tensors[0][0]), float(b.tensors[1][0])) for b in got] == \
        [(float(i), 2.0 * i) for i in range(n)]
    assert runner._pending_peak <= 3


def test_a_poison_terminator_is_paired_not_forwarded():
    """A collator pairs every buffer, poison terminators included, so its
    pads never shift against each other (the runtime's rule)."""
    from nnstreamer_tpu_torch.core.meta_keys import META_POISON

    p = ntt.Pipeline(MUX2)
    with p:
        for i in range(4):
            b = ntt.Buffer([np.full((4,), i, np.float32)], pts=i)
            if i == 1:
                b.meta[META_POISON] = True
            p.push("a", b)
            p.push("b", ntt.Buffer([np.full((4,), -i, np.float32)], pts=i))
        got = [p.pull("out", timeout=15) for _ in range(4)]
        p.eos()
        p.wait(timeout=15)
    assert [(float(b.tensors[0][0]), float(b.tensors[1][0])) for b in got] == \
        [(float(i), -float(i)) for i in range(4)]


# -- tracing: tee fan-out and collation spans -------------------------------------

def test_tee_fanout_shares_trace_id():
    desc = ("videotestsrc num-buffers=2 width=4 height=4 ! tensor_converter ! "
            "tee name=t t. ! tensor_sink name=a t. ! tensor_sink name=b")
    for (pkg, _r, _c), tr in ((PKGS["jax"], jtracing), (PKGS["port"], tracing)):
        p = pkg.Pipeline(desc, trace_mode="ring")
        with p:
            a = p.pull("a", timeout=15)
            b = p.pull("b", timeout=15)
            p.wait(timeout=15)
        assert a.meta[tr.META_TRACE_ID] == b.meta[tr.META_TRACE_ID]
        assert {e.stage for e in tr.recorder.events() if e.kind == "e2e"} == {"a", "b"}


def test_tee_branches_each_get_exact_queue_spans():
    n = 4
    desc = (f"videotestsrc num-buffers={n} width=4 height=4 ! tensor_converter ! "
            "tee name=t t. ! tensor_sink name=a t. ! tensor_sink name=b")
    counts = {}
    for name, tr in (("jax", jtracing), ("port", tracing)):
        pkg = PKGS[name][0]
        p = pkg.Pipeline(desc, trace_mode="ring")
        with p:
            for _ in range(n):
                p.pull("a", timeout=15)
                p.pull("b", timeout=15)
            p.wait(timeout=15)
        spans = [e for e in tr.recorder.events() if e.kind == "queue" and e.stage in ("a", "b")]
        assert all(e.dur >= 0 for e in spans)
        counts[name] = sorted((e.stage for e in spans))
    assert counts["port"] == counts["jax"] == ["a"] * n + ["b"] * n


def test_collator_links_member_trace_ids():
    x = np.ones((4,), np.float32)
    for (pkg, _r, _c), tr in ((PKGS["jax"], jtracing), (PKGS["port"], tracing)):
        p = pkg.Pipeline(MUX2, trace_mode="ring")
        with p:
            p.push("a", x)
            p.push("b", 2 * x)
            out = p.pull("out", timeout=15)
            p.eos()
            p.wait(timeout=15)
        ev = tr.recorder.events()
        ing = {e.stage: e.tid for e in ev if e.kind == "ingress"}
        assert set(ing) == {"a", "b"}
        spans = [e for e in ev if e.kind == "stage" and e.stage == "mux"
                 and e.args and e.args.get("trace_ids")]
        assert spans and set(spans[0].args["trace_ids"]) == set(ing.values())
        assert out.meta[tr.META_TRACE_ID] in ing.values()


def test_fakesink_counts_and_releases_credits():
    desc = ("appsrc name=src max-inflight=2 ! tee name=t t. ! fakesink name=devnull "
            "t. ! tensor_sink name=out")
    for pkg, _r, _c in PKGS.values():
        p = pkg.Pipeline(desc)
        with p:
            for i in range(6):  # past max-inflight: the fakesink frees credits
                p.push("src", np.full((2,), i, np.float32))
            p.eos()
            p.wait(timeout=15)
        assert p.element("devnull").count == 6
        assert float(np.asarray(p.element("devnull").last.tensors[0])[0]) == 5.0


def test_unknown_routing_property_rejected():
    with pytest.raises(PipelineError, match="unknown element properties"):
        ntt.Pipeline("appsrc name=src ! tee name=t bogus=1 t. ! tensor_sink").start()
