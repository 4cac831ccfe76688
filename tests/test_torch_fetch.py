"""The sink's fetch window in the port against the JAX package's
(``nnstreamer_tpu/elements/sink.py``, ``tests/test_fetch.py``), on the
CPU: up to ``fetch_depth`` buffers resolve on a pool while pop() returns
them in FIFO order; EOS and stage errors deliver what was admitted
before them; the ``fetch.window`` span and ``<sink>.fetch_window`` gauge.
Outputs are compared with the JAX pipeline's on the same inputs (f32
scaling: exact).  Ingress donation: the planner's ownership flags equal
the JAX package's, and outputs are bitwise equal with it on and off."""

import random
import time

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.config import get_config
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError
from nnstreamer_tpu_torch.utils import tracing

DIMS = 16
DESC = (f"appsrc name=src caps=other/tensors,dimensions={DIMS},types=float32 ! "
        "tensor_transform mode=arithmetic option=typecast:float32,add:1.0 ! "
        f"tensor_filter framework=jax model=scaler custom=scale:2.0,dims:{DIMS} "
        "{acc} name=f ! tensor_sink name=out")
PORT_DESC = DESC.format(acc="accelerator=true:cpu")


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(DIMS,)).astype(np.float32) for _ in range(n)]


def _run(pkg, desc, frames, **kw):
    p = pkg.Pipeline(desc, **kw)
    with p:
        for i, x in enumerate(frames):
            p.push("src", pkg.Buffer([x], pts=i))
        outs = [p.pull("out", timeout=60) for _ in frames]
        p.eos()
        p.wait(timeout=60)
    return outs, p


def test_window_keeps_fifo_order_under_random_delays(monkeypatch):
    real = Buffer.to_host
    rng = random.Random(7)

    def slow(self):
        time.sleep(rng.random() * 0.004)
        return real(self)

    monkeypatch.setattr(Buffer, "to_host", slow)
    frames = _frames(24)
    outs, p = _run(ntt, PORT_DESC, frames, fetch_depth=4)
    assert [o.pts for o in outs] == list(range(24))
    want, _ = _run(nt, DESC.format(acc=""), frames)
    for o, w in zip(outs, want):
        assert np.array_equal(np.asarray(o.tensors[0]), np.asarray(w.tensors[0]))
    assert p.element("out")._win_peak >= 1


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_depths_give_the_same_outputs(depth):
    """Depth 1 and deeper windows: bitwise the same outputs, in order, and
    the JAX pipeline's."""
    frames = _frames(12, seed=1)
    outs, _ = _run(ntt, PORT_DESC, frames, fetch_depth=depth)
    ref, _ = _run(ntt, PORT_DESC, frames, fetch_depth=1)
    want, _ = _run(nt, DESC.format(acc=""), frames, fetch_depth=depth)
    for o, r, w in zip(outs, ref, want):
        assert np.array_equal(o.tensors[0], r.tensors[0])
        assert np.array_equal(o.tensors[0], np.asarray(w.tensors[0]))
    assert [o.pts for o in outs] == list(range(12))


def test_depth_resolution_prop_beats_pipeline_beats_config():
    el = TensorSink({"fetch_depth": 5})
    assert el.fetch_depth == 5
    el2 = TensorSink({})
    el2._fetch_depth = 3  # what the runtime attaches from the pipeline knob
    assert el2.fetch_depth == 3
    el3 = TensorSink({})
    assert el3.fetch_depth == max(1, get_config().fetch_depth) == 2
    p = ntt.Pipeline(PORT_DESC.replace("tensor_sink name=out",
                                       "tensor_sink name=out fetch-depth=6"),
                     fetch_depth=3)
    assert p.fetch_depth == 3 and p.element("out").fetch_depth == 6
    p2 = ntt.Pipeline(PORT_DESC, fetch_depth=3)
    assert p2.element("out").fetch_depth == 3


def test_eos_flushes_the_window():
    """Buffers admitted before EOS are all delivered after wait()."""
    n = 12
    p = ntt.Pipeline(PORT_DESC, fetch_depth=2)
    with p:
        for i, x in enumerate(_frames(n)):
            p.push("src", ntt.Buffer([x], pts=i))
        p.eos()
        p.wait(timeout=60)
        outs = [p.pull("out", timeout=30) for _ in range(n)]
    assert [o.pts for o in outs] == list(range(n))


def test_stage_error_still_delivers_the_window_before_it():
    calls = {"n": 0}

    def boom(ins):
        calls["n"] += 1
        if calls["n"] > 4:
            raise RuntimeError("deliberate stage failure")
        return [np.asarray(ins[0]) * 2.0]

    spec = TensorsSpec.from_string(str(DIMS), "float32")
    register_custom_easy("fetch-boom-port", boom, in_spec=spec, out_spec=spec)
    p = ntt.Pipeline(
        f"appsrc name=src caps=other/tensors,dimensions={DIMS},types=float32 ! "
        "tensor_filter framework=custom-easy model=fetch-boom-port name=f ! "
        "tensor_transform mode=arithmetic option=typecast:float32,add:0.0 ! "
        "tensor_sink name=out", fetch_depth=2)
    outs = []
    with p:
        src = p.element("src")
        for i, x in enumerate(_frames(8)):
            src.push(ntt.Buffer([x], pts=i))  # raw push: no error re-check
        for _ in range(4):
            outs.append(p.pull("out", timeout=30))
        time.sleep(0.3)
        with pytest.raises(PipelineError):
            p.check()
    assert [o.pts for o in outs] == [0, 1, 2, 3]


def test_failed_resolution_raises_and_frees_its_credit(monkeypatch):
    """A resolution that raises reaches the app's pop() and releases the
    buffer's appsrc admission credit, so a max-inflight=1 source keeps
    admitting."""
    real = Buffer.to_host
    state = {"n": 0}

    def flaky(self):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("fetch fault")
        return real(self)

    monkeypatch.setattr(Buffer, "to_host", flaky)
    p = ntt.Pipeline(PORT_DESC.replace("appsrc name=src", "appsrc name=src max-inflight=1"),
                     fetch_depth=2)
    with p:
        p.push("src", ntt.Buffer([_frames(1)[0]], pts=0))
        with pytest.raises(RuntimeError, match="fetch fault"):
            p.pull("out", timeout=30)
        p.push("src", ntt.Buffer([_frames(1)[0]], pts=1))
        assert p.pull("out", timeout=30).pts == 1
        p.eos()
        p.wait(timeout=30)


def test_materialization_timeout_carries_trace_id(monkeypatch):
    real = Buffer.to_host

    def very_slow(self):
        time.sleep(1.0)
        return real(self)

    monkeypatch.setattr(Buffer, "to_host", very_slow)
    p = ntt.Pipeline(PORT_DESC, fetch_depth=2, trace_mode="ring")
    with p:
        p.push("src", ntt.Buffer([_frames(1)[0]], pts=0))
        sink = p.element("out")
        deadline = time.monotonic() + 30.0
        while sink._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(TimeoutError, match="trace id"):
            p.pull("out", timeout=0.25)
        # the buffer was kept: the next pop delivers it
        assert p.pull("out", timeout=30).pts == 0
        p.eos()
        p.wait(timeout=30)


def test_window_span_and_gauge():
    tracing.recorder.configure("ring")
    tracing.recorder.clear()
    try:
        outs, p = _run(ntt, PORT_DESC, _frames(8), fetch_depth=2, trace_mode="ring")
        spans = [e for e in tracing.recorder.events() if e.kind == "fetch.window"]
        assert len(spans) == 8
        assert all(e.args and e.args.get("depth", 0) >= 1 for e in spans)
        fetch = [e for e in tracing.recorder.events()
                 if e.kind == "fetch" and e.stage == "out"]
        assert len(fetch) == 8
        deadline = time.monotonic() + 10  # done callbacks run after results
        while metrics.gauges()["out.fetch_window"] != 0.0:
            assert time.monotonic() < deadline, "the window never drained"
            time.sleep(0.01)
        assert metrics.gauges()["out.fetch_window_peak"] >= 1.0
        assert "out.d2h_wait_ms" in metrics.snapshot()
    finally:
        tracing.recorder.configure("off")
        tracing.recorder.clear()


def test_callbacks_and_host_buffers_bypass_the_window():
    """A sink with callbacks resolves in its own thread, and a buffer with
    nothing but host arrays has nothing to overlap: neither opens the
    pool."""
    p = ntt.Pipeline("appsrc name=src ! tensor_sink name=out")
    with p:
        p.push("src", np.ones((4,), np.float32))
        assert p.pull("out", timeout=30).tensors[0].shape == (4,)
        p.eos()
        p.wait(timeout=30)
    assert p.element("out")._pool is None
    got = []
    p2 = ntt.Pipeline(PORT_DESC)
    p2.element("out").connect_new_data(got.append)
    with p2:
        p2.push("src", ntt.Buffer([_frames(1)[0]], pts=0))
        p2.pull("out", timeout=30)
        p2.eos()
        p2.wait(timeout=30)
    assert len(got) == 1 and p2.element("out")._pool is None


@pytest.mark.parametrize("model,custom,shape", [
    ("passthrough", "dims:3:4:4:2", (2, 4, 4, 3)),
    ("scaler", "scale:3.5,dims:3:4:4:2", (2, 4, 4, 3)),
    ("average", "dims:3:4:4:2", (2, 4, 4, 3)),
])
@pytest.mark.parametrize("fuse", [True, False])
def test_test_models_equal_jax(model, custom, shape, fuse):
    """The test models behind a sink, through both packages on the same
    inputs: passthrough and scaler exactly, average (a float32 mean) within
    1e-6 of the JAX package's."""
    rng = np.random.default_rng(2)
    frames = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    desc = (f"appsrc name=src ! tensor_filter framework=jax model={model} "
            f"custom={custom} {{acc}} ! tensor_sink name=out")
    outs = []
    for pkg, acc in ((ntt, "accelerator=true:cpu"), (nt, "")):
        p = pkg.Pipeline(desc.format(acc=acc), fuse=fuse)
        with p:
            for i, x in enumerate(frames):
                p.push("src", pkg.Buffer([x], pts=i))
            outs.append([np.asarray(p.pull("out", timeout=60).tensors[0])
                         for _ in frames])
            p.eos()
            p.wait(timeout=60)
    for got, want in zip(*outs):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if model == "average" else 0)


# -- ingress donation ----------------------------------------------------------------

def _fused_stages(p):
    return [s.element for s in p.stages if s.element.kind == "fused"]


def test_ingress_donation_planned_and_bit_identical():
    frames = _frames(6, seed=4)
    outs = {}
    for flag in (True, False):
        p = ntt.Pipeline(PORT_DESC, donate_ingress=flag, batch_max=4)
        jp = nt.Pipeline(DESC.format(acc=""), donate_ingress=flag)
        [fused], [jfused] = _fused_stages(p), _fused_stages(jp)
        assert fused._ingress_put is flag and fused._donate is flag
        assert (fused._ingress_put, fused._donate) == (jfused._ingress_put,
                                                       jfused._donate)
        outs[flag], _ = _run(ntt, PORT_DESC, frames, donate_ingress=flag)
    want, _ = _run(nt, DESC.format(acc=""), frames)
    for a, b, w in zip(outs[True], outs[False], want):
        assert bytes(np.asarray(a.tensors[0])) == bytes(np.asarray(b.tensors[0]))
        assert np.array_equal(np.asarray(a.tensors[0]), np.asarray(w.tensors[0]))


def test_donation_off_by_config(monkeypatch):
    monkeypatch.setattr(get_config(), "donate_ingress", False)
    [fused] = _fused_stages(ntt.Pipeline(PORT_DESC))
    assert not fused._ingress_put


def test_device_source_fold_keeps_plain_donation():
    """The folded device source owns its frames (``_donate``) without the
    host ingress path, as in the JAX package."""
    desc = ("videotestsrc device=true batch=2 num-buffers=4 width=16 height=16 "
            "name=src ! tensor_transform mode=arithmetic option=typecast:float32,"
            "div:255.0 ! tensor_filter framework=jax model=scaler "
            "custom=scale:2.0,dims:3:16:16:2 {acc}! tensor_sink name=out")
    p = ntt.Pipeline(desc.format(acc="accelerator=true:cpu "), donate_ingress=True)
    jp = nt.Pipeline(desc.format(acc=""), donate_ingress=True)
    folded = [s.element for s in p.stages if getattr(s.element, "fused", None)]
    jfolded = [s.element for s in jp.stages if getattr(s.element, "fused", None)]
    assert folded and jfolded
    assert folded[0].fused._donate and not folded[0].fused._ingress_put
    assert (folded[0].fused._donate, folded[0].fused._ingress_put) == \
        (jfolded[0].fused._donate, jfolded[0].fused._ingress_put)
    assert not any(s.batchable for s in p.stages)


TEE_DESC = (f"appsrc name=src caps=other/tensors,dimensions={DIMS},types=float32 ! "
            "tee name=t t. ! tensor_transform mode=arithmetic option=typecast:float32,"
            f"add:1.0 ! tensor_filter framework=jax model=scaler custom=scale:2.0,dims:{DIMS} "
            "{acc} name=f ! tensor_sink name=out t. ! fakesink name=devnull")


@pytest.mark.parametrize("graph", ["hand-built", "tee"])
def test_donation_vetoed_without_sole_consumer(graph):
    """A host source with a second consumer does not hand its frames to
    the chain: a graph given a second sink by hand, and the JAX package's
    own case (``tests/test_fetch.py``), a source feeding a tee with a
    ``fakesink`` on its other branch, whose chain then runs as before and
    whose frames stay untouched."""
    from nnstreamer_tpu_torch.pipeline.plan import plan_stages

    if graph == "hand-built":
        p = ntt.Pipeline(PORT_DESC, donate_ingress=True)
        [fused] = _fused_stages(p)
        assert fused._ingress_put
        graph = p.graph
        src = graph.nodes[p.stages[0].node_ids[0]]
        extra = graph.add("tensor_sink", {"name": "devnull"})
        graph.link(src, extra)
        elements = dict(p.elements)
        elements[extra.id] = TensorSink({}, name="devnull")
        stages = plan_stages(graph, elements, donate_ingress=True)
        [vetoed] = [s.element for s in stages if s.element.kind == "fused"]
        assert not vetoed._ingress_put and not vetoed._donate
        assert [s.batchable for s in stages if s.element.kind == "fused"] == [True]
        return
    jp = nt.Pipeline(TEE_DESC.format(acc=""), donate_ingress=True)
    p = ntt.Pipeline(TEE_DESC.format(acc="accelerator=true:cpu"), donate_ingress=True)
    [fused] = _fused_stages(p)
    [jfused] = _fused_stages(jp)
    assert (fused._donate, fused._ingress_put) == (jfused._donate, jfused._ingress_put) \
        == (False, False)
    frames = _frames(6, seed=3)
    kept = [x.copy() for x in frames]
    want, _ = _run(nt, DESC.format(acc=""), frames)
    with p:
        for i, x in enumerate(frames):
            p.push("src", ntt.Buffer([x], pts=i))
        outs = [p.pull("out", timeout=60) for _ in frames]
        p.eos()
        p.wait(timeout=60)
    assert p.element("devnull").count == len(frames)
    for x, k, o, w in zip(frames, kept, outs, want):
        assert np.array_equal(x, k)
        assert np.array_equal(np.asarray(o.tensors[0]), np.asarray(w.tensors[0]))
