"""``tensor_if``, ``tensor_rateadjust``, ``tensor_reposink`` /
``tensor_reposrc``, ``tensor_sparse_enc`` / ``_dec``, ``tensor_debug`` and
the host ``tensor_aggregator`` cases of ``tests/test_routing.py`` in the
port against the JAX package's (``nnstreamer_tpu/elements/cond.py``,
``rate.py``, ``repo.py``, ``sparse.py``, ``debug.py``,
``aggregator.py``), on the CPU.

Each case gives both packages' elements or pipelines the same numpy
inputs (the port's also as torch tensors) and compares what comes out:
routing decisions and pads exactly, tensors, wire bytes and pts
bitwise.  ``tensor_rateadjust`` has no JAX test of its own, so its drops
and duplicates are held against the JAX element over a seeded pts
sequence.  Repo slots are named per test and cleared by a fixture.
"""

import logging

import numpy as np
import pytest
import torch

import ml_dtypes

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.core.types import TensorsSpec as JSpec
from nnstreamer_tpu.elements import aggregator as jagg
from nnstreamer_tpu.elements import cond as jcond
from nnstreamer_tpu.elements import debug as jdebug
from nnstreamer_tpu.elements import rate as jrate
from nnstreamer_tpu.elements import repo as jrepo
from nnstreamer_tpu.elements import sparse as jsparse
from nnstreamer_tpu.filters.custom_easy import register_custom_easy as jregister
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.elements import aggregator as tagg
from nnstreamer_tpu_torch.elements import cond as tcond
from nnstreamer_tpu_torch.elements import debug as tdebug
from nnstreamer_tpu_torch.elements import rate as trate
from nnstreamer_tpu_torch.elements import repo as trepo
from nnstreamer_tpu_torch.elements import sparse as tsparse
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy as tregister

SIDES = {"jax": (nt, JBuffer), "port": (ntt, Buffer)}


@pytest.fixture(autouse=True)
def _clean_slots():
    jrepo.reset_slots()
    trepo.reset_slots()
    yield
    jrepo.reset_slots()
    trepo.reset_slots()


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _summary(outs):
    return [(pad, b.pts, [_host(t) for t in b.tensors]) for pad, b in outs]


def _same(a, b):
    assert len(a) == len(b)
    for (pa, ta, xa), (pb, tb, xb) in zip(a, b):
        assert (pa, ta) == (pb, tb)
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


def _both(make, steps, pads=("src",), wrap=None):
    """``make(key)`` -> an element of each package, configured with
    ``pads``; ``steps`` (pad, tensors, pts, meta) go through both, and the
    port's outputs must equal the JAX package's.  ``wrap`` turns the
    port's numpy inputs into torch tensors."""
    res = {}
    for key in ("jax", "port"):
        el = make(key)
        el.configure({}, list(pads))
        buf_cls = SIDES[key][1]
        outs = []
        for pad, tensors, pts, meta in steps:
            ts = [wrap(t) if (wrap and key == "port") else t for t in tensors]
            b = buf_cls(ts, pts=pts)
            b.meta.update(meta or {})
            outs += el.process(pad, b)
        res[key] = _summary(outs)
    _same(res["port"], res["jax"])
    return res["port"]


# -- tensor_if ----------------------------------------------------------------------------

def _if(props):
    return lambda key: (jcond if key == "jax" else tcond).TensorIf(dict(props))


@pytest.mark.parametrize("wrap", [None, torch.from_numpy])
def test_average_gate(wrap):
    props = {"compared_value": "TENSOR_AVERAGE_VALUE", "compared_value_option": "0",
             "operator": "GT", "supplied_value": "10", "then": "PASSTHROUGH",
             "else": "SKIP"}
    out = _both(_if(props), [("sink", [np.full((4,), 20.0, np.float32)], 0, None),
                             ("sink", [np.full((4,), 5.0, np.float32)], 1, None)],
                wrap=wrap)
    assert [pts for _, pts, _ in out] == [0]


@pytest.mark.parametrize("wrap", [None, torch.from_numpy])
def test_range_and_pick(wrap):
    props = {"compared_value": "A_VALUE", "compared_value_option": "0:0",
             "operator": "RANGE_INCLUSIVE", "supplied_value": "2:8", "then": "TENSORPICK",
             "then_option": "1"}
    out = _both(_if(props), [("sink", [np.array([5.0]), np.array([42.0])], 0, None)],
                wrap=wrap)
    assert len(out) == 1 and out[0][2][0].tolist() == [42.0]


def test_custom_condition():
    jcond.register_if_condition("always-no-port-test", lambda arrays: False)
    tcond.register_if_condition("always-no-port-test", lambda arrays: False)
    props = {"custom": "always-no-port-test", "then": "PASSTHROUGH", "else": "SKIP"}
    assert _both(_if(props), [("sink", [np.ones(3)], 0, None)]) == []


def test_custom_condition_gets_host_arrays():
    seen = []

    def cond(arrays):
        seen.append(arrays)
        return float(arrays[0].sum()) > 2

    tcond.register_if_condition("sum-gt-2-port-test", cond)
    jcond.register_if_condition("sum-gt-2-port-test", cond)
    props = {"custom": "sum-gt-2-port-test"}
    out = _both(_if(props), [("sink", [np.ones(3, np.float32)], 0, None),
                             ("sink", [np.ones(2, np.float32)], 1, None)],
                wrap=torch.from_numpy)
    assert [pts for _, pts, _ in out] == [0]
    assert all(isinstance(a, np.ndarray) for arrays in seen for a in arrays)


OPERATORS = ["EQ", "NE", "GT", "GE", "LT", "LE", "RANGE_INCLUSIVE", "RANGE_EXCLUSIVE",
             "NOT_IN_RANGE_INCLUSIVE", "NOT_IN_RANGE_EXCLUSIVE"]


@pytest.mark.parametrize("op", OPERATORS)
@pytest.mark.parametrize("value", ["A_VALUE", "TENSOR_AVERAGE_VALUE", "META_VALUE"])
def test_every_operator_and_compared_value_with_two_pads(op, value):
    """src_0 takes THEN, src_1 ELSE (an unset else on two linked pads
    passes through there)."""
    assert set(OPERATORS) == set(jcond._OPERATORS) == set(tcond._OPERATORS)
    supplied = "2:4" if "RANGE" in op else "3"
    props = {"compared_value": value, "operator": op, "supplied_value": supplied,
             "compared_value_option": "flag" if value == "META_VALUE" else "0"}
    steps = [("sink", [np.full((3,), v, np.float32)], i, {"flag": v})
             for i, v in enumerate([1.0, 2.0, 3.0, 4.0, 5.0])]
    out = _both(_if(props), steps, pads=("src_0", "src_1"), wrap=torch.from_numpy)
    assert len(out) == 5


def test_one_pad_falls_back_to_skip_and_explicit_else():
    props = {"compared_value": "A_VALUE", "operator": "GE", "supplied_value": "2"}
    steps = [("sink", [np.array([v], np.float32)], i, None) for i, v in enumerate([1, 3])]
    assert [p for _, p, _ in _both(_if(props), steps)] == [1]
    out = _both(_if(dict(props, **{"else": "TENSORPICK", "else_option": "0"})), steps)
    assert [p for _, p, _ in out] == [0, 1]


def test_meta_value_reads_no_tensor(monkeypatch):
    el = tcond.TensorIf({"compared_value": "META_VALUE",
                         "compared_value_option": "spec_draft", "operator": "GE",
                         "supplied_value": "1"})
    el.configure({}, ["src"])

    def trap(*_a, **_k):
        raise AssertionError("META_VALUE read a tensor")

    for attr in ("item", "cpu", "numpy", "tolist", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, attr, trap)
    b = Buffer([torch.ones(2)])
    b.meta["spec_draft"] = 1
    assert len(el.process("sink", b)) == 1
    assert el.process("sink", Buffer([torch.ones(2)])) == []  # absent key reads 0


def test_bad_operator_and_meta_raise():
    with pytest.raises(ElementError, match="unknown tensor_if operator"):
        tcond.TensorIf({"operator": "XOR"})
    el = tcond.TensorIf({"compared_value": "META_VALUE", "compared_value_option": "k"})
    el.configure({}, ["src"])
    b = Buffer([np.ones(1)])
    b.meta["k"] = "yes"
    with pytest.raises(ElementError, match="non-numeric"):
        el.process("sink", b)


def test_tensor_if_pipeline_two_branches():
    desc = ("appsrc name=src ! tensor_if name=g compared-value=A_VALUE operator=GT "
            "supplied-value=0 g.src_0 ! tensor_sink name=hi g.src_1 ! tensor_sink name=lo")
    res = {}
    for key, (lib, _) in SIDES.items():
        p = lib.Pipeline(desc)
        with p:
            for v in (1.0, -1.0, 2.0):
                p.push("src", np.array([v], np.float32))
            hi = [float(np.asarray(p.pull("hi", timeout=15).tensors[0])[0]) for _ in range(2)]
            lo = [float(np.asarray(p.pull("lo", timeout=15).tensors[0])[0])]
            p.eos()
            p.wait(timeout=15)
        res[key] = (hi, lo)
    assert res["port"] == res["jax"] == ([1.0, 2.0], [-1.0])


# -- tensor_rateadjust ------------------------------------------------------------------------

@pytest.mark.parametrize("framerate", ["30/1", "10/1", "60/1", "7/2", "0/1"])
def test_rateadjust_drops_and_duplicates_like_the_jax_element(framerate):
    rng = np.random.default_rng(11)
    pts = np.cumsum(rng.integers(5_000_000, 80_000_000, 60)) + 123_456
    els = {}
    outs = {}
    for key, mod in (("jax", jrate), ("port", trate)):
        el = mod.TensorRateAdjust({"framerate": framerate})
        el.configure({}, ["src"])
        buf_cls = SIDES[key][1]
        o = []
        for i, p in enumerate(pts):
            o += el.process("sink", buf_cls([np.full(2, i, np.int32)], pts=int(p)))
        o += el.process("sink", buf_cls([np.zeros(2, np.int32)]))  # no pts: passes
        els[key], outs[key] = el, _summary(o)
    _same(outs["port"], outs["jax"])
    counters = [(e.n_in, e.n_out, e.n_dropped, e.n_duplicated) for e in els.values()]
    assert counters[0] == counters[1]
    if framerate == "30/1":
        assert els["port"].n_dropped > 0 and els["port"].n_duplicated > 0


def test_rate_alias_and_caps():
    assert ntt.registry.get("element", "tensor_rate") is trate.TensorRateAdjust
    el = trate.TensorRateAdjust({"framerate": "15/1"})
    spec = TensorsSpec.from_string("4", "float32")
    caps = el.configure({"sink": ntt.Caps.tensors(spec)}, ["src"])
    assert caps["src"].spec.rate == (15, 1)


# -- tensor_repo -------------------------------------------------------------------------------

def test_repo_recurrence_equals_the_jax_packages():
    jspec = JSpec.from_string("4", "float32")
    tspec = TensorsSpec.from_string("4", "float32")
    jregister("inc_repo_port_test", lambda ins: [ins[0] + 1], jspec, jspec)
    tregister("inc_repo_port_test", lambda ins: [ins[0] + 1], tspec, tspec)
    desc = ("tensor_reposrc slot-name=loop_recurrence init-dims=4 init-type=float32 "
            "num-buffers=5 ! tensor_filter framework=custom-easy model=inc_repo_port_test ! "
            "tee name=t t. ! tensor_reposink slot-name=loop_recurrence "
            "t. ! tensor_sink name=out")
    res = {}
    for key, (lib, _) in SIDES.items():
        p = lib.Pipeline(desc, fuse=False)
        with p:
            res[key] = [np.asarray(p.pull("out", timeout=10).tensors[0]) for _ in range(5)]
        assert [float(v[0]) for v in res[key]] == [1.0, 2.0, 3.0, 4.0, 5.0]
    for a, b in zip(res["port"], res["jax"]):
        assert a.tobytes() == b.tobytes()


def test_repo_slots_are_the_ports_own_and_store_host_buffers():
    sink = trepo.TensorRepoSink({"slot_name": "slot_own"})
    sink.start()
    sink.process("sink", Buffer([torch.arange(3)], pts=7))
    assert jrepo._slot("slot_own").q.empty()
    src = trepo.TensorRepoSrc({"slot_name": "slot_own", "num_buffers": 1})
    src.configure({}, ["src"])
    [b] = list(src.generate())
    assert isinstance(b.tensors[0], np.ndarray) and b.pts == 7
    np.testing.assert_array_equal(b.tensors[0], np.arange(3))
    sink.stop()  # the EOS latch: a waiting reposrc ends
    src2 = trepo.TensorRepoSrc({"slot_index": "slot_own"})
    src2.configure({}, ["src"])
    assert list(src2.generate()) == []


def test_reposrc_init_buffer_matches():
    outs = []
    for mod in (jrepo, trepo):
        src = mod.TensorRepoSrc({"slot_name": "slot_init", "init_dims": "3:2",
                                 "init_type": "int16", "num_buffers": 1})
        caps = src.configure({}, ["src"])
        [b] = list(src.generate())
        outs.append((np.asarray(b.tensors[0]), caps["src"].spec.to_string()))
    assert outs[0][1] == outs[1][1]
    _same([("src", 0, [outs[1][0]])], [("src", 0, [outs[0][0]])])


# -- tensor_sparse ------------------------------------------------------------------------------

def _sparse_inputs():
    rng = np.random.default_rng(5)
    out = []
    for dt, shape in ((np.float32, (8, 8)), (np.int32, (4, 5, 3)), (np.uint8, (17,)),
                      (np.float64, (2, 3)), (np.int16, ())):
        x = np.zeros(shape, dt)
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, max(1, flat.size // 5), replace=False)
        flat[idx] = rng.integers(1, 100, idx.size).astype(dt)
        out.append(x)
    x = np.zeros((6, 4), np.float32)
    x[1, 2], x[5, 3], x[0, 0] = 1.5, -2.0, -0.0
    out.append(x.astype(ml_dtypes.bfloat16))
    return out


@pytest.mark.parametrize("i", range(6))
def test_sparse_wire_bytes_bitwise(i):
    x = _sparse_inputs()[i]
    want = jsparse.sparse_encode_array(x)
    got = tsparse.sparse_encode_array(x)
    assert got.dtype == want.dtype == np.uint8 and got.tobytes() == want.tobytes()
    if x.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    assert tsparse.sparse_encode_array(t).tobytes() == want.tobytes()
    back = tsparse.sparse_decode_array(want)
    ref = jsparse.sparse_decode_array(want)
    assert back.dtype == ref.dtype and back.shape == ref.shape
    assert back.tobytes() == ref.tobytes()


def test_sparse_decode_bf16_without_ml_dtypes(monkeypatch):
    """Where numpy has no bfloat16 (no ``ml_dtypes``, as on the card's
    machine), a bf16 tensor decodes to a torch bfloat16 tensor of the
    same bits."""
    x = _sparse_inputs()[5]
    blob = jsparse.sparse_encode_array(x)
    stand_in = np.dtype([("bfloat16", "<u2")])
    monkeypatch.setattr(tsparse, "bfloat16", stand_in)
    monkeypatch.setattr(tsparse, "dtype_from_name",
                        lambda n: stand_in if n == "bfloat16" else np.dtype(n))
    out = tsparse.sparse_decode_array(blob)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    want = jsparse.sparse_decode_array(blob)  # -0.0 is no nonzero: it comes back +0.0
    assert out.view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes()


def test_sparse_roundtrip_and_compression():
    x = np.zeros((8, 8), np.float32)
    x[2, 3], x[7, 0] = 1.5, -2.0
    blob = tsparse.sparse_encode_array(x)
    assert blob.nbytes < x.nbytes
    np.testing.assert_array_equal(tsparse.sparse_decode_array(blob), x)
    with pytest.raises(ElementError, match="bad magic"):
        tsparse.sparse_decode_array(np.zeros(16, np.uint8))


def test_sparse_pipeline_roundtrip_equals_the_jax_packages():
    desc = "appsrc name=src ! tensor_sparse_enc ! tensor_sparse_dec ! tensor_sink name=out"
    x = np.zeros((4, 4), np.int32)
    x[1, 1] = 7
    res = {}
    for key, (lib, _) in SIDES.items():
        p = lib.Pipeline(desc)
        with p:
            p.push("src", x)
            res[key] = np.asarray(p.pull("out", timeout=10).tensors[0])
            p.eos()
            p.wait(timeout=10)
    _same([("src", 0, [res["port"]])], [("src", 0, [res["jax"]])])
    np.testing.assert_array_equal(res["port"], x)
    assert ntt.registry.get("element", "tensor_sparseenc") is tsparse.TensorSparseEnc


def test_sparse_elements_on_torch_tensors():
    xs = _sparse_inputs()[:3]
    enc = _both(lambda k: (jsparse if k == "jax" else tsparse).TensorSparseEnc({}),
                [("sink", xs, 3, None)], wrap=torch.from_numpy)
    dec = tsparse.TensorSparseDec({})
    dec.configure({}, ["src"])
    [(_, b)] = dec.process("sink", Buffer([e for e in enc[0][2]]))
    for got, want in zip(b.tensors, xs):
        assert got.tobytes() == want.tobytes()


# -- tensor_debug -------------------------------------------------------------------------------

def test_debug_logs_what_the_jax_element_logs(caplog, monkeypatch):
    xs = [np.zeros((2, 3), np.float32), np.ones(4, np.uint8)]
    msgs = {}
    for key, mod in (("jax", jdebug), ("port", tdebug)):
        el = mod.TensorDebug({}, name="dbg")
        el.configure({}, ["src"])
        buf_cls = SIDES[key][1]
        b = buf_cls(list(xs), pts=42)
        b.meta["k"] = 1
        with caplog.at_level(logging.INFO):
            caplog.clear()
            assert el.process("sink", b) == [("src", b)]
        msgs[key] = [r.getMessage() for r in caplog.records if "[dbg]" in r.getMessage()]
    assert msgs["port"] == msgs["jax"] and len(msgs["port"]) == 1


def test_debug_describes_tensors_without_a_fetch(monkeypatch, capsys):
    def trap(*_a, **_k):
        raise AssertionError("tensor_debug fetched a tensor")

    for attr in ("cpu", "numpy", "item", "tolist", "__array__"):
        monkeypatch.setattr(torch.Tensor, attr, trap)
    el = tdebug.TensorDebug({"console": True}, name="dbg")
    el.configure({}, ["src"])
    el.process("sink", Buffer([torch.zeros(2, 5, dtype=torch.bfloat16)], pts=1))
    monkeypatch.undo()
    assert "tensors=[(2, 5):bfloat16]" in capsys.readouterr().out


# -- tensor_aggregator: the cases of tests/test_routing.py ------------------------------------

def _agg(props):
    return lambda key: (jagg if key == "jax" else tagg).TensorAggregator(dict(props))


@pytest.mark.parametrize("device", ["false", "true"])
def test_aggregator_window(device):
    props = {"frames_in": 1, "frames_out": 3, "frames_dim": 1, "device": device}

    def make(key):
        el = _agg(props)(key)
        el.ring_device = torch.device("cpu")
        return el

    out = _both(make, [("sink", [np.full((1, 2), i, np.float32)], i, None)
                       for i in range(5)])
    assert len(out) == 1 and out[0][2][0].shape == (3, 2)


@pytest.mark.parametrize("device", ["false", "true"])
def test_aggregator_sliding(device):
    props = {"frames_in": 1, "frames_out": 2, "frames_flush": 1, "frames_dim": 1,
             "device": device}

    def make(key):
        el = _agg(props)(key)
        el.ring_device = torch.device("cpu")
        return el

    out = _both(make, [("sink", [np.full((1, 1), i, np.float32)], i, None)
                       for i in range(4)])
    assert len(out) == 3 and out[1][2][0].ravel().tolist() == [1, 2]


def test_aggregator_caps_equal_the_jax_packages():
    for props in ({"frames_in": 2, "frames_out": 6, "frames_dim": 0},
                  {"frames_in": 2, "frames_out": 3, "frames_dim": 0, "concat": "false"}):
        caps = []
        for lib, mod, spec_cls in ((nt, jagg, JSpec), (ntt, tagg, TensorsSpec)):
            el = mod.TensorAggregator(dict(props))
            spec = spec_cls.from_string("4:1", "float32")
            c = el.configure({"sink": lib.Caps.tensors(spec)}, ["src"])
            caps.append([s.to_string() for s in c["src"].spec])
        assert caps[0] == caps[1]
