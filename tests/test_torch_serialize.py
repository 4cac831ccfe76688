"""The serialisation sub-plugins and the video decoders in the port
against the JAX package's, on the CPU: ``flatbuf``, ``flexbuf`` and
``protobuf`` (``decoders/serialize.py`` writes, ``converters/
serialize.py`` reads, over ``utils/wire.py``), ``octet_stream``,
``python3``, ``direct_video`` and ``tensor_region``.

Bytes must be equal byte for byte: the port's decoder bytes to the JAX
decoder's for the same buffer, and each side's converter reads the other
side's bytes back exactly.  ``tensor_region`` regions are integers and
must be equal on the same seeded boxes and scores, ties and boxes
outside [0, 1] included.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
from nnstreamer_tpu.converters import serialize as jconv
from nnstreamer_tpu.decoders import direct_video as jdv
from nnstreamer_tpu.decoders import serialize as jser
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu_torch.converters import serialize as tconv
from nnstreamer_tpu_torch.core import buffer as tbuffer
from nnstreamer_tpu_torch.core.registry import KIND_CONVERTER, KIND_DECODER, names
from nnstreamer_tpu_torch.decoders import direct_video as tdv
from nnstreamer_tpu_torch.decoders import serialize as tser

WIRE_MODES = ["flatbuf", "flexbuf", "protobuf"]


def _tensors(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, 4)).astype(np.float32),
            rng.integers(-5, 5, size=(7,)).astype(np.int16),
            rng.integers(0, 255, size=(2, 2, 3)).astype(np.uint8)]


def _buf(pkg, tensors, seqno=41, pts=1234):
    b = pkg.Buffer(list(tensors), pts=pts, seqno=seqno)
    b.meta.update({"detections": [{"box": [0, 0, 1, 1], "score": 0.5}], "tag": "x"})
    return b


def _decoder(mod, mode):
    cls = {"flatbuf": mod.FlatbufDecoder, "flexbuf": mod.FlexbufDecoder,
           "protobuf": mod.ProtobufDecoder}[mode]
    return cls({"mode": mode})


def _converter(mod, mode):
    cls = {"flatbuf": mod.FlatbufConverter, "flexbuf": mod.FlexbufConverter,
           "protobuf": mod.ProtobufConverter}[mode]
    return cls({"mode": mode})


def _blob(out):
    return np.asarray(out.tensors[0]).tobytes()


@pytest.mark.parametrize("mode", WIRE_MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_decoder_bytes_equal_jax(mode, seed):
    ts = _tensors(seed)
    j = _decoder(jser, mode).decode(ts, _buf(nt, ts))
    t = _decoder(tser, mode).decode(ts, _buf(ntt, ts))
    assert _blob(t) == _blob(j)
    assert t.spec is not None and np.asarray(t.tensors[0]).dtype == np.uint8


@pytest.mark.parametrize("mode", WIRE_MODES)
def test_each_converter_reads_the_other_sides_bytes(mode):
    ts = _tensors(5)
    jbytes = _blob(_decoder(jser, mode).decode(ts, _buf(nt, ts)))
    tbytes = _blob(_decoder(tser, mode).decode(ts, _buf(ntt, ts)))
    port_reads = _converter(tconv, mode).convert(ntt.Buffer([np.frombuffer(jbytes, np.uint8)]))
    jax_reads = _converter(jconv, mode).convert(nt.Buffer([np.frombuffer(tbytes, np.uint8)]))
    for got in (port_reads, jax_reads):
        assert got.pts == 1234 and got.seqno == 41
        assert got.meta["detections"][0]["score"] == 0.5
        for a, b in zip(got.tensors, ts):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bf16_torch_tensors_encode_as_the_jax_package_encodes_bf16():
    import ml_dtypes

    x = torch.tensor([[1.5, -2.25, 3.0e-3]], dtype=torch.bfloat16)
    jx = x.float().numpy().astype(ml_dtypes.bfloat16)
    j = _decoder(jser, "flexbuf").decode([jx], _buf(nt, [jx]))
    t = _decoder(tser, "flexbuf").decode([x], _buf(ntt, [x]))
    assert _blob(t) == _blob(j)
    back = _converter(tconv, "flexbuf").convert(ntt.Buffer([np.frombuffer(_blob(j), np.uint8)]))
    assert back.tensors[0].dtype == torch.bfloat16 and torch.equal(back.tensors[0], x)


def test_octet_stream_bytes_equal_jax():
    ts = _tensors(3)
    j = jser.OctetStream({}).decode(ts, nt.Buffer(ts))
    t = tser.OctetStream({}).decode(ts, ntt.Buffer(ts))
    assert _blob(t) == _blob(j) == b"".join(x.tobytes() for x in ts)


def test_octet_stream_reads_torch_tensors():
    ts = [torch.arange(6, dtype=torch.int32).reshape(2, 3).t(), torch.ones(2, dtype=torch.bfloat16)]
    out = tser.OctetStream({}).decode(ts, ntt.Buffer(ts))
    assert _blob(out) == ts[0].contiguous().numpy().tobytes() + \
        ts[1].view(torch.int16).numpy().tobytes()


def test_python3_converter_with_a_user_module(tmp_path, monkeypatch):
    mod = "nns_torch_user_conv"
    (tmp_path / f"{mod}.py").write_text(
        "import numpy as np\n"
        "def halves(buf):\n"
        "    raw = np.asarray(buf.tensors[0], np.uint8)\n"
        "    return [raw[: raw.size // 2], raw[raw.size // 2:]]\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        outs = {}
        for pkg in (nt, ntt):
            p = pkg.Pipeline("appsrc name=src ! tensor_converter mode=python3 "
                             f"script={mod}:halves ! tensor_sink name=out")
            with p:
                p.push("src", np.arange(10, dtype=np.uint8))
                outs[pkg] = [np.asarray(t) for t in p.pull("out", timeout=15).tensors]
                p.eos()
                p.wait(timeout=15)
        for a, b in zip(outs[nt], outs[ntt]):
            assert a.tobytes() == b.tobytes()
        assert [x.tolist() for x in outs[ntt]] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    finally:
        sys.modules.pop(mod, None)


def test_python3_converter_needs_module_and_function():
    for mod in (jconv, tconv):
        with pytest.raises(ValueError, match="module:function"):
            mod.Python3Converter({"script": "nocolon"})


@pytest.mark.parametrize("mode", WIRE_MODES)
def test_decoder_converter_pipeline_roundtrip(mode):
    """appsrc ! tensor_decoder mode=<m> ! tensor_converter mode=<m> in both
    packages (tests/test_decoders.py's round trip)."""
    x = np.arange(12, dtype=np.int16).reshape(3, 4)
    outs = {}
    for pkg in (nt, ntt):
        p = pkg.Pipeline(f"appsrc name=src ! tensor_decoder mode={mode} ! "
                         f"tensor_converter mode={mode} ! tensor_sink name=out")
        with p:
            p.push("src", pkg.Buffer([x], pts=77))
            out = p.pull("out", timeout=15)
            p.eos()
            p.wait(timeout=15)
        outs[pkg] = out
        np.testing.assert_array_equal(np.asarray(out.tensors[0]), x)
        assert out.pts == 77
    assert np.asarray(outs[ntt].tensors[0]).dtype == np.int16


def test_sub_plugins_registered():
    assert {"flatbuf", "flexbuf", "protobuf", "python3"} <= set(names(KIND_CONVERTER))
    assert {"flatbuf", "flexbuf", "protobuf", "octet_stream", "direct_video",
            "tensor_region"} <= set(names(KIND_DECODER))


# -- direct_video --------------------------------------------------------------------

@pytest.mark.parametrize("c,fmt", [(1, "GRAY8"), (3, "RGB"), (4, "RGBA"), (2, None)])
def test_direct_video_caps_and_frames_equal_jax(c, fmt):
    spec_t = ntt.TensorsSpec.from_string(f"{c}:5:3:1", "uint8")
    spec_j = nt.TensorsSpec.from_string(f"{c}:5:3:1", "uint8")
    tc = tdv.DirectVideo({}).out_caps(spec_t)
    jc = jdv.DirectVideo({}).out_caps(spec_j)
    assert tc.get("format") == jc.get("format") == fmt
    assert (tc.get("width"), tc.get("height")) == (jc.get("width"), jc.get("height"))
    x = np.random.default_rng(c).integers(0, 256, (1, 3, 5, c), dtype=np.uint8)
    t = tdv.DirectVideo({}).decode([torch.from_numpy(x)], ntt.Buffer([x]))
    j = jdv.DirectVideo({}).decode([x], nt.Buffer([x]))
    assert np.asarray(t.tensors[0]).tobytes() == np.asarray(j.tensors[0]).tobytes()
    assert np.asarray(t.tensors[0]).shape == (3, 5, c)


# -- tensor_region -------------------------------------------------------------------

def _detections(seed, n=40, classes=7):
    """Corner boxes, some outside [0, 1] and some inverted, and scores
    with exact ties on the best class."""
    rng = np.random.default_rng(seed)
    x1y1 = rng.uniform(-0.3, 1.1, size=(n, 2))
    wh = rng.uniform(-0.1, 0.8, size=(n, 2))
    boxes = np.concatenate([x1y1, x1y1 + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, size=(n, classes)).astype(np.float32)
    scores[5, 2] = scores[9, 4] = scores[17, 0] = 2.0  # a three-way tie on top
    scores[21, 1] = scores[30, 6] = 1.5
    return boxes[None], scores[None]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("opts", [("320:320", "4"), ("640:480", "1"), ("", ""),
                                  ("33:17", "60")], ids=["320x4", "640x1", "default", "pad"])
def test_tensor_region_equals_jax(seed, opts):
    boxes, scores = _detections(seed)
    props = {}
    if opts[0]:
        props = {"option1": opts[0], "option2": opts[1]}
    j = jdv.TensorRegion(dict(props)).decode([boxes, scores], nt.Buffer([boxes, scores]))
    t = tdv.TensorRegion(dict(props)).decode([torch.from_numpy(boxes), torch.from_numpy(scores)],
                                             ntt.Buffer([boxes, scores]))
    jr, tr = np.asarray(j.tensors[0]), np.asarray(t.tensors[0])
    assert tr.dtype == jr.dtype == np.uint32
    np.testing.assert_array_equal(tr, jr)
    num = int(opts[1] or 1)
    assert tr.shape == (num, 4)
    if num > 40:
        assert not tr[40:].any()  # zero rows pad the rest


def test_tensor_region_without_scores_keeps_anchor_order():
    boxes, _ = _detections(4)
    j = jdv.TensorRegion({"option2": "3"}).decode([boxes], nt.Buffer([boxes]))
    t = tdv.TensorRegion({"option2": "3"}).decode([boxes], ntt.Buffer([boxes]))
    np.testing.assert_array_equal(np.asarray(t.tensors[0]), np.asarray(j.tensors[0]))


def test_tensor_region_pipeline_equals_jax():
    boxes, scores = _detections(9, n=32)
    outs = {}
    for pkg in (nt, ntt):
        p = pkg.Pipeline("appsrc name=src ! tensor_decoder mode=tensor_region "
                         "option1=64:48 option2=5 ! tensor_sink name=out")
        with p:
            p.push("src", [boxes, scores])
            outs[pkg] = np.asarray(p.pull("out", timeout=15).tensors[0])
            p.eos()
            p.wait(timeout=15)
    np.testing.assert_array_equal(outs[ntt], outs[nt])


# -- one fetch per buffer across the branches of a tee --------------------------------

def test_fetched_is_one_copy_however_many_branches_ask(monkeypatch):
    """Two host decoders below a tee read the SAME buffer object: the
    card-to-host copy is made once, and both get it.  Here CPU tensors
    stand in for card tensors."""
    monkeypatch.setattr(tbuffer, "_on_card", lambda t: isinstance(t, torch.Tensor))
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        calls.append(1)
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    buf = ntt.Buffer([torch.arange(4.0), torch.ones(2, 3)])
    got = []
    threads = [threading.Thread(target=lambda: got.append(buf.fetched())) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert len(calls) == 2  # one per tensor, once
    host = ntt.Buffer([np.zeros(3)])
    assert host.fetched() is host
