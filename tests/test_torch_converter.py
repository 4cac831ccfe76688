"""tensor_converter in the port against the JAX package's
(``nnstreamer_tpu/elements/converter.py``), on the CPU: raw video bytes,
dense and with each row padded to 4 bytes, RGB, BGRx and GRAY8, at
``frames-per-tensor`` 1 and 3; text padded and cut to ``input-dim``;
octet-stream split into chunks; the ``mode=`` sub-plugin lookup.  The
same seeded numpy buffers go through both elements and the outputs must
be equal byte for byte (they are the input bytes, moved).

The JAX element strips a stride through its native library when one is
built; these tests take its numpy fallback instead (``_load`` returns
None), the same bytes without a compiler or ``ctypes`` in the test
process.
"""

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu.native as jnative
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.elements.converter import TensorConverter as JConverter
from nnstreamer_tpu_torch.core.caps import Caps, MediaType
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.elements.converter import TensorConverter, strip_row_stride
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError


@pytest.fixture(autouse=True)
def _numpy_stride_fallback(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda block=True: None)


def _caps(pkg, media, **fields):
    return pkg.Caps.new(getattr(pkg.MediaType, media.name), **fields)


def _pair(props, media, fields):
    """(JAX element, port element), configured on the same caps."""
    out = []
    for pkg, cls in ((nt, JConverter), (ntt, TensorConverter)):
        el = cls(dict(props))
        el.configure({"sink": _caps(pkg, media, **fields)}, ["src"])
        out.append(el)
    return out


def _feed(pair, bufs_np, pts0=0):
    """Push the same arrays through both elements -> the outputs, checked
    equal (shape, dtype, bytes, pts) and returned as host arrays."""
    outs = []
    for pkg, el in zip((nt, ntt), pair):
        got = []
        for i, a in enumerate(bufs_np):
            for _pad, b in el.process("sink", pkg.Buffer([a], pts=pts0 + i)):
                got.append((b.pts, [np.asarray(t) for t in b.tensors], b.spec))
        outs.append(got)
    j, t = outs
    assert len(j) == len(t)
    for (pj, xj, sj), (pt, xt, st) in zip(j, t):
        assert pj == pt
        for u, v in zip(xj, xt):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()
        assert (None if sj is None else [s.dims for s in sj]) == \
            (None if st is None else [s.dims for s in st])
    return t


def _raw_frames(seed, n, h, w, c, strided):
    """Seeded frames as a camera delivers them: one 1-D uint8 array each,
    rows padded to a multiple of 4 bytes when ``strided``."""
    rng = np.random.default_rng(seed)
    dense = [rng.integers(0, 256, (h, w, c), dtype=np.uint8) for _ in range(n)]
    row = w * c
    stride = (row + 3) // 4 * 4 if strided else row
    raw = []
    for f in dense:
        padded = rng.integers(0, 256, (h, stride), dtype=np.uint8)  # junk padding
        padded[:, :row] = f.reshape(h, row)
        raw.append(padded.reshape(-1))
    return dense, raw


@pytest.mark.parametrize("fmt,c,w,h", [("RGB", 3, 5, 3), ("RGB", 3, 8, 4),
                                       ("BGRx", 4, 5, 3), ("GRAY8", 1, 7, 5),
                                       ("GRAY8", 1, 8, 2)],
                         ids=["rgb-5x3", "rgb-8x4", "bgrx-5x3", "gray-7x5", "gray-8x2"])
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("fpt", [1, 3])
def test_raw_video_bytes_equal_jax(fmt, c, w, h, strided, fpt):
    dense, raw = _raw_frames(100 * w + 10 * h + c, 6, h, w, c, strided)
    pair = _pair({"frames_per_tensor": fpt}, MediaType.VIDEO,
                 dict(format=fmt, width=w, height=h, framerate=(30, 1)))
    outs = _feed(pair, raw)
    assert len(outs) == 6 // fpt
    for k, (_pts, [x], spec) in enumerate(outs):
        assert x.shape == (fpt, h, w, c)
        np.testing.assert_array_equal(x, np.stack(dense[k * fpt:(k + 1) * fpt]))
        assert spec[0].dims == (c, w, h, fpt)


def test_frames_as_arrays_pass_as_before():
    dense, _ = _raw_frames(1, 3, 4, 6, 3, False)
    pair = _pair({}, MediaType.VIDEO, dict(format="RGB", width=6, height=4))
    outs = _feed(pair, dense)
    assert [x[0].shape for _p, x, _s in outs] == [(1, 4, 6, 3)] * 3


@pytest.mark.parametrize("size", [5 * 3 * 3 - 1, 5 * 3 * 3 + 2])
def test_raw_bytes_fitting_neither_layout_raise(size):
    for pkg, cls in ((nt, JConverter), (ntt, TensorConverter)):
        el = cls({})
        el.configure({"sink": _caps(pkg, MediaType.VIDEO, format="RGB", width=5,
                                    height=3)}, ["src"])
        with pytest.raises(Exception, match="neither dense"):
            el.process("sink", pkg.Buffer([np.zeros(size, np.uint8)]))


def test_strip_row_stride_copies_only_the_rows():
    raw = np.arange(3 * 16, dtype=np.uint8)  # 3 rows of 15 bytes, stride 16
    out = strip_row_stride(raw, 3, 5, 3)
    assert out.flags.c_contiguous and not np.shares_memory(out, raw)
    np.testing.assert_array_equal(out.reshape(3, 15), raw.reshape(3, 16)[:, :15])
    np.testing.assert_array_equal(
        out.reshape(-1), jnative.strip_stride(raw, rows=3, row_bytes=15, src_stride=16))


@pytest.mark.parametrize("text", ["hello", "héllo wörld, a longer line", ""],
                         ids=["short", "long", "empty"])
@pytest.mark.parametrize("dim", [None, "12", "4:2"], ids=["nodim", "12", "4x2"])
def test_text_equal_jax(text, dim):
    props = {"input_dim": dim, "input_type": "uint8"} if dim else {}
    pair = _pair(props, MediaType.TEXT, {})
    data = np.frombuffer(text.encode("utf-8"), np.uint8)
    [(_p, [x], _s)] = _feed(pair, [data])
    if dim:
        n = int(np.prod([int(d) for d in dim.split(":")]))
        body = text.encode("utf-8")[:n]
        assert x.tobytes() == body + b"\0" * (n - len(body))


def test_text_from_a_string_pipeline():
    outs = {}
    for pkg in (nt, ntt):
        p = pkg.Pipeline("appsrc name=src caps=text/x-raw,format=utf8 ! "
                         "tensor_converter input-dim=8 input-type=uint8 ! tensor_sink name=out")
        with p:
            p.push("src", "streaming text")
            outs[pkg] = np.asarray(p.pull("out", timeout=15).tensors[0])
            p.eos()
            p.wait(timeout=15)
    assert outs[nt].tobytes() == outs[ntt].tobytes() == b"streamin"


@pytest.mark.parametrize("dtype,dim", [("float32", "4"), ("int16", "3:2"), ("uint8", "5")])
def test_octet_stream_chunks_equal_jax(dtype, dim):
    rng = np.random.default_rng(7)
    n = int(np.prod([int(d) for d in dim.split(":")]))
    payload = rng.normal(size=n * 3 + 1).astype(dtype) if dtype == "float32" else \
        rng.integers(0, 100, size=n * 3 + 1).astype(dtype)
    raw = np.frombuffer(payload.tobytes(), np.uint8)
    pair = _pair({"input_dim": dim, "input_type": dtype}, MediaType.OCTET, {})
    outs = _feed(pair, [raw])
    assert len(outs) == 3  # the partial chunk at the end is dropped
    for k, (_p, [x], _s) in enumerate(outs):
        assert x.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(x.reshape(-1), payload[k * n:(k + 1) * n])


def test_octet_stream_without_input_dim_raises():
    for pkg, cls in ((nt, JConverter), (ntt, TensorConverter)):
        el = cls({})
        el.configure({"sink": _caps(pkg, MediaType.OCTET)}, ["src"])
        with pytest.raises(Exception, match="input-dim"):
            el.process("sink", pkg.Buffer([np.zeros(8, np.uint8)]))


def test_unknown_mode_raises():
    for pkg, cls, err in ((nt, JConverter, Exception), (ntt, TensorConverter, ElementError)):
        el = cls({"mode": "nosuch"})
        with pytest.raises(err, match="unknown converter sub-plugin"):
            el.configure({"sink": pkg.Caps.any()}, ["src"])
    with pytest.raises(Exception, match="unknown converter sub-plugin"):
        ntt.Pipeline("appsrc name=src ! tensor_converter mode=nosuch ! tensor_sink")


def test_finalize_drops_a_partial_batch():
    pair = _pair({"frames_per_tensor": 3}, MediaType.VIDEO,
                 dict(format="RGB", width=4, height=2))
    dense, raw = _raw_frames(3, 2, 2, 4, 3, False)
    assert _feed(pair, raw) == []
    for el in pair:
        assert el.finalize() == []
    assert pair[1]._pending == []


def test_camera_bytes_pipeline_equal_jax():
    """Raw RGB bytes with a 4-byte stride through appsrc, converter and a
    transform, in both packages."""
    h, w = 3, 5
    dense, raw = _raw_frames(11, 4, h, w, 3, True)
    desc = (f"appsrc name=cam caps=video/x-raw,format=RGB,width={w},height={h},"
            "framerate=30/1 ! tensor_converter ! "
            "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_sink name=out")
    outs = {}
    for pkg in (nt, ntt):
        p = pkg.Pipeline(desc)
        with p:
            for f in raw:
                p.push("cam", f)
            outs[pkg] = [np.asarray(p.pull("out", timeout=30).tensors[0]) for _ in raw]
            p.eos()
            p.wait(timeout=30)
    for f, j, t in zip(dense, outs[nt], outs[ntt]):
        assert t.shape == (1, h, w, 3)
        # XLA rewrites x / c as x * (1/c): within an ulp of each other
        np.testing.assert_allclose(t, j, rtol=2e-7, atol=1e-7)
        np.testing.assert_array_equal(t[0], (f.astype(np.float32) - 127.5) / 127.5)


def test_unknown_converter_property_rejected():
    with pytest.raises(PipelineError, match="unknown element properties"):
        ntt.Pipeline("appsrc name=src caps=video/x-raw,format=RGB,width=2,height=2 ! "
                     "tensor_converter bogus=1 ! tensor_sink").start()


def test_caps_of_raw_video_negotiate_like_jax():
    el = TensorConverter({})
    caps = el.configure({"sink": Caps.new(MediaType.VIDEO, format="BGRx", width=5, height=3,
                                          framerate=(15, 1))}, ["src"])
    spec = caps["src"].spec
    assert spec[0].dims == (4, 5, 3, 1) and spec.rate == (15, 1)
