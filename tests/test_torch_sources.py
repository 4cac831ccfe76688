"""``filesrc``, ``tensor_src_iio`` and ``v4l2src`` in the port against the
JAX package's (``nnstreamer_tpu/elements/source.py``), on the CPU.

Every reader here reads a regular file under ``tmp_path`` or a loopback
socket on port 0 whose server thread the test joins: no FIFO, no device
node, and the JAX ``v4l2src`` only on its raw backend (a regular file
under ``io-mode=auto`` takes it).  Values are bitwise the JAX
package's.  The port keeps the JAX raw backend's rule that a short tail
frame at EOF is dropped; the JAX native backend's skip of a short frame
mid-stream (its capture ring's ``continue``) has no counterpart, since
the port has no character-device backend: ``io-mode=native`` raises.
"""

import socket
import threading

import numpy as np
import pytest

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.elements import source as jsource
from nnstreamer_tpu.elements.base import ElementError as JElementError
from nnstreamer_tpu_torch.elements import source as tsource
from nnstreamer_tpu_torch.elements.base import ElementError

PKGS = {"jax": (nt, jsource), "port": (ntt, tsource)}


def _run(cls, props, stop=None):
    """start / generate / stop one source element -> its buffers."""
    el = cls(dict(props), name="src")
    el.configure({}, ["src"])
    el._stop_event = stop or threading.Event()
    el.start()
    try:
        return [b for b in el.generate()]
    finally:
        el.stop()


def _arrays(bufs):
    return [(b.pts, np.asarray(b.tensors[0])) for b in bufs]


def _same(a, b):
    assert len(a) == len(b)
    for (pa, xa), (pb, xb) in zip(a, b):
        assert pa == pb
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        assert xa.tobytes() == xb.tobytes()


# -- filesrc ---------------------------------------------------------------------

@pytest.mark.parametrize("blocksize", [0, 1000, 4096, 5000])
def test_filesrc_bytes_equal_the_jax_packages(tmp_path, blocksize):
    data = np.random.default_rng(0).integers(0, 256, 12345, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    props = {"location": str(path), "blocksize": blocksize}
    got = _arrays(_run(tsource.FileSrc, props))
    _same(got, _arrays(_run(jsource.FileSrc, props)))
    assert b"".join(x.tobytes() for _, x in got) == data
    caps = tsource.FileSrc(props).configure({}, ["src"])["src"]
    assert caps.media.value == "application/octet-stream"


def test_filesrc_to_filesink_pipeline_replays_the_bytes(tmp_path):
    data = np.random.default_rng(1).integers(0, 256, 3 * 4096 + 17,
                                             dtype=np.uint8).tobytes()
    (tmp_path / "in.bin").write_bytes(data)
    for lib in (ntt, nt):
        out = tmp_path / f"out_{lib.__name__}.bin"
        p = lib.Pipeline(f"filesrc location={tmp_path / 'in.bin'} blocksize=4096 ! "
                         f"filesink location={out}")
        with p:
            p.wait(timeout=30)
        assert out.read_bytes() == data


# -- tensor_src_iio ----------------------------------------------------------------

def _records(fmt, n, channels, seed=0):
    dt = tsource._IIO_FORMATS[fmt]
    rng = np.random.default_rng(seed)
    if dt.kind == "f":
        return rng.standard_normal(n * channels).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n * channels, endpoint=True).astype(dt)


@pytest.mark.parametrize("fmt", sorted(tsource._IIO_FORMATS))
def test_iio_file_scans_bitwise_the_jax_packages(tmp_path, fmt):
    channels, capacity = 3, 8
    raw = _records(fmt, 5 * capacity + 3, channels)  # 5 scans and a short tail
    path = tmp_path / "scan.bin"
    path.write_bytes(raw.tobytes())
    props = {"device": str(path), "scan_format": fmt, "channels": channels,
             "buffer_capacity": capacity, "scale": 0.125, "offset": -3.0,
             "num_buffers": -1}
    got = _arrays(_run(tsource.TensorSrcIIO, props))
    _same(got, _arrays(_run(jsource.TensorSrcIIO, props)))
    assert len(got) == 5  # the short tail scan is dropped
    want = (raw[:5 * capacity * channels].astype(np.float32) + np.float32(-3.0)) \
        * np.float32(0.125)
    np.testing.assert_array_equal(np.concatenate([x for _, x in got]).ravel(), want)
    assert got[0][1].shape == (capacity, channels) and got[0][1].dtype == np.float32


def test_iio_num_buffers_and_timer_trigger(tmp_path):
    raw = _records("s16le", 40, 2, seed=3)
    path = tmp_path / "scan.bin"
    path.write_bytes(raw.tobytes())
    props = {"device": str(path), "channels": 2, "buffer_capacity": 4, "num_buffers": 3,
             "trigger": "timer", "frequency": 400.0}
    got = _arrays(_run(tsource.TensorSrcIIO, props))
    _same(got, _arrays(_run(jsource.TensorSrcIIO, props)))
    assert [p for p, _ in got] == [0, 10_000_000, 20_000_000]


def _serve_once(payload: bytes):
    """A loopback server thread that sends ``payload`` to one client and
    closes -> (port, thread)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)

    def run():
        try:
            conn, _ = srv.accept()
        except OSError:
            srv.close()
            return
        with conn:
            for off in range(0, len(payload), 100):  # in pieces
                conn.sendall(payload[off:off + 100])
        srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], t


def test_iio_tcp_stream_bitwise_the_jax_packages():
    raw = _records("s32le", 6 * 4 + 1, 3, seed=4)
    out = {}
    for key, (_, mod) in PKGS.items():
        port, t = _serve_once(raw.tobytes())
        props = {"device": f"tcp://127.0.0.1:{port}", "scan_format": "s32le",
                 "channels": 3, "buffer_capacity": 4, "scale": 2.0, "num_buffers": -1}
        out[key] = _arrays(_run(mod.TensorSrcIIO, props))
        t.join(timeout=10)
        assert not t.is_alive()
    _same(out["port"], out["jax"])
    assert len(out["port"]) == 6


def test_iio_unreachable_stream_raises():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    el = tsource.TensorSrcIIO({"device": f"tcp://127.0.0.1:{port}"})
    with pytest.raises(ElementError, match="cannot reach sensor stream"):
        el.start()


def test_iio_stop_ends_a_stalled_stream():
    """A sender that stays silent: setting the stop event ends generate
    within the reader's poll, as the JAX package's does."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10.0)
    held = []
    accepted = threading.Event()

    def run():
        try:
            held.append(srv.accept()[0])
        except OSError:
            pass
        accepted.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    stop = threading.Event()
    el = tsource.TensorSrcIIO({"device": f"tcp://127.0.0.1:{srv.getsockname()[1]}",
                               "num_buffers": -1})
    el.configure({}, ["src"])
    el._stop_event = stop
    el.start()
    got = []
    reader = threading.Thread(target=lambda: got.extend(el.generate()), daemon=True)
    reader.start()
    assert accepted.wait(timeout=10)
    stop.set()
    reader.join(timeout=5)
    assert not reader.is_alive() and got == []
    el.stop()
    t.join(timeout=5)
    for c in held:
        c.close()
    srv.close()


def test_iio_pseudo_sensor_and_sampler():
    props = {"channels": 4, "buffer_capacity": 5, "num_buffers": 3, "frequency": 50.0}
    _same(_arrays(_run(tsource.TensorSrcIIO, props)),
          _arrays(_run(jsource.TensorSrcIIO, props)))

    def sampler(i):
        return np.arange(4) * 0.5 + i

    got = _arrays(_run(tsource.TensorSrcIIO, dict(props, sampler=sampler)))
    _same(got, _arrays(_run(jsource.TensorSrcIIO, dict(props, sampler=sampler))))
    assert got[1][1][0, 0] == 5.0


def test_iio_pipeline_caps_and_values(tmp_path):
    raw = _records("u16le", 12, 3, seed=6)
    path = tmp_path / "scan.bin"
    path.write_bytes(raw.tobytes())
    desc = (f"tensor_src_iio device={path} scan-format=u16le channels=3 "
            "buffer-capacity=4 num-buffers=3 ! tensor_sink name=out")
    out = {}
    for key, (lib, _) in PKGS.items():
        p = lib.Pipeline(desc)
        with p:
            out[key] = [(b.pts, np.asarray(b.tensors[0]))
                        for b in (p.pull("out", timeout=30) for _ in range(3))]
            p.wait(timeout=30)
    _same(out["port"], out["jax"])


@pytest.mark.parametrize("props,match", [
    ({"scan_format": "s24le"}, "unknown scan-format"),
    ({"trigger": "edge"}, "trigger must be data"),
])
def test_iio_bad_props_raise_like_the_jax_package(props, match):
    with pytest.raises(JElementError, match=match):
        jsource.TensorSrcIIO(dict(props))
    with pytest.raises(ElementError, match=match):
        tsource.TensorSrcIIO(dict(props))


def test_iio_missing_device_raises(tmp_path):
    el = tsource.TensorSrcIIO({"device": str(tmp_path / "nope")})
    with pytest.raises(ElementError, match="cannot open device"):
        el.start()


# -- v4l2src: the raw backend ---------------------------------------------------------

def _frames(n, h, w, bpp, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, bpp), dtype=np.uint8)


@pytest.mark.parametrize("fmt,bpp", [("RGB", 3), ("GRAY8", 1), ("YUY2", 2)])
def test_v4l2src_raw_file_frames_and_pts_equal_the_jax_packages(tmp_path, fmt, bpp):
    """Frames from a regular file, the short tail frame at EOF dropped
    (the JAX raw backend's rule, which the port keeps)."""
    h, w = 6, 10
    frames = _frames(4, h, w, bpp)
    path = tmp_path / "cam.raw"
    path.write_bytes(frames.tobytes() + frames[0].tobytes()[:7])  # a short tail
    props = {"device": str(path), "width": w, "height": h, "format": fmt,
             "framerate": "25/1"}
    got = _arrays(_run(tsource.V4L2Src, props))
    _same(got, _arrays(_run(jsource.V4L2Src, props)))
    assert len(got) == 4
    assert [p for p, _ in got] == [i * 40_000_000 for i in range(4)]
    for (_, x), f in zip(got, frames):
        np.testing.assert_array_equal(x, f)
    caps = tsource.V4L2Src(props).configure({}, ["src"])["src"]
    jcaps = jsource.V4L2Src(props).configure({}, ["src"])["src"]
    assert caps.media.value == jcaps.media.value == "video/x-raw"
    assert dict(caps.fields) == dict(jcaps.fields)


def test_v4l2src_num_buffers_and_io_mode_raw(tmp_path):
    frames = _frames(5, 4, 4, 3, seed=2)
    path = tmp_path / "cam.raw"
    path.write_bytes(frames.tobytes())
    props = {"device": str(path), "width": 4, "height": 4, "num_buffers": 3,
             "io_mode": "raw"}
    got = _arrays(_run(tsource.V4L2Src, props))
    _same(got, _arrays(_run(jsource.V4L2Src, props)))
    assert len(got) == 3


def test_v4l2src_pipeline_through_the_converter(tmp_path):
    frames = _frames(3, 8, 12, 3, seed=4)
    path = tmp_path / "cam.raw"
    path.write_bytes(frames.tobytes())
    desc = (f"v4l2src device={path} width=12 height=8 ! tensor_converter ! "
            "tensor_sink name=out")
    out = {}
    for key, (lib, _) in PKGS.items():
        p = lib.Pipeline(desc)
        with p:
            out[key] = [(b.pts, np.asarray(b.tensors[0]))
                        for b in (p.pull("out", timeout=30) for _ in range(3))]
            p.wait(timeout=30)
    _same(out["port"], out["jax"])
    assert out["port"][0][1].shape == (1, 8, 12, 3)


def test_v4l2src_missing_device_raises_like_the_jax_package(tmp_path):
    props = {"device": str(tmp_path / "video9")}
    with pytest.raises(JElementError, match="cannot stat device"):
        jsource.V4L2Src(dict(props)).start()
    with pytest.raises(ElementError, match="cannot stat device"):
        tsource.V4L2Src(dict(props)).start()


@pytest.mark.parametrize("props,match", [
    ({"format": "NV12"}, "format must be one of"),
    ({"io_mode": "dma"}, "io-mode must be auto"),
])
def test_v4l2src_bad_props_raise_like_the_jax_package(props, match):
    with pytest.raises(JElementError, match=match):
        jsource.V4L2Src(dict(props))
    with pytest.raises(ElementError, match=match):
        tsource.V4L2Src(dict(props))


def test_v4l2src_native_backend_is_not_ported(tmp_path):
    """``io-mode=native`` raises at start, naming what to use instead,
    before anything is opened (the JAX native path is never driven)."""
    path = tmp_path / "cam.raw"
    path.write_bytes(b"\0" * 48)
    el = tsource.V4L2Src({"device": str(path), "width": 4, "height": 4,
                          "io_mode": "native"})
    with pytest.raises(ElementError, match="not ported.*io-mode=raw"):
        el.start()
    assert el._reader is None
