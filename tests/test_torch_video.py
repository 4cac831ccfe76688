"""``queue``, ``videoconvert``, ``videoscale`` and ``compositor`` in the
port against the JAX package's (``nnstreamer_tpu/elements/video.py``),
on the CPU: the cases of ``tests/test_video_elements.py``, each run
through both packages' elements or pipelines on the same numpy frames.
The arithmetic is the same numpy in both, so every output, bilinear
scaling and alpha blends included, is compared bitwise; the JAX test's
own expectations are kept beside the comparison.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.elements import video as jvideo
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.elements import video as tvideo
from nnstreamer_tpu_torch.elements.base import ElementError

SIDES = ((nt, jvideo, JBuffer), (ntt, tvideo, Buffer))


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _element(cls, props, fields, frame):
    """The same element of both packages on one frame -> the port's
    output, after checking it is bitwise the JAX package's (and the out
    caps equal)."""
    outs, caps = [], []
    for lib, mod, buf in SIDES:
        el = getattr(mod, cls)(dict(props))
        c = el.configure({"sink": lib.Caps.new("video/x-raw", **fields)}, ["src"])
        caps.append(dict(c["src"].fields))
        outs.append(np.asarray(el.process("sink", buf([frame]))[0][1].tensors[0]))
    _bitwise(outs[1], outs[0])
    assert caps[0] == caps[1]
    return outs[1]


def _group(props, in_fields, frames, pts=None):
    """Both packages' compositors on one group -> the port's output
    buffer, after checking it is bitwise the JAX package's."""
    outs = []
    for lib, mod, buf in SIDES:
        c = mod.Compositor(dict(props))
        c.configure({p: (lib.Caps.new("video/x-raw", **f) if f else lib.Caps.any())
                     for p, f in in_fields.items()}, ["src"])
        outs.append(c.process_group({
            p: buf([f], pts=None if pts is None else pts[p]) for p, f in frames.items()
        })[0][1])
    _bitwise(outs[1].tensors[0], outs[0].tensors[0])
    assert outs[1].pts == outs[0].pts
    return outs[1]


def _pipelines(desc, drive, **kw):
    """Run ``desc`` in both packages with ``drive(lib, p)`` -> port's
    buffers, after checking they are bitwise the JAX package's."""
    res = []
    for lib, _, _ in SIDES:
        p = lib.Pipeline(desc, **kw)
        with p:
            res.append(drive(lib, p))
            p.wait(timeout=30)
    for a, b in zip(res[1], res[0]):
        assert a.pts == b.pts
        _bitwise(a.tensors[0], b.tensors[0])
    assert len(res[0]) == len(res[1])
    return res[1]


def _frame():
    return np.random.default_rng(0).integers(0, 256, (4, 6, 3), np.uint8)


# -- videoconvert -----------------------------------------------------------------------

def test_rgb_to_bgr_roundtrip():
    f = _frame()
    out = _element("VideoConvert", {"format": "BGR"}, {"format": "RGB"}, f)
    np.testing.assert_array_equal(out, f[..., ::-1])
    back = _element("VideoConvert", {"format": "RGB"}, {"format": "BGR"}, out)
    np.testing.assert_array_equal(back, f)


def test_rgb_to_rgba_alpha_opaque():
    f = _frame()
    out = _element("VideoConvert", {"format": "RGBA"}, {"format": "RGB"}, f)
    assert out.shape == (4, 6, 4)
    np.testing.assert_array_equal(out[..., :3], f)
    assert (out[..., 3] == 255).all()


def test_gray8_bt601():
    f = np.zeros((2, 2, 3), np.uint8)
    f[0, 0] = [255, 0, 0]
    out = _element("VideoConvert", {"format": "GRAY8"}, {"format": "RGB"}, f)
    assert out.shape == (2, 2, 1) and out[0, 0, 0] == 76  # round(0.299*255)


def test_passthrough_without_format():
    f = _frame()
    np.testing.assert_array_equal(_element("VideoConvert", {}, {"format": "RGB"}, f), f)


def test_bad_format_rejected():
    for _, mod, _ in SIDES:
        with pytest.raises(Exception, match="unsupported format"):
            mod.VideoConvert({"format": "YUY2"})


def test_convert_takes_a_torch_tensor():
    f = _frame()
    el = tvideo.VideoConvert({"format": "BGRx"})
    el.configure({"sink": ntt.Caps.new("video/x-raw", format="RGB")}, ["src"])
    got = el.process("sink", Buffer([torch.from_numpy(f)]))[0][1].tensors[0]
    _bitwise(got, _element("VideoConvert", {"format": "BGRx"}, {"format": "RGB"}, f))


# -- videoscale -------------------------------------------------------------------------

def test_nearest_downscale():
    f = np.arange(16, dtype=np.uint8).reshape(4, 4, 1)
    out = _element("VideoScale", {"width": 2, "height": 2},
                   {"format": "GRAY8", "width": 4, "height": 4}, f)
    assert out.shape == (2, 2, 1)
    np.testing.assert_array_equal(out[..., 0], [[0, 2], [8, 10]])


def test_bilinear_constant_preserved():
    f = np.full((5, 7, 3), 111, np.uint8)
    out = _element("VideoScale", {"width": 13, "height": 9, "method": "bilinear"},
                   {"format": "RGB", "width": 7, "height": 5}, f)
    assert out.shape == (9, 13, 3) and (out == 111).all()


@pytest.mark.parametrize("method", ["nearest", "bilinear", "0", "1"])
@pytest.mark.parametrize("size", [(320, 320), (37, 53), (480, 640)])
def test_scale_a_camera_frame_bitwise(method, size):
    f = np.random.default_rng(1).integers(0, 256, (480, 640, 3), np.uint8)
    out = _element("VideoScale", {"width": size[1], "height": size[0], "method": method},
                   {"format": "RGB", "width": 640, "height": 480}, f)
    assert out.shape == (*size, 3)


def test_caps_carry_new_size():
    for lib, mod, _ in SIDES:
        s = mod.VideoScale({"width": 8, "height": 6})
        caps = s.configure({"sink": lib.Caps.new("video/x-raw", format="RGB", width=4,
                                                 height=4)}, ["src"])
        assert caps["src"].get("width") == 8 and caps["src"].get("height") == 6


def test_reference_style_pipeline_runs_verbatim():
    desc = ("videotestsrc num-buffers=2 width=12 height=10 pattern=random ! "
            "videoconvert format=RGB ! videoscale width=8 height=8 ! "
            "queue max-size-buffers=4 ! tensor_converter ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
            "tensor_sink name=out")
    bufs = _pipelines(desc, lambda lib, p: [p.pull("out", timeout=15) for _ in range(2)])
    for b in bufs:
        assert b.tensors[0].shape == (1, 8, 8, 3) and b.tensors[0].dtype == np.float32


# -- YUV ----------------------------------------------------------------------------------

def _solid_i420(h, w, y, u, v):
    return np.concatenate([np.full(h * w, y, np.uint8), np.full(h * w // 4, u, np.uint8),
                           np.full(h * w // 4, v, np.uint8)]).reshape(h * 3 // 2, w)


def test_i420_red_golden():
    frame = _solid_i420(4, 4, 82, 90, 240)  # BT.601 pure red
    rgb = tvideo._yuv_to_rgb(frame, 4, 4, "I420")
    _bitwise(rgb, jvideo._yuv_to_rgb(frame, 4, 4, "I420"))
    r, g, b = (int(c) for c in rgb[0, 0])
    assert r == 255 and g <= 2 and b <= 2


def test_rgb_i420_roundtrip():
    small = np.random.default_rng(0).integers(0, 256, (4, 4, 3), np.uint8)
    rgb = np.repeat(np.repeat(small, 2, 0), 2, 1)
    yuv = tvideo._rgb_to_yuv(rgb, "I420")
    _bitwise(yuv, jvideo._rgb_to_yuv(rgb, "I420"))
    back = tvideo._yuv_to_rgb(yuv, 8, 8, "I420")
    assert np.abs(back.astype(int) - rgb.astype(int)).max() <= 6


def test_nv12_matches_i420():
    rgb = np.random.default_rng(1).integers(0, 256, (8, 6, 3), np.uint8)
    a = tvideo._yuv_to_rgb(tvideo._rgb_to_yuv(rgb, "I420"), 8, 6, "I420")
    b = tvideo._yuv_to_rgb(tvideo._rgb_to_yuv(rgb, "NV12"), 8, 6, "NV12")
    np.testing.assert_array_equal(a, b)
    _bitwise(tvideo._rgb_to_yuv(rgb, "NV12"), jvideo._rgb_to_yuv(rgb, "NV12"))


@pytest.mark.parametrize("src,dst", [("I420", "RGB"), ("NV12", "BGRA"), ("I420", "NV12"),
                                     ("NV12", "GRAY8"), ("RGB", "I420"), ("RGBA", "NV12")])
def test_convert_yuv_bitwise(src, dst):
    rng = np.random.default_rng(2)
    if src in ("I420", "NV12"):
        frame = rng.integers(0, 256, (12, 8), np.uint8)
    else:
        frame = rng.integers(0, 256, (8, 8, 4 if src == "RGBA" else 3), np.uint8)
    _element("VideoConvert", {"format": dst}, {"format": src, "width": 8, "height": 8},
             frame)


def test_camera_pipeline_verbatim_i420():
    desc = ("appsrc name=cam caps=video/x-raw,format=I420,width=16,height=8 ! "
            "videoconvert format=RGB ! tensor_converter ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
            "tensor_sink name=out")

    def drive(lib, p):
        p.push("cam", _solid_i420(8, 16, 82, 90, 240))
        b = p.pull("out", timeout=15)
        p.eos()
        return [b]

    [b] = _pipelines(desc, drive)
    out = np.asarray(b.tensors[0])
    assert out.shape[-3:] == (8, 16, 3)
    assert out.reshape(-1, 3)[0, 0] == 1.0 and out.reshape(-1, 3)[0, 1] <= 0.01


def test_convert_rgb_to_nv12_and_back_pipeline():
    desc = ("appsrc name=src caps=video/x-raw,format=RGB,width=8,height=8 ! "
            "videoconvert format=NV12 ! tensor_sink name=out")
    rgb = np.repeat(np.repeat(np.random.default_rng(2).integers(0, 256, (4, 4, 3),
                                                                np.uint8), 2, 0), 2, 1)

    def drive(lib, p):
        p.push("src", rgb)
        b = p.pull("out", timeout=15)
        p.eos()
        return [b]

    [b] = _pipelines(desc, drive, fuse=False)
    assert np.asarray(b.tensors[0]).shape == (12, 8)


def test_compositor_i420_base():
    desc = ("appsrc name=cam caps=video/x-raw,format=I420,width=8,height=8 ! comp. "
            "appsrc name=ov caps=video/x-raw,format=RGBA,width=8,height=8 ! comp. "
            "compositor name=comp ! tensor_sink name=out")
    ov = np.zeros((8, 8, 4), np.uint8)
    ov[..., 1] = 200
    ov[..., 3] = 255

    def drive(lib, p):
        p.push("cam", _solid_i420(8, 8, 16, 128, 128))
        p.push("ov", ov)
        b = p.pull("out", timeout=15)
        p.eos("cam")
        p.eos("ov")
        return [b]

    [b] = _pipelines(desc, drive, fuse=False)
    out = np.asarray(b.tensors[0])
    assert out.shape == (12, 8)
    rgb = tvideo._yuv_to_rgb(out, 8, 8, "I420")
    assert abs(int(rgb[0, 0, 1]) - 200) <= 4 and rgb[0, 0, 0] <= 6 and rgb[0, 0, 2] <= 6


def test_videoscale_rejects_yuv():
    desc = ("appsrc name=src caps=video/x-raw,format=I420,width=8,height=8 ! "
            "videoscale width=4 height=4 ! tensor_sink name=out")
    for lib, _, _ in SIDES:
        with pytest.raises(Exception, match="videoconvert"):
            lib.Pipeline(desc).start()


def test_odd_dims_rejected():
    for _, mod, _ in SIDES:
        with pytest.raises(Exception, match="even"):
            mod._rgb_to_yuv(np.zeros((5, 4, 3), np.uint8), "I420")


# -- review regressions -----------------------------------------------------------------------

def test_alpha_preserved_rgba_to_bgra():
    f = np.zeros((2, 2, 4), np.uint8)
    f[..., 0], f[..., 2], f[..., 3] = 10, 30, 128
    out = _element("VideoConvert", {"format": "BGRA"}, {"format": "RGBA"}, f)
    assert (out[..., 3] == 128).all()
    assert (out[..., 0] == 30).all() and (out[..., 2] == 10).all()


def test_bilinear_2d_gray_frame():
    f = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = _element("VideoScale", {"width": 8, "height": 6, "method": "bilinear"},
                   {"format": "GRAY8"}, f)
    assert out.shape == (6, 8)


def test_bilinear_16bit_range():
    f = np.full((2, 2, 1), 1000, np.uint16)
    out = _element("VideoScale", {"width": 4, "height": 4, "method": "bilinear"},
                   {"format": "GRAY16_LE"}, f)
    assert (out == 1000).all()


# -- compositor -------------------------------------------------------------------------------

def test_source_over_blend():
    base = np.full((2, 2, 3), 100, np.uint8)
    ov = np.zeros((2, 2, 4), np.uint8)
    ov[0, 0] = [200, 0, 0, 255]
    ov[0, 1] = [200, 0, 0, 127]
    out = _group({}, {"sink_0": None, "sink_1": None}, {"sink_0": base, "sink_1": ov},
                 pts={"sink_0": 5, "sink_1": 9})
    o = out.tensors[0]
    np.testing.assert_array_equal(o[0, 0], [200, 0, 0])
    assert abs(int(o[0, 1, 0]) - 150) <= 1
    np.testing.assert_array_equal(o[1, 1], [100, 100, 100])
    assert out.pts == 9


@pytest.mark.parametrize("base_fmt,ov_fmt", [("RGB", "RGBA"), ("BGR", "ARGB"),
                                             ("GRAY8", "BGRA"), ("RGBx", "RGBA"),
                                             ("RGB", "RGB")])
def test_blend_formats_and_pad_alphas_bitwise(base_fmt, ov_fmt):
    rng = np.random.default_rng(3)
    cb = {"GRAY8": 1, "RGB": 3, "BGR": 3}.get(base_fmt, 4)
    co = 3 if ov_fmt == "RGB" else 4
    base = rng.integers(0, 256, (6, 5, cb), np.uint8)
    ovs = [rng.integers(0, 256, (6, 5, co), np.uint8) for _ in range(2)]
    _group({"sink_0::alpha": 0.75, "sink_2::alpha": 0.5},
           {"sink_0": {"format": base_fmt}, "sink_1": {"format": ov_fmt},
            "sink_2": {"format": ov_fmt}},
           {"sink_0": base, "sink_1": ovs[0], "sink_2": ovs[1]})


def test_size_mismatch_rejected():
    c = tvideo.Compositor({})
    c.configure({"sink_0": ntt.Caps.any(), "sink_1": ntt.Caps.any()}, ["src"])
    with pytest.raises(ElementError, match="videoscale"):
        c.process_group({"sink_0": Buffer([np.zeros((4, 4, 3), np.uint8)]),
                         "sink_1": Buffer([np.zeros((2, 2, 4), np.uint8)])})


def test_stock_overlay_pipeline():
    """tee'd video + detection overlay composited, the stock example's
    shape: the port's output against the JAX compositor on the port's own
    inputs (the two packages' random detectors differ)."""
    desc = ("videotestsrc num-buffers=2 width=32 height=32 pattern=ball name=cam ! "
            "tee name=t t. ! queue ! comp.sink_0 "
            "t. ! queue ! tensor_converter ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
            "tensor_filter framework=jax model=ssd_mobilenet "
            "custom=size:32,classes:4,batch:1,width:0.25 accelerator=true:cpu ! "
            "tensor_decoder mode=bounding_boxes option3=0.3 option4=32:32 ! comp.sink_1 "
            "compositor name=comp ! tensor_sink name=out")
    p = ntt.Pipeline(desc, fuse=False)
    comp = p.element("comp")
    seen = []
    real = comp.process_group

    def tap(bufs):
        outs = real(bufs)
        seen.append(({k: np.asarray(b.tensors[0]) for k, b in bufs.items()},
                     np.asarray(outs[0][1].tensors[0])))
        return outs

    comp.process_group = tap
    with p:
        bufs = [p.pull("out", timeout=60) for _ in range(2)]
        p.wait(timeout=30)
    for b in bufs:
        assert b.tensors[0].shape == (32, 32, 3) and "detections" in b.meta
    assert len(seen) == 2
    for ins, out in seen:
        j = jvideo.Compositor({})
        j.configure({"sink_0": nt.Caps.any(), "sink_1": nt.Caps.any()}, ["src"])
        want = j.process_group({k: JBuffer([v]) for k, v in ins.items()})[0][1]
        _bitwise(out, want.tensors[0])


def test_bare_refs_and_pad_alpha_and_bgr_base():
    desc = ("videotestsrc num-buffers=1 width=8 height=8 pattern=black ! "
            "videoconvert format=BGR ! comp. appsrc name=ov ! comp. "
            "compositor name=comp sink_1::alpha=0.5 ! tensor_sink name=out")
    ov = np.zeros((8, 8, 4), np.uint8)
    ov[..., 0], ov[..., 3] = 200, 255

    def drive(lib, p):
        p.push("ov", ov)
        b = p.pull("out", timeout=15)
        p.eos("ov")
        return [b]

    [b] = _pipelines(desc, drive, fuse=False)
    out = b.tensors[0]
    assert abs(int(out[0, 0, 2]) - 100) <= 1 and out[0, 0, 0] == 0


def test_queue_passes_buffers_through_unchanged():
    q = tvideo.Queue({"max_size_buffers": 4, "leaky": "downstream"})
    caps = q.configure({"sink": ntt.Caps.new("video/x-raw", format="RGB")}, ["src"])
    assert caps["src"].get("format") == "RGB"
    buf = Buffer([torch.arange(3)])
    assert q.process("sink", buf) == [("src", buf)]
    assert q.unknown_props() == set()
