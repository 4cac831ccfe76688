"""The vision path's modules in the port against the JAX package's, on
the CPU: the SAME-padded convs, mobilenet_v1 and ssd_mobilenet with the
JAX package's weights carried across, the anchors, every
tensor_transform mode, the SSD top-k and NMS, the bounding_boxes and
image_labeling decoders and videotestsrc.

Tolerances (float32): a model output may differ from the JAX package's by
1e-4 of its largest magnitude (XLA's and torch's convolutions sum in
different orders); integer outputs, anchors, frames, top-k orders and NMS
picks must match exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.decoders.image_labeling import ImageLabeling as JaxLabeling
from nnstreamer_tpu.elements.source import VideoTestSrc as JaxVideoTestSrc
from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform
from nnstreamer_tpu.models import mobilenet as jmob, ssd as jssd
from nnstreamer_tpu.ops.nms import nms_jax
from nnstreamer_tpu.ops.nms import nms_numpy as jax_nms_numpy
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.decoders.image_labeling import ImageLabeling
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.elements.source import VideoTestSrc
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.models import backbone as tbk, mobilenet as tmob, ssd as tssd
from nnstreamer_tpu_torch.ops.nms import nms_numpy, nms_torch

torch.set_num_threads(2)

#: float32 model outputs: share of the largest magnitude
F32_TOL = 1e-4


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _mobilenet_tree():
    return _np_tree(jmob.init_params(width=0.25, classes=10, seed=1))


@functools.lru_cache(maxsize=None)
def _ssd_tree():
    return _np_tree(jssd.init_params(classes=5, width=0.25, seed=4))


# -- convolutions ------------------------------------------------------------

@pytest.mark.parametrize("size", [7, 8, 15, 16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depthwise", [False, True])
def test_same_padded_conv_matches_xla(size, stride, depthwise):
    rng = np.random.default_rng(size * 10 + stride)
    cin = 8
    cout = cin if depthwise else 16
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1 if depthwise else cin, cout)).astype(np.float32)
    want = lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=cin if depthwise else 1)
    conv2d, _, _ = tbk.make_ops(torch.float32)
    wt = tbk.prepare(tbk.params_from_jax(w, "cpu"), torch.float32)
    got = conv2d(tbk.nhwc_to_internal(torch.from_numpy(x), torch.float32), wt,
                 stride, groups=cin if depthwise else 1).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("size,stride", [(224, 16), (257, 16), (320, 32), (33, 2)])
def test_rounding_and_feature_map_sizes(size, stride):
    from nnstreamer_tpu.models import backbone as jbk

    assert tbk.fm_size(size, stride) == jbk.fm_size(size, stride)
    for ch, w in ((32, 1.0), (32, 0.25), (1024, 0.75), (8, 0.1)):
        assert tbk.rounded(ch, w) == jbk.rounded(ch, w)


# -- models -----------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 40])
def test_mobilenet_apply_matches_jax(size):
    tree = _mobilenet_tree()
    x = np.random.default_rng(2).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jmob.apply, compute_dtype="float32"))(tree, x))
    params = tmob.params_from_jax(tree, "cpu")
    got = tmob.apply(params, torch.from_numpy(x), compute_dtype="float32")
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_mobilenet_bf16_rounds_like_jax():
    """bf16 on both sides, same weights: a looser bound (bf16 rounding of
    every conv output, ~0.4% a rounding), same labels."""
    tree = _mobilenet_tree()
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jmob.apply, compute_dtype="bfloat16"))(tree, x))
    got = tmob.apply(tbk.prepare(tmob.params_from_jax(tree, "cpu"), torch.bfloat16),
                     torch.from_numpy(x), compute_dtype="bfloat16").numpy()
    _close(got, want, 3e-2)


@pytest.mark.parametrize("size", [64, 96])
def test_ssd_apply_matches_jax(size):
    tree = _ssd_tree()
    x = np.random.default_rng(5).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    anchors = jssd.build_anchors(size)
    wb, ws = jax.jit(functools.partial(
        jssd.apply, anchors=anchors, classes=5, compute_dtype="float32"))(tree, x)
    gb, gs = tssd.apply(tssd.params_from_jax(tree, "cpu"), torch.from_numpy(x),
                        anchors=torch.from_numpy(tssd.build_anchors(size)),
                        classes=5, compute_dtype="float32")
    assert gb.shape == (2, anchors.shape[0], 4) and gs.shape == (2, anchors.shape[0], 5)
    _close(gb.numpy(), np.asarray(wb))
    _close(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("size", [64, 96, 320])
def test_anchors_bitwise(size):
    a, b = tssd.build_anchors(size), jssd.build_anchors(size)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_zoo_builds_on_the_given_device_from_a_seed():
    from nnstreamer_tpu_torch.models import zoo

    b1 = zoo.build("mobilenet_v1", {"width": "0.25", "size": "32", "classes": "4",
                                    "dtype": "float32"}, device="cpu")
    b2 = zoo.build("mobilenet_v1", {"width": "0.25", "size": "32", "classes": "4",
                                    "dtype": "float32"}, device="cpu")
    assert b1.in_spec.to_string() == "num=1 dims=3:32:32:1 types=float32 fmt=static"
    assert b1.out_spec[0].shape == (1, 4)
    assert torch.equal(b1.params["block3"]["pw"], b2.params["block3"]["pw"])
    s = zoo.build("ssd_mobilenet", {"width": "0.25", "size": "64", "classes": "3",
                                    "batch": "2"}, device="cpu")
    assert s.params["stem"]["w"].dtype == torch.bfloat16
    assert [t.shape for t in s.out_spec] == [(2, 80, 4), (2, 80, 3)]
    with pytest.raises(ValueError):
        zoo.build("ssd_mobilenet", {"size": "70"}, device="cpu")


# -- tensor_transform ---------------------------------------------------------

EDGES = np.array([[-300.7, -129.0, -1.5, 0.0, 0.4, 127.6, 255.5, 300.2,
                   3.1e9, -3.1e9, 65535.9, 1e5]], np.float32)

TRANSFORMS = [
    ("typecast", "uint8", EDGES),
    ("typecast", "int8", EDGES),
    ("typecast", "int16", EDGES),
    ("typecast", "uint16", EDGES),
    ("typecast", "int32", EDGES),
    ("typecast", "float32", np.arange(12, dtype=np.uint8).reshape(3, 4)),
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5",
     np.arange(24, dtype=np.uint8).reshape(2, 4, 3) * 10),
    ("arithmetic", "mul:2,add:3", np.arange(12, dtype=np.int32).reshape(3, 4)),
    ("arithmetic", "add:1|2|3@0,mul:0.5", np.arange(24, dtype=np.float32).reshape(2, 4, 3)),
    ("arithmetic", "mul:300.5,typecast:uint8", np.arange(12, dtype=np.float32).reshape(3, 4)),
    ("arithmetic", "mul:1e10,typecast:int32", np.linspace(-2, 2, 12, dtype=np.float32)),
    ("arithmetic", "pow:2", np.linspace(0, 3, 12, dtype=np.float32)),
    ("arithmetic", "sub:1.5", np.arange(6, dtype=np.uint8)),
    ("transpose", "1:0:2:3", np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4)),
    ("dimchg", "0:2", np.arange(24, dtype=np.float32).reshape(2, 3, 4)),
    ("clamp", "-1.5:2.25", np.linspace(-4, 4, 12, dtype=np.float32)),
    ("stand", "", np.random.default_rng(0).random((2, 5, 3)).astype(np.float32)),
    ("stand", "dc-average", np.random.default_rng(1).random((2, 5, 3)).astype(np.float32)),
    ("stand", "default:per-channel", np.random.default_rng(2).random((2, 5, 3)).astype(np.float32)),
    ("padding", "0:1:2,1:0:1", np.arange(12, dtype=np.uint8).reshape(3, 4)),
]


@pytest.mark.parametrize("mode,option,x", TRANSFORMS,
                         ids=[f"{m}-{o}" for m, o, _ in TRANSFORMS])
def test_transform_modes_match_jax_host_and_device(mode, option, x):
    props = {"mode": mode, "option": option}
    jt, tt = JaxTransform(dict(props)), TensorTransform(dict(props))
    want = np.asarray(jt.transform(Buffer([x])).tensors[0])
    host = np.asarray(tt.transform(Buffer([x])).tensors[0])
    assert host.dtype == want.dtype and host.shape == want.shape
    spec = TensorsSpec.of([x])
    fn, out_spec = tt.device_fn(spec)
    dev = fn((torch.from_numpy(np.ascontiguousarray(x)),))[0].numpy()
    jfn, jspec = jt.device_fn(spec)
    jdev = np.asarray(jfn((jnp.asarray(x),))[0])
    assert out_spec[0].shape == jspec[0].shape and out_spec[0].dtype == jspec[0].dtype
    assert dev.dtype == jdev.dtype == out_spec[0].dtype
    if want.dtype.kind == "f":
        # numpy and torch sum in different orders (stand): float32 ulps
        np.testing.assert_allclose(host, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dev, jdev, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-6)
    else:
        # saturating casts: the same integers on both paths
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev, jdev)
        np.testing.assert_array_equal(dev, host)


def test_saturating_cast_edges():
    tt = TensorTransform({"mode": "typecast", "option": "uint8"})
    out = tt.transform(Buffer([EDGES])).tensors[0]
    assert out[0, :8].tolist() == [0, 0, 0, 0, 0, 127, 255, 255]
    ti = TensorTransform({"mode": "typecast", "option": "int32"})
    out = ti.device_fn(TensorsSpec.of([EDGES]))[0]((torch.from_numpy(EDGES),))[0]
    assert out[0, 8].item() == 2**31 - 1 and out[0, 9].item() == -2**31


# -- top-k and NMS ------------------------------------------------------------

def test_ssd_topk_breaks_ties_by_lower_index_as_lax_top_k():
    rng = np.random.default_rng(6)
    b, n, c, k = 3, 40, 4, 16
    scores = np.round(rng.random((b, n, c)) * 4) / 4  # few distinct values
    scores = scores.astype(np.float32)
    scores[1, :, :] = 0.5  # every score tied
    boxes = rng.random((b, n, 4)).astype(np.float32)
    got = [t.numpy() for t in tbb._ssd_topk(torch.from_numpy(boxes),
                                             torch.from_numpy(scores), k)]
    want = [np.asarray(t) for t in jbb._ssd_topk(jnp.asarray(boxes),
                                                  jnp.asarray(scores), k)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1], boxes[1, :k])  # ties: index order


def _nms_case(seed, b=3, n=48):
    rng = np.random.default_rng(seed)
    xy = rng.random((b, n, 2)).astype(np.float32) * 0.8
    wh = rng.random((b, n, 2)).astype(np.float32) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = rng.permutation(b * n).reshape(b, n).astype(np.float32) / (b * n)
    scores[:, ::7] = -np.inf  # not candidates
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_out", [5, 16, 60])
def test_nms_torch_matches_nms_jax_and_numpy(seed, max_out):
    boxes, scores = _nms_case(seed)
    idx, valid = nms_torch(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.4, max_out)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    for f in range(boxes.shape[0]):
        ji, jv = nms_jax(jnp.asarray(boxes[f]), jnp.asarray(scores[f]), 0.4, max_out)
        np.testing.assert_array_equal(idx[f].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[f].numpy(), np.asarray(jv))
        live = np.isfinite(scores[f])
        keep = np.flatnonzero(live)[nms_numpy(boxes[f][live], scores[f][live],
                                               0.4, max_out)]
        np.testing.assert_array_equal(idx[f].numpy()[valid[f].numpy()], keep)


def test_nms_numpy_is_the_jax_packages():
    boxes, scores = _nms_case(3, b=1)
    live = np.isfinite(scores[0])
    np.testing.assert_array_equal(
        nms_numpy(boxes[0][live], scores[0][live], 0.5, 20),
        jax_nms_numpy(boxes[0][live], scores[0][live], 0.5, 20))


# -- decoders ---------------------------------------------------------------

def _det_inputs(seed=8, b=2, n=120, c=4):
    rng = np.random.default_rng(seed)
    xy = rng.random((b, n, 2)).astype(np.float32) * 0.7
    boxes = np.concatenate([xy, xy + 0.05 + rng.random((b, n, 2)).astype(np.float32) * 0.25],
                           axis=-1)
    scores = (rng.permutation(b * n * c).reshape(b, n, c) / (b * n * c)).astype(np.float32)
    return boxes, scores


def _jax_fused(dec, arrays):
    from nnstreamer_tpu.core.buffer import Buffer as JBuffer

    fn, _ = dec.device_fn(TensorsSpec.of(arrays))
    outs = [np.asarray(t) for t in fn(tuple(jnp.asarray(a) for a in arrays))]
    return dec.host_post(outs, JBuffer(outs))


def _port_fused(dec, arrays):
    fn, spec = dec.device_fn(TensorsSpec.of(arrays))
    outs = [t.numpy() for t in fn(tuple(torch.from_numpy(a) for a in arrays))]
    assert [o.shape for o in outs] == [s.shape for s in spec]
    return dec.host_post(outs, Buffer(outs))


def _same_dets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["class_index"] == y["class_index"] and x["label"] == y["label"]
        assert x["score"] == y["score"]
        assert x["box"] == y["box"]


@pytest.mark.parametrize("nms", ["host", "device"])
@pytest.mark.parametrize("form", ["overlay", "tensors"])
def test_bounding_boxes_fused_matches_jax(nms, form):
    boxes, scores = _det_inputs()
    props = {"option1": "ssd", "option3": "0.3", "option4": "48:40",
             "option5": "0.45", "option6": "12", "option7": nms, "option9": form}
    got = _port_fused(tbb.BoundingBoxes(dict(props)), [boxes, scores])
    want = _jax_fused(jbb.BoundingBoxes(dict(props)), [boxes, scores])
    assert len(got.tensors) == len(want.tensors)
    for g, w in zip(got.tensors, want.tensors):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if form == "overlay":
        for g, w in zip(got.meta["detections"], want.meta["detections"]):
            _same_dets(g, w)
        assert sum(len(d) for d in got.meta["detections"]) > 0


@pytest.mark.parametrize("form", ["overlay", "tensors"])
def test_bounding_boxes_host_decode_matches_jax(form):
    boxes, scores = _det_inputs(seed=9)
    props = {"option1": "ssd", "option3": "0.25", "option4": "32:32",
             "option6": "20", "option9": form}
    from nnstreamer_tpu.core.buffer import Buffer as JBuffer

    got = tbb.BoundingBoxes(dict(props)).decode(
        [torch.from_numpy(boxes), torch.from_numpy(scores)], Buffer([boxes, scores]))
    want = jbb.BoundingBoxes(dict(props)).decode([boxes, scores], JBuffer([boxes, scores]))
    assert len(got) == len(want) == 2  # one buffer per frame
    for g, w in zip(got, want):
        _same_dets(g.meta["detections"], w.meta["detections"])
        for a, b in zip(g.tensors, w.tensors):
            np.testing.assert_array_equal(a, b)
    # one frame, unbatched
    g1 = tbb.BoundingBoxes(dict(props)).decode([boxes[0], scores[0]], Buffer([boxes[0]]))
    w1 = jbb.BoundingBoxes(dict(props)).decode([boxes[0], scores[0]], JBuffer([boxes[0]]))
    _same_dets(g1.meta["detections"], w1.meta["detections"])


def test_bounding_boxes_yolo_formats_raise_not_yet_ported():
    """The yolo formats came with the yolo models
    (tests/test_torch_decoders.py holds them against the JAX package):
    they construct now, and an unknown format is what raises."""
    for fmt in ("yolov5", "yolo", "yolov8"):
        assert tbb.BoundingBoxes({"option1": fmt}).format == fmt
    with pytest.raises(ValueError, match="unknown bounding-box format"):
        tbb.BoundingBoxes({"option1": "yolov9"})


@pytest.mark.parametrize("batch", [1, 3])
def test_image_labeling_host_and_device_match_jax(batch):
    from nnstreamer_tpu.core.buffer import Buffer as JBuffer

    scores = np.random.default_rng(batch).random((batch, 1001)).astype(np.float32)
    scores[:, 7] = scores.max(axis=1)  # a planted tie: the first index wins
    td, jd = ImageLabeling({}), JaxLabeling({})
    host = td.decode([torch.from_numpy(scores)], Buffer([scores]))
    jhost = jd.decode([scores], JBuffer([scores]))
    fn, spec = td.device_fn(TensorsSpec.of([scores]))
    outs = [t.numpy() for t in fn((torch.from_numpy(scores),))]
    assert [o.dtype for o in outs] == [np.int32, np.float32]
    post = td.host_post(outs, Buffer(outs))
    jfn, _ = jd.device_fn(TensorsSpec.of([scores]))
    jouts = [np.asarray(t) for t in jfn((jnp.asarray(scores),))]
    jpost = jd.host_post(jouts, JBuffer(jouts))
    for got, want in ((host, jhost), (post, jpost)):
        assert got.meta["label"] == want.meta["label"]
        np.testing.assert_array_equal(got.meta["label_index"], want.meta["label_index"])
        np.testing.assert_array_equal(got.meta["score"], want.meta["score"])
        np.testing.assert_array_equal(got.tensors[0], want.tensors[0])


# -- videotestsrc ---------------------------------------------------------------

PATTERNS = ["smpte", "ball", "black", "white", "random"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("fmt", ["RGB", "GRAY8"])
def test_videotestsrc_host_frames_bitwise(pattern, fmt):
    props = {"width": 37, "height": 23, "pattern": pattern, "format": fmt}
    t, j = VideoTestSrc(dict(props)), JaxVideoTestSrc(dict(props))
    for i in (0, 1, 5, 300):
        a, b = t._frame(i), j._frame(i)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("pattern", PATTERNS[:4])
def test_videotestsrc_device_batches_bitwise(pattern):
    props = {"width": 30, "height": 18, "pattern": pattern, "device": True, "batch": 4}
    t, j = VideoTestSrc(dict(props)), JaxVideoTestSrc(dict(props))
    make = j._device_batch_fn()
    for i0 in (0, 4, 1000):
        want = np.asarray(make(i0))
        got = t.device_batch(i0, 4, "cpu").numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        host = np.stack([t._frame(i0 + k) for k in range(4)])
        assert got.tobytes() == host.tobytes()


def test_videotestsrc_device_generate_truncates_the_tail_batch():
    src = VideoTestSrc({"width": 8, "height": 6, "pattern": "smpte", "device": True,
                        "batch": 4, "num_buffers": 10})
    src.gen_device = torch.device("cpu")  # the planner's part in a pipeline
    bufs = list(src.generate())
    assert [b.tensors[0].shape[0] for b in bufs] == [4, 4, 2]
    allf = torch.cat([b.tensors[0] for b in bufs]).numpy()
    assert allf.tobytes() == np.stack([src._frame(i) for i in range(10)]).tobytes()


def test_videotestsrc_device_random_raises_not_yet_ported():
    with pytest.raises(ElementError, match="not yet ported"):
        VideoTestSrc({"device": True, "pattern": "random"})
    VideoTestSrc({"device": False, "pattern": "random"})  # the host pattern ports
