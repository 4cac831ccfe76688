"""The decoders of the rest of the vision and audio paths in the port
against the JAX package's, on the CPU: ``bounding_boxes`` in its yolo
formats (``yolov5``/``yolo``, ``yolov8`` with and without ``option8``;
host and device NMS; overlay and tensors), ``pose_estimation`` (overlay
and tensors, with and without offsets), ``image_segment`` (overlay and
classmap) and ``ctc`` (ids and text).  Each runs the host ``decode`` and
the fused ``device_fn`` + ``host_post`` on the same arrays as the JAX
decoder (its ``device_fn`` jitted).

Tolerances: indices, classes, valid masks, class maps, CTC ids and
overlay pixels match exactly; coordinates and scores within 1e-6 (the
JAX package's fused program may compute a division as a product with
the reciprocal, 1 ulp off)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.decoders import ctc as jctc
from nnstreamer_tpu.decoders import image_segment as jseg
from nnstreamer_tpu.decoders import pose as jpose
from nnstreamer_tpu.models import posenet as jposenet, yolo as jyolo
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.decoders import ctc as tctc
from nnstreamer_tpu_torch.decoders import image_segment as tseg
from nnstreamer_tpu_torch.decoders import pose as tpose

torch.set_num_threads(2)

#: coordinates and scores: absolute
COORD_TOL = 1e-6


def _jax_fused(dec, arrays):
    fn, spec = dec.device_fn(TensorsSpec.of(arrays))
    outs = [np.asarray(t) for t in jax.jit(fn)(tuple(jnp.asarray(a) for a in arrays))]
    return dec.host_post(outs, JBuffer(outs)), outs


def _port_fused(dec, arrays):
    fn, spec = dec.device_fn(TensorsSpec.of(arrays))
    outs = [t.numpy() for t in fn(tuple(torch.from_numpy(a) for a in arrays))]
    if spec is not None:
        assert [o.shape for o in outs] == [s.shape for s in spec]
        assert [o.dtype for o in outs] == [np.dtype(s.dtype) for s in spec]
    return dec.host_post(outs, Buffer(outs)), outs


def _same_tensors(got, want, float_tol=COORD_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=float_tol)
        else:
            np.testing.assert_array_equal(g, w)


def _same_dets(a, b, tol=COORD_TOL):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["class_index"] == y["class_index"] and x["label"] == y["label"]
        assert abs(x["score"] - y["score"]) <= tol
        np.testing.assert_allclose(x["box"], y["box"], rtol=0, atol=tol)


# -- bounding_boxes: the yolo formats ------------------------------------------

@functools.lru_cache(maxsize=None)
def _yolo_outputs(v8: bool):
    """A toy yolo's outputs (JAX, f32) on random frames, sharpened so that
    detections clear a threshold: [2, N, 5+C] (v8: [2, 4+C, N])."""
    tree = jax.tree_util.tree_map(np.asarray, jyolo.init_params(
        classes=4, width=0.25, seed=5, anchors_per_cell=1 if v8 else 3,
        head_values=4 if v8 else 5))
    x = np.random.default_rng(7).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    fn = jyolo.apply_v8 if v8 else jyolo.apply
    out = np.array(jax.jit(functools.partial(fn, classes=4, size=96,
                                             compute_dtype="float32"))(tree, x))
    rng = np.random.default_rng(8)
    if v8:
        out[:, 4:] = rng.uniform(0, 1, out[:, 4:].shape) ** 3
    else:
        out[..., 4:] = rng.uniform(0, 1, out[..., 4:].shape) ** 2
    return out


_YOLO_CASES = [
    ("yolov5", "", "0.3"), ("yolo", "", "0.3"), ("yolov8", "", "0.4"),
    ("yolov8", "96", "0.4"), ("yolov8", "96:64", "0.4"),
]


@pytest.mark.parametrize("fmt,o8,thr", _YOLO_CASES)
@pytest.mark.parametrize("nms", ["host", "device"])
@pytest.mark.parametrize("form", ["overlay", "tensors"])
def test_bounding_boxes_yolo_fused_matches_jax(fmt, o8, thr, nms, form):
    pred = _yolo_outputs(fmt == "yolov8")
    if o8:  # pixel-coordinate boxes, as an ultralytics export carries them
        pred = pred.copy()
        w, h = (int(v) for v in (o8 + ":" + o8).split(":")[:2])
        pred[:, :4] *= np.array([w, h, w, h], np.float32)[:, None]
    props = {"option1": fmt, "option3": thr, "option4": "80:64", "option5": "0.45",
             "option6": "10", "option7": nms, "option8": o8, "option9": form}
    got, gouts = _port_fused(tbb.BoundingBoxes(dict(props)), [pred])
    want, wouts = _jax_fused(jbb.BoundingBoxes(dict(props)), [pred])
    _same_tensors(gouts, wouts)
    _same_tensors(got.tensors, want.tensors)
    if form == "overlay":
        assert len(got.meta["detections"]) == 2
        for g, w in zip(got.meta["detections"], want.meta["detections"]):
            _same_dets(g, w)
        assert sum(len(d) for d in got.meta["detections"]) > 0
    else:
        assert got.tensors[3].sum() > 0


@pytest.mark.parametrize("fmt,o8,thr", _YOLO_CASES)
@pytest.mark.parametrize("form", ["overlay", "tensors"])
def test_bounding_boxes_yolo_host_decode_matches_jax(fmt, o8, thr, form):
    pred = _yolo_outputs(fmt == "yolov8")
    props = {"option1": fmt, "option3": thr, "option4": "48:40", "option6": "20",
             "option8": o8, "option9": form}
    got = tbb.BoundingBoxes(dict(props)).decode([torch.from_numpy(pred)], Buffer([pred]))
    want = jbb.BoundingBoxes(dict(props)).decode([pred], JBuffer([pred]))
    assert len(got) == len(want) == 2  # one buffer per frame
    for g, w in zip(got, want):
        _same_dets(g.meta["detections"], w.meta["detections"], 0.0)
        _same_tensors(g.tensors, w.tensors, 0.0)
    assert sum(len(g.meta["detections"]) for g in got) > 0
    # one frame, unbatched
    g1 = tbb.BoundingBoxes(dict(props)).decode([pred[0]], Buffer([pred[0]]))
    w1 = jbb.BoundingBoxes(dict(props)).decode([pred[0]], JBuffer([pred[0]]))
    _same_dets(g1.meta["detections"], w1.meta["detections"], 0.0)


def test_yolo_topk_breaks_ties_by_lower_index_as_lax_top_k():
    pred = np.zeros((1, 40, 7), np.float32)
    pred[..., :4] = np.random.default_rng(0).uniform(0.2, 0.4, (1, 40, 4))
    pred[..., 4] = 0.5
    pred[..., 5:] = 0.5  # every score tied
    props = {"option1": "yolov5", "option3": "0.0", "option6": "3", "option9": "tensors"}
    _, g = _port_fused(tbb.BoundingBoxes(dict(props)), [pred])
    _, w = _jax_fused(jbb.BoundingBoxes(dict(props)), [pred])
    _same_tensors(g, w)


# -- pose_estimation -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pose_outputs():
    tree = jax.tree_util.tree_map(np.asarray, jposenet.init_params(width=0.25, seed=3))
    x = np.random.default_rng(4).uniform(0, 1, (3, 96, 96, 3)).astype(np.float32)
    heat, off = jax.jit(functools.partial(jposenet.apply, compute_dtype="float32"))(tree, x)
    return np.asarray(heat), np.asarray(off)


@pytest.mark.parametrize("form", ["overlay", "tensors"])
@pytest.mark.parametrize("with_off", [True, False])
@pytest.mark.parametrize("batch", [1, 3])
def test_pose_fused_matches_jax(form, with_off, batch):
    heat, off = _pose_outputs()
    arrays = [heat[:batch]] + ([off[:batch]] if with_off else [])
    props = {"option2": "96:80", "option3": "0.3", "option4": form}
    got, gouts = _port_fused(tpose.PoseEstimation(dict(props)), arrays)
    want, wouts = _jax_fused(jpose.PoseEstimation(dict(props)), arrays)
    _same_tensors(gouts, wouts, 0.0)
    _same_tensors(got.tensors, want.tensors)
    if form == "overlay":
        kg, kw = got.meta["keypoints"], want.meta["keypoints"]
        if batch == 1:
            kg, kw = [kg], [kw]
        for a, b in zip(kg, kw):
            for p, q in zip(a, b):
                assert abs(p["x"] - q["x"]) <= COORD_TOL and abs(p["y"] - q["y"]) <= COORD_TOL
                assert p["score"] == q["score"]
        assert got.tensors[0].any()


@pytest.mark.parametrize("form", ["overlay", "tensors"])
@pytest.mark.parametrize("with_off", [True, False])
def test_pose_host_decode_matches_jax(form, with_off):
    heat, off = _pose_outputs()
    props = {"option2": "64:48", "option3": "0.3", "option4": form}
    for arrays in ([heat] + ([off] if with_off else []),
                   [heat[0]] + ([off[0]] if with_off else [])):
        got = tpose.PoseEstimation(dict(props)).decode(
            [torch.from_numpy(a) for a in arrays], Buffer(arrays))
        want = jpose.PoseEstimation(dict(props)).decode(arrays, JBuffer(arrays))
        _same_tensors(got.tensors, want.tensors, 0.0)
        assert got.meta["keypoints"] == want.meta["keypoints"]


def test_pose_offsets_are_the_first_cells_pairs_as_in_the_reference():
    """The JAX decoder reads offsets.reshape(-1, 2)[:K], the 2K channels of
    cell (0, 0), whichever cell a keypoint's argmax picked: the port keeps
    that quirk on both paths."""
    heat = np.zeros((1, 4, 4, 2), np.float32)
    heat[0, 3, 2, 0] = heat[0, 1, 1, 1] = 1.0
    off = np.zeros((1, 4, 4, 4), np.float32)
    off[0, 0, 0] = [1.0, 2.0, 3.0, 4.0]  # cell (0, 0): used
    off[0, 3, 2] = [9.0, 9.0, 9.0, 9.0]  # the argmax cell: not used
    props = {"option2": "40:40", "option4": "tensors"}
    got, _ = _port_fused(tpose.PoseEstimation(dict(props)), [heat, off])
    np.testing.assert_allclose(got.tensors[0][0], [(2.5 + 1.0) * 10, (1.5 + 3.0) * 10])
    np.testing.assert_allclose(got.tensors[1][0], [(3.5 + 2.0) * 10, (1.5 + 4.0) * 10])
    host = tpose.PoseEstimation(dict(props)).decode([heat[0], off[0]], Buffer([heat[0]]))
    np.testing.assert_array_equal(host.tensors[0], got.tensors[0][0])


# -- image_segment ----------------------------------------------------------------

def _scores(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("form", ["overlay", "classmap"])
@pytest.mark.parametrize("shape", [(1, 9, 7, 21), (3, 9, 7, 21), (2, 5, 6, 300), (9, 7, 5)])
def test_image_segment_fused_matches_jax(form, shape):
    x = _scores(shape, seed=len(shape))
    props = {"option1": form}
    got, gouts = _port_fused(tseg.ImageSegment(dict(props)), [x])
    want, wouts = _jax_fused(jseg.ImageSegment(dict(props)), [x])
    _same_tensors(gouts, wouts, 0.0)
    _same_tensors(got.tensors, want.tensors, 0.0)
    np.testing.assert_array_equal(got.meta["class_map"], want.meta["class_map"])


@pytest.mark.parametrize("form", ["overlay", "classmap"])
@pytest.mark.parametrize("x", [_scores((9, 7, 21)), _scores((1, 9, 7, 5), 1),
                               np.arange(12, dtype=np.int32).reshape(3, 4) % 21])
def test_image_segment_host_decode_matches_jax(form, x):
    props = {"option1": form}
    got = tseg.ImageSegment(dict(props)).decode([torch.from_numpy(x)], Buffer([x]))
    want = jseg.ImageSegment(dict(props)).decode([x], JBuffer([x]))
    _same_tensors(got.tensors, want.tensors, 0.0)
    np.testing.assert_array_equal(got.meta["class_map"], want.meta["class_map"])


def test_image_segment_host_decode_takes_a_batch_as_the_fused_path_emits():
    """The JAX package's host path refuses a batch of score maps; the
    port's stacks them, equal to its own fused output."""
    x = _scores((3, 9, 7, 21), 5)
    for form in ("overlay", "classmap"):
        host = tseg.ImageSegment({"option1": form}).decode([torch.from_numpy(x)], Buffer([x]))
        fused, _ = _port_fused(tseg.ImageSegment({"option1": form}), [x])
        _same_tensors(host.tensors, fused.tensors, 0.0)
    with pytest.raises(ValueError):
        jseg.ImageSegment({"option1": "classmap"}).decode([x], JBuffer([x]))


def test_image_segment_admits_reduced_geometry_only_as_a_classmap():
    assert tseg.ImageSegment({"option1": "classmap"}).admits_reduced_payload
    assert not tseg.ImageSegment({}).admits_reduced_payload
    assert not tseg.ImageSegment({"option1": "overlay"}).admits_reduced_payload


# -- ctc -----------------------------------------------------------------------

def _logits(b, t, v, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, v)).astype(np.float32)
    # runs and blanks, as CTC emits them
    x[:, ::3, 0] += 3.0
    x[:, 1::5] = x[:, 0::5][:, : x[:, 1::5].shape[1]]
    return x


@pytest.mark.parametrize("labels", ["", "digits"])
@pytest.mark.parametrize("blank", ["", "2"])
@pytest.mark.parametrize("shape", [(3, 40, 10), (1, 25, 10), (25, 10)])
def test_ctc_host_and_fused_match_jax(labels, blank, shape):
    x = _logits(*((1,) + shape if len(shape) == 2 else shape), seed=len(shape))
    if len(shape) == 2:
        x = x[0]
    props = {"option1": blank, "option2": labels}
    got = tctc.CTC(dict(props)).decode([torch.from_numpy(x)], Buffer([x]))
    want = jctc.CTC(dict(props)).decode([x], JBuffer([x]))
    fgot, gouts = _port_fused(tctc.CTC(dict(props)), [x])
    fwant, wouts = _jax_fused(jctc.CTC(dict(props)), [x])
    _same_tensors(gouts, wouts, 0.0)
    for g in (got, fgot):
        _same_tensors(g.tensors, want.tensors, 0.0)
        assert [list(s) for s in g.meta["tokens"]] == [list(s) for s in want.meta["tokens"]]
        if labels:
            assert g.meta["text"] == want.meta["text"]
        else:
            np.testing.assert_array_equal(g.meta["lengths"], want.meta["lengths"])
    assert tctc.CTC(dict(props)).out_caps(None).media == \
        jctc.CTC(dict(props)).out_caps(None).media


@pytest.mark.parametrize("seed", range(4))
def test_collapse_ctc_is_the_jax_packages(seed):
    ids = np.random.default_rng(seed).integers(0, 4, (5, 30)).astype(np.int32)
    for blank in (0, 3):
        got, want = tctc.collapse_ctc(ids, blank), jctc.collapse_ctc(ids, blank)
        assert [list(g) for g in got] == [list(w) for w in want]
