"""The rest of BASELINE's model families in the port against the JAX
package's, on the CPU: ``yolov5``, ``yolov8`` and ``yolov5s``, ``posenet``,
``deeplab_mobilenet`` (``upsample`` 0 and 1) and the audio models
``speech_commands`` and ``wav2vec2``, with the JAX package's weights
carried across by ``params_from_jax``; then the vision cells as pipeline
strings (yolov5s detection, posenet, deeplab segmentation), fused and
unfused, against the JAX pipeline on the same string, and the residency
planner's choice of deeplab's output.  The test-only zoo names
``<model>_jax_weights`` build the port's bundles from the JAX package's
trees.

Tolerances: a float32 model output may differ from the JAX package's by
``F32_TOL`` of its largest magnitude (at least 1): XLA's and torch's
convolutions and products sum in other orders.  In bfloat16 both sides
round every op's output to 8 bits, and the bound is ``BF16_TOL``.  A
pipeline's ids, classes, class maps and valid masks equal the JAX
pipeline's wherever the JAX model's top-1/top-2 gap exceeds the model
tolerance (where it does not, the port's decoder fed the JAX model's
outputs must give the JAX pipeline's output exactly, so a torch-vs-XLA
rounding cannot fail the test for the wrong reason); scores and
coordinates agree within the model tolerance carried through."""

import functools
import re

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.models import audio as jaudio, posenet as jposenet
from nnstreamer_tpu.models import segment as jseg, yolo as jyolo
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb, pose as tpose
from nnstreamer_tpu_torch.models import audio as taudio, backbone as tbk
from nnstreamer_tpu_torch.models import posenet as tposenet, segment as tseg
from nnstreamer_tpu_torch.models import yolo as tyolo, zoo as tzoo
from nnstreamer_tpu_torch.pipeline.plan import FusedElement, FusedSourceElement

torch.set_num_threads(2)

#: float32 model outputs: share of the largest magnitude (at least 1)
F32_TOL = 1e-4
#: bfloat16 on both sides: every op rounds to 8 bits; the deepest model
#: here (wav2vec2's transformer layers) moves 1.1% at these seeds
BF16_TOL = 3e-2


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(kind, **kw):
    init = {"yolov5": jyolo.init_params, "yolov5s": jyolo.init_v5s_params,
            "posenet": jposenet.init_params, "deeplab": jseg.init_params,
            "kws": jaudio.init_params_kws, "w2v": jaudio.init_params_w2v}[kind]
    return _np_tree(init(**kw))


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


# -- the models --------------------------------------------------------------

def _frames(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("v8", [False, True])
@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_toy_yolo_matches_jax(v8, size, dtype):
    tree = _jax_tree("yolov5", classes=4, width=0.25, seed=2,
                     anchors_per_cell=1 if v8 else 3, head_values=4 if v8 else 5)
    x = _frames((2, size, size, 3), size)
    want = np.asarray(_jit(jyolo.apply_v8 if v8 else jyolo.apply, classes=4, size=size,
                           compute_dtype=dtype)(tree, x))
    b = tyolo.build_bundle(tyolo.params_from_jax(tree, "cpu"),
                           dict(classes="4", size=str(size), batch="2", dtype=dtype),
                           "cpu", "t", v8=v8)
    got = b.apply_fn(b.params, torch.from_numpy(x))
    assert tuple(got.shape) == b.out_spec[0].shape and got.dtype == torch.float32
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov5s_matches_jax(size, dtype):
    tree = _jax_tree("yolov5s", classes=5, width=0.25, depth=0.33, seed=3)
    x = _frames((2, size, size, 3), size + 1)
    want = np.asarray(_jit(jyolo.apply_v5s, classes=5, size=size,
                           compute_dtype=dtype)(tree, x))
    b = tyolo.build_bundle_v5s(tyolo.params_from_jax(tree, "cpu"),
                               dict(classes="5", size=str(size), batch="2", dtype=dtype),
                               "cpu", "t")
    got = b.apply_fn(b.params, torch.from_numpy(x))
    assert tuple(got.shape) == b.out_spec[0].shape == (2, tyolo.num_predictions_v5s(size), 10)
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_yolov5s_full_geometry_and_spec_match_jax():
    """At the default width 0.5 / depth 0.33: the same channel and depth
    plan, the same parameter tree and the same 640 output spec."""
    assert tyolo.v5s_channels() == jyolo.v5s_channels() == [32, 64, 128, 256, 512]
    assert tyolo.v5s_depths() == jyolo.v5s_depths() == [1, 2, 3, 1]
    port = tyolo.init_v5s_params(classes=91, device="cpu")
    ref = jax.eval_shape(lambda: jyolo.init_v5s_params(classes=91))
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    for (_, p), (_, r) in zip(flat_p, flat_r):
        want = r.shape if len(r.shape) != 4 else (r.shape[3], r.shape[2], r.shape[0], r.shape[1])
        assert tuple(p.shape) == tuple(want)
    assert tyolo.num_predictions_v5s(640) == jyolo.num_predictions_v5s(640) == 25200
    jb = jyolo._yolov5s({"size": "640", "classes": "91", "batch": "64"})
    tb = tzoo.build("yolov5s", {"size": "64", "classes": "91", "batch": "64"}, device="cpu")
    assert tb.out_spec[0].shape == (64, 252, 96) and jb.out_spec[0].shape == (64, 25200, 96)


@pytest.mark.parametrize("size", [64, 72])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posenet_matches_jax(size, dtype):
    tree = _jax_tree("posenet", width=0.25, seed=1)
    x = _frames((2, size, size, 3), 3)
    want = _jit(jposenet.apply, compute_dtype=dtype)(tree, x)
    b = tposenet.build_bundle(tposenet.params_from_jax(tree, "cpu"),
                              dict(size=str(size), batch="2", dtype=dtype), "t")
    got = b.apply_fn(b.params, torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [s.shape for s in b.out_spec]
    for g, w in zip(got, want):
        assert _err(g, w) <= (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("upsample", [True, False])
@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deeplab_matches_jax(upsample, size, dtype):
    tree = _jax_tree("deeplab", width=0.25, classes=5, seed=1)
    x = _frames((2, size, size, 3), 4)
    want = _jit(jseg.apply, compute_dtype=dtype, upsample=upsample)(tree, x)
    b = tseg.build_bundle(tseg.params_from_jax(tree, "cpu"),
                          dict(size=str(size), batch="2", classes="5", dtype=dtype,
                               upsample=str(int(upsample))), "t")
    got = b.apply_fn(b.params, torch.from_numpy(x))
    assert tuple(got.shape) == b.out_spec[0].shape
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_deeplab_reduced_variant_shares_params_and_is_the_native_map():
    tree = _jax_tree("deeplab", width=0.25, classes=5, seed=1)
    opts = dict(size="64", batch="2", classes="5", dtype="float32")
    b = tseg.build_bundle(tseg.params_from_jax(tree, "cpu"), opts, "t")
    jb = jseg._deeplab(dict(opts, width="0.25"))
    r = b.reduced_variant()
    assert r.params is b.params and r.reduced_variant is None
    assert r.out_spec[0].shape == jb.reduced_variant().out_spec[0].shape == (2, 4, 4, 5)
    x = torch.from_numpy(_frames((2, 64, 64, 3), 5))
    native = tseg.build_bundle(tseg.params_from_jax(tree, "cpu"),
                               dict(opts, upsample="0"), "t")
    assert native.reduced_variant is None
    assert torch.equal(r.apply_fn(r.params, x), native.apply_fn(native.params, x))
    pinned = tseg.build_bundle(tseg.params_from_jax(tree, "cpu"), dict(opts, upsample="1"), "t")
    assert pinned.reduced_variant is None


def test_deeplab_full_resolution_resize_is_jax_image_resize():
    """The 14 -> 224 bilinear blow-up alone, float32 (half-pixel
    sampling, no antialiasing when upsampling)."""
    x = np.random.default_rng(0).standard_normal((2, 14, 14, 21)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 224, 224, 21), "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(224, 224), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    assert np.abs(got.numpy() - want).max() <= 2e-6


@pytest.mark.parametrize("samples", [1600, 4000])
@pytest.mark.parametrize("layout", ["BS", "S", "S1", "BS1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_speech_commands_matches_jax(samples, layout, dtype):
    tree = _jax_tree("kws", seed=2)
    w = np.random.default_rng(samples).uniform(-1, 1, (2, samples)).astype(np.float32)
    w = {"BS": w, "S": w[0], "S1": w[0][:, None], "BS1": w[..., None]}[layout]
    want = _jit(jaudio.apply_kws, frame=640, hop=320, bins=256, mels=64,
                compute_dtype=dtype)(tree, w)
    b = taudio.build_bundle_kws(taudio.params_from_jax(tree, "cpu"),
                                dict(samples=str(samples), dtype=dtype), "cpu", "t")
    got = b.apply_fn(b.params, torch.from_numpy(w))
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_speech_commands_front_end_tables_are_the_jax_packages():
    for a, b in zip(taudio._dft_basis(640, 256), jaudio._dft_basis(640, 256)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(taudio._mel_weights(256, 64, 16000, 640),
                                  jaudio._mel_weights(256, 64, 16000, 640))


@pytest.mark.parametrize("samples", [1600, 4000, 16000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav2vec2_matches_jax(samples, dtype):
    tree = _jax_tree("w2v", dim=64, n_layers=2, n_heads=4, ffn=128, vocab=12, seed=3)
    w = np.random.default_rng(samples).uniform(-1, 1, (2, samples)).astype(np.float32)
    want = _jit(jaudio.apply_w2v, n_heads=4, compute_dtype=dtype)(tree, w)
    b = taudio.build_bundle_w2v(taudio.params_from_jax(tree, "cpu"),
                                dict(samples=str(samples), batch="2", dtype=dtype), "t")
    assert b.out_spec[0].shape == (2, taudio.w2v_frames(samples), 12)
    got = b.apply_fn(b.params, torch.from_numpy(w))
    assert tuple(got.shape) == b.out_spec[0].shape
    assert _err(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_wav2vec2_frames_from_the_strides_match_eval_shape():
    """T from the conv strides, no forward pass: the JAX builder's
    eval_shape spec at the cell's 16,000 samples (T = 199) and others."""
    for samples in (400, 1600, 16000, 16007):
        jb = jaudio._wav2vec2({"samples": str(samples), "batch": "3"})
        tb = tzoo.build("wav2vec2", {"samples": str(samples), "batch": "3"}, device="cpu")
        assert tb.out_spec[0].shape == jb.out_spec[0].shape
    assert taudio.w2v_frames(16000) == 199


@pytest.mark.parametrize("kind,kw", [
    ("yolov5s", dict(classes=5, width=0.25, depth=0.33, seed=3)),
    ("yolov5", dict(classes=4, width=0.25, seed=2)),
    ("posenet", dict(width=0.25, seed=1)),
    ("deeplab", dict(width=0.25, classes=5, seed=1)),
    ("kws", dict(seed=2)),
    ("w2v", dict(dim=64, n_layers=2, n_heads=4, ffn=128, vocab=12, seed=3)),
])
def test_params_from_jax_is_bit_for_bit(kind, kw):
    """Every leaf crosses bit for bit: 4-D conv kernels HWIO -> OIHW,
    wav2vec2's 1-D conv kernels [k, cin, cout] -> [cout, cin, k], the rest
    as it is, in the tree's structure."""
    tree = _jax_tree(kind, **kw)
    conv = taudio.params_from_jax if kind in ("kws", "w2v") else tbk.params_from_jax
    port = conv(tree, "cpu")
    flat_r = jax.tree_util.tree_leaves_with_path(tree)
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_r]
    for (path, p), (_, r) in zip(flat_p, flat_r):
        r = np.asarray(r)
        if r.ndim == 4:
            r = r.transpose(3, 2, 0, 1)
        elif r.ndim == 3 and "convs" in jax.tree_util.keystr(path):
            r = r.transpose(2, 1, 0)
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), r)


def test_zoo_registers_every_model_built_from_a_seed():
    assert {"yolov5", "yolov8", "yolov5s", "posenet", "deeplab_mobilenet",
            "speech_commands", "wav2vec2"} <= set(tzoo.model_names())
    for name, opts in (("yolov5", {"size": "64", "width": "0.25"}),
                       ("yolov8", {"size": "64", "width": "0.25"}),
                       ("posenet", {"size": "64", "width": "0.25"}),
                       ("deeplab_mobilenet", {"size": "64", "width": "0.25"}),
                       ("speech_commands", {"samples": "1600"})):
        a = tzoo.build(name, dict(opts, seed="3"), device="cpu")
        b = tzoo.build(name, dict(opts, seed="3"), device="cpu")
        c = tzoo.build(name, dict(opts, seed="4"), device="cpu")
        la, lb, lc = (jax.tree_util.tree_leaves(t.params) for t in (a, b, c))
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        assert not all(torch.equal(x, y) for x, y in zip(la, lc))
        assert all(t.device.type == "cpu" for t in la)


# -- the vision cells as pipeline strings ----------------------------------------

def _yolov5s_ref(opts, device):
    tree = _jax_tree("yolov5s", classes=int(opts.get("classes", 80)),
                     width=float(opts.get("width", 0.5)),
                     depth=float(opts.get("depth", 0.33)), seed=int(opts.get("seed", 0)))
    return tyolo.build_bundle_v5s(tyolo.params_from_jax(tree, device), opts, device,
                                  "yolov5s_jax_weights")


def _yolo_ref(v8):
    def build(opts, device):
        tree = _jax_tree("yolov5", classes=int(opts.get("classes", 80)),
                         width=float(opts.get("width", 1.0)), seed=int(opts.get("seed", 0)),
                         anchors_per_cell=1 if v8 else 3, head_values=4 if v8 else 5)
        return tyolo.build_bundle(tyolo.params_from_jax(tree, device), opts, device,
                                  "yolov8_jax_weights" if v8 else "yolov5_jax_weights",
                                  v8=v8)
    return build


def _posenet_ref(opts, device):
    tree = _jax_tree("posenet", width=float(opts.get("width", 1.0)),
                     seed=int(opts.get("seed", 0)))
    return tposenet.build_bundle(tposenet.params_from_jax(tree, device), opts,
                                 "posenet_jax_weights")


def _deeplab_ref(opts, device):
    tree = _jax_tree("deeplab", width=float(opts.get("width", 1.0)),
                     classes=int(opts.get("classes", 21)), seed=int(opts.get("seed", 0)))
    return tseg.build_bundle(tseg.params_from_jax(tree, device), opts,
                             "deeplab_mobilenet_jax_weights")


for _name, _b in (("yolov5s", _yolov5s_ref), ("yolov5", _yolo_ref(False)),
                  ("yolov8", _yolo_ref(True)), ("posenet", _posenet_ref),
                  ("deeplab_mobilenet", _deeplab_ref)):
    tzoo.register_model(f"{_name}_jax_weights", _b)

DIV = "tensor_transform mode=arithmetic option=typecast:float32,div:255.0"
#: bench.py's cells at a small size: width 0.25, 64 px frames, batch 2
YOLO = ("videotestsrc device=true batch=2 num-buffers=4 width=64 height=64 pattern=ball "
        f"name=src ! {DIV} ! tensor_filter framework=jax model=yolov5s "
        "custom=size:64,classes:5,batch:2,width:0.25,dtype:float32 ! "
        "tensor_decoder mode=bounding_boxes option1=yolov5 option3=0.0 option4=64:64 "
        "option6=8 option7=device option9=tensors ! tensor_sink name=out")
POSE = ("videotestsrc device=true batch=2 num-buffers=4 width=64 height=64 pattern=ball "
        f"name=src ! {DIV} ! tensor_filter framework=jax model=posenet "
        "custom=size:64,batch:2,width:0.25,dtype:float32 ! tensor_decoder "
        "mode=pose_estimation option2=64:64 option3=0.3 option4=tensors ! "
        "tensor_sink name=out")
SEG = ("videotestsrc device=true batch=2 num-buffers=4 width=64 height=64 pattern=smpte "
       f"name=src ! {DIV} ! tensor_filter framework=jax model=deeplab_mobilenet "
       "custom=size:64,batch:2,width:0.25,dtype:float32 name=f ! tensor_decoder "
       "mode=image_segment option1=classmap ! tensor_sink name=out")


def _port(desc):
    """A JAX-package string as the port runs it on the CPU with the JAX
    package's weights."""
    desc = re.sub(r"model=(\w+) ", r"model=\1_jax_weights ", desc)
    return re.sub(r"(tensor_filter [^!]*?)( !|$)", r"\1 accelerator=true:cpu\2", desc, 1)


def _pull(p, n):
    with p:
        outs = [p.pull("out", timeout=120) for _ in range(n)]
        p.wait(timeout=120)
    return [[np.asarray(t) for t in o.tensors] for o in outs]


def _raw(desc):
    """The string with the decoder cut: the model's own outputs."""
    return re.sub(r" ! tensor_decoder [^!]*!", " !", desc)


def _one_fused_stage(p):
    st = p.stages[0].element
    assert isinstance(st, FusedSourceElement) and isinstance(st.fused, FusedElement)
    assert [s.element.name for s in p.stages] == [st.name, "out"]
    return st.fused


def _cell(desc, n=2):
    """(port fused outputs, port unfused outputs, JAX outputs, port model
    outputs, JAX model outputs) of a cell, ``n`` buffers each."""
    pf = ntt.Pipeline(_port(desc))
    fused = _pull(pf, n)
    fe = _one_fused_stage(pf)
    assert len(fe.census.signatures) == 1 and fe.census.captures == 1
    j = nt.Pipeline(desc)
    assert [s.element.name for s in j.stages] == [s.element.name for s in pf.stages]
    unfused_p = ntt.Pipeline(_port(desc), fuse=False)
    assert [s.element.name for s in unfused_p.stages] == \
        [s.element.name for s in nt.Pipeline(desc, fuse=False).stages]
    unfused = _pull(unfused_p, n * (2 if "bounding_boxes" in desc else 1))
    return (fused, unfused, _pull(j, n), _pull(ntt.Pipeline(_port(_raw(desc))), n),
            _pull(nt.Pipeline(_raw(desc)), n))


def test_yolov5s_detection_cell_against_the_jax_package():
    fused, unfused, ref, mine_raw, ref_raw = _cell(YOLO)
    err = max(_err(a[0], b[0]) for a, b in zip(mine_raw, ref_raw))
    assert err <= F32_TOL
    props = dict(re.findall(r"(option\d)=(\S+)", YOLO))
    per_frame = iter(unfused)
    for (f, j, raw) in zip(fused, ref, ref_raw):
        # fused (device NMS) against unfused (host decode, one buffer a frame)
        boxes, scores, classes, valid = f
        assert boxes.shape == (2, 8, 4) and valid.dtype == np.uint8
        for i in range(2):
            u = next(per_frame)
            v = valid[i].astype(bool)
            assert v.sum() == len(u[1]) > 0
            np.testing.assert_allclose(boxes[i][v], u[0], rtol=0, atol=1e-6)
            np.testing.assert_allclose(scores[i][v], u[1], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(classes[i][v], u[2])
        sc = np.sort((raw[0][..., 4:5] * raw[0][..., 5:]).max(-1), axis=1)
        gap = np.diff(sc, axis=1).min()
        scale = np.abs(raw[0]).max()
        if gap > 2 * err * scale:
            np.testing.assert_array_equal(valid, j[3])
            np.testing.assert_array_equal(classes, j[2])
            np.testing.assert_allclose(scores, j[1], rtol=0, atol=2 * err * scale)
            np.testing.assert_allclose(boxes, j[0], rtol=0, atol=2 * err * scale)
        else:  # a near tie: the decode, teacher-forced on the JAX model's outputs
            got = _port_decode(tbb.BoundingBoxes(dict(props)), raw)
            jgot = _jax_decode(jbb.BoundingBoxes(dict(props)), raw)
            for a, b in zip(got, jgot):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            for a, b in zip(jgot, j):
                np.testing.assert_array_equal(a, b)


def _port_decode(dec, arrays):
    """The port decoder's fused path on host arrays: its output tensors."""
    fn, _ = dec.device_fn(TensorsSpec.of(arrays))
    outs = [t.numpy() for t in fn(tuple(torch.from_numpy(np.array(a)) for a in arrays))]
    return dec.host_post(outs, Buffer(outs)).tensors


def _jax_decode(dec, arrays):
    """The JAX decoder's fused path (jitted) on host arrays."""
    fn, _ = dec.device_fn(TensorsSpec.of(arrays))
    outs = [np.asarray(t) for t in jax.jit(fn)(tuple(arrays))]
    return dec.host_post(outs, JBuffer(outs)).tensors


def test_posenet_cell_against_the_jax_package():
    fused, unfused, ref, mine_raw, ref_raw = _cell(POSE)
    errs = [max(_err(a, b) for a, b in zip(m, r)) for m, r in zip(mine_raw, ref_raw)]
    assert max(errs) <= F32_TOL
    held = 0
    for f, u, j, raw, err in zip(fused, unfused, ref, ref_raw, errs):
        for a, b in zip(f, u):
            np.testing.assert_array_equal(a, b)
        heat, off = raw
        b, hh, hw, k = heat.shape
        top = np.sort(heat.reshape(b, -1, k), axis=1)
        ok = (top[:, -1] - top[:, -2]) > 2 * err * max(1.0, np.abs(heat).max())
        held += int(ok.sum())
        tol = 2 * err * max(1.0, np.abs(off).max()) * 64 / min(hh, hw) + 1e-5
        np.testing.assert_allclose(f[0][ok], j[0][ok], rtol=0, atol=tol)
        np.testing.assert_allclose(f[1][ok], j[1][ok], rtol=0, atol=tol)
        np.testing.assert_allclose(f[2], j[2], rtol=0, atol=2 * err)
        # every keypoint, teacher-forced: the port's decode on the JAX outputs
        got = _port_decode(tpose.PoseEstimation(dict(option2="64:64", option3="0.3",
                                                     option4="tensors")), raw)
        for a, b in zip(got, j):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert held > 0


def test_deeplab_segmentation_cell_against_the_jax_package():
    """bench_segmentation at a small size: the residency planner picks the
    native-stride map in both packages, and the maps agree wherever the
    JAX scores' top-2 gap exceeds the tolerance."""
    fused, unfused, ref, mine_raw, ref_raw = _cell(SEG)
    err = max(_err(a[0], b[0]) for a, b in zip(mine_raw, ref_raw))
    assert err <= F32_TOL
    held = flipped = 0
    for f, u, j, raw in zip(fused, unfused, ref, ref_raw):
        assert f[0].shape == j[0].shape == (2, 4, 4) and f[0].dtype == np.uint8
        np.testing.assert_array_equal(f[0], u[0])
        top = np.sort(raw[0], axis=-1)
        ok = (top[..., -1] - top[..., -2]) > 2 * err * max(1.0, np.abs(raw[0]).max())
        held += int(ok.sum())
        np.testing.assert_array_equal(f[0][ok], j[0][ok])
        flipped += int((f[0] != j[0])[~ok].sum())
    assert held > 0 and flipped <= 2


# -- the residency planner ----------------------------------------------------------

def _plan(p):
    r = p.residency
    return (r.resident_edges, list(r.reduced_outputs),
            [(e.sink, e.producer, e.bytes_per_buffer, e.reduced) for e in r.fetch])


@pytest.mark.parametrize("fuse", [True, False])
def test_residency_selects_the_native_map_in_both_packages(fuse):
    desc = SEG.replace(",dtype:float32", "")
    p, j = ntt.Pipeline(_port(desc), fuse=fuse), nt.Pipeline(desc, fuse=fuse)
    assert p.residency.reduced_outputs == j.residency.reduced_outputs == ["f"]
    assert _plan(p) == _plan(j)
    if fuse:
        [edge] = p.residency.fetch
        assert edge.reduced == "fused host_post" and edge.bytes_per_buffer == 2 * 4 * 4
    assert "reduced output selected: f" in p.residency.render()
    assert _pull(p, 1)[0][0].shape == (2, 4, 4)


@pytest.mark.parametrize("variant", ["upsample:1", "overlay", "reduce_outputs=False"])
def test_residency_keeps_full_resolution(variant):
    desc, kw = SEG, {}
    if variant == "upsample:1":
        desc = SEG.replace("dtype:float32", "dtype:float32,upsample:1")
    elif variant == "overlay":
        desc = SEG.replace(" option1=classmap", "")
    else:
        kw = dict(reduce_outputs=False)
    p, j = ntt.Pipeline(_port(desc), **kw), nt.Pipeline(desc, **kw)
    assert p.residency.reduced_outputs == j.residency.reduced_outputs == []
    assert _plan(p) == _plan(j)
    out = _pull(p, 1)[0][0]
    assert out.shape == ((2, 64, 64, 4) if variant == "overlay" else (2, 64, 64))


def test_residency_env_switch(monkeypatch):
    from nnstreamer_tpu_torch.core import config

    monkeypatch.setenv("NNS_TPU_REDUCE_OUTPUTS", "0")
    config.reset_config()
    try:
        assert ntt.Pipeline(_port(SEG)).residency.reduced_outputs == []
    finally:
        monkeypatch.delenv("NNS_TPU_REDUCE_OUTPUTS")
        config.reset_config()
    assert ntt.Pipeline(_port(SEG)).residency.reduced_outputs == ["f"]


@pytest.mark.parametrize("desc", [
    YOLO, POSE, SEG,
    # a sink right behind the filter admits any geometry too
    _raw(SEG),
    # a host element between: the planner vetoes
    SEG.replace("pattern=smpte", "pattern=smpte ! tensor_converter"),
    "appsrc name=src caps=other/tensors,dimensions=3:64:64:2,types=uint8 ! " + DIV +
    " ! tensor_filter framework=jax model=deeplab_mobilenet custom=size:64,batch:2,"
    "width:0.25 name=f ! tensor_decoder mode=image_segment ! tensor_sink name=out",
], ids=["yolov5s", "posenet", "deeplab", "deeplab-sink", "host-element", "appsrc-overlay"])
@pytest.mark.parametrize("fuse", [True, False])
def test_residency_plan_names_the_jax_packages_edges(desc, fuse):
    assert _plan(ntt.Pipeline(_port(desc), fuse=fuse)) == _plan(nt.Pipeline(desc, fuse=fuse))
