"""Fusion in the port: the planner's stages, fused against unfused, the
deferred host mapping, outputs that outlive the next buffer, truncated
tail batches, and the README quick-start and the object-detection
example's pipeline strings end to end against the JAX package, with the
JAX package's weights carried across (test-only zoo names
``mobilenet_v1_jax_weights`` and ``ssd_mobilenet_jax_weights``).

Tolerance (float32): a logit or score may differ from the JAX package's
by ``TOL`` of the largest magnitude.  Near-tie rule: a label must equal
the JAX package's where the JAX top-1/top-2 gap exceeds that tolerance;
detections must equal the JAX package's where no two candidate scores
of the frame lie within twice the tolerance, and otherwise the port's
decoder fed the JAX model's outputs must give the JAX detections
exactly (torch-vs-XLA rounding cannot then flip a near tie and fail the
test for the wrong reason)."""

import ast
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.decoders import bounding_boxes as jbb
from nnstreamer_tpu.elements.source import VideoTestSrc as JaxVideoTestSrc
from nnstreamer_tpu.models import mobilenet as jmob, ssd as jssd
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.decoders import bounding_boxes as tbb
from nnstreamer_tpu_torch.elements.base import SRC, Element
from nnstreamer_tpu_torch.models import mobilenet as tmob, ssd as tssd, zoo as tzoo
from nnstreamer_tpu_torch.pipeline.plan import FusedElement, FusedSourceElement

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
NORM = "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5"
SMALL = "width:0.25,classes:10,dtype:float32"


@functools.lru_cache(maxsize=None)
def _jax_tree(model, width, classes, seed):
    init = jmob.init_params if model == "mobilenet" else jssd.init_params
    tree = init(width=width, classes=classes, seed=seed)
    return jax.tree_util.tree_map(np.asarray, tree)


def _opts(opts, classes):
    return float(opts.get("width", 1.0)), int(opts.get("classes", classes)), \
        int(opts.get("seed", 0))


def _mobilenet_ref(opts, device):
    tree = _jax_tree("mobilenet", *_opts(opts, 1001))
    return tmob.build_bundle(tmob.params_from_jax(tree, device), opts,
                             "mobilenet_v1_jax_weights")


def _ssd_ref(opts, device):
    tree = _jax_tree("ssd", *_opts(opts, 91))
    return tssd.build_bundle(tssd.params_from_jax(tree, device), opts, device,
                             "ssd_mobilenet_jax_weights")


tzoo.register_model("mobilenet_v1_jax_weights", _mobilenet_ref)
tzoo.register_model("ssd_mobilenet_jax_weights", _ssd_ref)


def _pipeline_string(source: str) -> str:
    """The first ``*.Pipeline("...")`` string literal of a Python source."""
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "Pipeline"
                and isinstance(node.args[0], ast.Constant)):
            return node.args[0].value
    raise AssertionError("no Pipeline string")


def _readme_quickstart() -> str:
    block = re.search(r"```python\n(.*?)```", (REPO / "README.md").read_text(), re.S)
    return _pipeline_string(block.group(1))


def _port(desc):
    """A JAX-package string as the port runs it on the CPU with the JAX
    package's weights."""
    desc = re.sub(r"model=(mobilenet_v1|ssd_mobilenet)", r"model=\1_jax_weights", desc)
    return desc.replace(" ! tensor_decoder", " accelerator=true:cpu ! tensor_decoder", 1)


def _qs(batch=2, size=32, custom=SMALL):
    return (f"appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:{batch},"
            f"types=uint8 ! {NORM} ! tensor_filter framework=jax "
            f"model=mobilenet_v1_jax_weights custom=size:{size},batch:{batch},{custom} "
            "accelerator=true:cpu ! tensor_decoder mode=image_labeling ! "
            "tensor_sink name=out")


def _frames(n, batch=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
            for _ in range(n)]


def _run(desc, frames=(), pulls=None, fuse=True, lib=ntt):
    p = lib.Pipeline(desc, fuse=fuse)
    with p:
        for f in frames:
            p.push("src", f)
        outs = [p.pull("out", timeout=120) for _ in range(pulls or len(frames))]
        if frames:
            p.eos("src")
        p.wait(timeout=120)
    return p, outs


def _labels(outs):
    return [(np.asarray(o.meta["label_index"]), np.asarray(o.meta["score"]))
            for o in outs]


# -- the planner --------------------------------------------------------------

def test_quickstart_is_one_fused_stage_named_as_in_the_jax_package():
    desc = _qs()
    p = ntt.Pipeline(desc)
    j = nt.Pipeline(desc.replace("_jax_weights", "").replace(" accelerator=true:cpu", ""))
    names = [s.element.name for s in p.stages]
    assert names == [s.element.name for s in j.stages]
    assert names == ["src", "tensor_transform1+tensor_filter2+tensor_decoder3", "out"]
    fused = p.stages[1].element
    assert isinstance(fused, FusedElement) and fused.device == torch.device("cpu")
    assert [s.element.name for s in ntt.Pipeline(desc, fuse=False).stages] == [
        "src", "tensor_transform1", "tensor_filter2", "tensor_decoder3", "out"]


def test_device_source_folds_into_the_stage_below():
    desc = ("videotestsrc device=true batch=2 num-buffers=4 width=32 height=32 name=src ! "
            f"{NORM} ! tensor_filter framework=jax model=mobilenet_v1 "
            f"custom=size:32,batch:2,{SMALL} accelerator=true:cpu ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    p = ntt.Pipeline(desc)
    assert [s.element.name for s in p.stages] == [
        "src+tensor_transform1+tensor_filter2+tensor_decoder3", "out"]
    assert isinstance(p.stages[0].element, FusedSourceElement)
    j = nt.Pipeline(desc.replace(" accelerator=true:cpu", ""))
    assert [s.element.name for s in j.stages] == [s.element.name for s in p.stages]


@pytest.mark.parametrize("desc", [
    # an inline caps pin is an identity inside the chain
    "appsrc name=src caps=other/tensors,dimensions=3:32:32:2,types=uint8 ! "
    "other/tensors,types=uint8 ! " + NORM + " ! tensor_filter framework=jax "
    "model=mobilenet_v1 custom=size:32,batch:2," + SMALL + " ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out",
    # a host video source: the converter stays on the host
    "videotestsrc num-buffers=2 width=32 height=32 ! tensor_converter ! " + NORM +
    " ! tensor_filter framework=jax model=mobilenet_v1 custom=size:32," + SMALL +
    " ! tensor_decoder mode=image_labeling ! tensor_sink name=out",
])
def test_stages_are_the_jax_packages(desc):
    port = desc.replace(" ! tensor_decoder", " accelerator=true:cpu ! tensor_decoder")
    assert [s.element.name for s in ntt.Pipeline(port).stages] == \
        [s.element.name for s in nt.Pipeline(desc).stages]


@pytest.mark.parametrize("fpt", [1, 2])
def test_converter_video_matches_the_jax_package(fpt):
    desc = (f"videotestsrc num-buffers=4 width=7 height=5 ! tensor_converter "
            f"frames-per-tensor={fpt} ! tensor_sink name=out")
    _, mine = _run(desc, pulls=4 // fpt)
    _, ref = _run(desc, pulls=4 // fpt, lib=nt)
    for m, r in zip(mine, ref):
        assert m.tensors[0].shape == (fpt, 5, 7, 3)
        np.testing.assert_array_equal(m.tensors[0], r.tensors[0])


def test_fused_chain_needs_two_device_elements_and_static_tensors():
    # the filter alone stays itself; an appsrc without caps cannot fuse
    p = ntt.Pipeline("appsrc name=src ! tensor_filter framework=jax model=mobilenet_v1 "
                     f"custom=size:32,{SMALL} accelerator=true:cpu ! tensor_sink name=out")
    assert [s.element.kind for s in p.stages] == ["appsrc", "tensor_filter", "tensor_sink"]
    p = ntt.Pipeline(f"appsrc name=src ! {NORM} ! tensor_filter framework=jax "
                     f"model=mobilenet_v1 custom=size:32,{SMALL} accelerator=true:cpu ! "
                     "tensor_sink name=out")
    assert len(p.stages) == 4


# -- fused against unfused ----------------------------------------------------

def test_filter_combinations_fuse_and_match_the_jax_package():
    """input-combination feeds the model tensor 0 of two; the output is
    (input 1, model output 0): fused, unfused and the JAX package agree."""
    desc = ("appsrc name=src caps=other/tensors,dimensions=3:32:32:2.4:1,"
            f"types=uint8.uint8 ! {NORM} ! tensor_filter framework=jax "
            f"model=mobilenet_v1_jax_weights custom=size:32,batch:2,{SMALL} "
            "accelerator=true:cpu input-combination=0 output-combination=i1,o0 ! "
            "tensor_sink name=out")
    rng = np.random.default_rng(4)
    bufs = [[f, rng.integers(0, 256, (1, 4), dtype=np.uint8)] for f in _frames(2)]
    pf, fused = _run(desc, bufs)
    assert pf.stages[1].element.name == "tensor_transform1+tensor_filter2"
    _, unfused = _run(desc, bufs, fuse=False)
    jdesc = desc.replace("_jax_weights", "").replace(" accelerator=true:cpu", "")
    _, ref = _run(jdesc, bufs, lib=nt)
    for a, b, r, src in zip(fused, unfused, ref, bufs):
        assert [t.shape for t in a.tensors] == [(1, 4), (2, 10)]
        for x, y in zip(a.tensors, b.tensors):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            a.tensors[0], (src[1].astype(np.float32) + np.float32(-127.5)) / np.float32(127.5))
        # the JAX package's fused program multiplies by 1/127.5 where the
        # port (and its own host path) divides: 1 ulp apart
        np.testing.assert_allclose(a.tensors[0], r.tensors[0], rtol=2.0 ** -23, atol=0)
        want = np.asarray(r.tensors[1])
        assert np.abs(a.tensors[1] - want).max() <= TOL * np.abs(want).max()


def test_quickstart_fused_equals_unfused_bitwise():
    frames = _frames(3)
    pf, fused = _run(_qs(), frames)
    _, unfused = _run(_qs(), frames, fuse=False)
    for a, b in zip(_labels(fused), _labels(unfused)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    census = pf.stages[1].element.census
    assert census.captures == 1 and census.replays == 3
    assert [o.meta["label"] for o in fused] == [o.meta["label"] for o in unfused]


def _det(nms, form, size=64, batch=2, n=5, thr="0.0"):
    return (f"videotestsrc device=true batch={batch} num-buffers={n} width={size} "
            f"height={size} pattern=ball name=src ! {NORM} ! "
            "tensor_filter framework=jax model=ssd_mobilenet "
            f"custom=size:{size},classes:5,batch:{batch},width:0.25,dtype:float32 "
            "accelerator=true:cpu ! tensor_decoder mode=bounding_boxes option1=ssd "
            f"option3={thr} option4={size}:{size} option6=8 option7={nms} "
            f"option9={form} ! tensor_sink name=out")


@pytest.mark.parametrize("nms", ["host", "device"])
def test_detection_tail_batch_and_fused_equals_unfused(nms):
    """5 frames at batch 2: a truncated tail batch of one frame is a second
    signature, captured once, computed on its own rows."""
    pf, fused = _run(_det(nms, "tensors"), pulls=3)
    fe = pf.stages[0].element.fused
    assert fe.census.captures == 2 and len(fe.census.signatures) == 2
    assert [o.tensors[0].shape for o in fused] == [(2, 8, 4), (2, 8, 4), (1, 8, 4)]
    _, unfused = _run(_det(nms, "tensors"), pulls=5, fuse=False)  # one per frame
    flat = [[t[i] for t in o.tensors] for o in fused for i in range(o.tensors[0].shape[0])]
    for f, u in zip(flat, unfused):
        v = f[3].astype(bool)
        assert v.sum() == len(u.tensors[1]) > 0
        np.testing.assert_array_equal(f[0][v], u.tensors[0])
        np.testing.assert_array_equal(f[1][v], u.tensors[1])
        np.testing.assert_array_equal(f[2][v], u.tensors[2])


def test_detection_device_nms_equals_host_nms():
    _, dev = _run(_det("device", "tensors", thr="0.01"), pulls=3)
    _, host = _run(_det("host", "tensors", thr="0.01"), pulls=3)
    for a, b in zip(dev, host):
        v = a.tensors[3].astype(bool)
        np.testing.assert_array_equal(v, b.tensors[3].astype(bool))
        assert v.any()
        for x, y in zip(a.tensors[:3], b.tensors[:3]):
            np.testing.assert_array_equal(x[v], y[v])  # invalid rows are padding


def test_overlay_form_fused():
    _, outs = _run(_det("device", "overlay"), pulls=3)
    assert outs[0].tensors[0].shape == (2, 64, 64, 4) and outs[2].tensors[0].shape == (64, 64, 4)
    assert len(outs[0].meta["detections"]) == 2 and outs[0].meta["detections"][0]


def test_late_pulls_keep_their_own_values():
    """Every buffer is processed before the first pull: a replay writes the
    same static outputs each time, so a stage that handed those downstream
    would show the last buffer's values in all of them.  The transpose
    chain's outputs alias the static input itself."""
    from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform

    desc = ("appsrc name=src caps=other/tensors,dimensions=3:4:5:1,types=float32 ! "
            "tensor_transform mode=transpose option=1:0:2:3 ! "
            "tensor_transform mode=dimchg option=0:2 ! tensor_sink name=out")
    p = ntt.Pipeline(desc)
    assert isinstance(p.stages[1].element, FusedElement)
    xs = [np.full((1, 5, 4, 3), i, np.float32) + np.arange(3, dtype=np.float32)
          for i in range(4)]
    with p:
        for x in xs:
            p.push("src", x)
        p.eos("src")
        p.wait(timeout=60)  # all processed, none pulled yet
        outs = [p.pull("out", timeout=10).tensors[0] for _ in xs]
    chain = [JaxTransform({"mode": "transpose", "option": "1:0:2:3"}),
             JaxTransform({"mode": "dimchg", "option": "0:2"})]
    for x, o in zip(xs, outs):
        want = JBuffer([x])
        for t in chain:
            want = t.transform(want)
        np.testing.assert_array_equal(o, want.tensors[0])
    frames = _frames(4)
    p = ntt.Pipeline(_qs())
    with p:
        for f in frames:
            p.push("src", f)
        p.eos("src")
        p.wait(timeout=120)
        late = [p.pull("out", timeout=10) for _ in frames]
    _, alone = _run(_qs(), frames, fuse=False)
    for a, b in zip(_labels(late), _labels(alone)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


class _HostProbe(Element):
    """A host-only element: records what reaches it."""

    kind = "host_probe_for_tests"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.seen = []

    def process(self, pad, buf):
        self.seen.append(buf)
        return [(SRC, buf)]


@pytest.fixture
def host_probe():
    """The probe registered for one test only: the registry is the
    process's, and another test file reads its element names."""
    ntt.register_element(_HostProbe.kind, _HostProbe)
    try:
        yield _HostProbe.kind
    finally:
        ntt.registry._registry.pop((ntt.registry.KIND_ELEMENT, _HostProbe.kind))


def test_host_element_after_a_deferred_mapping_gets_it_resolved(host_probe):
    frames = _frames(2)
    p, outs = _run(_qs().replace("image_labeling !",
                                 f"image_labeling ! {host_probe} name=probe !"),
                   frames)
    _, want = _run(_qs(), frames)
    seen = p.element("probe").seen
    assert len(seen) == 2 and all("_host_post" not in b.meta for b in seen)
    assert [b.meta["label"] for b in seen] == [o.meta["label"] for o in want]
    assert [o.meta["label"] for o in outs] == [o.meta["label"] for o in want]


def test_callback_sink_sees_the_resolved_buffer():
    seen = []
    p = ntt.Pipeline(_qs())
    p.element("out").connect_new_data(lambda b: seen.append(b.meta["label"]))
    with p:
        p.push("src", _frames(1)[0])
        got = p.pull("out", timeout=60)
        p.eos("src")
        p.wait(timeout=60)
    assert seen == [got.meta["label"]] and len(seen[0]) == 2


def test_no_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the filter takes it")
    with pytest.raises(Exception, match="accelerator=true:cpu"):
        ntt.Pipeline(_qs().replace(" accelerator=true:cpu", ""))
    src = ntt.Pipeline("videotestsrc device=true batch=2 num-buffers=2 width=8 "
                       "height=8 name=src ! tensor_sink name=out")
    with src:
        with pytest.raises(ntt.PipelineError, match="accelerator=true:cpu"):
            src.wait(timeout=30)


@pytest.mark.parametrize("fuse", [True, False])
def test_device_source_without_a_filter_takes_the_card(fuse, monkeypatch):
    """No filter below a device source names a device: it generates on
    the card, folded into a stage or not, and without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = ntt.Pipeline("videotestsrc device=true batch=2 num-buffers=2 width=8 "
                     f"height=8 name=src ! {NORM} ! tensor_sink name=out", fuse=fuse)
    assert [s.element.name for s in p.stages] == (
        ["src+tensor_transform1", "out"] if fuse else
        ["src", "tensor_transform1", "out"])
    with p:
        with pytest.raises(ntt.PipelineError, match="accelerator=true:cpu"):
            p.wait(timeout=30)


@pytest.mark.parametrize("fuse", [True, False])
def test_device_source_generates_on_its_filters_device(fuse, monkeypatch):
    """The filter's accelerator=true:cpu puts the source on the CPU too,
    folded or not, and the two plans give the same labels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    desc = ("videotestsrc device=true batch=2 num-buffers=3 width=32 height=32 "
            f"name=src ! {NORM} ! tensor_filter framework=jax "
            f"model=mobilenet_v1_jax_weights custom=size:32,batch:2,{SMALL} "
            "accelerator=true:cpu ! tensor_decoder mode=image_labeling ! "
            "tensor_sink name=out")
    p, outs = _run(desc, pulls=2, fuse=fuse)
    assert p.element("src").gen_device == torch.device("cpu")
    _, ref = _run(desc, pulls=2, fuse=not fuse)
    assert [o.meta["label"] for o in outs] == [o.meta["label"] for o in ref]
    assert [np.atleast_1d(o.meta["label_index"]).size for o in outs] == [2, 1]


def test_fused_labels_over_the_query_pair():
    """serversrc ! transform ! filter ! decoder ! serversink: the fused
    stage's deferred label mapping is resolved before the server's sink
    sends it (after its copy to the host has landed), so a client reads
    the label text and scores a tensor_sink reads in process."""
    frames = _frames(2)
    _, want = _run(_qs(), frames)
    server = ntt.Pipeline(
        "tensor_query_serversrc name=ssrc port=0 id=7301 ! "
        "other/tensors,dimensions=3:32:32:2,types=uint8 ! "
        + _qs().split(" ! ", 1)[1].replace("tensor_sink name=out",
                                           "tensor_query_serversink id=7301"))
    assert [s.element.name for s in server.stages][2] == \
        "tensor_transform2+tensor_filter3+tensor_decoder4"
    with server:
        client = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port="
            f"{server.element('ssrc').bound_port} timeout=60 ! tensor_sink name=out")
        with client:
            got = []
            for f in frames:
                client.push("src", f)
                got.append(client.pull("out", timeout=120))
            client.eos("src")
            client.wait(timeout=60)
    for g, w in zip(got, want):
        assert bytes(np.asarray(g.tensors[0])).decode().split("\n") == w.meta["label"]
        assert g.meta["label"] == w.meta["label"]
        np.testing.assert_array_equal(np.asarray(g.meta["score"], np.float32),
                                      w.meta["score"])


# -- end to end against the JAX package ---------------------------------------

def _jax_logits(frames, size):
    tree = _jax_tree("mobilenet", 0.25, 10, 0)
    x = np.concatenate(frames).astype(np.float32)
    x = (x + np.float32(-127.5)) / np.float32(127.5)
    return np.asarray(jax.jit(functools.partial(jmob.apply, compute_dtype="float32"))(
        tree, x))


def test_readme_quickstart_against_the_jax_package():
    desc = _readme_quickstart()
    assert "model=mobilenet_v1 custom=size:224,batch:64" in desc
    small = desc.replace("3:224:224:64", "3:32:32:2").replace(
        "custom=size:224,batch:64", f"custom=size:32,batch:2,{SMALL}")
    frames = _frames(3)
    _, mine = _run(_port(small), frames)
    _, ref = _run(small, frames, lib=nt)
    logits = _jax_logits(frames, 32)
    top = np.sort(logits, axis=1)
    tol = TOL * np.abs(logits).max(axis=1)
    held = (top[:, -1] - top[:, -2]) > tol
    got = np.concatenate([m for m, _ in _labels(mine)])
    want = np.concatenate([w for w, _ in _labels(ref)])
    assert held.any()
    np.testing.assert_array_equal(got[held], want[held])
    scores = np.concatenate([s for _, s in _labels(mine)])
    assert np.all(np.abs(scores - top[:, -1]) <= tol)


def _example_detection_string():
    return _pipeline_string((REPO / "examples" / "object_detection.py").read_text())


def test_object_detection_example_against_the_jax_package():
    desc = _example_detection_string()
    assert "model=ssd_mobilenet custom=size:96,classes:7" in desc
    small = desc.replace("custom=size:96,classes:7",
                         "custom=size:96,classes:7,width:0.25,dtype:float32")
    _, mine = _run(_port(small), pulls=2)
    _, ref = _run(small, pulls=2, lib=nt)
    src = JaxVideoTestSrc({"width": 96, "height": 96, "pattern": "ball"})
    tree = _jax_tree("ssd", 0.25, 7, 0)
    dec_props = {"option3": "0.0", "option4": "96:96"}
    apply = jax.jit(functools.partial(jssd.apply, anchors=jssd.build_anchors(96),
                                      classes=7, compute_dtype="float32"))
    params = tssd.params_from_jax(tree, "cpu")
    anchors = torch.from_numpy(tssd.build_anchors(96))
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert m.tensors[0].shape == r.tensors[0].shape == (96, 96, 4)
        x = (src._frame(i)[None].astype(np.float32) + np.float32(-127.5)) / np.float32(127.5)
        boxes, scores = (np.asarray(t) for t in apply(tree, x))
        gb, gs = tssd.apply(params, torch.from_numpy(x), anchors=anchors, classes=7,
                            compute_dtype="float32")
        err = max(np.abs(gb.numpy() - boxes).max(), np.abs(gs.numpy() - scores).max())
        assert err <= TOL * max(1.0, np.abs(boxes).max())
        gap = np.diff(np.sort(scores.max(axis=-1).ravel())).min()
        if 2 * err < gap:
            # no candidate's order can flip: the detections themselves agree
            _same(m.meta["detections"], r.meta["detections"], err)
            continue
        # near ties: the decode held teacher-forced on the JAX model's outputs
        tdec, jdec = tbb.BoundingBoxes(dict(dec_props)), jbb.BoundingBoxes(dict(dec_props))
        fn, _ = tdec.device_fn(TensorsSpec.of([boxes, scores]))
        outs = [t.numpy() for t in fn((torch.tensor(boxes), torch.tensor(scores)))]
        jfn, _ = jdec.device_fn(TensorsSpec.of([boxes, scores]))
        jouts = [np.asarray(t) for t in jfn((jnp.asarray(boxes), jnp.asarray(scores)))]
        _same(tdec.host_post(outs, Buffer(outs)).meta["detections"],
              jdec.host_post(jouts, JBuffer(jouts)).meta["detections"], 0.0)
        assert len(m.meta["detections"]) == len(r.meta["detections"]) > 0


def _same(a, b, tol):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x["class_index"] == y["class_index"] and x["label"] == y["label"]
        assert abs(x["score"] - y["score"]) <= tol
        np.testing.assert_allclose(x["box"], y["box"], rtol=0, atol=max(tol, 1e-6))


@pytest.mark.parametrize("name", ["torch_image_classification.py",
                                  "torch_object_detection.py"])
def test_port_examples_run_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "examples" / name), "--cpu"],
                         cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("labels:" in out.stdout) or out.stdout.count("detections;") == 2
