"""The camera slice as a whole, in the port against the JAX package, on
the CPU: raw RGB bytes through ``tensor_converter``, a ``tee``, detection
(ssd_mobilenet with the JAX package's weights, f32, 32 px), a second
``tee`` into ``tensor_region`` and the flexbuf round trip, and
``tensor_crop`` pairing each frame with its regions.

Tolerances: the detector's f32 tensors within ``TOL`` of the largest
magnitude (the vision tests' f32 tolerance; the scores, all near 0.012
with random weights, within ``TOL`` of their own largest); regions equal
to the JAX package's wherever the anchors' best scores are apart by more
than that; every crop bitwise a numpy slice of its own frame; the wire
sink's tensors bitwise the detector's.  Then what the port must show because
its tensors are mutable: a slow branch still crops its own frames, and
the tee below the fused stage gets the rows copied out, never the
stage's static outputs.  ``videotestsrc device=true pattern=random``
draws the port's own frames (the JAX package's ``jax.random`` bits are
not reproduced): shape, range, reruns and consecutive frames.
"""

import functools
import runpy
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu.native as jnative
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.decoders.direct_video import TensorRegion as JRegion
from nnstreamer_tpu.models import ssd as jssd
from nnstreamer_tpu_torch.decoders import direct_video as tdv
from nnstreamer_tpu_torch.elements.routing import Tee
from nnstreamer_tpu_torch.elements.source import VideoTestSrc
from nnstreamer_tpu_torch.models import ssd as tssd, zoo as tzoo

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
SIZE = 32
REGIONS = 4
NORM = "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5"
SLICE = ("appsrc name=cam caps=video/x-raw,format=RGB,width={s},height={s},framerate=30/1 "
         "max-inflight=8 ! tensor_converter ! tee name=t "
         "t. ! " + NORM + " ! tensor_filter framework=jax model={model} "
         "custom=size:{s},classes:91,batch:1,dtype:float32{acc} ! tee name=d "
         "d. ! tensor_decoder name=region mode=tensor_region option1={s}:{s} "
         f"option2={REGIONS} ! crop.sink_1 "
         "d. ! tensor_decoder mode=flexbuf ! tensor_converter mode=flexbuf ! "
         "tensor_sink name=wire "
         "t. ! crop.sink_0 "
         "tensor_crop name=crop ! tensor_sink name=crops")
PORT = SLICE.format(s=SIZE, model="ssd_mobilenet_jax_weights", acc=" accelerator=true:cpu")
JAX = SLICE.format(s=SIZE, model="ssd_mobilenet", acc="")


@functools.lru_cache(maxsize=None)
def _jax_tree(classes, seed):
    return jax.tree_util.tree_map(np.asarray, jssd.init_params(classes=classes, seed=seed))


def _ssd_ref(opts, device):
    tree = _jax_tree(int(opts.get("classes", 91)), int(opts.get("seed", 0)))
    return tssd.build_bundle(tssd.params_from_jax(tree, device), opts, device,
                             "ssd_mobilenet_jax_weights")


tzoo.register_model("ssd_mobilenet_jax_weights", _ssd_ref)


@pytest.fixture(autouse=True)
def _numpy_stride_fallback(monkeypatch):
    # the JAX converter's raw-byte path takes its numpy fallback, not a
    # native library built and loaded in the test process
    monkeypatch.setattr(jnative, "_load", lambda block=True: None)


def _frames(n, size=SIZE, seed=0):
    """Seeded raw RGB frames as a camera delivers them (1-D uint8), noise
    with a box moving across."""
    rng = np.random.default_rng(seed)
    out = []
    box = size // 4
    for i in range(n):
        f = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        x, y = (i * 7) % (size - box), (i * 3) % (size - box)
        f[y:y + box, x:x + box] = (255, 64, 0)
        out.append(f.reshape(-1))
    return out


def _run(pkg, desc, frames, pipe=None):
    """Push from a thread (pushes block at max-inflight), pull crops and
    wire in order -> (crops, wires, pipeline)."""
    p = pipe or pkg.Pipeline(desc)
    crops, wires = [], []
    with p:
        th = threading.Thread(target=lambda: [p.push("cam", pkg.Buffer([f], pts=i))
                                              for i, f in enumerate(frames)])
        th.start()
        for _ in frames:
            crops.append(p.pull("crops", timeout=120))
            wires.append(p.pull("wire", timeout=120))
        th.join(timeout=60)
        p.eos("cam")
        p.wait(timeout=60)
    assert not th.is_alive()
    return crops, wires, p


def _slices(frame, regions):
    h, w = frame.shape[:2]
    out = []
    for x, y, cw, ch in np.asarray(regions, np.int64).reshape(-1, 4):
        x0, y0 = int(np.clip(x, 0, w)), int(np.clip(y, 0, h))
        x1, y1 = int(np.clip(x + cw, 0, w)), int(np.clip(y + ch, 0, h))
        out.append(frame[y0:y1, x0:x1])
    return out


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _separated(scores, n, tol):
    """True when the top ``n + 1`` anchors' best scores are apart by more
    than ``tol``: the region order cannot flip on rounding."""
    best = np.sort(np.asarray(scores, np.float32).reshape(-1, scores.shape[-1]).max(1))[::-1]
    return bool(np.all(-np.diff(best[:n + 1]) > tol))


def test_the_slice_against_the_jax_package():
    frames = _frames(8)
    tcrops, twires, p = _run(ntt, PORT, frames)
    jcrops, jwires, _ = _run(nt, JAX, frames)
    [stage] = [s.element for s in p.stages if s.element.kind == "fused"]
    assert stage.name == "tensor_transform3+tensor_filter4"
    assert not stage._donate and not stage._ingress_put  # fed through a tee
    compared = 0
    for i, f in enumerate(frames):
        frame = f.reshape(SIZE, SIZE, 3)
        tb, ts = (np.asarray(t) for t in twires[i].tensors)
        jb, js = (np.asarray(t) for t in jwires[i].tensors)
        _close(tb, jb)
        # random weights put every score near 0.012: the scores are held
        # to TOL of their own largest value, and the region order where
        # the top anchors are apart by more than that
        score_tol = TOL * float(np.abs(js).max())
        assert np.abs(ts.astype(np.float64) - js).max() <= score_tol
        assert twires[i].pts == tcrops[i].pts == i
        regions = tdv.regions(tb, ts, REGIONS, SIZE, SIZE)
        got = [np.asarray(c) for c in tcrops[i].tensors]
        want = _slices(frame, regions)
        assert len(got) == REGIONS
        assert all(g.dtype == np.uint8 and g.shape == w.shape and np.array_equal(g, w)
                   for g, w in zip(got, want))
        jregions = np.asarray(JRegion({"option1": f"{SIZE}:{SIZE}", "option2": str(REGIONS)})
                              .decode([jb, js], nt.Buffer([jb, js])).tensors[0])
        if _separated(js, REGIONS, score_tol):
            compared += 1
            np.testing.assert_array_equal(regions, jregions)
            for g, jc in zip(got, jcrops[i].tensors):
                assert np.array_equal(g, np.asarray(jc))
    assert compared >= 4, compared


def test_wire_tensors_are_bitwise_the_detectors():
    frames = _frames(4, seed=2)
    _, wires, _ = _run(ntt, PORT, frames)
    det = ntt.Pipeline(
        f"appsrc name=cam caps=video/x-raw,format=RGB,width={SIZE},height={SIZE} ! "
        f"tensor_converter ! {NORM} ! tensor_filter framework=jax "
        f"model=ssd_mobilenet_jax_weights custom=size:{SIZE},classes:91,batch:1,"
        "dtype:float32 accelerator=true:cpu ! tensor_sink name=out")
    with det:
        for f in frames:
            det.push("cam", f)
        outs = [det.pull("out", timeout=60) for _ in frames]
        det.eos()
        det.wait(timeout=60)
    for w, o in zip(wires, outs):
        for a, b in zip(w.tensors, o.tensors):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_a_slow_branch_still_crops_its_own_frames(monkeypatch):
    """The region branch sleeps, so the crop's raw pad holds frames while
    the rest of the pipeline moves on: each frame's crops are still slices
    of that frame, and the tee below the fused stage receives the rows
    copied out of the stage, never its static outputs."""
    decode = tdv.TensorRegion.decode

    def slow(self, tensors, buf):
        time.sleep(0.03)
        return decode(self, tensors, buf)

    monkeypatch.setattr(tdv.TensorRegion, "decode", slow)
    p = ntt.Pipeline(PORT)
    [stage] = [s.element for s in p.stages if s.element.kind == "fused"]
    shared = []
    process = Tee.process

    def spy(self, pad, buf):
        if self.name == "d":
            # the stage's static outputs as they are now: live beside the
            # buffer's tensors, so a shared address would be the same memory
            static = {t.data_ptr() for st in stage._sets.values() for t in st.outputs}
            shared.append(any(t.data_ptr() in static for t in buf.tensors))
        return process(self, pad, buf)

    monkeypatch.setattr(Tee, "process", spy)
    frames = _frames(10, seed=5)
    crops, wires, p = _run(ntt, PORT, frames, pipe=p)
    assert len(shared) == len(frames) and not any(shared)
    for f, c, w in zip(frames, crops, wires):
        boxes, scores = (np.asarray(t) for t in w.tensors)
        want = _slices(f.reshape(SIZE, SIZE, 3), tdv.regions(boxes, scores, REGIONS, SIZE, SIZE))
        assert all(np.array_equal(np.asarray(g), x) for g, x in zip(c.tensors, want))
    crop_runner = [r for r in p._unique_runners() if r.element.name == "crop"][0]
    assert crop_runner._pending_peak <= 8  # max-inflight bounds the held frames


def test_camera_example_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["torch_camera_crop.py", "--cpu", "--size", "32",
                                      "--frames", "3"])
    runpy.run_path(str(REPO / "examples" / "torch_camera_crop.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert out.count("crops [") == 3
    assert "3 frames: tee, tensor_region, tensor_crop and the flexbuf round trip" in out


def test_chip_smoke_camera_phase_rehearses_on_the_cpu():
    """The chip script's camera phase at a tiny size on the CPU: every
    check it makes on the card holds here too."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    c = chip_smoke.phase_camera(torch.device("cpu"), size=SIZE, frames_n=12, runs=1,
                                acc="accelerator=true:cpu", custom=",dtype:float32",
                                random_size=32)
    assert c["checked_frames"] == 2 * 12 + chip_smoke.CAMERA_WARM
    assert c["dropped"] == 0 and c["census"]["captures_after_warmup"] == 0
    assert c["runs"][0]["crops"] == 12 * chip_smoke.CAMERA_REGIONS
    assert c["random"]["frames_differ"] and c["random"]["rerun_bitwise"]


# -- videotestsrc device=true pattern=random ----------------------------------------

def _random_src(**kw):
    props = {"device": True, "pattern": "random", "width": 12, "height": 7, "batch": 3}
    props.update(kw)
    return VideoTestSrc(props)


def test_device_random_frames_are_the_ports_own():
    """Shape, dtype and range as the JAX package's frames, a rerun with the
    same settings bitwise equal, and consecutive frames different.  The
    bits are NOT the JAX package's (``jax.random`` cannot be reproduced in
    torch), nor the host pattern's."""
    a = _random_src().device_batch(0, 3, "cpu")
    b = _random_src().device_batch(0, 3, "cpu")
    assert a.shape == (3, 7, 12, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert int(a.min()) >= 0 and int(a.max()) <= 255 and a.float().std() > 50
    # frame i is frame i, whatever batch it falls in
    c = _random_src(batch=2).device_batch(1, 2, "cpu")
    assert torch.equal(c, a[1:3])
    host = np.stack([_random_src()._frame(i) for i in range(3)])
    assert a.numpy().tobytes() != host.tobytes()


def test_device_random_source_folds_into_a_stage():
    desc = ("videotestsrc device=true pattern=random batch=2 num-buffers=6 width=16 "
            f"height=16 name=src ! {NORM} ! tensor_filter framework=jax model=scaler "
            "custom=scale:1.0,dims:3:16:16:2 accelerator=true:cpu ! tensor_sink name=out")
    runs = []
    for _ in range(2):
        p = ntt.Pipeline(desc)
        folded = [s.element for s in p.stages if getattr(s.element, "fused", None)]
        assert folded and folded[0].source.pattern == "random"
        with p:
            runs.append([np.asarray(p.pull("out", timeout=60).tensors[0]) for _ in range(3)])
            p.wait(timeout=60)
        assert folded[0].fused.census.captures == 1
    for a, b in zip(*runs):
        assert a.shape == (2, 16, 16, 3) and a.dtype == np.float32
        assert np.array_equal(a, b)
    assert not np.array_equal(runs[0][0][0], runs[0][0][1])
