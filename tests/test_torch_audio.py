"""The audio path in the port against the JAX package's, on the CPU:
``audiotestsrc`` (host buffers in every format and channel count;
device batches), ``tensor_converter`` for audio, and the two audio cells
as pipeline strings, ``audiotestsrc device=true ! tensor_filter
model=speech_commands ! tensor_sink`` and ``... model=wav2vec2 !
tensor_decoder mode=ctc ! tensor_sink``, fused and unfused, with the JAX
package's weights carried across (test-only zoo names
``speech_commands_jax_weights`` and ``wav2vec2_jax_weights``).

Tolerances: host audio buffers are bitwise the JAX package's.  A device
batch's sample is ``sin(n * k)`` with the int32 sample index ``n`` and
the float32 phase constant ``k`` XLA folds the JAX package's ``2 pi freq
n / rate`` into, so it differs from the JAX package's device batch only
where torch's float32 sine rounds otherwise than XLA's: within
``SINE_TOL`` (2^-24, one rounding of a value in [0.5, 1)).  The float32
phase itself is what separates both from the float64 host path (up to a
few 1e-4 at 16 kHz, the reference's own gap): a device batch is held to
the host within the JAX package's own device-to-host gap plus
``SINE_TOL``.  Model outputs within 1e-4 of their largest magnitude; CTC
ids equal wherever the JAX logits' top-1/top-2 gap exceeds that."""

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

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.elements.source import AudioTestSrc as JaxAudioTestSrc
from nnstreamer_tpu.models import audio as jaudio
from nnstreamer_tpu_torch.elements.source import AudioTestSrc
from nnstreamer_tpu_torch.models import audio as taudio, zoo as tzoo
from nnstreamer_tpu_torch.pipeline.plan import FusedSourceElement

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-4
SINE_TOL = 2.0 ** -24


def _host(cls, props):
    src = cls(dict(props))
    src.configure({}, ["src"])
    return [np.asarray(b.tensors[0]) for b in src.generate()]


# -- audiotestsrc ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["S16LE", "F32LE", "U8"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate,spb,freq", [(16000, 1000, 440.0), (44100, 1024, 523.25)])
def test_audiotestsrc_host_buffers_bitwise(fmt, channels, rate, spb, freq):
    props = {"format": fmt, "channels": channels, "rate": rate, "samplesperbuffer": spb,
             "freq": freq, "num_buffers": 3}
    got, want = _host(AudioTestSrc, props), _host(JaxAudioTestSrc, props)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (spb, channels)
        np.testing.assert_array_equal(g, w)
    src = AudioTestSrc(dict(props))
    jsrc = JaxAudioTestSrc(dict(props))
    caps, jcaps = src.configure({}, ["src"])["src"], jsrc.configure({}, ["src"])["src"]
    assert caps.media.value == jcaps.media.value
    assert dict(caps.fields) == dict(jcaps.fields)
    assert [b.pts for b in src.generate()] == [b.pts for b in jsrc.generate()]


@pytest.mark.parametrize("rate,spb,freq,batch", [
    (16000, 16000, 440.0, 3), (16000, 1600, 523.25, 2), (44100, 1024, 440.0, 4),
    (8000, 4000, 1000.0, 2)])
def test_audiotestsrc_device_batches_match_jax(rate, spb, freq, batch):
    props = {"device": True, "batch": batch, "samplesperbuffer": spb, "rate": rate,
             "freq": freq, "num_buffers": 2 * batch + 1}
    src = AudioTestSrc(dict(props))
    src.gen_device = torch.device("cpu")
    src.configure({}, ["src"])
    got = [b.tensors[0] for b in src.generate()]
    want = _host(JaxAudioTestSrc, props)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(batch, spb), (batch, spb), (1, spb)]
    host = _host(JaxAudioTestSrc, {"format": "F32LE", "samplesperbuffer": spb,
                                   "rate": rate, "freq": freq,
                                   "num_buffers": 2 * batch + 1})
    host = np.stack([h[:, 0] for h in host])
    g = np.concatenate([t.numpy() for t in got])
    w = np.concatenate(want)
    assert g.dtype == np.float32
    assert np.abs(g - w).max() <= SINE_TOL
    assert (g != w).mean() < 0.1  # most samples bitwise
    # the reference's own device-to-host gap bounds the port's
    assert np.abs(g - host).max() <= np.abs(w - host).max() + SINE_TOL


def test_audiotestsrc_device_without_a_filter_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = ntt.Pipeline("audiotestsrc device=true batch=2 num-buffers=2 "
                     "samplesperbuffer=1600 rate=16000 ! tensor_sink name=out")
    with p:
        with pytest.raises(ntt.PipelineError, match="accelerator=true:cpu"):
            p.wait(timeout=30)


@pytest.mark.parametrize("fuse", [True, False])
def test_audiotestsrc_device_generates_on_its_filters_device(fuse, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = ntt.Pipeline(KWS.format(acc=" accelerator=true:cpu", model="speech_commands"),
                     fuse=fuse)
    with p:
        outs = [p.pull("out", timeout=60) for _ in range(2)]
        p.wait(timeout=60)
    assert p.element("src").gen_device == torch.device("cpu")
    assert [o.tensors[0].shape for o in outs] == [(2, 12), (1, 12)]


# -- tensor_converter: audio ------------------------------------------------------

@pytest.mark.parametrize("fmt,channels,fpt", [
    ("S16LE", 1, 1), ("F32LE", 2, 1), ("U8", 1, 1), ("F32LE", 1, 1500), ("S16LE", 2, 700)])
def test_converter_audio_matches_the_jax_package(fmt, channels, fpt):
    desc = (f"audiotestsrc num-buffers=4 samplesperbuffer=1000 rate=16000 format={fmt} "
            f"channels={channels} ! tensor_converter frames-per-tensor={fpt} ! "
            "tensor_sink name=out")
    n = 4 if fpt == 1 else 4 * 1000 // fpt
    outs = {}
    for lib in (ntt, nt):
        p = lib.Pipeline(desc)
        with p:
            outs[lib] = [p.pull("out", timeout=60) for _ in range(n)]
            p.wait(timeout=60)
        spec = p.stages[1].element.out_caps["src"].spec
        outs[lib, "spec"] = None if spec is None else [s.shape for s in spec]
    assert outs[ntt, "spec"] == outs[nt, "spec"]
    for a, b in zip(outs[ntt], outs[nt]):
        assert a.tensors[0].shape == (fpt if fpt > 1 else 1000, channels)
        assert a.tensors[0].dtype == b.tensors[0].dtype
        np.testing.assert_array_equal(a.tensors[0], b.tensors[0])
        assert a.pts == b.pts


def test_converter_text_and_modes_stay_unported():
    with pytest.raises(Exception, match="not yet ported"):
        ntt.Pipeline("appsrc name=src caps=text/x-raw ! tensor_converter ! "
                     "tensor_sink name=out")
    with pytest.raises(Exception, match="not yet ported"):
        ntt.Pipeline("appsrc name=src ! tensor_converter mode=flatbuf ! "
                     "tensor_sink name=out")


# -- the audio cells as pipeline strings -------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tree(kind, **kw):
    init = jaudio.init_params_kws if kind == "kws" else jaudio.init_params_w2v
    return jax.tree_util.tree_map(np.asarray, init(**kw))


def _kws_ref(opts, device):
    tree = _jax_tree("kws", classes=int(opts.get("classes", 12)),
                     mels=int(opts.get("mels", 64)), seed=int(opts.get("seed", 0)))
    return taudio.build_bundle_kws(taudio.params_from_jax(tree, device), opts, device,
                                   "speech_commands_jax_weights")


def _w2v_ref(opts, device):
    tree = _jax_tree("w2v", dim=int(opts.get("dim", 256)),
                     n_layers=int(opts.get("n_layers", 4)),
                     n_heads=int(opts.get("n_heads", 4)), vocab=int(opts.get("vocab", 32)),
                     seed=int(opts.get("seed", 0)))
    return taudio.build_bundle_w2v(taudio.params_from_jax(tree, device), opts,
                                   "wav2vec2_jax_weights")


tzoo.register_model("speech_commands_jax_weights", _kws_ref)
tzoo.register_model("wav2vec2_jax_weights", _w2v_ref)

#: bench.py's audio cells at a small size: 4,000-sample windows, batch 2,
#: wav2vec2 at dim 64 with 2 layers
KWS = ("audiotestsrc device=true batch=2 num-buffers=3 samplesperbuffer=4000 rate=16000 "
       "name=src ! tensor_filter framework=jax model={model} "
       "custom=dtype:float32,batch:2,samples:4000{acc} ! tensor_sink name=out")
W2V = ("audiotestsrc device=true batch=2 num-buffers=4 samplesperbuffer=4000 rate=16000 "
       "name=src ! tensor_filter framework=jax model={model} "
       "custom=dtype:float32,batch:2,samples:4000,dim:64,n_layers:2{acc} ! "
       "tensor_decoder mode=ctc{opt} ! tensor_sink name=out")


def _pull(p, n):
    with p:
        outs = [p.pull("out", timeout=120) for _ in range(n)]
        p.wait(timeout=120)
    return outs


@pytest.mark.parametrize("fuse", [True, False])
def test_speech_commands_cell_against_the_jax_package(fuse):
    port = KWS.format(model="speech_commands_jax_weights", acc=" accelerator=true:cpu")
    ref = KWS.format(model="speech_commands", acc="")
    p = ntt.Pipeline(port, fuse=fuse)
    j = nt.Pipeline(ref, fuse=fuse)
    assert [s.element.name for s in p.stages] == [s.element.name for s in j.stages]
    if fuse:
        assert [s.element.name for s in p.stages] == ["src+tensor_filter1", "out"]
        st = p.stages[0].element
        assert isinstance(st, FusedSourceElement)
    mine, want = _pull(p, 2), _pull(j, 2)
    if fuse:
        assert len(st.fused.census.signatures) == 2  # the truncated tail batch
    for m, w in zip(mine, want):
        w = np.asarray(w.tensors[0])
        assert m.tensors[0].shape == w.shape
        err = np.abs(m.tensors[0] - w).max() / max(1.0, np.abs(w).max())
        assert err <= F32_TOL


@pytest.mark.parametrize("opt", ["", " option2=digits"])
def test_wav2vec2_ctc_cell_against_the_jax_package(opt):
    port = W2V.format(model="wav2vec2_jax_weights", acc=" accelerator=true:cpu", opt=opt)
    ref = W2V.format(model="wav2vec2", acc="", opt=opt)
    p = ntt.Pipeline(port)
    assert [s.element.name for s in p.stages] == \
        [s.element.name for s in nt.Pipeline(ref).stages] == \
        ["src+tensor_filter1+tensor_decoder2", "out"]
    fused = _pull(p, 2)
    st = p.stages[0].element.fused
    assert len(st.census.signatures) == 1 and st.census.captures == 1
    unfused = _pull(ntt.Pipeline(port, fuse=False), 2)
    want = _pull(nt.Pipeline(ref), 2)
    raw = re.sub(r" ! tensor_decoder [^!]*!", " !", ref)
    logits = [np.asarray(b.tensors[0]) for b in _pull(nt.Pipeline(raw), 2)]
    mine = [np.asarray(b.tensors[0]) for b in
            _pull(ntt.Pipeline(re.sub(r" ! tensor_decoder [^!]*!", " !", port)), 2)]
    for f, u, w, lg, ml in zip(fused, unfused, want, logits, mine):
        assert lg.shape == (2, taudio.w2v_frames(4000), 32)
        err = np.abs(ml - lg).max() / max(1.0, np.abs(lg).max())
        assert err <= F32_TOL
        np.testing.assert_array_equal(f.tensors[0], u.tensors[0])
        top = np.sort(lg, axis=-1)
        if ((top[..., -1] - top[..., -2]) > 2 * err * max(1.0, np.abs(lg).max())).all():
            np.testing.assert_array_equal(f.tensors[0], w.tensors[0])
            assert [list(t) for t in f.meta["tokens"]] == [list(t) for t in w.meta["tokens"]]
        # the ids are the host argmax of the port's own logits
        ids = ml.argmax(-1)
        keep = np.ones(ids.shape, bool)
        keep[:, 1:] = ids[:, 1:] != ids[:, :-1]
        keep &= ids != 0
        assert [list(t) for t in f.meta["tokens"]] == [list(r[k]) for r, k in zip(ids, keep)]


def test_wav2vec2_builds_at_the_cells_width_with_t_199():
    b = tzoo.build("wav2vec2", {"dtype": "float32", "batch": "64", "samples": "16000"},
                   device="cpu")
    assert b.out_spec[0].shape == (64, 199, 32)
    assert b.params["layers"]["wq"].shape == (4, 256, 256)


def test_port_audio_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for name, want in (("torch_audio_classification.py", "command scores shape: (12,)"),
                       ("torch_pose_estimation.py", "first keypoints:"),
                       ("torch_segmentation.py", "class map (2, 4, 4)")):
        out = subprocess.run([sys.executable, str(REPO / "examples" / name), "--cpu"],
                             cwd=str(REPO), env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr
        assert want in out.stdout
        if name == "torch_segmentation.py":
            assert "reduced output selected: f" in out.stdout
