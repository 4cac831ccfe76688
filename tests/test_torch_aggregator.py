"""``tensor_aggregator`` in the port against the JAX package's
(``nnstreamer_tpu/elements/aggregator.py``), on the CPU.

Both elements get the same seeded numpy buffers; the port's windows, in
host mode and with the device ring (``device=true``, its ring on the
CPU here), must be bitwise the JAX package's windows in both of its modes
(the JAX device mode runs on the JAX CPU backend, as
``tests/test_aggregator_device.py`` runs it): a window is pure data
movement.  Then the ring's own rules: each window owns its storage, one
ring allocation for the stage's lifetime, no host read inside device
mode, and a buffer of another signature refused.  Last, the windowed
streaming ASR pipeline (``audiotestsrc device=true ! tensor_aggregator
device=true ! tensor_filter model=speech_commands``) against the JAX
package's, the scores within ``F32_TOL`` (1e-4 of the largest magnitude,
as ``tests/test_torch_audio.py``): the two sources' sines differ in their
last bits, so the windows there are not compared bitwise.
"""

import functools
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.elements.aggregator import TensorAggregator as JAgg
from nnstreamer_tpu.elements.base import ElementError as JElementError
from nnstreamer_tpu.models import audio as jaudio
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.models import audio as taudio, zoo as tzoo

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-4

#: (props, buffer shape, dtype, buffers): overlapping 4000 / 16000 / 4000,
#: non-overlapping, a flush longer than the window, a 2-D tensor counted
#: along frames_dim=1, an integer stream, and one shorter than a window
CASES = {
    "overlap": (dict(frames_in=4000, frames_out=16000, frames_flush=4000, frames_dim=0),
                (1, 4000), np.float32, 12),
    "non_overlap": (dict(frames_in=1000, frames_out=4000, frames_flush=4000, frames_dim=0),
                    (1, 1000), np.float32, 9),
    "flush_past_window": (dict(frames_in=100, frames_out=300, frames_flush=500,
                               frames_dim=0), (1, 100), np.float32, 23),
    "frames_dim_1": (dict(frames_in=3, frames_out=5, frames_flush=2, frames_dim=1),
                     (3, 2), np.float32, 11),
    "int16_frames": (dict(frames_in=2, frames_out=6, frames_flush=4, frames_dim=0),
                     (2, 4), np.int16, 10),
    "partial_at_eos": (dict(frames_in=4000, frames_out=16000, frames_flush=4000,
                            frames_dim=0), (1, 4000), np.float32, 3),
}


def _inputs(shape, dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return [rng.integers(-1000, 1000, shape).astype(dtype) for _ in range(n)]
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _drive(cls, buf_cls, props, inputs, wrap=lambda x: x):
    el = cls(dict(props), name="agg")
    if isinstance(el, TensorAggregator):
        el.ring_device = torch.device("cpu")
    el.configure({}, ["src"])
    outs = []
    for i, x in enumerate(inputs):
        outs += el.process("sink", buf_cls([wrap(x)], pts=i))
    assert list(el.finalize()) == []
    return el, [(pad, b.pts, [_host(t) for t in b.tensors]) for pad, b in outs]


def _same(a, b):
    assert len(a) == len(b)
    for (pa, ta, xa), (pb, tb, xb) in zip(a, b):
        assert (pa, ta) == (pb, tb)
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_windows_bitwise_the_jax_packages_in_both_modes(case):
    props, shape, dtype, n = CASES[case]
    inputs = _inputs(shape, dtype, n)
    _, jhost = _drive(JAgg, JBuffer, props, inputs)
    _, jdev = _drive(JAgg, JBuffer, dict(props, device="true"), inputs)
    _same(jhost, jdev)
    _, host = _drive(TensorAggregator, Buffer, props, inputs)
    el, dev = _drive(TensorAggregator, Buffer, dict(props, device="true"), inputs)
    _same(host, jhost)
    _same(dev, jdev)
    if case == "partial_at_eos":
        assert dev == [] and el._rings is None  # dropped, and the ring freed
    else:
        assert len(dev) > 0


@pytest.mark.parametrize("concat", ["true", "false"])
def test_host_mode_takes_torch_tensors_and_concat_false(concat):
    props = dict(frames_in=2, frames_out=4, frames_flush=2, frames_dim=0, concat=concat)
    inputs = _inputs((3, 2), np.float32, 7, seed=3)
    _, want = _drive(JAgg, JBuffer, props, inputs)
    _, got = _drive(TensorAggregator, Buffer, props, inputs, wrap=torch.from_numpy)
    _same(got, want)
    assert len(got[0][2]) == (1 if concat == "true" else 4)


def test_device_mode_takes_torch_tensors():
    props, shape, dtype, n = CASES["overlap"]
    inputs = _inputs(shape, dtype, n)
    _, want = _drive(JAgg, JBuffer, dict(props, device="true"), inputs)
    _, got = _drive(TensorAggregator, Buffer, dict(props, device="true"), inputs,
                    wrap=torch.from_numpy)
    _same(got, want)


def test_rejections_match_the_jax_package():
    props = dict(frames_in=1, frames_out=2, device="true", concat="false")
    with pytest.raises(JElementError) as je:
        JAgg(dict(props))
    with pytest.raises(ElementError) as te:
        TensorAggregator(dict(props))
    assert str(te.value) == str(je.value)
    two = [np.zeros((1, 4), np.float32)] * 2
    j = JAgg(dict(frames_in=4, frames_out=8, frames_dim=0, device="true"))
    with pytest.raises(JElementError) as je:
        j.process("sink", JBuffer(list(two)))
    t = TensorAggregator(dict(frames_in=4, frames_out=8, frames_dim=0, device="true"))
    t.ring_device = torch.device("cpu")
    with pytest.raises(ElementError) as te:
        t.process("sink", Buffer(list(two)))
    assert str(te.value) == str(je.value)


def test_a_buffer_of_another_signature_raises():
    el = TensorAggregator(dict(frames_in=4, frames_out=8, frames_dim=0, device="true"))
    el.ring_device = torch.device("cpu")
    el.process("sink", Buffer([torch.zeros(1, 4)]))
    with pytest.raises(ElementError, match="differs from the stage's first"):
        el.process("sink", Buffer([torch.zeros(1, 5)]))
    with pytest.raises(ElementError, match="differs from the stage's first"):
        el.process("sink", Buffer([torch.zeros(1, 4, dtype=torch.float64)]))


def _ring_el(**kw):
    props = dict(frames_in=4000, frames_out=16000, frames_flush=4000, frames_dim=0,
                 device="true", **kw)
    el = TensorAggregator(props, name="agg")
    el.ring_device = torch.device("cpu")
    el.configure({}, ["src"])
    return el


def test_a_held_window_owns_its_storage():
    """The stage below may hold window k while the ring takes 8 more
    buffers: its values stay, and it shares no storage with the ring or
    with another window."""
    el = _ring_el()
    inputs = [torch.from_numpy(x) for x in _inputs((1, 4000), np.float32, 12, seed=5)]
    wins = []
    for x in inputs[:4]:
        wins += [b.tensors[0] for _, b in el.process("sink", Buffer([x]))]
    held = wins[0]
    kept = held.clone()
    for x in inputs[4:]:
        wins += [b.tensors[0] for _, b in el.process("sink", Buffer([x]))]
    assert len(wins) == 9
    assert torch.equal(held, kept)
    assert torch.equal(held, torch.cat(inputs[:4], dim=1))
    ring = el._rings.untyped_storage().data_ptr()
    ptrs = {w.untyped_storage().data_ptr() for w in wins}
    assert ring not in ptrs and len(ptrs) == len(wins)
    assert all(w.is_contiguous() for w in wins)


def test_one_ring_allocation_and_no_host_read(monkeypatch):
    """100 windows from one ring allocation, and inside device mode no
    read of a tensor's value on the host (``item``, ``cpu``, ``numpy``,
    ``tolist`` or a conversion to a Python scalar)."""
    el = _ring_el()
    inputs = [torch.from_numpy(x) for x in _inputs((1, 4000), np.float32, 103, seed=7)]
    zeros = []
    real_zeros = torch.zeros

    def counting_zeros(*a, **k):
        zeros.append(a)
        return real_zeros(*a, **k)

    def trap(*_a, **_k):
        raise AssertionError("a host read inside the aggregator's device mode")

    monkeypatch.setattr(torch, "zeros", counting_zeros)
    for attr in ("item", "cpu", "numpy", "tolist", "__bool__", "__float__", "__int__"):
        monkeypatch.setattr(torch.Tensor, attr, trap)
    wins = []
    for i, x in enumerate(inputs):
        wins += [b.tensors[0] for _, b in el.process("sink", Buffer([x], pts=i))]
    monkeypatch.undo()
    assert len(wins) == 100
    assert el.ring_allocations == 1 and len(zeros) == 1
    assert tuple(el._rings.shape) == (2, 1, 16000 + 4000)
    assert torch.equal(wins[-1], torch.cat(inputs[-4:], dim=1))


def test_finalize_frees_the_ring_and_a_new_stream_allocates_again():
    el = _ring_el()
    for x in _inputs((1, 4000), np.float32, 5):
        el.process("sink", Buffer([torch.from_numpy(x)]))
    assert el._rings is not None
    el.finalize()
    assert el._rings is None and el._valid == 0
    outs = []
    for x in _inputs((1, 4000), np.float32, 4, seed=9):
        outs += el.process("sink", Buffer([torch.from_numpy(x)]))
    assert len(outs) == 1 and el.ring_allocations == 2


def test_aggregator_is_a_stage_of_its_own_and_not_restartable():
    p = ntt.Pipeline(
        "audiotestsrc device=true num-buffers=4 samplesperbuffer=400 rate=16000 ! "
        "tensor_aggregator frames_in=400 frames_out=800 frames_flush=400 frames_dim=0 "
        "device=true name=agg ! tensor_sink name=out")
    st = [s for s in p.stages if s.element.name == "agg"][0]
    assert st.restartable is False and st.batchable is False


# -- the windowed streaming ASR path ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kws_tree(classes, mels, seed):
    return jax.tree_util.tree_map(np.asarray, jaudio.init_params_kws(
        classes=classes, mels=mels, seed=seed))


def _kws_ref(opts, device):
    tree = _kws_tree(int(opts.get("classes", 12)), int(opts.get("mels", 64)),
                     int(opts.get("seed", 0)))
    return taudio.build_bundle_kws(taudio.params_from_jax(tree, device), opts, device,
                                   "speech_commands_agg_jax_weights")


tzoo.register_model("speech_commands_agg_jax_weights", _kws_ref)

#: the JAX example's pipeline (``examples/asr_streaming_window.py``)
ASR = ("audiotestsrc device=true num-buffers={n} samplesperbuffer=4000 rate=16000 "
       "freq=880 name=src ! tensor_aggregator frames_in=4000 frames_out=16000 "
       "frames_flush=4000 frames_dim=0 {dev}name=agg ! tensor_filter framework=jax "
       "model={model} custom=dtype:float32{acc} name=f ! tensor_sink name=out")


def _scores(lib, desc, n):
    p = lib.Pipeline(desc)
    with p:
        outs = [np.asarray(p.pull("out", timeout=120).tensors[0]) for _ in range(n)]
        p.wait(timeout=120)
    return p, outs


@pytest.mark.parametrize("dev", ["device=true ", ""], ids=["ring", "host"])
def test_asr_window_path_against_the_jax_package(dev):
    n_chunks, n_win = 7, 4
    port = ASR.format(n=n_chunks, dev=dev, model="speech_commands_agg_jax_weights",
                      acc=" accelerator=true:cpu")
    p, got = _scores(ntt, port, n_win)
    _, want = _scores(nt, ASR.format(n=n_chunks, dev=dev, model="speech_commands",
                                     acc=""), n_win)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 12)
        assert np.abs(g - w).max() / max(1.0, np.abs(w).max()) <= F32_TOL
    agg = p.element("agg")
    if dev:
        assert agg.ring_device == torch.device("cpu") and agg.ring_allocations == 1
        assert p.residency.resident_edges >= 1
    else:
        assert agg.ring_allocations == 0


def test_asr_device_ring_scores_bitwise_the_host_carrys():
    desc = ASR.replace("model={model}", "model=speech_commands").format(
        n=6, model="", acc=" accelerator=true:cpu", dev="{dev}")
    _, ring = _scores(ntt, desc.format(dev="device=true "), 3)
    _, host = _scores(ntt, desc.format(dev=""), 3)
    for a, b in zip(ring, host):
        assert a.tobytes() == b.tobytes()


def test_asr_example_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["torch_asr_streaming_window.py", "--cpu",
                                      "--chunks", "6"])
    runpy.run_path(str(REPO / "examples" / "torch_asr_streaming_window.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "1 device-resident edge(s)" in out
    assert "ring on cpu, 1 allocation(s)" in out
    assert "3 overlapping windows decoded" in out


def test_chip_smoke_asr_phase_rehearses_on_the_cpu():
    """The chip script's asr phase at a tiny size on the CPU: the same
    checks it makes on the card (windows and scores bitwise between the
    carries, one ring allocation, windows owning their storage)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    a = chip_smoke.phase_asr(torch.device("cpu"), windows=6, runs=1,
                             acc="accelerator=true:cpu", checked=4)
    assert a["windows_bitwise"] and a["scores_bitwise"] and a["all_scores_bitwise"]
    assert a["gate"]["ring_allocations"] == 1
    assert a["gate"]["windows"] == chip_smoke.ASR_GATE_BUFFERS - 3
    assert a["card_ms"] is None  # no card: not measured
