"""The port's frameworks and single-shot API against the JAX package's:
``python3`` (one user script through both), ``torch`` / ``pytorch`` (a
TorchScript file and a registered module, exact at f32 on the CPU), the
gated ``tensorflow-lite`` and ``onnxruntime`` wrappers (a fake runtime,
imported, behaves the same through both), ``TensorFilter.reload_model``
(the same swaps accepted and refused), ``latency`` / ``throughput`` and
``SingleShot``."""

import sys
import types

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.elements import filter as jfilter
from nnstreamer_tpu.filters import custom_easy as jce
from nnstreamer_tpu.filters import torch_fw as jtorch
from nnstreamer_tpu_torch.elements import filter as tfilter
from nnstreamer_tpu_torch.filters import custom_easy as tce
from nnstreamer_tpu_torch.filters import torch_fw as ttorch
from nnstreamer_tpu_torch.filters.base import FrameworkError

PKGS = {"jax": nt, "torch": ntt}
WAIT = 30.0
#: the port's filters run on the card unless told otherwise
CPU = {"jax": "", "torch": "accelerator=true:cpu"}

USER_SCRIPT = '''
import numpy as np


class Scale:
    """A class with invoke(): numpy arrays in, numpy arrays out."""

    def __init__(self):
        self.seen = []

    def invoke(self, inputs):
        self.seen.append([type(a).__name__ for a in inputs])
        assert all(isinstance(a, np.ndarray) for a in inputs)
        return [inputs[0] * 2 + 1, inputs[1].sum(axis=-1, keepdims=True)]


def add_one(inputs):
    return [np.asarray(inputs[0]) + 1]
'''


def _run(pkg, desc, inputs):
    with PKGS[pkg].Pipeline(f"appsrc name=src ! {desc} ! tensor_sink name=out") as p:
        outs = []
        for x in inputs:
            p.push("src", x)
            outs.append([np.asarray(t) for t in p.pull("out", timeout=WAIT).tensors])
        p.eos("src")
        p.wait(timeout=WAIT)
    return outs


@pytest.fixture
def user_script(tmp_path, monkeypatch):
    name = f"user_script_{tmp_path.name.replace('-', '_')}"
    (tmp_path / f"{name}.py").write_text(USER_SCRIPT)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield name
    sys.modules.pop(name, None)


@pytest.mark.parametrize("fw", ["python3", "python"])
def test_a_user_script_runs_unchanged_through_both(user_script, fw):
    rng = np.random.default_rng(0)
    inputs = [[rng.standard_normal((2, 3)).astype(np.float32),
               rng.integers(0, 9, (2, 4)).astype(np.int32)] for _ in range(3)]
    got = {pkg: _run(pkg, f"tensor_filter framework={fw} model={user_script}:Scale",
                     inputs) for pkg in PKGS}
    for a, b in zip(got["torch"], got["jax"]):
        assert [x.tobytes() for x in a] == [x.tobytes() for x in b]
        assert [x.dtype for x in a] == [x.dtype for x in b]
    fn = {pkg: _run(pkg, f"tensor_filter framework={fw} model={user_script}:add_one",
                    [x[:1] for x in inputs]) for pkg in PKGS}
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(fn["torch"], fn["jax"]))


def test_the_script_gets_numpy_for_torch_tensors(user_script):
    from nnstreamer_tpu_torch.filters.python3 import Python3Framework

    fw = Python3Framework()
    fw.open({"model": f"{user_script}:Scale"})
    out = fw.invoke([torch.ones(2, 2), torch.arange(3)])
    assert fw._obj.seen == [["ndarray", "ndarray"]]
    assert np.array_equal(out[0], np.full((2, 2), 3.0, np.float32))


def test_a_bad_script_name_fails_in_both():
    from nnstreamer_tpu.filters.python3 import Python3Framework as J
    from nnstreamer_tpu_torch.filters.python3 import Python3Framework as T

    for cls, err in ((J, Exception), (T, FrameworkError)):
        with pytest.raises(err, match="module.path:attr"):
            cls().open({"model": "no_colon"})


class _Net(torch.nn.Module):
    """NHWC in, (logits, features) out."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.fc = torch.nn.Linear(4, 5)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2)).relu().mean(dim=(2, 3))
        return self.fc(y), y


def _frames(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 8, 8, 3)).astype(np.float32) for _ in range(n)]


def test_a_torchscript_file_gives_the_same_outputs_through_both(tmp_path):
    path = tmp_path / "net.pt"
    torch.jit.trace(_Net().eval(), torch.from_numpy(_frames(1)[0])).save(str(path))
    got = {pkg: _run(pkg, f"tensor_filter framework=torch model={path} {CPU[pkg]}",
                     _frames()) for pkg in PKGS}
    for a, b in zip(got["torch"], got["jax"]):
        assert len(a) == 2 and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_a_registered_module_gives_the_same_outputs_through_both():
    net = _Net()
    jtorch.register_torch_module("test_torch_net", net)
    ttorch.register_torch_module("test_torch_net", net)
    got = {pkg: _run(pkg, f"tensor_filter framework=pytorch model=test_torch_net "
                     f"{CPU[pkg]}", _frames()) for pkg in PKGS}
    for a, b in zip(got["torch"], got["jax"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_outputs_stay_on_the_filters_device(tmp_path):
    fw = ttorch.TorchFramework()
    fw.open({"model": _Net(), "accelerator": "true:cpu"})
    outs = fw.invoke([_frames(1)[0]])
    assert fw.device == torch.device("cpu")
    assert all(isinstance(o, torch.Tensor) and o.device == fw.device for o in outs)
    assert fw.pure_fn() is None and fw.get_model_info() == (None, None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there")
def test_no_card_and_no_cpu_request_raises():
    with pytest.raises(FrameworkError, match="no CUDA device"):
        ttorch.TorchFramework().open({"model": _Net()})


def test_unknown_model_and_unreadable_file_raise(tmp_path):
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a torchscript file")
    for model, match in (("nope", "neither a TorchScript"), (str(bad), "cannot load")):
        with pytest.raises(FrameworkError, match=match):
            ttorch.TorchFramework().open({"model": model, "accelerator": "true:cpu"})


def test_state_dict_to_tree_matches_the_jax_package():
    sd = dict(_Net().state_dict())
    sd["embed_tokens.weight"] = torch.arange(6.0).reshape(3, 2)
    a, b = ttorch.state_dict_to_tree(sd), jtorch.state_dict_to_tree(sd)
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape and np.array_equal(a[k], b[k]) for k in a)
    assert a["conv.weight"].shape == (3, 3, 3, 4) and a["fc.weight"].shape == (4, 5)
    assert a["embed_tokens.weight"].shape == (3, 2)


class _FakeTFLiteInterpreter:
    """Recorded-IO stand-in for the TFLite Interpreter (as
    ``tests/test_filters_extra.py`` has it), computing y = 2x."""

    def __init__(self, model_path=None):
        self.model_path = model_path
        self._tensors = {}
        self.allocated = False
        self.invoked = 0

    def allocate_tensors(self):
        self.allocated = True

    def get_input_details(self):
        return [{"index": 0, "shape": np.array([1, 4]), "dtype": np.float32, "name": "in0"},
                {"index": 1, "shape": np.array([2, 3]), "dtype": np.uint8, "name": "in1"}]

    def get_output_details(self):
        return [{"index": 10, "shape": np.array([1, 4]), "dtype": np.float32,
                 "name": "out0"}]

    def set_tensor(self, index, value):
        assert value.flags["C_CONTIGUOUS"]  # the wrapper marshals contiguous
        self._tensors[index] = value

    def get_tensor(self, index):
        return self._tensors[index]

    def invoke(self):
        self.invoked += 1
        self._tensors[10] = self._tensors[0] * 2


class _FakeOrtSession:
    class _Input:
        def __init__(self, name):
            self.name = name

    def __init__(self, model, providers=None):
        self.feeds = []

    def get_inputs(self):
        return [self._Input("a"), self._Input("b")]

    def run(self, outputs, feed):
        assert outputs is None
        self.feeds.append(feed)
        return [feed["a"] + feed["b"]]


@pytest.fixture
def fake_runtimes(monkeypatch):
    """tflite_runtime and onnxruntime, importable, backed by the fakes."""
    tfl = types.ModuleType("tflite_runtime")
    interp = types.ModuleType("tflite_runtime.interpreter")
    interp.Interpreter = _FakeTFLiteInterpreter
    tfl.interpreter = interp
    ort = types.ModuleType("onnxruntime")
    ort.InferenceSession = _FakeOrtSession
    for name, mod in (("tflite_runtime", tfl), ("tflite_runtime.interpreter", interp),
                      ("onnxruntime", ort)):
        monkeypatch.setitem(sys.modules, name, mod)


def _gated(pkg):
    if pkg == "jax":
        from nnstreamer_tpu.filters import gated
    else:
        from nnstreamer_tpu_torch.filters import gated
    return gated


@pytest.mark.parametrize("pkg", list(PKGS))
def test_the_fake_tflite_runtime_through_both(fake_runtimes, pkg):
    g = _gated(pkg)
    fw = g.TFLiteFramework()
    fw.open({"model": "model.tflite"})
    assert fw._interp.allocated and fw._interp.model_path == "model.tflite"
    x = np.arange(4, dtype=np.float32)[None, :]
    y = np.zeros((2, 6), np.uint8)[:, ::2]  # not contiguous: marshalled
    outs = fw.invoke([x, y])
    assert fw._interp.invoked == 1 and np.array_equal(outs[0], 2 * x)
    in_spec, out_spec = fw.get_model_info()
    assert [(s.shape, s.dtype) for s in in_spec] == [((1, 4), np.float32),
                                                    ((2, 3), np.uint8)]
    assert [(s.shape, s.dtype) for s in out_spec] == [((1, 4), np.float32)]


def test_the_fake_tflite_runtime_in_singleshot_and_a_pipeline(fake_runtimes):
    x = np.arange(4, dtype=np.float32)[None, :]
    u = np.zeros((2, 3), np.uint8)
    shots = {}
    for pkg, mod in PKGS.items():
        with mod.SingleShot(framework="tensorflow-lite", model="m.tflite") as s:
            shots[pkg] = s.invoke(x, u)
    assert np.array_equal(shots["torch"][0], shots["jax"][0])
    got = _run("torch", "tensor_filter framework=tensorflow2-lite model=m.tflite",
               [[torch.from_numpy(x), u]])  # a torch tensor is fed as numpy
    assert np.array_equal(got[0][0], 2 * x)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_the_fake_onnxruntime_maps_feeds_by_name(fake_runtimes, pkg):
    fw = _gated(pkg).OnnxRuntimeFramework()
    fw.open({"model": "m.onnx"})
    a, b = np.full((3,), 1.5, np.float32), np.full((3,), 0.5, np.float32)
    outs = fw.invoke([a, b])
    assert np.array_equal(outs[0], np.full((3,), 2.0, np.float32))
    assert list(fw._sess.feeds[0]) == ["a", "b"]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_without_a_runtime_both_raise_the_clear_error(monkeypatch, pkg):
    for name in ("tflite_runtime", "tflite_runtime.interpreter", "tensorflow",
                 "tensorflow.lite", "onnxruntime"):
        monkeypatch.setitem(sys.modules, name, None)
    g = _gated(pkg)
    for cls in (g.OnnxRuntimeFramework, g.TFLiteFramework):
        with pytest.raises(Exception, match="install|not installed"):
            cls().open({"model": "nonexistent.bin"})


def _register(pkg):
    ce = jce if pkg == "jax" else tce
    spec_mod = sys.modules[f"{PKGS[pkg].__name__}.core.types"]
    four = spec_mod.TensorsSpec.from_string("4", "float32")
    seven = spec_mod.TensorsSpec.from_string("7", "float32")
    for name, scale in (("reload_a", 2.0), ("reload_b", 10.0)):
        ce.register_custom_easy(
            f"t_{name}", lambda ins, s=scale: [np.asarray(ins[0], np.float32) * s],
            in_spec=four, out_spec=four)
    ce.register_custom_easy("t_reload_wrong", lambda ins: [np.zeros((7,), np.float32)],
                            in_spec=seven, out_spec=seven)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_reload_model_accepts_and_refuses_the_same_swaps(pkg):
    _register(pkg)
    fmod = jfilter if pkg == "jax" else tfilter
    buf = PKGS[pkg].Buffer
    x = np.ones((4,), np.float32)
    f = fmod.TensorFilter({"framework": "custom-easy", "model": "t_reload_a"})
    f.configure({}, ["src"])
    assert np.array_equal(np.asarray(f.process("sink", buf([x]))[0][1].tensors[0]), 2 * x)
    f.reload_model("t_reload_b")
    assert np.array_equal(np.asarray(f.process("sink", buf([x]))[0][1].tensors[0]), 10 * x)
    assert f.props["model"] == "t_reload_b"
    with pytest.raises(Exception, match="reload input spec"):
        f.reload_model("t_reload_wrong")
    # the old model is still live after the refused reload
    assert np.array_equal(np.asarray(f.process("sink", buf([x]))[0][1].tensors[0]), 10 * x)
    assert f.props["model"] == "t_reload_b"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_latency_and_throughput(pkg):
    _register(pkg)
    fmod = jfilter if pkg == "jax" else tfilter
    f = fmod.TensorFilter({"framework": "custom-easy", "model": "t_reload_a",
                           "latency": 1})
    f.configure({}, ["src"])
    assert f.latency is None and f.throughput is None
    for _ in range(3):
        f.process("sink", PKGS[pkg].Buffer([np.ones((4,), np.float32)]))
    assert f.latency > 0 and f.throughput == pytest.approx(1.0 / f.latency)


def test_singleshot_outputs_are_equal():
    fn = lambda ins: [np.asarray(ins[0]) * 3 - 1, np.asarray(ins[1])[::-1].copy()]  # noqa: E731
    jce.register_custom_easy("t_shot", fn)
    tce.register_custom_easy("t_shot", fn)
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 5)).astype(np.float32), np.arange(6, dtype=np.int64)
    outs = {}
    for pkg, mod in PKGS.items():
        with mod.SingleShot(framework="custom-easy", model="t_shot") as s:
            outs[pkg] = [s.invoke(a, b), s.invoke([a, b])]
    for x, y in zip(outs["torch"], outs["jax"]):
        assert all(isinstance(t, np.ndarray) and np.array_equal(t, u) for t, u in zip(x, y))


def test_singleshot_equals_the_fused_pipeline_bitwise():
    custom = "size:32,width:0.25,dtype:float32"
    rng = np.random.default_rng(4)
    xs = [rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    with ntt.SingleShot(framework="jax", model="mobilenet_v1", custom=custom,
                        accelerator="true:cpu") as s:
        shot = [s.invoke(x)[0] for x in xs]
    pipe = _run("torch", "tensor_filter framework=jax model=mobilenet_v1 "
                f"custom={custom} accelerator=true:cpu", xs)
    assert all(np.array_equal(a, b[0]) for a, b in zip(shot, pipe))
    assert shot[0].shape == (1, 1001)
