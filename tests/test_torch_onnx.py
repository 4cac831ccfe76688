"""The port's ``.onnx`` ingestion (``nnstreamer_tpu_torch/models/onnx.py``)
against the JAX package's and against the exporting module, on the CPU:
the counterpart of each test of ``tests/test_onnx.py``.

The fixtures are exported by torch's own ONNX exporter (a serializer
independent of both packages' wire readers), as the JAX tests do.  Each
file and its seeded input go to the JAX bundle under ``jax.jit``, to the
port's bundle on the CPU and to the module: the port within 1e-5
(relative to the largest output) of the JAX package, and within the JAX
tests' tolerances of the module."""


import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.models import onnx as jnx
from nnstreamer_tpu_torch.models import onnx as nx
from nnstreamer_tpu_torch.models import zoo

CPU = "accelerator=true:cpu"


@pytest.fixture(autouse=True, scope="module")
def _patch_exporter():
    # torch's legacy exporter serializes its own protobuf but insists on
    # the `onnx` package for a final (optional) onnxscript post-step —
    # skip it; the serialized ModelProto is already complete.
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom: model_bytes
    yield
    onnx_proto_utils._add_onnxscript_fn = orig


def _export(tmp_path, module, x, name="m.onnx", opset=13):
    path = str(tmp_path / name)
    module.eval()
    with torch.no_grad():
        torch.onnx.export(module, x, path, opset_version=opset, dynamo=False)
    return path


def _port(path, x, opts=None):
    b = nx.load_bundle(path, opts, device="cpu")
    return b, b.apply_fn(b.params, x).numpy()


def _compare(path, module, x, rtol=1e-4, atol=1e-5):
    jb = jnx.load_bundle(path)
    want_jax = np.asarray(jax.jit(jb.apply_fn)(jb.params, x.numpy()))
    bundle, got = _port(path, x)
    with torch.no_grad():
        want = module(x).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_jax).max()))
    return bundle


class TestTorchExportedModels:
    def test_small_cnn(self, tmp_path):
        torch.manual_seed(0)
        m = nn.Sequential(
            nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.ReLU(),
            nn.Conv2d(8, 8, 3, padding=1, groups=8), nn.ReLU6(),
            nn.MaxPool2d(2),
            nn.Flatten(), nn.Linear(8 * 2 * 2, 5), nn.Softmax(dim=1))
        x = torch.randn(2, 3, 8, 8)
        _compare(_export(tmp_path, m, x), m, x)

    def test_batchnorm_and_avgpool(self, tmp_path):
        torch.manual_seed(1)
        m = nn.Sequential(
            nn.Conv2d(3, 4, 3, padding=1), nn.BatchNorm2d(4), nn.ReLU(),
            nn.AvgPool2d(2), nn.Conv2d(4, 6, 1), nn.Sigmoid())
        m.eval()
        m[1].running_mean.uniform_(-1, 1)
        m[1].running_var.uniform_(0.5, 2.0)
        x = torch.randn(1, 3, 8, 8)
        _compare(_export(tmp_path, m, x), m, x)

    def test_global_pool_residual(self, tmp_path):
        torch.manual_seed(2)

        class Block(nn.Module):
            def __init__(self):
                super().__init__()
                self.c1 = nn.Conv2d(4, 4, 3, padding=1)
                self.c2 = nn.Conv2d(4, 4, 3, padding=1)
                self.head = nn.Linear(4, 3)

            def forward(self, x):
                h = torch.relu(self.c1(x))
                h = self.c2(h) + x
                h = torch.nn.functional.adaptive_avg_pool2d(h, 1)
                return self.head(h.flatten(1))

        m = Block()
        x = torch.randn(2, 4, 6, 6)
        _compare(_export(tmp_path, m, x), m, x)

    def test_transpose_pad_mean(self, tmp_path):
        torch.manual_seed(3)

        class M(nn.Module):
            def forward(self, x):
                h = x.permute(0, 2, 1)
                h = torch.nn.functional.pad(h, (1, 1), value=0.5)
                return h.mean(dim=-1)

        m = M()
        x = torch.randn(2, 3, 5)
        _compare(_export(tmp_path, m, x), m, x)

    def test_reflect_pad_and_ceil_pool(self, tmp_path):
        torch.manual_seed(6)
        m = nn.Sequential(nn.ReflectionPad2d(1), nn.Conv2d(2, 3, 3),
                          nn.MaxPool2d(2, ceil_mode=True))
        x = torch.randn(1, 2, 5, 5)
        _compare(_export(tmp_path, m, x), m, x)

    def test_avgpool_ceil_mode(self, tmp_path):
        m = nn.Sequential(nn.AvgPool2d(2, ceil_mode=True))
        x = torch.randn(1, 2, 5, 5)
        _compare(_export(tmp_path, m, x), m, x)

    def test_weight_transpose_on_the_device(self, tmp_path):
        # a hostable op (Transpose) applied to a WEIGHT initializer runs on
        # the device tensor, not through the numpy folding
        torch.manual_seed(7)

        class M(nn.Module):
            def __init__(self):
                super().__init__()
                self.w = nn.Parameter(torch.randn(3, 5))

            def forward(self, x):
                return x @ self.w.t()

        m = M()
        x = torch.randn(2, 5)
        _compare(_export(tmp_path, m, x), m, x)

    def test_mlp_gemm(self, tmp_path):
        torch.manual_seed(4)
        m = nn.Sequential(nn.Linear(10, 16), nn.Tanh(), nn.Linear(16, 4))
        x = torch.randn(3, 10)
        bundle = _compare(_export(tmp_path, m, x), m, x)
        assert any(tuple(v.shape) == (16, 10) for v in bundle.params.values())

    def test_conv_weights_channels_last(self, tmp_path):
        torch.manual_seed(11)
        m = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(), nn.Conv2d(8, 4, 1))
        x = torch.randn(2, 3, 6, 6)
        b = _compare(_export(tmp_path, m, x), m, x)
        convs = [t for t in b.params.values() if t.dim() == 4]
        assert len(convs) == 2
        assert all(t.is_contiguous(memory_format=torch.channels_last) for t in convs)


class TestTransformerAndYolo:
    def test_attention_block(self, tmp_path):
        torch.manual_seed(8)

        class Attn(nn.Module):
            def __init__(self, d=32, h=4):
                super().__init__()
                self.h, self.hd = h, d // h
                self.qkv = nn.Linear(d, 3 * d)
                self.o = nn.Linear(d, d)
                self.ln1 = nn.LayerNorm(d)
                self.ln2 = nn.LayerNorm(d)
                self.ff1 = nn.Linear(d, 64)
                self.ff2 = nn.Linear(64, d)

            def forward(self, x):
                B, T, D = x.shape
                q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
                q = q.view(B, T, self.h, self.hd).transpose(1, 2)
                k = k.view(B, T, self.h, self.hd).transpose(1, 2)
                v = v.view(B, T, self.h, self.hd).transpose(1, 2)
                a = torch.softmax(q @ k.transpose(-1, -2) / (self.hd ** 0.5), dim=-1)
                y = (a @ v).transpose(1, 2).reshape(B, T, D)
                x = x + self.o(y)
                return x + self.ff2(torch.nn.functional.gelu(self.ff1(self.ln2(x))))

        m = Attn()
        x = torch.randn(2, 6, 32)
        _compare(_export(tmp_path, m, x, opset=14), m, x, rtol=2e-4, atol=2e-5)

    def test_yolo_block_leaky_resize_split_max(self, tmp_path):
        torch.manual_seed(9)

        class Y(nn.Module):
            def __init__(self):
                super().__init__()
                self.c = nn.Conv2d(8, 16, 3, padding=1)

            def forward(self, x):
                h = torch.nn.functional.leaky_relu(self.c(x), 0.1)
                h = torch.nn.functional.interpolate(h, scale_factor=2, mode="nearest")
                a, b = torch.split(h, 8, dim=1)
                return torch.maximum(a, b)

        m = Y()
        x = torch.randn(1, 8, 8, 8)
        _compare(_export(tmp_path, m, x), m, x)

    def test_bilinear_upsample(self, tmp_path):
        class U(nn.Module):
            def forward(self, x):
                return torch.nn.functional.interpolate(
                    x, scale_factor=2, mode="bilinear", align_corners=False)

        x = torch.randn(1, 3, 5, 5)
        _compare(_export(tmp_path, U(), x), U(), x)

    @staticmethod
    def _resize_node(coord=None):
        n, jn = nx._Node(), jnx._Node()
        for node, mod in ((n, nx), (jn, jnx)):
            node.op, node.name = "Resize", "r"
            node.inputs, node.outputs = ["x", "", "scales"], ["y"]
            node.attrs = {}
            if coord is not None:
                a = mod._Attr()
                a.f = a.i = a.t = None
                a.s = coord
                a.floats, a.ints = [], []
                node.attrs = {"coordinate_transformation_mode": a}
        return n, jn

    @staticmethod
    def _env(x):
        return nx._Env("t", {"x": torch.from_numpy(x)}, {}, {}, {}, {},
                       torch.device("cpu"))

    def test_resize_spec_default_round_prefer_floor(self):
        n, jn = self._resize_node()
        x = np.arange(4, dtype=np.float32).reshape(1, 1, 4, 1)
        scales = lambda name: np.array([1, 1, 2, 1], np.float32)  # noqa: E731
        out = nx._resize(self._env(x), scales, n).numpy()
        np.testing.assert_array_equal(out.ravel(), [0, 0, 1, 1, 2, 2, 3, 3])
        np.testing.assert_array_equal(out, np.asarray(jnx._resize({"x": x}, scales, jn)))

    def test_resize_unknown_coord_mode_rejected(self):
        n, _ = self._resize_node("tf_crop_and_resize")
        with pytest.raises(nx.ONNXError, match="tf_crop_and_resize"):
            nx._resize(self._env(np.zeros((1, 1, 4, 4), np.float32)),
                       lambda name: np.array([1, 1, 2, 2], np.float32), n)

    def test_embedding_gather_on_the_device(self, tmp_path):
        # Gather with DATA indices (token ids): the indices stay a tensor
        torch.manual_seed(10)

        class E(nn.Module):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(50, 16)
                self.head = nn.Linear(16, 4)

            def forward(self, ids):
                return self.head(self.emb(ids).mean(dim=1))

        m = E()
        ids = torch.randint(0, 50, (3, 7))
        path = _export(tmp_path, m, ids)
        jb = jnx.load_bundle(path)
        want_jax = np.asarray(jax.jit(jb.apply_fn)(jb.params, ids.numpy()))
        _, got = _port(path, ids)
        with torch.no_grad():
            want = m(ids).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, want_jax, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want_jax).max()))


def _pb_varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _pb(field, payload):
    """A length-delimited protobuf field."""
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


class TestErrorsAndOptions:
    def test_not_onnx(self, tmp_path):
        p = tmp_path / "junk.onnx"
        p.write_bytes(b"\x00\x01\x02\x03" * 8)
        with pytest.raises(nx.ONNXError):
            nx.load_bundle(str(p), device="cpu")

    def test_unsupported_op_listed(self, tmp_path):
        """A graph whose one node is an op neither package runs (written
        here on the wire: torch cannot export one): both refuse it by
        name."""
        node = _pb(1, b"x") + _pb(2, b"y") + _pb(4, b"DFT")
        tensor_type = _pb(1, _pb_varint(1 << 3) + _pb_varint(1))  # elem_type float
        value = lambda name: _pb(1, name) + _pb(2, tensor_type)  # noqa: E731
        graph = _pb(1, node) + _pb(11, value(b"x")) + _pb(12, value(b"y"))
        p = tmp_path / "dft.onnx"
        p.write_bytes(_pb(7, graph))
        with pytest.raises(nx.ONNXError, match=r"unsupported op\(s\) \['DFT'\]"):
            nx.load_bundle(str(p), device="cpu")
        with pytest.raises(jnx.ONNXError, match="DFT"):
            jnx.load_bundle(str(p))

    def test_unknown_option_rejected(self, tmp_path):
        m = nn.Sequential(nn.Linear(4, 2))
        path = _export(tmp_path, m, torch.randn(1, 4))
        with pytest.raises(nx.ONNXError, match="param_dtype"):
            nx.load_bundle(path, {"bogus": "1"}, device="cpu")

    def test_param_dtype_option(self, tmp_path):
        m = nn.Sequential(nn.Linear(4, 2))
        path = _export(tmp_path, m, torch.randn(1, 4))
        b = nx.load_bundle(path, {"param_dtype": "bfloat16"}, device="cpu")
        floats = [t for t in b.params.values() if t.is_floating_point()]
        assert floats and all(t.dtype == torch.bfloat16 for t in floats)


class TestPipelineIntegration:
    def test_tensor_filter_loads_onnx_file(self, tmp_path):
        torch.manual_seed(5)
        m = nn.Sequential(
            nn.Conv2d(3, 4, 3, stride=2, padding=1), nn.ReLU(),
            nn.Flatten(), nn.Linear(4 * 4 * 4, 5), nn.Softmax(dim=1))
        x = torch.randn(1, 3, 8, 8)
        path = _export(tmp_path, m, x)
        outs = {}
        for pkg, acc in ((nt, ""), (ntt, CPU)):
            p = pkg.Pipeline(
                "appsrc name=src caps=other/tensors,dimensions=8:8:3:1,types=float32 ! "
                f"tensor_filter framework=jax model={path} {acc} ! tensor_sink name=out")
            with p:
                p.push("src", x.numpy())
                outs[pkg] = np.asarray(p.pull("out", timeout=60).tensors[0])
                p.eos("src")
                p.wait(timeout=30)
        with torch.no_grad():
            want = m(x).numpy()
        np.testing.assert_allclose(outs[ntt], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(outs[ntt], outs[nt], rtol=1e-5, atol=1e-6)

    def test_zoo_routes_onnx(self, tmp_path):
        m = nn.Sequential(nn.Linear(4, 2))
        path = _export(tmp_path, m, torch.randn(1, 4))
        bundle = zoo.build(path, device="cpu")
        assert bundle.in_spec.specs[0].shape == (1, 4)


def test_shape_arithmetic_from_shapes(tmp_path):
    """A view sized from ``x.size(0)`` with a dynamic batch exports a Shape
    -> Gather -> Unsqueeze -> Concat -> Reshape chain: the chain runs in
    numpy from the input's shape (no device read), the Constant nodes are
    folded once at open, and two batch sizes match the module and the JAX
    package."""
    torch.manual_seed(12)

    class V(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(12, 3)

        def forward(self, x):
            return self.lin(x.reshape(x.size(0), -1) * 2.0 + 1.0)

    m = V().eval()
    path = str(tmp_path / "v.onnx")
    with torch.no_grad():
        torch.onnx.export(m, torch.randn(2, 3, 4), path, opset_version=13, dynamo=False,
                          input_names=["x"], dynamic_axes={"x": {0: "batch"}})
    ops = [n.op for n in nx.ONNXGraph(open(path, "rb").read()).nodes]
    assert ops[:3] == ["Shape", "Constant", "Gather"], ops
    for batch in (2, 5):
        _compare(path, m, torch.randn(batch, 3, 4))
    b = nx.load_bundle(path, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in b.params.values())
