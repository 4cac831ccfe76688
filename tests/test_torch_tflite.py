"""The port's ``.tflite`` ingestion (``nnstreamer_tpu_torch/models/tflite.py``)
against the JAX package's, on the CPU: the counterpart of each test of
``tests/test_tflite.py``.  Each fixture file is written once (by the port's
``tflite_build``, whose bytes equal the JAX package's writer's) and fed,
with the same seeded numpy inputs, to the JAX bundle under ``jax.jit`` and
to the port's bundle on the CPU.  Float graphs agree within 1e-5 relative
at f32; integer outputs exactly."""

import os

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.models import tflite as jtflite
from nnstreamer_tpu.models import tflite_build as jbuild
from nnstreamer_tpu_torch.models import tflite, tflite_build, zoo

CPU = "accelerator=true:cpu"
WAIT = 60


def _jax(path, *xs, opts=None):
    b = jtflite.load_bundle(path, opts)
    out = jax.jit(b.apply_fn)(b.params, *xs)
    return np.asarray(out)


def _port(path, *xs, opts=None):
    b = tflite.load_bundle(path, opts, device="cpu")
    out = b.apply_fn(b.params, *[torch.from_numpy(np.array(x)) for x in xs])
    return out.numpy()


def _close(got, want, rtol=1e-5):
    """Within ``rtol`` of the reference, relative to its largest value."""
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _build_cnn(seed=0):
    """conv(SAME,s2,relu6) -> dwconv(SAME) -> avgpool -> reshape -> fc ->
    softmax (tests/test_tflite.py's fixture), with either writer."""

    def build(mod):
        rng = np.random.default_rng(seed)
        mw = mod.ModelWriter()
        x = mw.add_input([1, 8, 8, 3])
        w1 = mw.add_const(rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.3,
                          "conv_w")
        b1 = mw.add_const(rng.standard_normal((4,)).astype(np.float32) * 0.1, "conv_b")
        y = mw.add_op("CONV_2D", [x, w1, b1], [1, 4, 4, 4],
                      options={"padding": "SAME", "stride": (2, 2), "act": "relu6"})
        wd = mw.add_const(rng.standard_normal((1, 3, 3, 4)).astype(np.float32) * 0.3,
                          "dw_w")
        bd = mw.add_const(np.zeros((4,), np.float32), "dw_b")
        y = mw.add_op("DEPTHWISE_CONV_2D", [y, wd, bd], [1, 4, 4, 4],
                      options={"padding": "SAME", "stride": (1, 1)})
        y = mw.add_op("AVERAGE_POOL_2D", [y], [1, 2, 2, 4],
                      options={"padding": "VALID", "stride": (2, 2), "filter": (2, 2)})
        y = mw.add_op("RESHAPE", [y], [1, 16], options={"new_shape": [1, 16]})
        wf = mw.add_const(rng.standard_normal((5, 16)).astype(np.float32) * 0.2, "fc_w")
        bf = mw.add_const(rng.standard_normal((5,)).astype(np.float32) * 0.1, "fc_b")
        y = mw.add_op("FULLY_CONNECTED", [y, wf, bf], [1, 5])
        y = mw.add_op("SOFTMAX", [y], [1, 5])
        return mw.finish(outputs=[y])

    return build(tflite_build), build(jbuild)


def _cnn_file(tmp_path, seed=0):
    blob, _ = _build_cnn(seed)
    path = tmp_path / "tiny_cnn.tflite"
    path.write_bytes(blob)
    return str(path), np.random.default_rng(100 + seed)


def _write(tmp_path, mw, outputs, name):
    path = tmp_path / name
    path.write_bytes(mw.finish(outputs=outputs))
    return str(path)


class TestParser:
    def test_graph_structure(self, tmp_path):
        path, _ = _cnn_file(tmp_path)
        data = open(path, "rb").read()
        g, jg = tflite.TFLiteGraph(data), jtflite.TFLiteGraph(data)
        assert [op.kind for op in g.ops] == [op.kind for op in jg.ops] == [
            "CONV_2D", "DEPTHWISE_CONV_2D", "AVERAGE_POOL_2D", "RESHAPE",
            "FULLY_CONNECTED", "SOFTMAX"]
        assert [op.attrs for op in g.ops] == [op.attrs for op in jg.ops]
        assert g.inputs == jg.inputs and g.outputs == jg.outputs
        assert g.shapes == jg.shapes and g.tensor_names == jg.tensor_names
        assert g.ops[0].attrs["padding"] == "SAME"
        assert g.ops[0].attrs["strides"] == (2, 2)
        assert sorted(g.constants) == sorted(jg.constants)
        for i, a in g.constants.items():
            np.testing.assert_array_equal(a, jg.constants[i])

    def test_rejects_non_tflite(self):
        with pytest.raises(tflite.TFLiteError, match="TFL3"):
            tflite.TFLiteGraph(b"\x00" * 64)

    def test_matches_torch_golden(self, tmp_path):
        import torch.nn.functional as F

        path, rng = _cnn_file(tmp_path)
        x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
        got, want = _port(path, x), _jax(path, x)
        _close(got, want)
        # and an independent execution of the graph with plain torch ops
        g = tflite.TFLiteGraph(open(path, "rb").read())
        c = {g.tensor_names[i]: torch.from_numpy(np.array(a)) for i, a in g.constants.items()}
        t = F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (0, 1, 0, 1))
        t = torch.clamp(F.conv2d(t, c["conv_w"].permute(0, 3, 1, 2), c["conv_b"], stride=2),
                        0, 6)
        t = F.conv2d(F.pad(t, (1, 1, 1, 1)), c["dw_w"].permute(3, 0, 1, 2), c["dw_b"],
                     groups=4)
        flat = F.avg_pool2d(t, 2, 2).permute(0, 2, 3, 1).reshape(1, 16)
        golden = torch.softmax(flat @ c["fc_w"].T + c["fc_b"], dim=-1).numpy()
        np.testing.assert_allclose(got, golden, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)

    def test_runs_in_a_fused_stage(self, tmp_path):
        """The bundle's callable inside a fused stage (the JAX test jits
        it): the same numbers as a direct call and as the JAX package."""
        path, rng = _cnn_file(tmp_path)
        x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
        p = ntt.Pipeline(
            "appsrc name=src caps=other/tensors,dimensions=3:8:8:1,types=float32 ! "
            "tensor_transform mode=arithmetic option=add:0.0 ! "
            f"tensor_filter framework=jax model={path} {CPU} ! tensor_sink name=out")
        with p:
            p.push("src", x)
            got = np.asarray(p.pull("out", timeout=WAIT).tensors[0])
            names = [s.element.name for s in p.stages]
            p.eos("src")
            p.wait(timeout=WAIT)
        assert any("+" in n for n in names), names
        np.testing.assert_array_equal(got, _port(path, x))
        _close(got, _jax(path, x))

    def test_specs_reflect_graph_io(self, tmp_path):
        path, _ = _cnn_file(tmp_path)
        b = tflite.load_bundle(path, device="cpu")
        jb = jtflite.load_bundle(path)
        assert b.in_spec.specs[0].shape == jb.in_spec.specs[0].shape == (1, 8, 8, 3)
        assert b.out_spec.specs[0].shape == jb.out_spec.specs[0].shape == (1, 5)
        assert b.in_spec.specs[0].dtype == np.float32

    def test_writer_bytes_equal_the_jax_writer(self):
        for seed in (0, 1):
            port, ref = _build_cnn(seed)
            assert port == ref


class TestElementwiseOps:
    def test_add_mul_concat_mean(self, tmp_path):
        rng = np.random.default_rng(1)
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4, 4, 2])
        c = mw.add_const(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))
        s = mw.add_op("ADD", [x, c], [1, 4, 4, 2], options={"act": "relu"})
        m = mw.add_op("MUL", [s, c], [1, 4, 4, 2])
        cc = mw.add_op("CONCATENATION", [s, m], [1, 4, 4, 4], options={"axis": 3})
        axes = mw.add_const(np.array([1, 2], np.int32), "axes")
        out = mw.add_op("MEAN", [cc, axes], [1, 4], options={"keep_dims": False})
        path = _write(tmp_path, mw, [out], "ew.tflite")
        xv = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
        _close(_port(path, xv), _jax(path, xv))


class TestPipelineIntegration:
    def test_tensor_filter_loads_tflite_file(self, tmp_path):
        path, rng = _cnn_file(tmp_path)
        x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
        outs = {}
        for pkg, acc in ((nt, ""), (ntt, CPU)):
            p = pkg.Pipeline(
                "appsrc name=src caps=other/tensors,dimensions=3:8:8:1,types=float32 ! "
                f"tensor_filter framework=jax model={path} {acc} ! tensor_sink name=out")
            with p:
                p.push("src", x)
                outs[pkg] = np.asarray(p.pull("out", timeout=WAIT).tensors[0])
                p.eos("src")
                p.wait(timeout=WAIT)
        _close(outs[ntt], outs[nt])

    def test_zoo_build_missing_file(self):
        with pytest.raises(KeyError, match="not found"):
            zoo.build("/nonexistent/model.tflite", device="cpu")

    def test_zoo_routes_tflite(self, tmp_path):
        path, _ = _cnn_file(tmp_path)
        b = zoo.build(path, device="cpu")
        assert b.out_spec.specs[0].shape == (1, 5)
        assert all(t.device.type == "cpu" for t in b.params.values())

    def test_quantized_activations_recorded_for_io(self):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4], dtype=np.uint8, quant_scale=[0.5],
                         quant_zero_point=[128])
        w = mw.add_const(np.zeros((4, 4), np.uint8), "qw", quant_scale=[0.5])
        out = mw.add_op("FULLY_CONNECTED", [x, w], [1, 4], out_dtype=np.uint8,
                        quant_scale=[0.25], quant_zero_point=[3])
        blob = mw.finish(outputs=[out])
        g, jg = tflite.TFLiteGraph(blob), jtflite.TFLiteGraph(blob)
        assert g.io_quant[x] == jg.io_quant[x] == (0.5, 128, np.dtype(np.uint8))
        assert g.io_quant[out] == jg.io_quant[out] == (0.25, 3, np.dtype(np.uint8))

    def test_quantized_weights_dequantize(self, tmp_path):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 3])
        q = np.array([[10, -10, 0], [20, 0, -20]], np.int8)  # [out=2, in=3]
        w = mw.add_const(q, "qw", quant_scale=[0.1, 0.5], quant_zero_point=[0, 4],
                         quant_axis=0)
        y = mw.add_op("FULLY_CONNECTED", [x, w], [1, 2])
        path = _write(tmp_path, mw, [y], "q.tflite")
        g = tflite.TFLiteGraph(open(path, "rb").read())
        want_w = np.array([[1.0, -1.0, 0.0], [8.0, -2.0, -12.0]], np.float32)
        assert g.constants[w].dtype == np.float32
        np.testing.assert_array_equal(g.constants[w],
                                      jtflite.TFLiteGraph(open(path, "rb").read()).constants[w])
        np.testing.assert_allclose(g.constants[w], want_w)
        ones = np.ones((1, 3), np.float32)
        got = _port(path, ones)
        _close(got, _jax(path, ones))
        np.testing.assert_allclose(got, want_w.sum(axis=1)[None, :])

    def test_new_ops_transpose_s2d_div_resize(self, tmp_path):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4, 4, 2])
        perm = mw.add_const(np.array([0, 2, 1, 3], np.int32), "perm")
        y = mw.add_op("TRANSPOSE", [x, perm], [1, 4, 4, 2])
        y = mw.add_op("SPACE_TO_DEPTH", [y], [1, 2, 2, 8], options={"block": 2})
        two = mw.add_const(np.full((1,), 2.0, np.float32), "two")
        y = mw.add_op("DIV", [y, two], [1, 2, 2, 8])
        path = _write(tmp_path, mw, [y], "ops.tflite")
        xv = np.arange(32, dtype=np.float32).reshape(1, 4, 4, 2)
        got = _port(path, xv)
        np.testing.assert_array_equal(got, _jax(path, xv))
        t = xv.transpose(0, 2, 1, 3)
        s2d = t.reshape(1, 2, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4, 5).reshape(1, 2, 2, 8)
        np.testing.assert_allclose(got, s2d / 2.0)

    @pytest.mark.parametrize("mode", [{"half_pixel": True}, {"align_corners": True}, {}])
    def test_resize_bilinear_matches_torch(self, tmp_path, mode):
        import torch.nn.functional as F

        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4, 4, 3])
        size = mw.add_const(np.array([8, 8], np.int32), "size")
        y = mw.add_op("RESIZE_BILINEAR", [x, size], [1, 8, 8, 3], options=mode)
        path = _write(tmp_path, mw, [y], "resize.tflite")
        xv = np.random.default_rng(0).standard_normal((1, 4, 4, 3)).astype(np.float32)
        got = _port(path, xv)
        _close(got, _jax(path, xv))
        if mode.get("half_pixel"):
            # torch align_corners=False == tflite half_pixel_centers=True
            want = F.interpolate(torch.from_numpy(xv).permute(0, 3, 1, 2), size=(8, 8),
                                 mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)

    def test_mul_fused_activation_roundtrips(self, tmp_path):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4])
        c = mw.add_const(np.array([[-1, 1, -1, 1]], np.float32))
        y = mw.add_op("MUL", [x, c], [1, 4], options={"act": "relu"})
        path = _write(tmp_path, mw, [y], "mul.tflite")
        assert tflite.TFLiteGraph(open(path, "rb").read()).ops[0].attrs["act"] == 1
        xv = np.array([[2, 2, -3, -3]], np.float32)
        got = _port(path, xv)
        np.testing.assert_array_equal(got, [[0, 2, 3, 0]])
        np.testing.assert_array_equal(got, _jax(path, xv))

    def test_shared_static_and_data_constant(self, tmp_path):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([2, 2], dtype=np.int32)
        c = mw.add_const(np.array([4], np.int32), "four")
        flat = mw.add_op("RESHAPE", [x, c], [4], out_dtype=np.int32)
        y = mw.add_op("ADD", [flat, c], [4], out_dtype=np.int32)
        path = _write(tmp_path, mw, [y], "shared.tflite")
        xv = np.ones((2, 2), np.int32)
        got = _port(path, xv)
        np.testing.assert_array_equal(got, [5, 5, 5, 5])
        np.testing.assert_array_equal(got, _jax(path, xv))

    def test_unknown_option_rejected(self, tmp_path):
        path, _ = _cnn_file(tmp_path)
        for load in (lambda o: tflite.load_bundle(path, o, device="cpu"),
                     lambda o: jtflite.load_bundle(path, o)):
            with pytest.raises(ValueError, match="param_dtype"):
                load({"nope": "1"})

    def test_param_dtype_option(self, tmp_path):
        path, rng = _cnn_file(tmp_path)
        b = tflite.load_bundle(path, {"param_dtype": "bfloat16"}, device="cpu")
        floats = [t for t in b.params.values() if t.is_floating_point()]
        assert floats and all(t.dtype == torch.bfloat16 for t in floats)
        with pytest.raises(tflite.TFLiteError, match="param_dtype"):
            tflite.load_bundle(path, {"param_dtype": "complex64"}, device="cpu")

    def test_static_operands_stay_on_the_host(self, tmp_path):
        """MEAN axes / PAD widths / shape-tensor RESHAPE are host constants
        (the JAX package keeps them out of its params for jit; the port out
        of the device params, so the callable never reads the device)."""
        rng = np.random.default_rng(2)
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 4, 4, 2])
        pads = mw.add_const(np.array([[0, 0], [1, 1], [1, 1], [0, 0]], np.int32), "pads")
        y = mw.add_op("PAD", [x, pads], [1, 6, 6, 2])
        axes = mw.add_const(np.array([1, 2], np.int32), "axes")
        y = mw.add_op("MEAN", [y, axes], [1, 2])
        shp = mw.add_const(np.array([2, 1], np.int32), "shape")
        y = mw.add_op("RESHAPE", [y, shp], [2, 1])
        path = _write(tmp_path, mw, [y], "static.tflite")
        b = tflite.load_bundle(path, device="cpu")
        assert not b.params
        xv = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
        got = _port(path, xv)
        _close(got, _jax(path, xv))
        want = np.pad(xv, [(0, 0), (1, 1), (1, 1), (0, 0)]).mean(axis=(1, 2)).reshape(2, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("kind,pad", [("MAX_POOL_2D", "SAME"), ("AVERAGE_POOL_2D", "SAME"),
                                          ("MAX_POOL_2D", "VALID")])
    def test_pools_with_tflite_padding(self, tmp_path, kind, pad):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([2, 5, 6, 3])
        y = mw.add_op(kind, [x], [2, 3, 3, 3] if pad == "SAME" else [2, 2, 2, 3],
                      options={"padding": pad, "stride": (2, 2), "filter": (3, 3),
                               "act": "relu6"})
        path = _write(tmp_path, mw, [y], "pool.tflite")
        xv = np.random.default_rng(4).standard_normal((2, 5, 6, 3)).astype(np.float32) * 4
        _close(_port(path, xv), _jax(path, xv))


class TestQuantEdgeCases:
    def test_stale_scale_on_float_weight_untouched(self):
        mw = tflite_build.ModelWriter()
        x = mw.add_input([1, 2])
        wv = np.array([[1.5, -2.5], [0.5, 3.0]], np.float32)
        w = mw.add_const(wv, "fw", quant_scale=[0.1])
        y = mw.add_op("FULLY_CONNECTED", [x, w], [1, 2])
        g = tflite.TFLiteGraph(mw.finish(outputs=[y]))
        np.testing.assert_array_equal(g.constants[w], wv)


class TestFullyQuantized:
    """Fully-quantized graphs: uint8 in, uint8 out; the port's integers
    exactly the JAX package's."""

    def _files(self, tmp_path):
        rng = np.random.default_rng(7)
        wf = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.3
        bf = rng.standard_normal((8,)).astype(np.float32) * 0.1
        mf = tflite_build.ModelWriter()
        x = mf.add_input([1, 8, 8, 3])
        w = mf.add_const(wf, "w")
        b = mf.add_const(bf, "b")
        y = mf.add_op("CONV_2D", [x, w, b], [1, 4, 4, 8],
                      options={"stride": (2, 2), "padding": "SAME", "act": "relu6"})
        pf = _write(tmp_path, mf, [y], "f.tflite")
        s_in, z_in = 1.0 / 255.0, 0
        s_out, z_out = 6.0 / 255.0, 0
        sw = np.abs(wf).max(axis=(1, 2, 3)) / 127.0
        wq = np.clip(np.round(wf / sw[:, None, None, None]), -127, 127).astype(np.int8)
        bq = np.round(bf / (s_in * sw)).astype(np.int32)
        mq = tflite_build.ModelWriter()
        xq = mq.add_input([1, 8, 8, 3], dtype=np.uint8, quant_scale=[s_in],
                          quant_zero_point=[z_in])
        wqi = mq.add_const(wq, "wq", quant_scale=list(sw), quant_zero_point=[0] * 8,
                           quant_axis=0)
        bqi = mq.add_const(bq, "bq", quant_scale=list(s_in * sw),
                           quant_zero_point=[0] * 8, quant_axis=0)
        yq = mq.add_op("CONV_2D", [xq, wqi, bqi], [1, 4, 4, 8], out_dtype=np.uint8,
                       options={"stride": (2, 2), "padding": "SAME", "act": "relu6"},
                       quant_scale=[s_out], quant_zero_point=[z_out])
        pq = _write(tmp_path, mq, [yq], "q.tflite")
        return pf, pq, (s_in, z_in, s_out, z_out)

    def test_quant_graph_matches_float_within_tolerance(self, tmp_path):
        pf, pq, (s_in, z_in, s_out, z_out) = self._files(tmp_path)
        xf = np.random.default_rng(3).random((1, 8, 8, 3)).astype(np.float32)
        xu = np.clip(np.round(xf / s_in) + z_in, 0, 255).astype(np.uint8)
        yq = _port(pq, xu)
        np.testing.assert_array_equal(yq, _jax(pq, xu))
        ydq = (yq.astype(np.float32) - z_out) * s_out
        np.testing.assert_allclose(ydq, _port(pf, xf), atol=4 * s_out + 0.02)

    def test_integer_io_specs(self, tmp_path):
        _, pq, _ = self._files(tmp_path)
        b = tflite.load_bundle(pq, device="cpu")
        assert b.in_spec[0].dtype == np.uint8
        assert b.out_spec[0].dtype == np.uint8

    def test_pipeline_feeds_uint8_directly(self, tmp_path):
        _, pq, _ = self._files(tmp_path)
        x = np.random.default_rng(0).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
        outs = {}
        for pkg, acc in ((nt, ""), (ntt, CPU)):
            p = pkg.Pipeline(
                "appsrc name=src caps=other/tensors,dimensions=3:8:8:1,types=uint8 ! "
                f"tensor_filter framework=jax model={pq} name=f {acc} ! tensor_sink name=out")
            with p:
                p.push("src", x)
                outs[pkg] = np.asarray(p.pull("out", timeout=WAIT).tensors[0])
                p.eos("src")
                p.wait(timeout=WAIT)
        assert outs[ntt].dtype == np.uint8 and outs[ntt].shape == (1, 4, 4, 8)
        np.testing.assert_array_equal(outs[ntt], outs[nt])

    def test_dequantized_path_matches(self, tmp_path):
        """``int_exec:0``: integer boundary, float interior, in both."""
        _, pq, _ = self._files(tmp_path)
        x = np.random.default_rng(1).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
        got = _port(pq, x, opts={"int_exec": "0"})
        want = _jax(pq, x, opts={"int_exec": "0"})
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_zero_frame_bitwise(self, tmp_path):
        _, pq, _ = self._files(tmp_path)
        x = np.zeros((1, 8, 8, 3), np.uint8)
        got = _port(pq, x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _jax(pq, x))


def test_model_files_example_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/torch_model_files.py --cpu``: the .tflite (float and
    quantized), .onnx and .gguf halves."""
    import runpy
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(sys, "argv", ["torch_model_files.py", "--cpu"])
    runpy.run_path(os.path.join(repo, "examples", "torch_model_files.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert ".tflite            -> probs sum=1.000" in out
    assert ".tflite, quantized -> uint8 (1, 8, 8, 8)" in out
    assert ".onnx              -> max |port - torch|" in out
    assert ".gguf,quant:int4, text in" in out
