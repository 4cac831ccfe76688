"""Integer execution of fully-quantized ``.tflite`` graphs in the port,
against the JAX package, on the CPU: the counterpart of each test of
``tests/test_tflite_int.py``, and the ``int8_conv`` op's plain version.

The same file and the same seeded inputs go to both packages.  Every
integer CONV / DEPTHWISE / FC output, and every graph output, equals the
JAX package's bitwise.  The one exception is an op that requantizes
through ``_req_t`` (dequant -> f32 op -> ``round(x / scale) + zp``): XLA
fuses a jitted program's float arithmetic its own way (``x * (1 / c)``
for ``x / c`` is one such rewrite), which can move a value by 1 LSB at a
rounding boundary.  The port does not mirror that: it computes what the JAX
package's functions compute op by op, so it is bitwise equal to the JAX
bundle run eagerly, and within 1 LSB of the jitted one, where the test
also bounds how many elements differ.  On the port's integer path every
int8 conv runs through ``int8_conv`` (on the CPU its plain float64
version) and no float conv runs."""

import os
import re
import tempfile
import types

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.models import tflite as jtflite
from nnstreamer_tpu_torch.models import tflite, tflite_build
from nnstreamer_tpu_torch.ops import int8_conv as i8

CPU = "accelerator=true:cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quant_conv_file(tmp_path, *, w_dtype=np.int8, act="relu6", padding="SAME",
                     w_zp=0, name="q.tflite"):
    """tests/test_tflite_int.py's one-conv fully-quantized graph."""
    rng = np.random.default_rng(11)
    s_in, z_in = 0.5 / 127.0, 3
    s_out, z_out = 6.0 / 255.0, 0
    sw = np.asarray([0.02, 0.01, 0.03, 0.025], np.float32)
    if w_dtype == np.int8:
        wq = rng.integers(-127, 128, (4, 3, 3, 3)).astype(np.int8)
        wzp = [0] * 4
    else:
        wq = rng.integers(0, 256, (4, 3, 3, 3)).astype(np.uint8)
        wzp = [int(w_zp)] * 4
    bq = rng.integers(-2000, 2000, (4,)).astype(np.int32)
    m = tflite_build.ModelWriter()
    x = m.add_input([1, 8, 8, 3], dtype=np.uint8, quant_scale=[s_in],
                    quant_zero_point=[z_in])
    wi = m.add_const(wq, "w", quant_scale=list(sw), quant_zero_point=wzp, quant_axis=0)
    bi = m.add_const(bq, "b", quant_scale=list(s_in * sw), quant_zero_point=[0] * 4,
                     quant_axis=0)
    y = m.add_op("CONV_2D", [x, wi, bi], [1, 4, 4, 4], out_dtype=np.uint8,
                 options={"stride": (2, 2), "padding": padding, "act": act},
                 quant_scale=[s_out], quant_zero_point=[z_out])
    path = os.path.join(str(tmp_path), name)
    open(path, "wb").write(m.finish(outputs=[y]))
    return path, dict(s_in=s_in, z_in=z_in, s_out=s_out, z_out=z_out, sw=sw, wq=wq,
                      wzp=np.asarray(wzp), bq=bq)


def _oracle_conv(x_u8, p, padding="SAME"):
    """Float conv over exactly dequantized operands, requantized (the
    JAX test's numpy oracle)."""
    xf = (x_u8.astype(np.float64) - p["z_in"]) * p["s_in"]
    wf = ((p["wq"].astype(np.float64) - p["wzp"][:, None, None, None])
          * p["sw"][:, None, None, None].astype(np.float64))
    bf = p["bq"].astype(np.float64) * (p["s_in"] * p["sw"])
    B, H, W, C = xf.shape
    O, kh, kw, _ = wf.shape
    if padding == "SAME":
        oh, ow = -(-H // 2), -(-W // 2)
        th, tw = max(0, (oh - 1) * 2 + kh - H), max(0, (ow - 1) * 2 + kw - W)
        xf = np.pad(xf, ((0, 0), (th // 2, th - th // 2), (tw // 2, tw - tw // 2), (0, 0)))
    else:
        oh, ow = (H - kh) // 2 + 1, (W - kw) // 2 + 1
    y = np.zeros((B, oh, ow, O))
    for i in range(oh):
        for j in range(ow):
            win = xf[:, i * 2:i * 2 + kh, j * 2:j * 2 + kw, :]
            y[:, i, j, :] = np.einsum("bhwc,ohwc->bo", win, wf)
    y = np.clip(y + bf, 0, 6)
    return np.clip(np.round(y / p["s_out"]) + p["z_out"], 0, 255).astype(np.uint8)


def _both(path, x, opts=None, jit=True):
    jb = jtflite.load_bundle(path, opts)
    fn = jax.jit(jb.apply_fn) if jit else jb.apply_fn
    want = np.asarray(fn(jb.params, x))
    b = tflite.load_bundle(path, opts, device="cpu")
    got = b.apply_fn(b.params, torch.from_numpy(np.array(x))).numpy()
    return got, want


class _Census:
    """Counts the calls of ``int8_conv``'s plain version (and holds each
    one's operands to what the card kernel takes: contiguous int8) and of
    float convolutions outside it."""

    def __init__(self, monkeypatch):
        self.int8, self.float_convs = [], 0
        self._inside = False
        ref, conv = i8.int8_conv_reference, F.conv2d

        def counted_ref(x, w, *a, **k):
            assert x.dtype == w.dtype == torch.int8
            assert x.is_contiguous() and w.is_contiguous()
            self.int8.append((tuple(x.shape), tuple(w.shape)))
            self._inside = True
            try:
                return ref(x, w, *a, **k)
            finally:
                self._inside = False

        def counted_conv(*a, **k):
            if not self._inside:
                self.float_convs += 1
            return conv(*a, **k)

        monkeypatch.setattr(i8, "int8_conv_reference", counted_ref)
        monkeypatch.setattr(F, "conv2d", counted_conv)


class TestIntegerConv:
    @pytest.mark.parametrize("w_dtype,w_zp", [(np.int8, 0), (np.uint8, 131)])
    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    def test_matches_numpy_oracle(self, tmp_path, w_dtype, w_zp, padding):
        path, p = _quant_conv_file(tmp_path, w_dtype=w_dtype, w_zp=w_zp, padding=padding)
        x = np.random.default_rng(5).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
        got, want = _both(path, x)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        diff = np.abs(got.astype(int) - _oracle_conv(x, p, padding).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05

    def test_interior_goes_through_int8_conv(self, tmp_path, monkeypatch):
        """The counterpart of ``test_interior_is_int8_on_the_mxu``: the
        conv's sums go through ``int8_conv`` (its plain version here) as
        int8 x int8, the box sum of a nonzero weight zero point too, and
        no float conv runs."""
        census = _Census(monkeypatch)
        path, _ = _quant_conv_file(tmp_path)
        b = tflite.load_bundle(path, device="cpu")
        b.apply_fn(b.params, torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
        assert census.int8 == [((1, 9, 9, 3), (4, 3, 3, 3))]
        assert census.float_convs == 0
        path, _ = _quant_conv_file(tmp_path, w_dtype=np.uint8, w_zp=131, name="zp.tflite")
        b = tflite.load_bundle(path, device="cpu")
        b.apply_fn(b.params, torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
        assert census.int8[1:] == [((1, 9, 9, 3), (4, 3, 3, 3)), ((1, 9, 9, 3), (1, 3, 3, 3))]
        assert census.float_convs == 0

    def test_int_exec_opt_out_restores_dequantized_path(self, tmp_path, monkeypatch):
        census = _Census(monkeypatch)
        path, p = _quant_conv_file(tmp_path)
        x = np.random.default_rng(5).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
        got, want = _both(path, x, {"int_exec": "0"})
        assert not census.int8 and census.float_convs == 1
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(got.astype(int) - _oracle_conv(x, p).astype(int)).max() <= 1


class TestIntegerDepthwiseFC:
    def test_depthwise_and_fc_chain(self, tmp_path, monkeypatch):
        rng = np.random.default_rng(9)
        s_in, z_in = 1.0 / 255.0, 128
        s_mid, z_mid = 0.02, 7
        s_out, z_out = 0.05, 11
        dwq = rng.integers(-127, 128, (1, 3, 3, 3)).astype(np.int8)
        s_dw = np.asarray([0.01, 0.02, 0.015], np.float32)
        dwb = rng.integers(-500, 500, (3,)).astype(np.int32)
        fcq = rng.integers(-127, 128, (4, 27)).astype(np.int8)
        s_fc = np.asarray([0.03], np.float32)
        fcb = rng.integers(-500, 500, (4,)).astype(np.int32)
        m = tflite_build.ModelWriter()
        x = m.add_input([1, 6, 6, 3], dtype=np.uint8, quant_scale=[s_in],
                        quant_zero_point=[z_in])
        dwi = m.add_const(dwq, "dw", quant_scale=list(s_dw), quant_zero_point=[0] * 3,
                          quant_axis=3)
        dbi = m.add_const(dwb, "dwb", quant_scale=list(s_in * s_dw),
                          quant_zero_point=[0] * 3, quant_axis=0)
        h = m.add_op("DEPTHWISE_CONV_2D", [x, dwi, dbi], [1, 3, 3, 3], out_dtype=np.uint8,
                     options={"stride": (2, 2), "padding": "SAME", "act": None},
                     quant_scale=[s_mid], quant_zero_point=[z_mid])
        r = m.add_op("RESHAPE", [h], [1, 27], out_dtype=np.uint8,
                     options={"new_shape": [1, 27]}, quant_scale=[s_mid],
                     quant_zero_point=[z_mid])
        fci = m.add_const(fcq, "fc", quant_scale=list(s_fc), quant_zero_point=[0])
        fbi = m.add_const(fcb, "fcb", quant_scale=[float(s_mid * s_fc[0])],
                          quant_zero_point=[0])
        y = m.add_op("FULLY_CONNECTED", [r, fci, fbi], [1, 4], out_dtype=np.uint8,
                     options={"act": None}, quant_scale=[s_out], quant_zero_point=[z_out])
        path = os.path.join(str(tmp_path), "dwfc.tflite")
        open(path, "wb").write(m.finish(outputs=[y]))
        census = _Census(monkeypatch)
        xv = rng.integers(0, 256, (1, 6, 6, 3), dtype=np.uint8)
        got, want = _both(path, xv)
        assert got.dtype == np.uint8 and got.shape == (1, 4)
        np.testing.assert_array_equal(got, want)
        # both integer ops through int8_conv: the depthwise (groups = 3)
        # and the FC as a 1x1 conv over [B, 1, 1, K]
        assert census.int8 == [((1, 7, 7, 3), (3, 3, 3, 1)), ((1, 1, 1, 27), (4, 1, 1, 27))]
        assert census.float_convs == 0


def test_quantized_pipeline_still_uint8(tmp_path):
    path, _ = _quant_conv_file(tmp_path, name="p.tflite")
    x = np.random.default_rng(0).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    outs = {}
    for pkg, acc in ((nt, ""), (ntt, CPU)):
        p = pkg.Pipeline(
            "appsrc name=src caps=other/tensors,dimensions=3:8:8:1,types=uint8 ! "
            f"tensor_filter framework=jax model={path} name=f {acc} ! tensor_sink name=out")
        with p:
            p.push("src", x)
            outs[pkg] = np.asarray(p.pull("out", timeout=120).tensors[0])
            p.eos("src")
            p.wait(timeout=30)
    assert outs[ntt].dtype == np.uint8 and outs[ntt].shape == (1, 4, 4, 4)
    np.testing.assert_array_equal(outs[ntt], outs[nt])


def _mobilenet(size, classes, batch):
    import chip_smoke

    return chip_smoke.mobilenet_tflite(size, classes, batch, quantized=True)


class TestMobileNetFile:
    """BASELINE's config #1 file (bench.py's quantized MobileNet-v1) at a
    small edge: the same bytes from the port's writer, the same integers
    from both packages."""

    def test_bytes_equal_bench_file(self, tmp_path, monkeypatch):
        import bench

        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        path = bench._quant_mobilenet_file(32, classes=11, batch=2)
        assert open(path, "rb").read() == _mobilenet(32, 11, 2)

    @pytest.mark.parametrize("size", [32, 64])
    def test_every_op_bitwise(self, tmp_path, size):
        import chip_smoke

        path = os.path.join(str(tmp_path), "mnq.tflite")
        open(path, "wb").write(_mobilenet(size, 11, 2))
        x = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
        taps, got = chip_smoke.int_taps(tflite.load_bundle(path, device="cpu"),
                                        torch.from_numpy(x))
        jb = jtflite.load_bundle(path)
        jtaps, run = [], jtflite._run_op_int

        def tap(*a, **k):
            y = run(*a, **k)
            jtaps.append(np.asarray(y))
            return y

        jtflite._run_op_int = tap
        try:
            want = np.asarray(jb.apply_fn(jb.params, x))
        finally:
            jtflite._run_op_int = run
        assert len(taps) == len(jtaps) == 29
        for t, j in zip(taps, jtaps):
            np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.jit(jb.apply_fn)(jb.params, x)))


def test_requantizing_ops_within_one_lsb_of_jit(tmp_path):
    """AVERAGE_POOL, ADD, LOGISTIC, MEAN and SOFTMAX on uint8 through the
    fallback (dequant -> f32 -> ``_req_t``): bitwise the JAX package run
    op by op; within 1 LSB of its jitted program on at most 1% of the
    outputs (measured: 5 of 2,560 over these 20 seeds)."""
    m = tflite_build.ModelWriter()
    x = m.add_input([8, 6, 6, 16], dtype=np.uint8, quant_scale=[0.05],
                    quant_zero_point=[128])
    y = m.add_op("AVERAGE_POOL_2D", [x], [8, 3, 3, 16], out_dtype=np.uint8,
                 options={"padding": "VALID", "stride": (2, 2), "filter": (2, 2)},
                 quant_scale=[0.05], quant_zero_point=[128])
    c = m.add_const(np.random.default_rng(1).integers(0, 256, (1, 1, 1, 16)).astype(np.uint8),
                    "c", quant_scale=[0.03], quant_zero_point=[120])
    y = m.add_op("ADD", [y, c], [8, 3, 3, 16], out_dtype=np.uint8, quant_scale=[0.07],
                 quant_zero_point=[100])
    y = m.add_op("LOGISTIC", [y], [8, 3, 3, 16], out_dtype=np.uint8,
                 quant_scale=[1 / 256], quant_zero_point=[0])
    axes = m.add_const(np.array([1, 2], np.int32), "axes")
    y = m.add_op("MEAN", [y, axes], [8, 16], out_dtype=np.uint8,
                 options={"keep_dims": False}, quant_scale=[1 / 256], quant_zero_point=[0])
    y = m.add_op("SOFTMAX", [y], [8, 16], out_dtype=np.uint8, quant_scale=[1 / 256],
                 quant_zero_point=[0])
    path = os.path.join(str(tmp_path), "req.tflite")
    open(path, "wb").write(m.finish(outputs=[y]))
    differ = total = 0
    for seed in range(20):
        xv = np.random.default_rng(seed).integers(0, 256, (8, 6, 6, 16), dtype=np.uint8)
        got, want = _both(path, xv)
        eager = _both(path, xv, jit=False)[1]
        np.testing.assert_array_equal(got, eager)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1
        differ += int((d > 0).sum())
        total += d.size
    assert differ <= total // 100, f"{differ} of {total} outputs 1 LSB off the jitted program"


def test_non_constant_weight_names_the_tensor(tmp_path):
    """The port guards the integer path's weight read: a CONV_2D whose
    weight is not a constant of the file raises a TFLiteError naming the
    tensor (the JAX package reads ``g.raw_constants[wi]`` unguarded and
    raises a bare KeyError)."""
    m = tflite_build.ModelWriter()
    x = m.add_input([1, 4, 4, 4], dtype=np.uint8, quant_scale=[0.1],
                    quant_zero_point=[128], name="x")
    w = m.add_input([2, 1, 1, 4], dtype=np.int8, quant_scale=[0.02],
                    quant_zero_point=[0], name="computed_w")
    y = m.add_op("CONV_2D", [x, w], [1, 4, 4, 2], out_dtype=np.uint8,
                 options={"padding": "VALID"}, quant_scale=[0.1], quant_zero_point=[128])
    path = os.path.join(str(tmp_path), "w_in.tflite")
    open(path, "wb").write(m.finish(outputs=[y]))
    with pytest.raises(tflite.TFLiteError, match="computed_w"):
        tflite.load_bundle(path, device="cpu")
    jb = jtflite.load_bundle(path)
    with pytest.raises(KeyError):
        jb.apply_fn(jb.params, np.zeros((1, 4, 4, 4), np.uint8),
                    np.zeros((2, 1, 1, 4), np.int8))


class TestInt8ConvPlain:
    """``int8_conv``'s plain version (the CPU path and the card kernel's
    yardstick) against XLA's integer convolution and numpy, exactly."""

    @pytest.mark.parametrize("B,H,W,cin,O,k,stride,dil,groups", [
        (2, 9, 9, 3, 8, 3, 2, 1, 1),        # the first conv's form
        (2, 7, 8, 8, 8, 3, 1, 1, 8),        # depthwise
        (1, 7, 7, 4, 8, 3, 1, 2, 4),        # depthwise, multiplier 2, dilated
        (3, 1, 1, 40, 17, 1, 1, 1, 1),      # an FC as a 1x1 conv
        (2, 6, 6, 16, 12, 1, 1, 1, 1),      # pointwise
        (1, 8, 6, 12, 6, 3, 2, 1, 3),       # grouped
    ])
    def test_against_xla(self, B, H, W, cin, O, k, stride, dil, groups):
        rng = np.random.default_rng(B * 100 + H + cin)
        x = rng.integers(-128, 128, (B, H, W, cin)).astype(np.int8)
        w = rng.integers(-128, 128, (O, k, k, cin // groups)).astype(np.int8)
        got = i8.int8_conv(torch.from_numpy(x), torch.from_numpy(w), stride, dil, groups)
        want = lax.conv_general_dilated(
            x, w.transpose(1, 2, 3, 0), window_strides=(stride, stride), padding="VALID",
            rhs_dilation=(dil, dil), feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=np.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_exact_past_two_to_the_24(self):
        """A 3x3 conv over 512 channels at the extremes sums to -74.9e6:
        float32 could not hold it, the float64 plain version does."""
        x = torch.full((1, 3, 3, 512), -128, dtype=torch.int8)
        w = torch.full((2, 3, 3, 512), 127, dtype=torch.int8)
        w[1, 0, 0, 0] = 126
        got = i8.int8_conv(x, w)
        want = np.einsum("bhwc,ohwc->bo", x.numpy().astype(np.int64),
                         w.numpy().astype(np.int64))
        assert abs(int(want.min())) > 2 ** 24
        np.testing.assert_array_equal(got.numpy().reshape(1, 2), want)

    def test_routes_and_refusals(self):
        assert i8.int8_conv_kernel(32, 64, 1, 1, 1) == "gemm"
        assert i8.int8_conv_kernel(3, 96, 1, 3, 3, 2) == "direct"
        assert i8.int8_conv_kernel(32, 32, 32, 3, 3) == "depthwise"
        x = torch.zeros((1, 4, 4, 4), dtype=torch.int8)
        with pytest.raises(ValueError, match="int8"):
            i8.int8_conv(x.float(), torch.zeros((2, 1, 1, 4), dtype=torch.int8))
        with pytest.raises(ValueError, match="groups"):
            i8.int8_conv(x, torch.zeros((2, 1, 1, 3), dtype=torch.int8))
        with pytest.raises(ValueError, match="window"):
            i8.int8_conv(x, torch.zeros((2, 5, 5, 4), dtype=torch.int8))
        # meta tensors (abstract execution) give the CPU route's shape and
        # dtype, no data, no launch
        w1 = torch.zeros((2, 1, 1, 4), dtype=torch.int8)
        got = i8.int8_conv(x.to("meta"), w1.to("meta"))
        want = i8.int8_conv(x, w1)
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)

    def test_c_signature_matches_the_binding(self):
        """The ctypes binding declares one argument per parameter of every
        launching C entry in csrc/int8_conv.cu (checked here: no compiler
        on the CPU).  There is one: ``int8_conv``'s int32 sums and
        ``int8_conv_requant`` both launch through it."""
        src = open(os.path.join(REPO, "nnstreamer_tpu_torch", "csrc", "int8_conv.cu")).read()
        entries = dict(re.findall(r'extern "C" int (nns_\w+)\(([^)]*)\)', src))
        assert list(entries) == ["nns_int8_conv_requant"]
        lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in entries})
        i8._declare(lib)
        for name, params in entries.items():
            kinds = ["p" if "*" in a else "i" for a in params.split(",")]
            declared = ["p" if t is __import__("ctypes").c_void_p else "i"
                        for t in getattr(lib, name).argtypes]
            assert declared == kinds, name


def test_modelfiles_phase_rehearsal(tmp_path):
    """chip_smoke.py's ``modelfiles`` phase on the CPU at a tiny size: the
    files, the pipelines (one fused stage each), the bitwise and
    tolerance checks and the ONNX export all run as on the card."""
    import chip_smoke

    mf = chip_smoke.phase_modelfiles(
        torch.device("cpu"), size=32, batch=2, classes=11, acc=CPU, timed=2, checked=2,
        onnx_batch=2, onnx_batches=1, kernel_rows=False, files_dir=str(tmp_path))
    assert mf["quant_check"]["differ"] == mf["quant_check"]["op_outputs_differ"] == 0
    assert mf["quant"]["census"]["captures_after_warmup"] == 0
    assert mf["zero_point_case"]["differ"] == 0
    assert mf["float"]["cpu_check"]["max_err_share"] <= chip_smoke.MF_FLOAT_TOL
    assert mf["onnx"]["max_err_share"] <= chip_smoke.MF_ONNX_TOL
    assert not os.path.exists(tmp_path / "modelfiles")
