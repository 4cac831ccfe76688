"""The fused integer conv layer of the port (``ops/int8_conv.py``
``int8_conv_requant``: one launch from an activation's bytes to the next
activation's on the card) against the JAX package, on the CPU, where the
entry takes its plain version.

One-op fully-quantized files, written with ``tflite_build``, go through
the JAX package's integer execution (``_run_op_int``, run eagerly) and the
port's; every output must be equal, bitwise, over CONV_2D,
DEPTHWISE_CONV_2D (multiplier 1 and 2) and FULLY_CONNECTED, SAME and
VALID padding, stride 1 and 2, uint8 and int8 activations, a weight zero
point of 0 and not 0, and the three fused activations.  The constants
folded at open (``cb`` = correction + bias) are held against the unfolded
int32 sum, wrapping included; the C entry's binding against its
signature; the kernel each shape takes and what the entry refuses."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import tflite as jtflite
from nnstreamer_tpu_torch.models import tflite, tflite_build
from nnstreamer_tpu_torch.ops import int8_conv as i8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, CIN = 2, 7, 6, 8


def _one_op_file(tmp_path, kind, padding, stride, dtype, wz, act, mult=1, seed=0):
    """A file of one integer ``kind`` op over a [B, H, W, CIN] activation of
    ``dtype``: int8 weights with zero point 0 (``wz`` False) or uint8
    weights with per-channel zero points in 100..155, int32 biases, and an
    output scale that spreads the outputs over their range."""
    rng = np.random.default_rng(seed)
    zp_in = 131 if dtype == np.uint8 else -5
    s_in = 0.003 if act == "relu6" else 0.03  # relu6: most real outputs within +-6
    if kind == "FULLY_CONNECTED":
        in_shape, K = [B, H * W * CIN], H * W * CIN
        O, w_shape, axis = 24, (24, H * W * CIN), 0
    elif kind == "DEPTHWISE_CONV_2D":
        in_shape, K = [B, H, W, CIN], 9
        O, w_shape, axis = CIN * mult, (1, 3, 3, CIN * mult), 3
    else:
        in_shape, K = [B, H, W, CIN], 9 * CIN
        O, w_shape, axis = 16, (16, 3, 3, CIN), 0
    sw = rng.uniform(0.005, 0.02, O).astype(np.float32)
    if wz:
        wq = rng.integers(0, 256, w_shape).astype(np.uint8)
        wzp = [int(z) for z in rng.integers(100, 156, O)]
    else:
        wq = rng.integers(-127, 128, w_shape).astype(np.int8)
        wzp = [0] * O
    bq = rng.integers(-3000, 3000, (O,)).astype(np.int32)
    zp_out = 120 if dtype == np.uint8 else 3
    # six standard deviations of the real-valued sum across the output range
    s_out = float(s_in * 74 * 0.0125 * 74 * np.sqrt(K) * 6 / 255)
    if act == "relu6":  # at least 100 steps below 6.0
        s_out = min(s_out, 0.06)
    m = tflite_build.ModelWriter()
    x = m.add_input(in_shape, dtype=dtype, quant_scale=[s_in], quant_zero_point=[zp_in])
    wi = m.add_const(wq, "w", quant_scale=list(sw), quant_zero_point=wzp, quant_axis=axis)
    bi = m.add_const(bq, "b", quant_scale=list(s_in * sw), quant_zero_point=[0] * O,
                     quant_axis=0)
    if kind == "FULLY_CONNECTED":
        out_shape, opts = [B, O], {"act": act}
    else:
        oh = -(-H // stride) if padding == "SAME" else (H - 3) // stride + 1
        ow = -(-W // stride) if padding == "SAME" else (W - 3) // stride + 1
        out_shape = [B, oh, ow, O]
        opts = {"padding": padding, "stride": (stride, stride), "act": act}
        if kind == "DEPTHWISE_CONV_2D":
            opts["multiplier"] = mult
    y = m.add_op(kind, [x, wi, bi], out_shape, out_dtype=dtype, options=opts,
                 quant_scale=[s_out], quant_zero_point=[zp_out])
    path = os.path.join(str(tmp_path), "one_op.tflite")
    with open(path, "wb") as fh:
        fh.write(m.finish(outputs=[y]))
    if dtype == np.uint8:
        xv = rng.integers(0, 256, in_shape, dtype=np.uint8)
    else:
        xv = rng.integers(-128, 128, in_shape).astype(np.int8)
    return path, xv


def _both(path, x):
    jb = jtflite.load_bundle(path)
    want = np.asarray(jb.apply_fn(jb.params, x))  # eager: _run_op_int op by op
    b = tflite.load_bundle(path, device="cpu")
    got = b.apply_fn(b.params, torch.from_numpy(np.array(x))).numpy()
    return got, want


_CONV_CASES = [(k, m, pad, s) for k, m in (("CONV_2D", 1), ("DEPTHWISE_CONV_2D", 1),
                                           ("DEPTHWISE_CONV_2D", 2))
               for pad in ("SAME", "VALID") for s in (1, 2)]


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("wz", [False, True], ids=["wz0", "wz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8], ids=["uint8", "int8"])
@pytest.mark.parametrize("kind,mult,padding,stride", _CONV_CASES,
                         ids=[f"{k[:4]}x{m}-{p}-s{s}" for k, m, p, s in _CONV_CASES])
def test_conv_layer_equals_jax(tmp_path, kind, mult, padding, stride, dtype, wz, act):
    path, x = _one_op_file(tmp_path, kind, padding, stride, dtype, wz, act, mult)
    got, want = _both(path, x)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 8, "the outputs should spread over the range"


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("wz", [False, True], ids=["wz0", "wz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8], ids=["uint8", "int8"])
def test_fully_connected_equals_jax(tmp_path, dtype, wz, act):
    path, x = _one_op_file(tmp_path, "FULLY_CONNECTED", None, 1, dtype, wz, act)
    got, want = _both(path, x)
    assert got.dtype == dtype and got.shape == (B, 24)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 8


def test_one_fused_call_a_layer(tmp_path, monkeypatch):
    """On the port's integer path each conv layer is one call of the fused
    entry, no int32 sum comes back to the graph, and the weight zero
    point's box sum stays inside that call."""
    calls = []
    fused = i8.int8_conv_requant

    def counted(x, w, *a, **k):
        calls.append((x.dtype, tuple(w.shape)))
        return fused(x, w, *a, **k)

    monkeypatch.setattr(i8, "int8_conv_requant", counted)
    path, x = _one_op_file(tmp_path, "DEPTHWISE_CONV_2D", "SAME", 2, np.uint8, True, "relu6", 2)
    b = tflite.load_bundle(path, device="cpu")
    y = b.apply_fn(b.params, torch.from_numpy(x))
    assert calls == [(torch.uint8, (CIN * 2, 3, 3, 1))] and y.dtype == torch.uint8


class TestFoldAtOpen:
    def test_fold_wraps_as_int32(self):
        corr = np.asarray([2**31 - 1, -2**31, 5, -7, 1 << 30], np.int32)
        bias = np.asarray([1, -1, -5, 2**31 - 1, 1 << 30], np.int32)
        cb = tflite.fold_cb(corr, bias)
        assert cb.dtype == np.int32
        want = [(int(c) + int(b) + 2**31) % 2**32 - 2**31 for c, b in zip(corr, bias)]
        assert cb.tolist() == want
        assert cb[0] == -2**31 and cb[1] == 2**31 - 1  # both ends wrapped
        np.testing.assert_array_equal(tflite.fold_cb(corr, None), corr)

    def test_cb_is_the_jax_packages_corr_plus_bias(self, tmp_path):
        """``cb`` made at open equals the JAX package's correction
        (``-xz8 * sum(w8) + K * xz8 * wz8``) plus the file's bias, in
        int32, for uint8 weights with zero points."""
        path, _ = _one_op_file(tmp_path, "CONV_2D", "SAME", 1, np.uint8, True, None)
        g = tflite.TFLiteGraph(open(path, "rb").read())
        [op] = g.ops
        prep = tflite._prepare_conv(op, g, path, "cpu")
        w_raw = g.raw_constants[op.inputs[1]]
        _, wz, _ = g.quant[op.inputs[1]]
        xz8 = int(g.quant[op.inputs[0]][1][0]) - 128
        w8 = w_raw.astype(np.int32) - 128
        wz8 = wz.astype(np.int32) - 128
        corr = (-xz8 * w8.sum(axis=(1, 2, 3)).astype(np.int64)
                + w8[0].size * xz8 * wz8).astype(np.int32)
        bias = g.raw_constants[op.inputs[2]].astype(np.int32)
        np.testing.assert_array_equal(prep["cb"].numpy(), (corr + bias).astype(np.int32))
        np.testing.assert_array_equal(prep["wz"].numpy(), wz8)

    def test_wrapping_sum_equals_jax(self, tmp_path):
        """A bias near 2^31 makes corr + bias wrap: the port's output still
        equals the JAX package's, whose int32 adds wrap the same way."""
        rng = np.random.default_rng(4)
        m = tflite_build.ModelWriter()
        x = m.add_input([1, 4, 4, 8], dtype=np.uint8, quant_scale=[0.02], quant_zero_point=[0])
        wq = rng.integers(1, 128, (4, 1, 1, 8)).astype(np.int8)  # sum(w8) > 0: corr > 0
        wi = m.add_const(wq, "w", quant_scale=[0.01] * 4, quant_zero_point=[0] * 4,
                         quant_axis=0)
        bq = np.asarray([2**31 - 10, 2**31 - 1, -2**31, 7], np.int32)
        bi = m.add_const(bq, "b", quant_scale=[0.0002] * 4, quant_zero_point=[0] * 4,
                         quant_axis=0)
        y = m.add_op("CONV_2D", [x, wi, bi], [1, 4, 4, 4], out_dtype=np.uint8,
                     options={"padding": "SAME", "act": None}, quant_scale=[1e6],
                     quant_zero_point=[128])
        path = os.path.join(str(tmp_path), "wrap.tflite")
        with open(path, "wb") as fh:
            fh.write(m.finish(outputs=[y]))
        xv = rng.integers(0, 256, (1, 4, 4, 8), dtype=np.uint8)
        got, want = _both(path, xv)
        np.testing.assert_array_equal(got, want)
        g = tflite.TFLiteGraph(open(path, "rb").read())
        cb = tflite._prepare_conv(g.ops[0], g, path, "cpu")["cb"].numpy()
        assert cb[0] < 0 and cb[1] < 0  # past 2^31 - 1: wrapped


class TestFusedEntry:
    def test_c_signature_matches_the_binding(self):
        """The ctypes binding declares one argument per parameter of the
        fused C entry in csrc/int8_conv.cu (checked here: no compiler on
        the CPU)."""
        src = open(os.path.join(REPO, "nnstreamer_tpu_torch", "csrc", "int8_conv.cu")).read()
        params = re.search(r'extern "C" int nns_int8_conv_requant\(([^)]*)\)', src).group(1)
        kinds = ["p" if "*" in a else "i" for a in params.split(",")]

        class Fn:
            pass

        class Lib:
            nns_int8_conv_requant = Fn()

        i8._declare(Lib)
        declared = ["p" if t is ctypes.c_void_p else "i"
                    for t in Lib.nns_int8_conv_requant.argtypes]
        assert declared == kinds and len(kinds) == 31
        assert Lib.nns_int8_conv_requant.restype is ctypes.c_int

    @pytest.mark.parametrize("cin,out,groups,k,stride,dilation,want", [
        (3, 32, 1, 3, 2, 1, "dense"),        # MobileNet's first conv
        (32, 32, 32, 3, 1, 1, "depthwise"),  # its depthwise layers
        (64, 64, 64, 3, 2, 1, "depthwise"),
        (32, 64, 1, 1, 1, 1, "gemm"),        # its pointwise layers
        (1024, 1001, 1, 1, 1, 1, "gemm"),    # its FC
        (512, 512, 1, 3, 1, 1, "gemm"),      # a 3x3 conv over 16-byte runs
        (24, 144, 1, 1, 1, 1, "gemm"),       # channels in fours: 4-byte copies
        (24, 48, 1, 3, 2, 1, "gemm"),
        (4, 32, 1, 3, 2, 1, "dense"),        # few channels: the dense kernel first
        (12, 24, 12, 3, 2, 1, "direct"),     # a depthwise multiplier of 2
        (30, 30, 30, 3, 1, 1, "direct"),     # channels not in fours
        (32, 32, 32, 3, 3, 1, "direct"),     # a column stride of 3
        (32, 32, 32, 3, 1, 2, "direct"),     # dilated
        (3, 96, 1, 3, 2, 1, "direct"),       # more outputs than the dense kernel holds
        (4, 16, 1, 5, 1, 1, "gemm"),         # five rows: not the dense kernel's
        (8, 8, 1, 1, 1, 1, "gemm"),          # channels in fours, not sixteens
        (6, 8, 1, 1, 1, 1, "direct"),        # channels not in fours
        (12, 24, 3, 3, 1, 1, "direct"),      # grouped
    ])
    def test_kernel_by_shape(self, cin, out, groups, k, stride, dilation, want):
        assert i8.int8_conv_kernel(cin, out, groups, k, k, stride, dilation) == want

    def test_refusals(self):
        x = torch.zeros((1, 4, 4, 8), dtype=torch.uint8)
        w = torch.zeros((4, 1, 1, 8), dtype=torch.int8)
        cb, mult = torch.zeros(4, dtype=torch.int32), torch.ones(4)
        with pytest.raises(ValueError, match="uint8 or int8 x"):
            i8.int8_conv_requant(x.float(), w, cb, mult)
        with pytest.raises(ValueError, match="no torch.int32 output"):
            i8.int8_conv_requant(x, w, cb, mult, out_dtype=torch.int32)
        with pytest.raises(ValueError, match="cb"):
            i8.int8_conv_requant(x, w, cb[:3], mult)
        with pytest.raises(ValueError, match="cb"):
            i8.int8_conv_requant(x, w, cb, mult.double())
        with pytest.raises(ValueError, match="ones weight"):
            i8.int8_conv_requant(x, w, cb, mult, wz=cb)
        with pytest.raises(ValueError, match="not int8"):
            i8.int8_conv_requant(x, w, cb, mult, pad8=128)
        with pytest.raises(ValueError, match="groups"):
            i8.int8_conv_requant(x, torch.zeros((4, 1, 1, 3), dtype=torch.int8), cb, mult)
        with pytest.raises(ValueError, match="pads"):
            i8.int8_conv_requant(x, torch.zeros((4, 5, 5, 8), dtype=torch.int8), cb, mult)
        # meta tensors (abstract execution) give the CPU route's shape and
        # dtype, no data, no launch
        meta = [t.to("meta") for t in (x, w, cb, mult)]
        before = i8.LAUNCHES.value
        got = i8.int8_conv_requant(*meta)
        want = i8.int8_conv_requant(x, w, cb, mult)
        assert got.device.type == "meta" and i8.LAUNCHES.value == before
        assert (got.shape, got.dtype) == (want.shape, want.dtype)

    def test_plain_version_is_the_int32_route_requantized(self):
        """The plain version's sums are ``int8_conv_reference`` over the
        shifted, padded input; its f32 step is the JAX package's
        ``round(f32(v) * mult) + zp`` clamped, half to even."""
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.integers(0, 256, (2, 5, 6, 8), dtype=np.uint8))
        w = torch.from_numpy(rng.integers(-127, 128, (8, 3, 3, 1)).astype(np.int8))
        cb = torch.from_numpy(rng.integers(-500, 500, 8).astype(np.int32))
        mult = torch.from_numpy(rng.uniform(0.01, 0.05, 8).astype(np.float32))
        pads = ((1, 1), (1, 1))
        got = i8.int8_conv_requant(x, w, cb, mult, 1, 1, 8, pads, -27, 100, 0, 255,
                                   torch.uint8)
        x8 = torch.nn.functional.pad((x ^ 128).view(torch.int8), (0, 0, 1, 1, 1, 1), value=-27)
        acc = i8.int8_conv(x8.contiguous(), w, 1, 1, 8) + cb
        want = np.clip(np.round(acc.numpy().astype(np.float32) * mult.numpy()) + 100, 0, 255)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))

    def test_edge_cases_rehearsal(self):
        """chip_smoke.py's edge cases (ragged M and N, a 3x3 and a strided
        1x1 GEMM, the GEMM's 4-byte copies over 12 and 24 channels, a
        depthwise multiplier, the dense kernel on int8, a 1001-wide FC) run
        on the CPU as they do on the card, each on the kernel it names."""
        import chip_smoke

        cases = chip_smoke.int8_edge_cases(torch.device("cpu"))
        assert [k for _, k, _ in cases] == ["gemm"] * 5 + ["direct", "dense", "gemm"]
        assert all(n > 0 for _, _, n in cases)
