"""``.onnx`` model-file ingestion: protobuf wire parse -> a torch
``ModelBundle`` on the filter's device.

Port of ``nnstreamer_tpu/models/onnx.py``.  The file is parsed with the
JAX package's hand-rolled protobuf *wire-format* reader (varints and
length-delimited fields; no protoc, no ``onnx`` package, which the card
machine lacks too), copied; the node list then walks as torch ops over
the file's real weights, which go to the device at open.  ``tensor_filter
framework=jax model=/m.onnx`` runs it on the card unless the filter says
``accelerator=true:cpu``, captured with the rest of its fused stage.

Layout: ONNX's NCHW at the bundle's edges and through every op, as in the
JAX package.  Inside, each Conv's 4-D weight is made ``channels_last`` at
open and its input is given ``channels_last`` memory, so cuDNN runs its
NHWC kernels; a conv's output stays ``channels_last`` through the
elementwise ops that follow, so only the first conv of a chain copies.

Constants never move inside the callable: the shape and constant
arithmetic the JAX package evaluates on concrete values (``_host_run``)
is folded once, at open, where its inputs are constants of the file; the
chains that start from a ``Shape`` node run in numpy from the tensors'
shapes (host metadata, no read of the card).  A folded value that a
device op reads as data is copied to the device once: at open, or, for a
shape-derived value, at the first call of its input signature (a fused
stage's eager warm-up, before its capture).  A Gather with indices on
the device stays there.

Op set: Conv, Gemm, MatMul, Relu, Sigmoid, Tanh, Clip, Softmax, MaxPool,
AveragePool, GlobalAveragePool, BatchNormalization, Add, Sub, Mul, Div,
Concat, Reshape, Flatten, Transpose, Pad, ReduceMean, Squeeze, Unsqueeze,
Constant, Identity, Cast, ConstantOfShape, Slice (positive steps on
device tensors), Erf, Sqrt, Exp, Neg, Pow, LeakyRelu, Max, Min, Shape,
Gather, Split, Resize.
"""

from __future__ import annotations

import functools
import operator
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import TensorSpec, TensorsSpec
from .tflite import param_cast, to_device, torch_dtype
from .zoo import ModelBundle


class ONNXError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Minimal protobuf wire reader (the JAX package's)
# ---------------------------------------------------------------------------

def _varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ONNXError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ONNXError("varint too long")


def _signed(v: int) -> int:
    """protobuf int64: negatives ride as 10-byte two's-complement varints."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(data: bytes):
    """Yield (field_number, wire_type, value); value is int for varint/fixed
    and bytes for length-delimited."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _varint(data, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            v, pos = _varint(data, pos)
            yield fnum, wtype, v
        elif wtype == 1:
            yield fnum, wtype, struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wtype == 2:
            ln, pos = _varint(data, pos)
            yield fnum, wtype, data[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            yield fnum, wtype, struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ONNXError(f"unsupported wire type {wtype}")


def _packed_varints(val, wtype) -> List[int]:
    if wtype == 0:
        return [_signed(val)]
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _varint(val, pos)
        out.append(_signed(v))
    return out


# ---------------------------------------------------------------------------
# ONNX schema readers (field numbers from the public onnx.proto)
# ---------------------------------------------------------------------------

_TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _tensor_proto(data: bytes, what: str) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    raw = None
    floats: List[float] = []
    i32s: List[int] = []
    i64s: List[int] = []
    name = ""
    for fnum, wtype, val in _fields(data):
        if fnum == 1:
            dims.extend(_packed_varints(val, wtype))
        elif fnum == 2:
            dtype_code = val
        elif fnum == 4:  # float_data
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif fnum == 5:
            i32s.extend(_packed_varints(val, wtype))
        elif fnum == 7:
            i64s.extend(_packed_varints(val, wtype))
        elif fnum == 8:
            name = val.decode("utf-8", "replace")
        elif fnum == 9:
            raw = val
    if dtype_code not in _TENSOR_DTYPES:
        raise ONNXError(f"{what}: tensor {name!r} has unsupported "
                        f"data_type {dtype_code}")
    dt = np.dtype(_TENSOR_DTYPES[dtype_code])
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt)
    elif floats:
        arr = np.asarray(floats, dt)
    elif i64s:
        arr = np.asarray(i64s, dt)
    elif i32s:
        arr = np.asarray(i32s, dt)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _value_info(data: bytes) -> Tuple[str, Optional[np.dtype], List[int]]:
    """ValueInfoProto -> (name, dtype, dims); symbolic dims become 1."""
    name = ""
    dtype = None
    dims: List[int] = []
    for fnum, _w, val in _fields(data):
        if fnum == 1:
            name = val.decode("utf-8", "replace")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _fields(val):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _w3, v3 in _fields(v2):
                    if f3 == 1:  # elem_type
                        dtype = np.dtype(_TENSOR_DTYPES.get(v3, np.float32))
                    elif f3 == 2:  # TensorShapeProto
                        for f4, _w4, v4 in _fields(v3):
                            if f4 != 1:  # dim
                                continue
                            dim_value = 1
                            for f5, _w5, v5 in _fields(v4):
                                if f5 == 1:
                                    dim_value = _signed(v5)
                            dims.append(max(1, dim_value))
    return name, dtype, dims


class _Attr:
    __slots__ = ("f", "i", "s", "t", "floats", "ints")


def _attributes(node_fields) -> Dict[str, _Attr]:
    attrs: Dict[str, _Attr] = {}
    for data in node_fields:
        a = _Attr()
        a.f = a.i = a.s = a.t = None
        a.floats = []
        a.ints = []
        name = ""
        for fnum, wtype, val in _fields(data):
            if fnum == 1:
                name = val.decode("utf-8", "replace")
            elif fnum == 2:
                a.f = struct.unpack("<f", struct.pack("<I", val))[0]
            elif fnum == 3:
                a.i = _signed(val)
            elif fnum == 4:
                a.s = val.decode("utf-8", "replace")
            elif fnum == 5:
                a.t = _tensor_proto(val, "attribute")[1]
            elif fnum == 7:
                if wtype == 2:
                    a.floats.extend(
                        struct.unpack(f"<{len(val) // 4}f", val))
                else:
                    a.floats.append(
                        struct.unpack("<f", struct.pack("<I", val))[0])
            elif fnum == 8:
                a.ints.extend(_packed_varints(val, wtype))
        attrs[name] = a
    return attrs


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")


class ONNXGraph:
    """Parsed .onnx model: initializers, node list, graph IO."""

    def __init__(self, data: bytes, name: str = "onnx"):
        self.name = name
        graph = None
        for fnum, _w, val in _fields(data):
            if fnum == 7:  # ModelProto.graph
                graph = val
        if graph is None:
            raise ONNXError(f"{name}: no GraphProto (not an ONNX file?)")
        self.initializers: Dict[str, np.ndarray] = {}
        self.nodes: List[_Node] = []
        inputs: List[Tuple[str, Optional[np.dtype], List[int]]] = []
        outputs: List[Tuple[str, Optional[np.dtype], List[int]]] = []
        for fnum, _w, val in _fields(graph):
            if fnum == 1:  # node
                n = _Node()
                n.inputs, n.outputs, attr_blobs = [], [], []
                n.op = ""
                n.name = ""
                for f2, _w2, v2 in _fields(val):
                    if f2 == 1:
                        n.inputs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 2:
                        n.outputs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 3:
                        n.name = v2.decode("utf-8", "replace")
                    elif f2 == 4:
                        n.op = v2.decode("utf-8", "replace")
                    elif f2 == 5:
                        attr_blobs.append(v2)
                n.attrs = _attributes(attr_blobs)
                self.nodes.append(n)
            elif fnum == 5:  # initializer
                tname, arr = _tensor_proto(val, name)
                self.initializers[tname] = arr
            elif fnum == 11:
                inputs.append(_value_info(val))
            elif fnum == 12:
                outputs.append(_value_info(val))
        # graph inputs exclude initializers (ONNX lists weights both ways
        # in old opsets)
        self.inputs = [(n, d, s) for n, d, s in inputs
                       if n not in self.initializers]
        self.outputs = outputs
        unsupported = sorted({n.op for n in self.nodes
                              if n.op not in _OPS})
        if unsupported:
            raise ONNXError(
                f"{name}: unsupported op(s) {unsupported} "
                f"(supported: {sorted(_OPS)})")


# ---------------------------------------------------------------------------
# torch execution (NCHW)
# ---------------------------------------------------------------------------
#
# ``env[name]`` is a value as it is (a numpy array for a constant, a
# tensor otherwise); ``env.t(name)`` is the same value as a device tensor.

def _same_pads(size, k, s, d, lower):
    eff_k = (k - 1) * d + 1
    total = max((-(size // -s) - 1) * s + eff_k - size, 0)
    lo = total // 2
    return (total - lo, lo) if lower else (lo, total - lo)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv(env, const, n):
    x, w = env.t(n.inputs[0]), env.t(n.inputs[1])
    a = n.attrs
    rank = w.dim() - 2
    strides = tuple(a["strides"].ints) if "strides" in a else (1,) * rank
    dil = tuple(a["dilations"].ints) if "dilations" in a else (1,) * rank
    group = a["group"].i if "group" in a else 1
    if "pads" in a:
        p = a["pads"].ints
        padding = [(p[i], p[i + rank]) for i in range(rank)]
    else:
        auto = a["auto_pad"].s if "auto_pad" in a else "NOTSET"
        if auto and auto.startswith("SAME"):
            # SAME_UPPER puts the extra element at the end, SAME_LOWER at
            # the beginning
            padding = [_same_pads(x.shape[2 + i], w.shape[2 + i], strides[i],
                                  dil[i], auto == "SAME_LOWER")
                       for i in range(rank)]
        else:
            padding = [(0, 0)] * rank
    if rank == 2:
        x = x.contiguous(memory_format=torch.channels_last)
    if all(lo == hi for lo, hi in padding):
        y = _CONV[rank](x, w, stride=strides, padding=[lo for lo, _ in padding],
                        dilation=dil, groups=group)
    else:
        flat = [v for lo_hi in reversed(padding) for v in lo_hi]
        y = _CONV[rank](F.pad(x, flat), w, stride=strides, dilation=dil,
                        groups=group)
    if len(n.inputs) > 2:
        y = y + env.t(n.inputs[2]).reshape((1, -1) + (1,) * rank)
    return y


def _reduce_windows(x, k, strides, wdil, pads, value, combine):
    """XLA's ``reduce_window`` over the trailing ``len(k)`` dims of ``x``
    padded with ``value``: each window position's slices combined."""
    rank = len(k)
    x = F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi], value=value)
    out = [(x.shape[2 + i] - (k[i] - 1) * wdil[i] - 1) // strides[i] + 1
           for i in range(rank)]
    if rank == 2 and wdil == (1, 1):
        if combine is torch.maximum:
            return F.max_pool2d(x, k, strides)
        return F.avg_pool2d(x, k, strides, divisor_override=1)
    acc = None
    for offs in np.ndindex(*k):
        idx = (slice(None), slice(None)) + tuple(
            slice(o * d, o * d + (m - 1) * s + 1, s)
            for o, d, m, s in zip(offs, wdil, out, strides))
        acc = x[idx] if acc is None else combine(acc, x[idx])
    return acc


def _pool(env, const, n, kind):
    x = env.t(n.inputs[0])
    a = n.attrs
    k = tuple(a["kernel_shape"].ints)
    rank = len(k)
    strides = tuple(a["strides"].ints) if "strides" in a else (1,) * rank
    wdil = tuple(a["dilations"].ints) if "dilations" in a else (1,) * rank
    if "pads" in a:
        p = a["pads"].ints
        explicit = [[p[i], p[i + rank]] for i in range(rank)]
    else:
        explicit = [[0, 0] for _ in range(rank)]
    ceil_mode = "ceil_mode" in a and a["ceil_mode"].i == 1
    include = "count_include_pad" in a and a["count_include_pad"].i == 1
    ceil_ext = [0] * rank
    if ceil_mode:
        # grow the END pad so the floor-mode windows match the ceil size
        for i in range(rank):
            size = x.shape[2 + i] + explicit[i][0] + explicit[i][1]
            eff_k = (k[i] - 1) * wdil[i] + 1
            out_ceil = -((size - eff_k) // -strides[i]) + 1
            ceil_ext[i] = (out_ceil - 1) * strides[i] + eff_k - size
    pad = [(lo, hi + e) for (lo, hi), e in zip(explicit, ceil_ext)]
    if kind == "max":
        return _reduce_windows(x, k, strides, wdil, pad, -float("inf"),
                               torch.maximum)
    s = _reduce_windows(x, k, strides, wdil, pad, 0.0, torch.add)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if include:
        # explicit pads count toward the divisor, the implicit ceil
        # extension does not
        ones = F.pad(ones, [v for lo_hi in reversed(explicit) for v in lo_hi],
                     value=1.0)
        cnt = _reduce_windows(ones, k, strides, wdil, [(0, e) for e in ceil_ext],
                              0.0, torch.add)
    else:
        cnt = _reduce_windows(ones, k, strides, wdil, pad, 0.0, torch.add)
    return s / torch.clamp_min(cnt, 1.0)  # ceil pad can make all-pad windows


def _gemm(env, const, n):
    a = n.attrs
    A, B = env.t(n.inputs[0]), env.t(n.inputs[1])
    if "transA" in a and a["transA"].i:
        A = A.T
    if "transB" in a and a["transB"].i:
        B = B.T
    y = (a["alpha"].f if "alpha" in a else 1.0) * (A @ B)
    if len(n.inputs) > 2:
        y = y + (a["beta"].f if "beta" in a else 1.0) * env.t(n.inputs[2])
    return y


def _batchnorm(env, const, n):
    x = env.t(n.inputs[0])
    scale, bias, mean, var = (env.t(n.inputs[i]) for i in range(1, 5))
    eps = n.attrs["epsilon"].f if "epsilon" in n.attrs else 1e-5
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)


def _reshape(env, const, n):
    x = env[n.inputs[0]]
    if len(n.inputs) > 1:
        shape = [int(v) for v in const(n.inputs[1]).ravel()]
    else:
        shape = list(n.attrs["shape"].ints)
    allowzero = "allowzero" in n.attrs and n.attrs["allowzero"].i == 1
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


_PAD_MODES = {"reflect": "reflect", "edge": "replicate"}


def _pad_op(env, const, n):
    x = env.t(n.inputs[0])
    if "pads" in n.attrs:
        p = n.attrs["pads"].ints
    else:
        p = [int(v) for v in const(n.inputs[1]).ravel()]
    mode = n.attrs["mode"].s if "mode" in n.attrs else "constant"
    rank = x.dim()
    widths = [(p[i], p[i + rank]) for i in range(rank)]
    if mode == "constant":
        cval = 0.0
        if len(n.inputs) > 2 and n.inputs[2]:
            cval = float(const(n.inputs[2]).ravel()[0])
        return F.pad(x, [v for lo_hi in reversed(widths) for v in lo_hi],
                     value=cval)
    if mode in _PAD_MODES:
        # torch pads the trailing dims only: keep from the first padded one
        first = next((i for i, w in enumerate(widths) if w != (0, 0)), rank)
        flat = [v for lo_hi in reversed(widths[first:]) for v in lo_hi]
        return F.pad(x, flat, mode=_PAD_MODES[mode]) if flat else x
    raise ONNXError(f"Pad mode {mode!r} unsupported")


def _reduce_mean(env, const, n):
    x = env.t(n.inputs[0])
    if "axes" in n.attrs:
        axes = tuple(n.attrs["axes"].ints)
    elif len(n.inputs) > 1:
        axes = tuple(int(v) for v in const(n.inputs[1]).ravel())
    else:
        axes = tuple(range(x.dim()))
    keep = ("keepdims" not in n.attrs) or n.attrs["keepdims"].i == 1
    return torch.mean(x, dim=axes, keepdim=keep)


def _squeeze_axes(env, const, n):
    if "axes" in n.attrs:
        return tuple(n.attrs["axes"].ints)
    if len(n.inputs) > 1:
        return tuple(int(v) for v in const(n.inputs[1]).ravel())
    return None


def _clip(env, const, n):
    x = env.t(n.inputs[0])
    lo = hi = None
    if "min" in n.attrs:
        lo = n.attrs["min"].f
    elif len(n.inputs) > 1 and n.inputs[1]:
        lo = float(const(n.inputs[1]).ravel()[0])
    if "max" in n.attrs:
        hi = n.attrs["max"].f
    elif len(n.inputs) > 2 and n.inputs[2]:
        hi = float(const(n.inputs[2]).ravel()[0])
    if lo is not None:
        x = torch.clamp_min(x, lo)
    if hi is not None:
        x = torch.clamp_max(x, hi)
    return x


def _resize(env, const, n: _Node):
    """ONNX Resize (opset 11+), 4D NCHW over the spatial dims: nearest
    (asymmetric/floor — torch's interpolate export) and linear
    (half_pixel / align_corners / asymmetric)."""
    x = env.t(n.inputs[0])
    if x.dim() != 4:
        raise ONNXError(f"Resize: only 4D NCHW supported, got {x.dim()}D")
    for unsup in ("antialias", "exclude_outside"):
        if unsup in n.attrs and n.attrs[unsup].i:
            raise ONNXError(f"Resize: attribute {unsup}=1 unsupported")
    if "axes" in n.attrs and n.attrs["axes"].ints:
        raise ONNXError(
            "Resize: the opset-18 axes attribute is unsupported "
            "(full-rank scales/sizes only)")
    mode = n.attrs["mode"].s if "mode" in n.attrs else "nearest"
    coord = (n.attrs["coordinate_transformation_mode"].s
             if "coordinate_transformation_mode" in n.attrs else "half_pixel")
    h, w = x.shape[2], x.shape[3]
    oh = ow = None
    if len(n.inputs) > 3 and n.inputs[3]:  # sizes
        sizes = [int(v) for v in const(n.inputs[3]).ravel()]
        oh, ow = sizes[2], sizes[3]
    elif len(n.inputs) > 2 and n.inputs[2]:  # scales
        scales = [float(v) for v in const(n.inputs[2]).ravel()]
        if len(scales) != 4 or scales[0] != 1 or scales[1] != 1:
            raise ONNXError(f"Resize: unsupported scales {scales}")
        oh, ow = int(h * scales[2]), int(w * scales[3])
    if oh is None:
        raise ONNXError("Resize: neither scales nor sizes given")

    def src_idx(o, nsrc):
        i = torch.arange(o, dtype=torch.float32, device=x.device)
        if coord == "align_corners":
            return i * (nsrc - 1) / (o - 1) if o > 1 else i * 0.0
        if coord == "asymmetric":
            return i * nsrc / o
        if coord == "pytorch_half_pixel":
            # like half_pixel, but a length-1 output maps to source 0
            return (i + 0.5) * nsrc / o - 0.5 if o > 1 else i * 0.0
        if coord == "half_pixel":
            return (i + 0.5) * nsrc / o - 0.5
        raise ONNXError(
            f"Resize coordinate_transformation_mode {coord!r} unsupported")

    yf, xf = src_idx(oh, h), src_idx(ow, w)
    if mode == "nearest":
        near = (n.attrs["nearest_mode"].s if "nearest_mode" in n.attrs
                else "round_prefer_floor")  # the opset-11+ default
        rounders = {
            "round_prefer_floor": lambda v: torch.ceil(v - 0.5),
            "round_prefer_ceil": lambda v: torch.floor(v + 0.5),
            "floor": torch.floor,
            "ceil": torch.ceil,
        }
        if near not in rounders:
            raise ONNXError(f"Resize nearest_mode {near!r} unsupported")
        rnd = rounders[near]
        yi = torch.clamp(rnd(yf).to(torch.int64), 0, h - 1)
        xi = torch.clamp(rnd(xf).to(torch.int64), 0, w - 1)
        return x[:, :, yi][:, :, :, xi]
    if mode == "linear":
        y0 = torch.clamp(torch.floor(yf).to(torch.int64), 0, h - 1)
        x0 = torch.clamp(torch.floor(xf).to(torch.int64), 0, w - 1)
        y1 = torch.clamp_max(y0 + 1, h - 1)
        x1 = torch.clamp_max(x0 + 1, w - 1)
        wy = torch.clamp(yf - y0, 0.0, 1.0)[None, None, :, None]
        wx = torch.clamp(xf - x0, 0.0, 1.0)[None, None, None, :]
        f = x.to(torch.float32)
        top = f[:, :, y0][:, :, :, x0] * (1 - wx) + f[:, :, y0][:, :, :, x1] * wx
        bot = f[:, :, y1][:, :, :, x0] * (1 - wx) + f[:, :, y1][:, :, :, x1] * wx
        return (top * (1 - wy) + bot * wy).to(x.dtype)
    raise ONNXError(f"Resize mode {mode!r} unsupported")


def _gather(data, idx, axis):
    """``jnp.take(data, idx, axis)`` on the device, ONNX's negative
    indices counted from the end."""
    n = data.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _slice(env, const, n):
    x = env[n.inputs[0]]
    starts = [int(v) for v in const(n.inputs[1]).ravel()]
    ends = [int(v) for v in const(n.inputs[2]).ravel()]
    axes = ([int(v) for v in const(n.inputs[3]).ravel()]
            if len(n.inputs) > 3 and n.inputs[3]
            else list(range(len(starts))))
    steps = ([int(v) for v in const(n.inputs[4]).ravel()]
             if len(n.inputs) > 4 and n.inputs[4]
             else [1] * len(starts))
    if isinstance(x, torch.Tensor) and any(st < 0 for st in steps):
        raise ONNXError(f"Slice {n.name!r}: negative steps on a device "
                        "tensor are unsupported")
    idx = [slice(None)] * x.ndim
    for s, e, ax, st in zip(starts, ends, axes, steps):
        idx[ax] = slice(s, None if e >= (1 << 62) else e, st)
    return x[tuple(idx)]


def _run_node(env, const, n: _Node):
    op = n.op
    t = env.t
    if op == "Conv":
        return _conv(env, const, n)
    if op == "Gemm":
        return _gemm(env, const, n)
    if op == "MatMul":
        return torch.matmul(t(n.inputs[0]), t(n.inputs[1]))
    if op == "Relu":
        return torch.clamp_min(t(n.inputs[0]), 0)
    if op == "Sigmoid":
        return torch.sigmoid(t(n.inputs[0]))
    if op == "Tanh":
        return torch.tanh(t(n.inputs[0]))
    if op == "Clip":
        return _clip(env, const, n)
    if op == "Softmax":
        axis = n.attrs["axis"].i if "axis" in n.attrs else -1
        return torch.softmax(t(n.inputs[0]), dim=axis)
    if op == "MaxPool":
        return _pool(env, const, n, "max")
    if op == "AveragePool":
        return _pool(env, const, n, "avg")
    if op == "GlobalAveragePool":
        x = t(n.inputs[0])
        return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)
    if op == "BatchNormalization":
        return _batchnorm(env, const, n)
    if op in ("Add", "Sub", "Mul", "Div"):
        x, y = t(n.inputs[0]), t(n.inputs[1])
        if op == "Div":
            if not x.is_floating_point() and not y.is_floating_point():
                # ONNX integer Div truncates toward zero
                return torch.div(x, y, rounding_mode="trunc")
            return x / y
        return {"Add": operator.add, "Sub": operator.sub,
                "Mul": operator.mul}[op](x, y)
    if op == "Concat":
        return torch.cat([t(i) for i in n.inputs], dim=n.attrs["axis"].i)
    if op == "Reshape":
        return _reshape(env, const, n)
    if op == "Flatten":
        axis = n.attrs["axis"].i if "axis" in n.attrs else 1
        x = t(n.inputs[0])
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)
    if op == "Transpose":
        x = t(n.inputs[0])
        perm = (tuple(n.attrs["perm"].ints) if "perm" in n.attrs
                else tuple(reversed(range(x.dim()))))
        return x.permute(perm)
    if op == "Pad":
        return _pad_op(env, const, n)
    if op == "ReduceMean":
        return _reduce_mean(env, const, n)
    if op == "Squeeze":
        axes = _squeeze_axes(env, const, n)
        x = t(n.inputs[0])
        return torch.squeeze(x, axes) if axes is not None else torch.squeeze(x)
    if op == "Unsqueeze":
        x = t(n.inputs[0])
        for ax in sorted(_squeeze_axes(env, const, n)):
            x = torch.unsqueeze(x, ax)
        return x
    if op == "Constant":
        for key in ("value", "value_float", "value_int"):
            if key in n.attrs:
                a = n.attrs[key]
                return a.t if a.t is not None else np.asarray(
                    a.f if a.f is not None else a.i)
        raise ONNXError(f"Constant node {n.name!r} without value")
    if op == "Identity":
        return env[n.inputs[0]]
    if op == "Erf":
        return torch.erf(t(n.inputs[0]))
    if op == "Sqrt":
        return torch.sqrt(t(n.inputs[0]))
    if op == "Exp":
        return torch.exp(t(n.inputs[0]))
    if op == "Neg":
        return -t(n.inputs[0])
    if op == "Pow":
        return torch.pow(t(n.inputs[0]), t(n.inputs[1]))
    if op == "LeakyRelu":
        alpha = n.attrs["alpha"].f if "alpha" in n.attrs else 0.01
        x = t(n.inputs[0])
        return torch.where(x >= 0, x, alpha * x)
    if op in ("Max", "Min"):
        fn = torch.maximum if op == "Max" else torch.minimum
        return functools.reduce(fn, (t(i) for i in n.inputs))
    if op == "Shape":
        # host metadata: the shape math downstream stays numpy
        shape = np.asarray(tuple(env[n.inputs[0]].shape), np.int64)
        start = n.attrs["start"].i if "start" in n.attrs else 0
        end = n.attrs["end"].i if "end" in n.attrs else len(shape)
        return shape[start:end]
    if op == "Gather":
        axis = n.attrs["axis"].i if "axis" in n.attrs else 0
        return _gather(t(n.inputs[0]), t(n.inputs[1]), axis)
    if op == "Split":
        x = t(n.inputs[0])
        axis = n.attrs["axis"].i if "axis" in n.attrs else 0
        if "split" in n.attrs and n.attrs["split"].ints:
            sizes = list(n.attrs["split"].ints)
        elif len(n.inputs) > 1 and n.inputs[1]:
            sizes = [int(v) for v in const(n.inputs[1]).ravel()]
        else:
            # opset-18 equal split: ceil-sized chunks, LAST one smaller
            k = len(n.outputs)
            chunk = -(x.shape[axis] // -k)
            sizes = [chunk] * (k - 1) + [x.shape[axis] - chunk * (k - 1)]
        return tuple(torch.split(x, sizes, dim=axis))
    if op == "Resize":
        return _resize(env, const, n)
    if op == "Cast":
        to = n.attrs["to"].i
        if to not in _TENSOR_DTYPES:
            raise ONNXError(f"Cast to unsupported data_type {to}")
        return t(n.inputs[0]).to(torch_dtype(_TENSOR_DTYPES[to]))
    if op == "ConstantOfShape":
        shape = [int(v) for v in const(n.inputs[0]).ravel()]
        if "value" in n.attrs and n.attrs["value"].t is not None:
            v = n.attrs["value"].t.ravel()[0]
        else:
            v = np.float32(0)
        return np.full(shape, v)  # a host constant
    if op == "Slice":
        return _slice(env, const, n)
    raise ONNXError(f"unsupported op {op}")  # pragma: no cover


#: ops this module runs
_OPS = {"Conv", "Gemm", "MatMul", "Relu", "Sigmoid", "Tanh", "Clip",
        "Softmax", "MaxPool", "AveragePool", "GlobalAveragePool",
        "BatchNormalization", "Add", "Sub", "Mul", "Div", "Concat",
        "Reshape", "Flatten", "Transpose", "Pad", "ReduceMean", "Squeeze",
        "Unsqueeze", "Constant", "Identity", "Cast", "ConstantOfShape",
        "Slice", "Erf", "Sqrt", "Exp", "Neg", "Pow", "LeakyRelu", "Max",
        "Min", "Shape", "Gather", "Split", "Resize"}

#: per-op input positions that are static metadata (the file's constants
#: on the host, kept out of the device params)
_STATIC_OPERANDS = {"Reshape": (1,), "Pad": (1, 2), "Clip": (1, 2),
                    "ReduceMean": (1,), "Squeeze": (1,), "Unsqueeze": (1,),
                    "ConstantOfShape": (0,), "Slice": (1, 2, 3, 4),
                    "Resize": (1, 2, 3), "Split": (1,)}

#: shape-computation ops that run in numpy when all their inputs are host
#: values (constants, or derived from shapes)
_HOSTABLE = {"Cast", "Slice", "Concat", "ConstantOfShape", "Unsqueeze",
             "Squeeze", "Reshape", "Transpose", "Identity", "Constant",
             "Gather", "Add", "Sub", "Mul", "Div", "Max", "Min"}


def _host_run(env, const, n: _Node):
    """Numpy execution of a _HOSTABLE node (host inputs only)."""
    op = n.op
    if op in ("Constant", "ConstantOfShape", "Slice"):
        return _run_node(env, const, n)  # numpy in, numpy out
    if op == "Identity":
        return np.asarray(env[n.inputs[0]])
    if op == "Cast":
        to = n.attrs["to"].i
        return np.asarray(env[n.inputs[0]]).astype(_TENSOR_DTYPES[to])
    if op == "Concat":
        return np.concatenate([np.asarray(env[i]) for i in n.inputs],
                              axis=n.attrs["axis"].i)
    if op == "Unsqueeze":
        x = np.asarray(env[n.inputs[0]])
        for ax in sorted(_squeeze_axes(env, const, n)):
            x = np.expand_dims(x, ax)
        return x
    if op == "Squeeze":
        axes = _squeeze_axes(env, const, n)
        return np.squeeze(np.asarray(env[n.inputs[0]]), axis=axes)
    if op == "Reshape":
        return np.asarray(_reshape(env, const, n))
    if op == "Transpose":
        x = np.asarray(env[n.inputs[0]])
        perm = (tuple(n.attrs["perm"].ints) if "perm" in n.attrs
                else tuple(reversed(range(x.ndim))))
        return np.transpose(x, perm)
    if op == "Gather":
        axis = n.attrs["axis"].i if "axis" in n.attrs else 0
        return np.take(np.asarray(env[n.inputs[0]]),
                       np.asarray(env[n.inputs[1]]), axis=axis)
    if op in ("Add", "Sub", "Mul", "Div", "Max", "Min"):
        fn = {"Add": operator.add, "Sub": operator.sub,
              "Mul": operator.mul, "Div": operator.truediv,
              "Max": np.maximum, "Min": np.minimum}[op]
        out = np.asarray(env[n.inputs[0]])
        for i in n.inputs[1:]:
            out = fn(out, np.asarray(env[i]))
        if op == "Div" and all(
                np.issubdtype(np.asarray(env[i]).dtype, np.integer)
                for i in n.inputs):
            # ONNX integer Div truncates toward zero, result keeps the
            # promoted INPUT dtype
            dt = np.promote_types(*(np.asarray(env[i]).dtype
                                    for i in n.inputs[:2]))
            out = np.trunc(out).astype(dt)
        return out
    raise ONNXError(f"not hostable: {op}")  # pragma: no cover


class _Env:
    """Values by name: the call's own, then the folded host values, then
    the device params, then the file's host-only initializers."""

    def __init__(self, path, own, folded, params, initializers, uploads, device):
        self.path, self.own, self.folded = path, own, folded
        self.params, self.initializers = params, initializers
        self.uploads, self.device = uploads, device

    def __contains__(self, name):
        return (name in self.own or name in self.folded or name in self.params
                or name in self.initializers)

    def __getitem__(self, name):
        for d in (self.own, self.folded, self.params, self.initializers):
            if name in d:
                return d[name]
        raise ONNXError(f"{self.path}: tensor {name!r} used before produced")

    def host(self, name) -> bool:
        """True where the value is a host constant (numpy), as the JAX
        package's concrete values are; an absent optional input too."""
        return name == "" or (name in self and not isinstance(self[name],
                                                              torch.Tensor))

    def t(self, name) -> torch.Tensor:
        """The value as a device tensor: a host value is copied once and
        kept (a folded one by name, a shape-derived one by its bytes)."""
        v = self[name]
        if isinstance(v, torch.Tensor):
            return v
        a = np.ascontiguousarray(v)
        key = ((name,) if name in self.folded
               else (name, a.dtype.str, a.shape, a.tobytes()))
        out = self.uploads.get(key)
        if out is None:
            out = self.uploads[key] = torch.from_numpy(a.copy()).to(self.device)
        return out


def load_bundle(path: str, opts: Optional[Dict[str, str]] = None, *,
                device) -> ModelBundle:
    """Parse a .onnx file into a :class:`ModelBundle` on ``device`` (NCHW
    IO, as an onnxruntime consumer of the same file would see).

    ``custom=param_dtype:bfloat16`` casts the float weights; other option
    keys are rejected."""
    opts = dict(opts or {})
    device = torch.device(device)
    param_dtype = opts.pop("param_dtype", None)
    if opts:
        raise ONNXError(
            f"{path}: unsupported options {sorted(opts)} "
            "(onnx ingestion supports: param_dtype)")
    with open(path, "rb") as f:
        g = ONNXGraph(f.read(), name=path)

    static_names = set()
    data_names = set()
    for n in g.nodes:
        static_pos = _STATIC_OPERANDS.get(n.op, ())
        for pos, iname in enumerate(n.inputs):
            (static_names if pos in static_pos else data_names).add(iname)
    cast = param_cast(path, param_dtype, ONNXError)
    conv_weights = {n.inputs[1] for n in g.nodes if n.op == "Conv"}
    params: Dict[str, torch.Tensor] = {}
    for k, v in g.initializers.items():
        if k in static_names - data_names:
            continue
        t = to_device(v, device)
        if cast is not None and t.is_floating_point():
            t = t.to(cast)
        if k in conv_weights and t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        params[k] = t
    host_inits = {k: v for k, v in g.initializers.items() if k not in params}

    def const_fn(env):
        def const(name):
            if name in g.initializers:
                return np.asarray(g.initializers[name])
            if name in env and not isinstance(env[name], torch.Tensor):
                return np.asarray(env[name])
            raise ONNXError(
                f"{path}: tensor {name!r} must be a graph constant "
                "(shapes/axes/paddings are static)")

        return const

    def run(env, n):
        const = const_fn(env)
        if n.op in _HOSTABLE and all(env.host(i) for i in n.inputs):
            return _host_run(env, const, n)
        return _run_node(env, const, n)

    def store(d, n, out):
        if isinstance(out, tuple):  # multi-output ops (Split)
            d.update(zip(n.outputs, out))
        else:
            d[n.outputs[0]] = out

    # fold, once, every hostable node whose inputs are constants of the
    # file; copy each folded value a device op reads to the device
    uploads: Dict[tuple, torch.Tensor] = {}
    folded: Dict[str, object] = {}
    env = _Env(path, {}, folded, params, host_inits, uploads, device)
    live = []
    for n in g.nodes:
        if n.op in _HOSTABLE and all(env.host(i) for i in n.inputs):
            store(folded, n, run(env, n))
        else:
            live.append(n)
    for n in live:
        static_pos = _STATIC_OPERANDS.get(n.op, ())
        for pos, iname in enumerate(n.inputs):
            if iname in folded and pos not in static_pos:
                env.t(iname)

    def apply_fn(p, *inputs):
        if len(inputs) != len(g.inputs):
            raise ONNXError(
                f"{path}: expected {len(g.inputs)} input(s), got "
                f"{len(inputs)}")
        own = {}
        for (iname, _dt, _shape), arr in zip(g.inputs, inputs):
            own[iname] = (arr if isinstance(arr, torch.Tensor)
                          else torch.as_tensor(np.asarray(arr))).to(device)
        call = _Env(path, own, folded, p, host_inits, uploads, device)
        for n in live:
            store(own, n, run(call, n))
        results = tuple(call[nm] for nm, _d, _s in g.outputs)
        return results if len(results) > 1 else results[0]

    in_spec = TensorsSpec(tuple(
        TensorSpec.from_shape(shape or (1,), dt or np.float32, nm)
        for nm, dt, shape in g.inputs))
    out_spec = TensorsSpec(tuple(
        TensorSpec.from_shape(shape or (1,), dt or np.float32, nm)
        for nm, dt, shape in g.outputs))
    return ModelBundle(apply_fn=apply_fn, params=params, in_spec=in_spec,
                       out_spec=out_spec, name=path)
