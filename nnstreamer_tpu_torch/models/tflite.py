"""``.tflite`` model-file ingestion: flatbuffer -> a torch ``ModelBundle``
on the filter's device.

Port of ``nnstreamer_tpu/models/tflite.py``.  The parser is the JAX
package's (a pure-Python flatbuffer reader over the public schema: no
TensorFlow), copied; the graph walk becomes torch ops over the file's
real weights, which go to the device once, at open.  ``tensor_filter
framework=jax model=/path/m.tflite`` then runs like a zoo model: on the
card unless the filter says ``accelerator=true:cpu``, captured with the
rest of its fused stage.

Operators: CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED, AVERAGE/MAX_POOL_2D,
RESHAPE, SOFTMAX, ADD, SUB, MUL, DIV, CONCATENATION, PAD, MEAN, SQUEEZE,
TRANSPOSE, RESIZE_BILINEAR, SPACE_TO_DEPTH, RELU, RELU6, LOGISTIC, TANH.
Activations are NHWC as in the file; a conv takes the NCHW view of an
NHWC tensor and the OIHW view of the file's OHWI kernel, both
``channels_last`` in memory with no copy, so cuDNN runs its NHWC kernels.
Float and hybrid-quantized graphs run in float (integer weights
dequantize at parse time, per tensor or per axis).

Fully-quantized graphs (every graph input and output an integer
activation: the reference's ``mobilenet_v1_..._quant.tflite`` class) run
by INTEGER EXECUTION, as in the JAX package: activations keep the file's
integer dtypes; CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED sum int8 x
int8 -> int32 through :func:`~..ops.int8_conv.int8_conv` (a hand-written
CUDA kernel on the card; on the CPU its plain float64 version, exact),
with the exact zero-point algebra and per-op requantization of the JAX
package (an f32 multiply of the int32 accumulator, half-to-even
rounding); light ops run dequant -> f32 -> requant.  The correction
constants are made at open, on the device.  ``custom=int_exec:0``
restores dequantized execution; ``custom=param_dtype:bfloat16`` casts
the float weights; other options are rejected.

One difference from the JAX package: a CONV / DEPTHWISE / FC weight (or
an integer bias) that is not a constant of the file raises a
:class:`TFLiteError` naming the tensor, where the JAX package's
``g.raw_constants[wi]`` read (``tflite.py:665``, ``:733``) raises a bare
``KeyError``.
"""

from __future__ import annotations

import operator
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import TensorSpec, TensorsSpec
from ..ops import int8_conv as i8
from .backbone import compute_dtype
from .zoo import ModelBundle


# ---------------------------------------------------------------------------
# Minimal flatbuffer reader (tables / vtables / vectors / strings — the
# subset the tflite schema uses).  The JAX package's, as it is.
# ---------------------------------------------------------------------------

class _FB:
    def __init__(self, data: bytes):
        self.d = data

    def u8(self, o):
        return self.d[o]

    def u16(self, o):
        return struct.unpack_from("<H", self.d, o)[0]

    def u32(self, o):
        return struct.unpack_from("<I", self.d, o)[0]

    def i8(self, o):
        return struct.unpack_from("<b", self.d, o)[0]

    def i32(self, o):
        return struct.unpack_from("<i", self.d, o)[0]

    def i64(self, o):
        return struct.unpack_from("<q", self.d, o)[0]

    def f32(self, o):
        return struct.unpack_from("<f", self.d, o)[0]

    def indirect(self, o):
        """Follow a uoffset at ``o`` to its target position."""
        return o + self.u32(o)

    def root(self):
        return self.indirect(0)

    def field(self, tab: int, fid: int) -> Optional[int]:
        """Absolute position of table field ``fid``'s data, or None."""
        vt = tab - self.i32(tab)  # soffset points BACK from table to vtable
        vsz = self.u16(vt)
        slot = 4 + 2 * fid
        if slot + 2 > vsz:
            return None
        off = self.u16(vt + slot)
        return tab + off if off else None

    # typed field reads with schema defaults
    def f_u8(self, tab, fid, default=0):
        p = self.field(tab, fid)
        return self.u8(p) if p is not None else default

    def f_i8(self, tab, fid, default=0):
        p = self.field(tab, fid)
        return self.i8(p) if p is not None else default

    def f_i32(self, tab, fid, default=0):
        p = self.field(tab, fid)
        return self.i32(p) if p is not None else default

    def f_u32(self, tab, fid, default=0):
        p = self.field(tab, fid)
        return self.u32(p) if p is not None else default

    def f_f32(self, tab, fid, default=0.0):
        p = self.field(tab, fid)
        return self.f32(p) if p is not None else default

    def f_bool(self, tab, fid, default=False):
        p = self.field(tab, fid)
        return bool(self.u8(p)) if p is not None else default

    def f_tab(self, tab, fid) -> Optional[int]:
        p = self.field(tab, fid)
        return self.indirect(p) if p is not None else None

    def f_str(self, tab, fid, default=""):
        p = self.field(tab, fid)
        if p is None:
            return default
        s = self.indirect(p)
        n = self.u32(s)
        return self.d[s + 4:s + 4 + n].decode("utf-8", "replace")

    def _vec(self, tab, fid):
        p = self.field(tab, fid)
        if p is None:
            return None, 0
        v = self.indirect(p)
        return v + 4, self.u32(v)

    def f_vec_i32(self, tab, fid) -> Optional[List[int]]:
        base, n = self._vec(tab, fid)
        if base is None:
            return None
        return list(struct.unpack_from(f"<{n}i", self.d, base))

    def f_vec_f32(self, tab, fid) -> Optional[List[float]]:
        base, n = self._vec(tab, fid)
        if base is None:
            return None
        return list(struct.unpack_from(f"<{n}f", self.d, base))

    def f_vec_i64(self, tab, fid) -> Optional[List[int]]:
        base, n = self._vec(tab, fid)
        if base is None:
            return None
        return list(struct.unpack_from(f"<{n}q", self.d, base))

    def f_vec_bytes(self, tab, fid) -> Optional[bytes]:
        base, n = self._vec(tab, fid)
        if base is None:
            return None
        return self.d[base:base + n]

    def f_vec_tabs(self, tab, fid) -> List[int]:
        base, n = self._vec(tab, fid)
        if base is None:
            return []
        return [self.indirect(base + 4 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# tflite schema constants (public schema.fbs)
# ---------------------------------------------------------------------------

_TENSOR_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
}

_OP_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 21: "RELU6", 22: "RESHAPE",
    23: "RESIZE_BILINEAR", 25: "SOFTMAX", 26: "SPACE_TO_DEPTH", 28: "TANH",
    34: "PAD", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV",
    43: "SQUEEZE",
}

_PADDING = {0: "SAME", 1: "VALID"}
_ACT = {0: None, 1: "relu", 3: "relu6", 4: "tanh"}

class TFLiteError(ValueError):
    pass


def _act_fn(code: int, what: str):
    if code not in _ACT:
        raise TFLiteError(f"{what}: unsupported fused activation {code}")
    name = _ACT[code]
    if name is None:
        return lambda x: x
    if name == "relu":
        return lambda x: torch.clamp_min(x, 0)
    if name == "relu6":
        return lambda x: torch.clamp(x, 0, 6)
    return torch.tanh


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def to_device(arr, device) -> torch.Tensor:
    """A file's numpy constant as a C-contiguous tensor of its own on
    ``device`` (numpy's ``astype`` and transposes may leave a Fortran or
    strided layout, which no kernel of this package takes)."""
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def param_cast(path: str, value, error=ValueError) -> Optional[torch.dtype]:
    """The dtype ``custom=param_dtype:`` names (None when absent)."""
    if not value:
        return None
    try:
        return compute_dtype(str(value).strip().lower())
    except ValueError as e:
        raise error(f"{path}: param_dtype: {e}") from None


# ---------------------------------------------------------------------------
# Graph IR (the JAX package's parser)
# ---------------------------------------------------------------------------

class _Op:
    __slots__ = ("kind", "inputs", "outputs", "attrs")

    def __init__(self, kind, inputs, outputs, attrs):
        self.kind = kind
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs


class TFLiteGraph:
    """Parsed model: tensors, constant weights, op list, graph IO."""

    def __init__(self, data: bytes, name: str = "tflite"):
        if len(data) < 8:
            raise TFLiteError("file too short to be a flatbuffer")
        if data[4:8] != b"TFL3":
            raise TFLiteError(
                f"not a tflite flatbuffer (identifier {data[4:8]!r}, "
                "expected b'TFL3')")
        self.name = name
        fb = _FB(data)
        model = fb.root()
        opcodes = []
        for oc in fb.f_vec_tabs(model, 1):
            # effective builtin code: max of the deprecated int8 field (0)
            # and the extended int32 field (3) — the schema's own rule for
            # codes above 127
            opcodes.append(max(fb.f_i8(oc, 0), fb.f_i32(oc, 3)))
        buffers = [fb.f_vec_bytes(b, 0) for b in fb.f_vec_tabs(model, 4)]
        subgraphs = fb.f_vec_tabs(model, 2)
        if not subgraphs:
            raise TFLiteError("model has no subgraph")
        sg = subgraphs[0]

        self.shapes: List[List[int]] = []
        self.dtypes: List[np.dtype] = []
        self.tensor_names: List[str] = []
        self.constants: Dict[int, np.ndarray] = {}
        #: ORIGINAL integer constants (weights/biases) of quantized
        #: tensors, kept alongside the dequantized ``constants`` for the
        #: integer-execution path
        self.raw_constants: Dict[int, np.ndarray] = {}
        #: full quantization record for EVERY quantized tensor
        #: (constants and activations): idx -> (scales f32 [k],
        #: zero_points i32 [k], axis)
        self.quant: Dict[int, tuple] = {}
        #: activation quantization: tensor idx -> (scale, zero_point,
        #: dtype) for integer activation tensors
        self.io_quant: Dict[int, tuple] = {}
        for idx, t in enumerate(fb.f_vec_tabs(sg, 0)):
            shape = fb.f_vec_i32(t, 0) or []
            tcode = fb.f_i8(t, 1, 0)
            if tcode not in _TENSOR_DTYPES:
                raise TFLiteError(
                    f"tensor {idx} ({fb.f_str(t, 3)}): unsupported tensor "
                    f"type code {tcode}")
            dt = np.dtype(_TENSOR_DTYPES[tcode])
            tname = fb.f_str(t, 3)
            self.shapes.append(shape)
            self.dtypes.append(dt)
            self.tensor_names.append(tname)
            q = fb.f_tab(t, 4)
            scale = fb.f_vec_f32(q, 2) if q is not None else None
            bufidx = fb.f_u32(t, 2, 0)
            raw = buffers[bufidx] if bufidx < len(buffers) else None
            if scale and np.issubdtype(dt, np.integer):
                zp = fb.f_vec_i64(q, 3) or [0] * len(scale)
                axis = fb.f_i32(q, 6, 0)
                self.quant[idx] = (np.asarray(scale, np.float32),
                                   np.asarray(zp, np.int32), axis)
            if scale and not raw and np.issubdtype(dt, np.integer):
                # Quantized ACTIVATION (fully-quantized graph); only
                # per-tensor scales make sense here.
                zp = fb.f_vec_i64(q, 3) or [0]
                if len(scale) != 1:
                    raise TFLiteError(
                        f"tensor {idx} ({tname!r}): per-axis activation "
                        "quantization is not meaningful; file corrupt?")
                self.io_quant[idx] = (float(scale[0]), int(zp[0]), dt)
            if raw:
                arr = np.frombuffer(raw, dtype=dt)
                arr = arr.reshape(shape) if shape else arr
                # Only INTEGER weights dequantize; some converters leave a
                # stale scale on already-float tensors (schema-legal), and
                # re-scaling those would silently corrupt them.
                if scale and np.issubdtype(dt, np.integer):
                    self.raw_constants[idx] = arr
                    arr = self._dequantize(fb, q, arr, scale, tname)
                    self.dtypes[idx] = np.dtype(np.float32)
                self.constants[idx] = arr

        self.inputs = fb.f_vec_i32(sg, 1) or []
        self.outputs = fb.f_vec_i32(sg, 2) or []
        self.ops: List[_Op] = []
        for op in fb.f_vec_tabs(sg, 3):
            oci = fb.f_u32(op, 0, 0)
            code = opcodes[oci]
            kind = _OP_NAMES.get(code)
            if kind is None:
                raise TFLiteError(
                    f"unsupported builtin operator code {code} "
                    f"(supported: {sorted(_OP_NAMES.values())})")
            ins = fb.f_vec_i32(op, 1) or []
            outs = fb.f_vec_i32(op, 2) or []
            bo = fb.f_tab(op, 4)
            self.ops.append(_Op(kind, ins, outs, self._attrs(fb, kind, bo)))

    @staticmethod
    def _dequantize(fb: _FB, q: int, arr: np.ndarray, scale, tname: str):
        """int8/uint8 weights -> float32 via (q - zero_point) * scale,
        per-tensor or per-axis (quantized_dimension)."""
        zp = fb.f_vec_i64(q, 3) or [0] * len(scale)
        axis = fb.f_i32(q, 6, 0)
        s = np.asarray(scale, np.float32)
        z = np.asarray(zp, np.float32)
        if s.size == 1:
            return (arr.astype(np.float32) - z[0]) * s[0]
        if arr.ndim == 0 or arr.shape[axis] != s.size:
            raise TFLiteError(
                f"tensor {tname!r}: per-axis scale count {s.size} does not "
                f"match dim {axis} of shape {arr.shape}")
        bshape = [1] * arr.ndim
        bshape[axis] = s.size
        return ((arr.astype(np.float32) - z.reshape(bshape))
                * s.reshape(bshape))

    @staticmethod
    def _attrs(fb: _FB, kind: str, bo: Optional[int]) -> Dict:
        """Decode the builtin-options table for ``kind`` (field ids from the
        public schema.fbs; all fields default like the schema does)."""
        a: Dict = {}
        if kind in ("CONV_2D",):
            a["padding"] = _PADDING[fb.f_i8(bo, 0, 0)] if bo else "SAME"
            a["strides"] = (fb.f_i32(bo, 2, 1), fb.f_i32(bo, 1, 1)) if bo else (1, 1)
            a["act"] = fb.f_i8(bo, 3, 0) if bo else 0
            a["dilation"] = (fb.f_i32(bo, 5, 1), fb.f_i32(bo, 4, 1)) if bo else (1, 1)
        elif kind == "DEPTHWISE_CONV_2D":
            a["padding"] = _PADDING[fb.f_i8(bo, 0, 0)] if bo else "SAME"
            a["strides"] = (fb.f_i32(bo, 2, 1), fb.f_i32(bo, 1, 1)) if bo else (1, 1)
            a["act"] = fb.f_i8(bo, 4, 0) if bo else 0
            a["dilation"] = (fb.f_i32(bo, 6, 1), fb.f_i32(bo, 5, 1)) if bo else (1, 1)
        elif kind in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
            a["padding"] = _PADDING[fb.f_i8(bo, 0, 0)] if bo else "SAME"
            a["strides"] = (fb.f_i32(bo, 2, 1), fb.f_i32(bo, 1, 1)) if bo else (1, 1)
            a["filter"] = (fb.f_i32(bo, 4, 1), fb.f_i32(bo, 3, 1)) if bo else (1, 1)
            a["act"] = fb.f_i8(bo, 5, 0) if bo else 0
        elif kind == "FULLY_CONNECTED":
            a["act"] = fb.f_i8(bo, 0, 0) if bo else 0
            a["keep_num_dims"] = fb.f_bool(bo, 2, False) if bo else False
        elif kind == "SOFTMAX":
            a["beta"] = fb.f_f32(bo, 0, 1.0) if bo else 1.0
        elif kind == "RESHAPE":
            a["new_shape"] = fb.f_vec_i32(bo, 0) if bo else None
        elif kind in ("ADD", "SUB", "MUL", "DIV"):
            a["act"] = fb.f_i8(bo, 0, 0) if bo else 0
        elif kind == "RESIZE_BILINEAR":
            a["align_corners"] = fb.f_bool(bo, 2, False) if bo else False
            a["half_pixel"] = fb.f_bool(bo, 3, False) if bo else False
        elif kind == "SPACE_TO_DEPTH":
            a["block"] = fb.f_i32(bo, 0, 1) if bo else 1
        elif kind == "CONCATENATION":
            a["axis"] = fb.f_i32(bo, 0, 0) if bo else 0
            a["act"] = fb.f_i8(bo, 1, 0) if bo else 0
        elif kind == "MEAN":
            a["keep_dims"] = fb.f_bool(bo, 0, False) if bo else False
        elif kind == "SQUEEZE":
            a["squeeze_dims"] = fb.f_vec_i32(bo, 0) if bo else None
        return a


def _raw_const(g: TFLiteGraph, i: int, what: str) -> np.ndarray:
    """The file's integer constant ``i`` (a quantized weight or bias)."""
    if i not in g.raw_constants:
        raise TFLiteError(
            f"{what}: tensor {i} ({g.tensor_names[i]!r}) must be a quantized "
            "constant of the file (integer execution takes no computed "
            "weights)")
    return g.raw_constants[i]


# ---------------------------------------------------------------------------
# torch execution (float)
# ---------------------------------------------------------------------------

#: per-op input positions that are STATIC metadata (shapes/axes/paddings),
#: not data: they resolve to the file's constants on the host
_STATIC_OPERANDS = {"RESHAPE": (1,), "PAD": (1,), "MEAN": (1,),
                    "TRANSPOSE": (1,), "RESIZE_BILINEAR": (1,)}


def _same_pads(in_hw, k_hw, strides, dilation):
    """Explicit TFLite/XLA SAME padding: (before, after) per spatial edge,
    the odd pixel after."""
    pads = []
    for n, k, s, d in zip(in_hw, k_hw, strides, dilation):
        eff = (k - 1) * d + 1
        total = max(0, (-(-n // s) - 1) * s + eff - n)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv(x, w_oihw, a, groups):
    """A float conv of NHWC ``x`` with an OIHW kernel (a view of the
    file's layout): the NCHW view in, the NHWC view out."""
    kh, kw = w_oihw.shape[2:]
    if a["padding"] == "SAME":
        (pt, pb), (pl, pr) = _same_pads(x.shape[1:3], (kh, kw), a["strides"],
                                        a["dilation"])
    else:
        pt = pb = pl = pr = 0
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w_oihw, stride=a["strides"], padding=(pt, pl),
                     dilation=a["dilation"], groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w_oihw, stride=a["strides"],
                     dilation=a["dilation"], groups=groups)
    return y.permute(0, 2, 3, 1)


def _window_sum(xc, k, s, pads, value=0.0):
    """Sum over each (kh, kw) window of an NCHW tensor padded with
    ``value``: XLA's ``reduce_window(add)``."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xc = F.pad(xc, (pl, pr, pt, pb), value=value)
    return F.avg_pool2d(xc, k, s, divisor_override=1)


def _pool(x, a, kind, pad_value=None):
    """AVERAGE_POOL_2D / MAX_POOL_2D on NHWC ``x`` with TFLite's padding:
    SAME averages over the window's real pixels only (the count taken by
    the same window sum over ones)."""
    k, s = a["filter"], a["strides"]
    if a["padding"] == "SAME":
        pads = _same_pads(x.shape[1:3], k, s, (1, 1))
    else:
        pads = [(0, 0), (0, 0)]
    xc = x.permute(0, 3, 1, 2)
    if kind == "MAX_POOL_2D":
        (pt, pb), (pl, pr) = pads
        if pt or pb or pl or pr:
            xc = F.pad(xc, (pl, pr, pt, pb),
                       value=-float("inf") if pad_value is None else pad_value)
        return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)
    total = _window_sum(xc, k, s, pads)
    cnt = _window_sum(torch.ones_like(xc[:1, :1]), k, s, pads)
    return (total / cnt).permute(0, 2, 3, 1)


def _resize_bilinear(x, oh: int, ow: int, align_corners: bool,
                     half_pixel: bool):
    """tflite ResizeBilinear semantics (all three coordinate mappings)."""
    h, w = x.shape[1], x.shape[2]

    def coords(o, n):
        i = torch.arange(o, dtype=torch.float32, device=x.device)
        if align_corners and o > 1:
            return i * (n - 1) / (o - 1)
        if half_pixel:
            return torch.clamp_min((i + 0.5) * n / o - 0.5, 0.0)
        return i * n / o

    yf = coords(oh, h)
    xf = coords(ow, w)
    y0 = torch.clamp(torch.floor(yf).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xf).to(torch.int64), 0, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    wy = (yf - y0)[None, :, None, None]
    wx = (xf - x0)[None, None, :, None]
    f = x.to(torch.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def _run_op(op: _Op, get, const, attrs_name: str):
    """Execute one op; ``get(idx)`` resolves a tensor index to a tensor on
    the device, ``const(idx)`` to the file's numpy constant."""
    k, a = op.kind, op.attrs
    if k in ("CONV_2D", "DEPTHWISE_CONV_2D"):
        x, w = get(op.inputs[0]), get(op.inputs[1])
        if k == "CONV_2D":  # OHWI -> OIHW
            y = _conv(x, w.permute(0, 3, 1, 2), a, 1)
        else:  # [1, kh, kw, cin*mult] -> [cin*mult, 1, kh, kw], groups=cin
            y = _conv(x, w.permute(3, 0, 1, 2), a, x.shape[-1])
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + get(op.inputs[2])
        return _act_fn(a["act"], attrs_name)(y)
    if k == "FULLY_CONNECTED":
        x, w = get(op.inputs[0]), get(op.inputs[1])
        if not a["keep_num_dims"] and x.dim() != 2:
            x = x.reshape(-1, w.shape[1])
        y = x @ w.T
        if len(op.inputs) > 2 and op.inputs[2] >= 0:
            y = y + get(op.inputs[2])
        return _act_fn(a["act"], attrs_name)(y)
    if k in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
        return _act_fn(a["act"], attrs_name)(_pool(get(op.inputs[0]), a, k))
    if k == "RESHAPE":
        x = get(op.inputs[0])
        shape = a["new_shape"]
        if shape is None and len(op.inputs) > 1:
            shape = [int(v) for v in const(op.inputs[1])]
        if shape is None:
            raise TFLiteError(f"{attrs_name}: RESHAPE without a target shape")
        return x.reshape(shape)
    if k == "SOFTMAX":
        return torch.softmax(get(op.inputs[0]) * a["beta"], dim=-1)
    if k in ("ADD", "SUB", "MUL", "DIV"):
        fn = {"ADD": operator.add, "SUB": operator.sub,
              "MUL": operator.mul, "DIV": operator.truediv}[k]
        z = fn(get(op.inputs[0]), get(op.inputs[1]))
        return _act_fn(a["act"], attrs_name)(z)
    if k == "TRANSPOSE":
        perm = [int(v) for v in const(op.inputs[1]).ravel()]
        return get(op.inputs[0]).permute(perm)
    if k == "SPACE_TO_DEPTH":
        x = get(op.inputs[0])
        b = a["block"]
        B, H, W, C = x.shape
        x = x.reshape(B, H // b, b, W // b, b, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // b, W // b, C * b * b)
    if k == "RESIZE_BILINEAR":
        oh, ow = (int(v) for v in const(op.inputs[1]).ravel())
        return _resize_bilinear(get(op.inputs[0]), oh, ow, a["align_corners"],
                                a["half_pixel"])
    if k == "CONCATENATION":
        z = torch.cat([get(i) for i in op.inputs], dim=a["axis"])
        return _act_fn(a["act"], attrs_name)(z)
    if k == "PAD":
        pads = const(op.inputs[1]).reshape(-1, 2)
        return F.pad(get(op.inputs[0]),
                     [int(v) for lo_hi in pads[::-1] for v in lo_hi])
    if k == "MEAN":
        x = get(op.inputs[0])
        if not x.is_floating_point():
            x = x.to(torch.float32)  # jnp.mean of an integer array
        axes = [int(v) for v in const(op.inputs[1]).ravel()]
        return torch.mean(x, dim=tuple(axes), keepdim=a["keep_dims"])
    if k == "SQUEEZE":
        dims = a["squeeze_dims"]
        x = get(op.inputs[0])
        return torch.squeeze(x, tuple(dims)) if dims else torch.squeeze(x)
    if k == "RELU":
        return torch.clamp_min(get(op.inputs[0]), 0)
    if k == "RELU6":
        return torch.clamp(get(op.inputs[0]), 0, 6)
    if k == "LOGISTIC":
        return torch.sigmoid(get(op.inputs[0]))
    if k == "TANH":
        return torch.tanh(get(op.inputs[0]))
    raise TFLiteError(f"unsupported op {k}")  # pragma: no cover


# ---------------------------------------------------------------------------
# Integer execution (fully-quantized graphs)
# ---------------------------------------------------------------------------
#
# The JAX package's zero-point algebra (uint8 legacy files have nonzero
# zero points on BOTH sides): operands are shifted into int8 (x-128 /
# w-128, zero points adjusted), inputs are explicitly padded with their
# zero point so every window is full, and
#     y = conv(x8, w8) - x_zp*sum(w8) - w_zp*sum_win(x8) + K*x_zp*w_zp
# with sum(w8) per output channel made at open and sum_win(x8) the same
# int8 kernel over a ones weight (run only where w_zp != 0).  The int32
# accumulator requantizes per op through an f32 multiplier (per axis
# where the file says so) with the fused activation as a clamp in the
# quantized domain.  Light ops run dequant -> f32 -> requant.


def _deq_t(x, q):
    """Dequantize, per-tensor: (q - zp) * scale -> f32."""
    s, z, _ = q
    return (x.to(torch.float32) - float(z[0])) * float(s[0])


def _req_t(x, q, dt):
    """Requantize, per-tensor: f32 -> clamped integer dtype."""
    s, z, _ = q
    info = np.iinfo(dt)
    y = torch.round(x.to(torch.float32) / float(s[0])) + float(z[0])
    return torch.clamp(y, info.min, info.max).to(torch_dtype(dt))


def _act_qrange(act: int, dt, scale: float, zp: int, what: str):
    """Fused-activation clamp range in the QUANTIZED domain."""
    info = np.iinfo(dt)
    lo, hi = info.min, info.max
    name = _ACT.get(act)
    if act not in _ACT or name == "tanh":
        raise TFLiteError(f"{what}: unsupported fused activation {act} "
                          "for integer execution")
    if name in ("relu", "relu6"):
        lo = max(lo, zp)
    if name == "relu6":
        hi = min(hi, int(round(6.0 / scale)) + zp)
    return lo, hi


def _to_i8(x, zp: int):
    """Shift a uint8 activation into int8 (zp adjusted by -128); int8
    passes through."""
    if x.dtype == torch.uint8:
        return (x ^ 128).view(torch.int8), zp - 128
    return x, zp


def _int_route(op: _Op, g: TFLiteGraph) -> str:
    """How :func:`_run_op_int` runs ``op`` (the JAX package's branches)."""
    k, qof = op.kind, g.quant.get
    if k in ("CONV_2D", "DEPTHWISE_CONV_2D") and qof(op.inputs[0]):
        return "conv"
    if k == "FULLY_CONNECTED" and qof(op.inputs[0]):
        return "fc"
    if k == "MAX_POOL_2D" and qof(op.inputs[0]):
        return "max_pool"
    if k in ("RESHAPE", "SQUEEZE", "TRANSPOSE", "SPACE_TO_DEPTH"):
        return "layout"
    if k == "PAD" and qof(op.inputs[0]):
        return "pad"
    if k == "CONCATENATION" and all(qof(i) for i in op.inputs):
        return "concat"
    return "fallback"


def _out_q(op: _Op, g: TFLiteGraph, name: str, pos: int = 0):
    i = op.outputs[pos]
    q = g.quant.get(i)
    if q is None:
        raise TFLiteError(
            f"{name}: output tensor {i} ({g.tensor_names[i]!r}) of "
            f"{op.kind} has no quantization — not a fully-quantized graph")
    return q, g.dtypes[i]


def _prepare_conv(op: _Op, g: TFLiteGraph, name: str, device) -> Dict:
    """The device constants and static geometry of one integer CONV_2D,
    DEPTHWISE_CONV_2D or FULLY_CONNECTED, made once at open: the int8
    kernel in OHWI, the zero-point correction per output channel, the
    ones kernel of the box sum (only where a weight zero point is not 0),
    the int32 bias and the f32 multiplier."""
    k, a = op.kind, op.attrs
    xi, wi = op.inputs[0], op.inputs[1]
    xs, xz, _ = g.quant[xi]
    w_raw = _raw_const(g, wi, f"{name}: {k} weight")
    wq = g.quant.get(wi)
    if wq is None:  # pragma: no cover - raw constants always carry a scale
        raise TFLiteError(f"{name}: {k} weight {g.tensor_names[wi]!r} "
                          "has no quantization")
    ws, wz, _ = wq
    xz8 = int(xz[0]) - (128 if g.dtypes[xi] == np.uint8 else 0)
    w8 = w_raw.astype(np.int32) - (128 if w_raw.dtype == np.uint8 else 0)
    wz8 = wz.astype(np.int32) - (128 if w_raw.dtype == np.uint8 else 0)
    dw = k == "DEPTHWISE_CONV_2D"
    fc = k == "FULLY_CONNECTED"
    if fc:  # [O, K] -> a 1x1 conv
        ohwi = w8.reshape(w8.shape[0], 1, 1, w8.shape[1])
    elif dw:  # [1, kh, kw, cin*mult] -> [cin*mult, kh, kw, 1]
        ohwi = w8.transpose(3, 1, 2, 0)
    else:
        ohwi = w8
    O, kh, kw, cg = ohwi.shape
    cin = int(g.shapes[xi][-1]) if not fc else cg
    groups = cin if dw else 1
    # the JAX package's constants, in its arithmetic: sum(w8) per output
    # channel over its window, K = window size, wz per output channel
    sum_w = ohwi.sum(axis=(1, 2, 3)).astype(np.int64)
    K = kh * kw * cg
    wz_vec = (np.broadcast_to(wz8, (O,)) if wz8.size > 1
              else np.full((O,), int(wz8.ravel()[0])))
    corr = (-xz8 * sum_w + K * xz8 * wz_vec).astype(np.int32)
    oq = _out_q(op, g, name)
    mult = (float(xs[0]) * ws.astype(np.float32) / float(oq[0][0][0]))
    mult = np.broadcast_to(mult, (O,)).astype(np.float32)
    lo, hi = _act_qrange(a["act"], oq[1], float(oq[0][0][0]), int(oq[0][1][0]),
                         name)

    prep = dict(
        w8=to_device(ohwi.astype(np.int8), device), corr=to_device(corr, device),
        mult=to_device(mult, device), bias=None, wz=None, ones=None,
        static=dict(fc=fc, dw=dw, groups=groups, K=cg, xz8=xz8,
                    strides=(1, 1) if fc else tuple(a["strides"]),
                    dilation=(1, 1) if fc else tuple(a["dilation"]),
                    padding="VALID" if fc else a["padding"],
                    kh=kh, kw=kw, rep=O // cin if dw else 1,
                    zp=float(oq[0][1][0]), lo=lo, hi=hi,
                    dtype=torch_dtype(oq[1])))
    if np.any(wz_vec != 0):
        prep["wz"] = to_device(wz_vec.astype(np.int32), device)
        prep["ones"] = to_device(np.ones((cin, kh, kw, 1) if dw else (1, kh, kw, cg),
                                         np.int8), device)
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        bias = _raw_const(g, op.inputs[2], f"{name}: {k} bias")
        prep["bias"] = to_device(bias.astype(np.int32), device)
    return prep


def _run_conv_int(x, prep):
    """One integer CONV_2D / DEPTHWISE_CONV_2D / FULLY_CONNECTED on the
    device: int8 sums through the int8 kernel, the corrections, the bias
    and the requantization."""
    st = prep["static"]
    x8, _ = _to_i8(x, 0)
    if st["fc"]:
        x8p = x8.reshape(-1, 1, 1, st["K"])
    else:
        if st["padding"] == "SAME":
            (pt, pb), (pl, pr) = _same_pads(x8.shape[1:3], (st["kh"], st["kw"]),
                                            st["strides"], st["dilation"])
        else:
            pt = pb = pl = pr = 0
        x8p = (F.pad(x8, (0, 0, pl, pr, pt, pb), value=st["xz8"])
               if pt or pb or pl or pr else x8)
    x8p = x8p.contiguous()
    acc = i8.int8_conv(x8p, prep["w8"], st["strides"], st["dilation"], st["groups"])
    acc = acc + prep["corr"]
    if prep["wz"] is not None:
        sum_x = i8.int8_conv(x8p, prep["ones"], st["strides"], st["dilation"],
                             st["groups"])
        if st["rep"] > 1:
            sum_x = sum_x.repeat_interleave(st["rep"], dim=-1)
        acc = acc - prep["wz"] * sum_x
    if st["fc"]:
        acc = acc.reshape(acc.shape[0], -1)
    if prep["bias"] is not None:
        acc = acc + prep["bias"]
    y = torch.round(acc.to(torch.float32) * prep["mult"]) + st["zp"]
    return torch.clamp(y, st["lo"], st["hi"]).to(st["dtype"])


def _run_op_int(op: _Op, route: str, geti, getf, const, g: TFLiteGraph,
                prep, name: str):
    """Integer-execution twin of :func:`_run_op`, by :func:`_int_route`."""
    k, a = op.kind, op.attrs
    qof = g.quant.get
    if route in ("conv", "fc"):
        return _run_conv_int(geti(op.inputs[0]), prep)
    if route == "max_pool":
        # max commutes with the (monotone) quantization map; same in/out
        # quant per the tflite spec — run on the integers (held exactly in
        # f32), the padding at the dtype's minimum as XLA's init value
        x = geti(op.inputs[0])
        info = np.iinfo(g.dtypes[op.inputs[0]])
        y = _pool(x.to(torch.float32), a, k, pad_value=float(info.min))
        return y.to(x.dtype)
    if route == "layout":
        return _run_op(op, geti, const, name)  # pure layout: int passes
    if route == "pad":
        _, z, _ = qof(op.inputs[0])
        pads = const(op.inputs[1]).reshape(-1, 2)
        return F.pad(geti(op.inputs[0]),
                     [int(v) for lo_hi in pads[::-1] for v in lo_hi],
                     value=int(z[0]))
    if route == "concat":
        oq, odt = _out_q(op, g, name)
        parts = []
        for i in op.inputs:
            q = qof(i)
            same = (float(q[0][0]) == float(oq[0][0])
                    and int(q[1][0]) == int(oq[1][0]))
            parts.append(geti(i) if same else _req_t(_deq_t(geti(i), q), oq, odt))
        return torch.cat(parts, dim=a["axis"])
    # generic fallback: dequant integer inputs, run the float op, requant
    # to the op output's quantization
    res = _run_op(op, getf, const, name)
    oi = op.outputs[0]
    q = qof(oi)
    if q is not None:
        return _req_t(res, q, g.dtypes[oi])
    return res


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------

def _graph_spec(g: TFLiteGraph, ids) -> TensorsSpec:
    return TensorsSpec(tuple(
        TensorSpec.from_shape(g.shapes[i], g.dtypes[i], g.tensor_names[i])
        for i in ids))


def _inputs(path, g, inputs, device):
    if len(inputs) != len(g.inputs):
        raise TFLiteError(f"{path}: expected {len(g.inputs)} input(s), got "
                          f"{len(inputs)}")
    return [(x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, order="C")))
            .to(device) for x in inputs]


def _const_fn(path, g):
    def const(i):
        if i not in g.constants:
            raise TFLiteError(
                f"{path}: tensor {i} ({g.tensor_names[i]!r}) must be a graph "
                "constant (shapes/axes/paddings are static; dynamic values "
                "are unsupported)")
        return np.asarray(g.constants[i])

    return const


def _missing(path, g, i):
    return TFLiteError(
        f"{path}: tensor {i} ({g.tensor_names[i]!r}) used before produced — "
        "graph is not topologically ordered?")


def load_bundle(path: str, opts: Optional[Dict[str, str]] = None, *,
                device) -> ModelBundle:
    """Parse a .tflite file into a :class:`ModelBundle` on ``device``.

    The file's weight tensors go to the device here (the bundle's params);
    the returned callable walks the graph with torch ops, reads nothing
    back from the device and copies nothing to it, so a fused stage can
    capture it.  ``custom=param_dtype:bfloat16`` casts the float weights;
    ``custom=int_exec:0`` runs a fully-quantized graph dequantized; other
    option keys are rejected."""
    opts = dict(opts or {})
    device = torch.device(device)
    param_dtype = opts.pop("param_dtype", None)
    int_exec_opt = str(opts.pop("int_exec", "1")).lower() not in (
        "0", "false", "no")
    if opts:
        raise TFLiteError(
            f"{path}: unsupported options {sorted(opts)} "
            "(tflite ingestion supports: param_dtype, int_exec)")
    with open(path, "rb") as f:
        data = f.read()
    g = TFLiteGraph(data, name=path)
    # Fully-quantized graph (every graph input AND output is an integer
    # activation): the INTEGER execution path, unless the caller forces
    # the dequantized one with custom=int_exec:0.
    int_exec = (int_exec_opt and g.inputs and g.outputs
                and all(i in g.io_quant for i in g.inputs)
                and all(i in g.io_quant for i in g.outputs))
    if int_exec:
        return _load_bundle_int(path, g, device)
    # Static-metadata operands (reshape shapes, pad widths, mean axes) stay
    # on the host; a constant also consumed as data keeps its params slot.
    static_ids = set()
    data_ids = set()
    for op in g.ops:
        static_pos = _STATIC_OPERANDS.get(op.kind, ())
        for pos, idx in enumerate(op.inputs):
            (static_ids if pos in static_pos else data_ids).add(idx)
    cast = param_cast(path, param_dtype, TFLiteError)
    params = {}
    for i, v in g.constants.items():
        if i in static_ids - data_ids:
            continue
        t = to_device(v, device)
        params[f"t{i}"] = t.to(cast) if cast is not None and t.is_floating_point() else t
    const = _const_fn(path, g)

    def apply_fn(p, *inputs):
        env: Dict[int, torch.Tensor] = {}
        for idx, arr in zip(g.inputs, _inputs(path, g, inputs, device)):
            if idx in g.io_quant:
                # fully-quantized graph boundary: integer in, float inside
                scale, zp, _ = g.io_quant[idx]
                arr = (arr.to(torch.float32) - zp) * scale
            env[idx] = arr

        def get(i):
            if i in env:
                return env[i]
            key = f"t{i}"
            if key in p:
                return p[key]
            raise _missing(path, g, i)

        for op in g.ops:
            env[op.outputs[0]] = _run_op(op, get, const, path)

        def requant(i):
            x = env[i]
            if i not in g.io_quant:
                return x
            scale, zp, dt = g.io_quant[i]
            info = np.iinfo(dt)
            q = torch.round(x.to(torch.float32) / scale) + zp
            return torch.clamp(q, info.min, info.max).to(torch_dtype(dt))

        results = tuple(requant(i) for i in g.outputs)
        return results if len(results) > 1 else results[0]

    return ModelBundle(apply_fn=apply_fn, params=params,
                       in_spec=_graph_spec(g, g.inputs),
                       out_spec=_graph_spec(g, g.outputs), name=path)


def _load_bundle_int(path: str, g: TFLiteGraph, device) -> ModelBundle:
    """Integer-execution bundle for a fully-quantized graph.

    Every device constant is made here: per integer CONV / DW / FC op its
    int8 kernel, correction, multiplier and bias (``params["op<n>"]``), and
    for the other ops each constant they read as data, as the file's
    integers (``r<i>``) or dequantized (``t<i>``), as the JAX package's
    ``geti`` and fallback read them."""
    routes = [_int_route(op, g) for op in g.ops]
    params: Dict[str, object] = {}

    for n, (op, route) in enumerate(zip(g.ops, routes)):
        if route in ("conv", "fc"):
            params[f"op{n}"] = _prepare_conv(op, g, path, device)
            continue
        static_pos = _STATIC_OPERANDS.get(op.kind, ())
        for pos, i in enumerate(op.inputs):
            if i not in g.constants or pos in static_pos:
                continue
            if route == "fallback":
                params.setdefault(f"t{i}", to_device(g.constants[i], device))
            else:
                params.setdefault(f"r{i}", to_device(g.raw_constants.get(i, g.constants[i]),
                                                     device))
    const = _const_fn(path, g)

    def apply_fn(p, *inputs):
        env: Dict[int, torch.Tensor] = dict(zip(g.inputs, _inputs(path, g, inputs,
                                                                   device)))

        def geti(i):
            if i in env:
                return env[i]
            if f"r{i}" in p:
                return p[f"r{i}"]
            raise _missing(path, g, i)

        def getf(i):
            if i in env:
                v, q = env[i], g.quant.get(i)
                if q is not None and not v.is_floating_point():
                    return _deq_t(v, q)
                return v
            if f"t{i}" in p:
                return p[f"t{i}"]  # pre-dequantized weights
            raise _missing(path, g, i)

        for n, (op, route) in enumerate(zip(g.ops, routes)):
            env[op.outputs[0]] = _run_op_int(op, route, geti, getf, const, g,
                                             p.get(f"op{n}"), path)

        results = []
        for i in g.outputs:
            x = env[i]
            want = torch_dtype(g.dtypes[i])
            if x.dtype != want:
                q = g.quant.get(i)
                x = _req_t(x, q, g.dtypes[i]) if q is not None else x.to(want)
            results.append(x)
        return tuple(results) if len(results) > 1 else results[0]

    return ModelBundle(apply_fn=apply_fn, params=params,
                       in_spec=_graph_spec(g, g.inputs),
                       out_spec=_graph_spec(g, g.outputs), name=path)
