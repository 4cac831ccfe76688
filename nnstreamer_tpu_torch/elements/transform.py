"""tensor_transform: elementwise/layout preprocessing.

Port of ``nnstreamer_tpu/elements/transform.py`` (reference:
``gsttensor_transform.c``).  Modes: ``typecast``, ``arithmetic`` (op
chain, e.g. ``typecast:float32,add:-127.5,div:127.5``), ``transpose``,
``dimchg``, ``clamp``, ``stand`` (standardization), ``padding``.

Every mode is written once, in :class:`Ops`, over an array namespace:
:data:`NUMPY` on the host path, a :class:`TorchNS` in :meth:`device_fn`,
where the chain runs inside a fused stage on the stage's device.  A
float->integer cast saturates at the target's range on both (the JAX
package's ``_saturate_cast``), so a chain emits the same bytes fused or
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps
from ..core.registry import register_element
from ..core.types import (TensorSpec, TensorsSpec, dtype_from_name,
                          dtype_name, numpy_dtype)
from .base import Element, ElementError, SRC


def _np_axis(rank: int, dim_index: int) -> int:
    """nnstreamer dim index (innermost-first) -> axis (outermost-first)."""
    return rank - 1 - dim_index


@dataclasses.dataclass
class _ArithOp:
    name: str  # add|sub|mul|div|pow|typecast
    value: object = None
    per_channel_dim: Optional[int] = None  # dim index for vector consts


def _promotes_to_float(op: "_ArithOp") -> bool:
    """Whether applying ``op`` to an integer tensor lifts it to float32:
    one rule for the spec (:meth:`TensorTransform._out_spec_one`) and the
    data (:meth:`Ops.arithmetic`), so negotiated caps match the buffers."""
    if op.name == "div":
        return True
    v = op.value
    if isinstance(v, float) and not float(v).is_integer():
        return True
    if isinstance(v, (list, tuple)) and any(not float(e).is_integer() for e in v):
        return True
    return False


class _NumpyNS:
    """The host namespace: numpy."""

    name = "numpy"

    @staticmethod
    def kind(x) -> str:
        return np.dtype(x.dtype).kind

    @staticmethod
    def astype(x, dt):
        return x.astype(np.dtype(dt))

    @staticmethod
    def const(values, dt, like):
        return np.asarray(list(values), dtype=np.dtype(dt))

    clip = staticmethod(np.clip)
    transpose = staticmethod(np.transpose)
    moveaxis = staticmethod(np.moveaxis)

    @staticmethod
    def mean(x, axes=None):
        return x.mean() if axes is None else x.mean(axis=axes, keepdims=True)

    @staticmethod
    def std(x, axes=None):
        return x.std() if axes is None else x.std(axis=axes, keepdims=True)

    @staticmethod
    def pad(x, width):
        return np.pad(x, width)


NUMPY = _NumpyNS()


def torch_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (``int32`` -> ``torch.int32``)."""
    return getattr(torch, dtype_name(np.dtype(dt)))


class TorchNS:
    """The device namespace: torch tensors, wherever they lie.  Constant
    vectors are made once per device and kept (:meth:`const`): a fused
    stage runs its callable once eagerly before capturing it, and the
    captured run then finds them made, since a capture cannot copy from
    the host."""

    name = "torch"

    def __init__(self):
        self._consts: Dict[tuple, torch.Tensor] = {}

    @staticmethod
    def kind(x) -> str:
        return numpy_dtype(x.dtype).kind

    @staticmethod
    def astype(x, dt):
        return x.to(torch_dtype(dt))

    def const(self, values, dt, like):
        key = (tuple(values), np.dtype(dt).str, like.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(
                list(values), dtype=torch_dtype(dt), device=like.device)
        return t

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def transpose(x, axes):
        return x.permute(*axes)

    @staticmethod
    def moveaxis(x, frm, to):
        return torch.movedim(x, frm, to)

    @staticmethod
    def mean(x, axes=None):
        return x.mean() if axes is None else x.mean(dim=axes, keepdim=True)

    @staticmethod
    def std(x, axes=None):
        if axes is None:
            return x.std(correction=0)
        return x.std(dim=axes, correction=0, keepdim=True)

    @staticmethod
    def pad(x, width):
        flat: List[int] = []
        for before, after in reversed(width):  # F.pad lists the last dim first
            flat += [before, after]
        return F.pad(x, flat)


def _saturate_cast(xp, x, dtype):
    """Float -> integer cast with ONE semantic on both paths: saturate at
    the target's range.  A raw cast wraps on numpy (300.2 -> uint8 44)
    and is undefined in C++ for out-of-range values, so the value is
    clamped first: in float32 for targets of up to 16 bits (whose bounds
    float32 holds exactly), in float64 for 32-bit targets (whose bounds it
    does not), on both namespaces.  NaN stays out of the contract."""
    dt = np.dtype(dtype)
    if dt.kind in "iu" and xp.kind(x) == "f" and dt.itemsize <= 4:
        info = np.iinfo(dt)
        if dt.itemsize == 4:
            x = xp.astype(x, np.float64)
        x = xp.clip(x, info.min, info.max)
    return xp.astype(x, dt)


class Ops:
    """Mode implementations, over the array namespace ``xp``."""

    @staticmethod
    def typecast(xp, x, dtype):
        return _saturate_cast(xp, x, dtype)

    @staticmethod
    def arithmetic(xp, x, ops: Sequence[_ArithOp]):
        for op in ops:
            if op.name == "typecast":
                # the same saturating cast as mode=typecast
                x = _saturate_cast(xp, x, op.value)
                continue
            v = op.value
            # one promotion rule on both paths: float constants lift
            # integer tensors to float32
            if xp.kind(x) in "iu":
                if _promotes_to_float(op):
                    x = xp.astype(x, np.float32)
                elif isinstance(v, float):
                    v = int(v)
            if op.per_channel_dim is not None and isinstance(v, (list, tuple)):
                dt = numpy_dtype(x.dtype) if xp.kind(x) == "f" else np.float32
                shape = [1] * x.ndim
                shape[_np_axis(x.ndim, op.per_channel_dim)] = len(v)
                v = xp.const(v, dt, x).reshape(shape)
            if op.name == "add":
                x = x + v
            elif op.name == "sub":
                x = x - v
            elif op.name == "mul":
                x = x * v
            elif op.name == "div":
                x = x / v
            elif op.name == "pow":
                x = x**v
            else:
                raise ElementError(f"unknown arithmetic op {op.name!r}")
        return x

    @staticmethod
    def transpose(xp, x, order: Sequence[int]):
        r = x.ndim
        axes = [_np_axis(r, order[_np_axis(r, a)]) for a in range(r)]
        return xp.transpose(x, axes)

    @staticmethod
    def dimchg(xp, x, frm: int, to: int):
        r = x.ndim
        return xp.moveaxis(x, _np_axis(r, frm), _np_axis(r, to))

    @staticmethod
    def clamp(xp, x, lo: float, hi: float):
        return xp.clip(x, lo, hi)

    @staticmethod
    def stand(xp, x, variant: str, per_channel: bool):
        xf = xp.astype(x, np.float32)
        # all but the channel (innermost) axis, or the whole tensor
        axes = tuple(range(xf.ndim - 1)) if per_channel else None
        mean = xp.mean(xf, axes)
        if variant == "dc-average":
            return xf - mean
        return (xf - mean) / (xp.std(xf, axes) + 1e-10)

    @staticmethod
    def padding(xp, x, pads: Dict[int, Tuple[int, int]]):
        width = [(0, 0)] * x.ndim
        for dim, (before, after) in pads.items():
            if not 0 <= dim < x.ndim:
                raise ElementError(
                    f"padding dim {dim} out of range for rank-{x.ndim} tensor"
                )
            width[_np_axis(x.ndim, dim)] = (before, after)
        return xp.pad(x, width)


def _parse_arith(option: str) -> List[_ArithOp]:
    ops: List[_ArithOp] = []
    for part in option.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ElementError(f"bad arithmetic op {part!r}")
        name, val = part.split(":", 1)
        name = name.strip().lower()
        if name == "typecast":
            ops.append(_ArithOp("typecast", dtype_from_name(val)))
            continue
        ch_dim = None
        if "@" in val:
            val, ch = val.rsplit("@", 1)
            ch_dim = int(ch)
        vals = [float(v) for v in val.split("|")]
        value: object = vals if len(vals) > 1 else vals[0]
        ops.append(_ArithOp(name, value, ch_dim))
    return ops


@register_element("tensor_transform")
class TensorTransform(Element):
    kind = "tensor_transform"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.mode = str(self.props.get("mode", "typecast")).lower()
        self.option = str(self.props.get("option", ""))
        self._parse()

    # -- option parsing ----------------------------------------------------
    def _parse(self) -> None:
        m, o = self.mode, self.option
        if m == "typecast":
            self._dtype = dtype_from_name(o or "float32")
        elif m == "arithmetic":
            self._ops = _parse_arith(o)
        elif m == "transpose":
            self._order = [int(v) for v in o.split(":") if v != ""]
        elif m == "dimchg":
            frm, to = o.split(":")
            self._frm, self._to = int(frm), int(to)
        elif m == "clamp":
            lo, hi = o.split(":")
            self._lo, self._hi = float(lo), float(hi)
        elif m == "stand":
            parts = o.split(":") if o else ["default"]
            self._variant = parts[0] or "default"
            self._per_channel = "per-channel" in parts
        elif m == "padding":
            self._pads: Dict[int, Tuple[int, int]] = {}
            for item in o.split(","):
                item = item.strip()
                if not item:
                    continue
                d, b, a = item.split(":")
                self._pads[int(d)] = (int(b), int(a))
        else:
            raise ElementError(f"unknown transform mode {self.mode!r}")

    # -- spec propagation --------------------------------------------------
    def _out_spec_one(self, spec: TensorSpec) -> TensorSpec:
        m = self.mode
        dims, dtype = spec.dims, spec.dtype
        if m == "typecast":
            dtype = self._dtype
        elif m == "arithmetic":
            for op in self._ops:
                if op.name == "typecast":
                    dtype = op.value
                    continue
                if dtype.kind in "iu" and _promotes_to_float(op):
                    dtype = np.dtype(np.float32)
        elif m == "transpose":
            order = self._order + list(range(len(self._order), len(dims)))
            dims = tuple(dims[order[i]] for i in range(len(dims)))
        elif m == "dimchg":
            d = list(dims)
            v = d.pop(self._frm)
            d.insert(self._to, v)
            dims = tuple(d)
        elif m == "stand":
            dtype = np.dtype(np.float32)
        elif m == "padding":
            d = list(dims)
            for dim, (b, a) in self._pads.items():
                if not 0 <= dim < len(d):
                    raise ElementError(
                        f"padding dim {dim} out of range for rank-{len(d)} tensor"
                    )
                d[dim] += b + a
            dims = tuple(d)
        return TensorSpec(dims, dtype, spec.name)

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        return in_spec.replace(specs=tuple(self._out_spec_one(s) for s in in_spec))

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        spec = src.spec
        caps = Caps.tensors(self.out_spec(spec) if spec is not None else None)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- math (shared by host + device paths) ------------------------------
    def _apply(self, xp, x):
        m = self.mode
        if m == "typecast":
            return Ops.typecast(xp, x, self._dtype)
        if m == "arithmetic":
            return Ops.arithmetic(xp, x, self._ops)
        if m == "transpose":
            order = self._order + list(range(len(self._order), x.ndim))
            return Ops.transpose(xp, x, order)
        if m == "dimchg":
            return Ops.dimchg(xp, x, self._frm, self._to)
        if m == "clamp":
            return Ops.clamp(xp, x, self._lo, self._hi)
        if m == "stand":
            return Ops.stand(xp, x, self._variant, self._per_channel)
        if m == "padding":
            return Ops.padding(xp, x, self._pads)
        raise ElementError(self.mode)

    def process(self, pad, buf: Buffer):
        return [(SRC, self.transform(buf))]

    def transform(self, buf: Buffer) -> Buffer:
        outs = [np.asarray(self._apply(NUMPY, _to_numpy(t))) for t in buf.tensors]
        spec = None
        if buf.spec is not None:
            try:
                spec = self.out_spec(buf.spec)
            except ElementError:  # the spec stays derived from the payload
                spec = None
        return buf.with_tensors(outs, spec=spec)

    def device_fn(self, in_spec: TensorsSpec):
        xp = TorchNS()

        def fn(arrays: Tuple) -> Tuple:
            return tuple(self._apply(xp, a) for a in arrays)

        return fn, self.out_spec(in_spec)
