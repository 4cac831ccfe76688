"""Loadable custom-filter framework: ``framework=custom model=<.so path>``.

Port of ``nnstreamer_tpu/filters/custom_so.py`` (reference analog:
``tensor_filter_custom.c`` and ``tensor_filter_cpp.cc`` — dlopen a
user-compiled shared object exposing a filter vtable and drive it as a
model).  The ABI is ``native/include/nnstpu_custom.h``, the JAX package's
header copied unchanged: the .so exports

    const nnstpu_custom_class *nnstpu_custom_get(void);

so a filter built against either package's headers loads in both.

The filter is host compute by construction (raw malloc'd buffers).  A
card tensor reaches it through one copy to the host
(:func:`~..core.buffer.host_value`); its outputs are host arrays, which a
card stage below moves as it moves any host input.  ``bfloat16`` has no
dtype code in the ABI, so a bf16 input is refused with a message that
names it: the filter never casts it on its own.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.buffer import host_value
from ..core.registry import register_filter
from ..core.types import TensorSpec, TensorsSpec, bfloat16
from .base import Framework, FrameworkError

ABI_VERSION = 1
RANK_LIMIT = 8
TENSOR_LIMIT = 16

#: enum order in nnstpu_custom.h
_DTYPES = [
    np.dtype(np.int8), np.dtype(np.uint8), np.dtype(np.int16),
    np.dtype(np.uint16), np.dtype(np.int32), np.dtype(np.uint32),
    np.dtype(np.int64), np.dtype(np.uint64), np.dtype(np.float16),
    np.dtype(np.float32), np.dtype(np.float64),
]


class _TensorInfo(ctypes.Structure):
    _fields_ = [
        ("rank", ctypes.c_uint32),
        ("dims", ctypes.c_uint64 * RANK_LIMIT),
        ("dtype", ctypes.c_int32),
    ]


class _TensorsInfo(ctypes.Structure):
    _fields_ = [
        ("num", ctypes.c_uint32),
        ("info", _TensorInfo * TENSOR_LIMIT),
    ]


_INIT = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_char_p)
_FINISH = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_GETINFO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                            ctypes.POINTER(_TensorsInfo))
_INVOKE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_void_p))


class _CustomClass(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("init", _INIT),
        ("finish", _FINISH),
        ("get_input_info", _GETINFO),
        ("get_output_info", _GETINFO),
        ("invoke", _INVOKE),
    ]


def _spec_from_info(ti: _TensorsInfo) -> TensorsSpec:
    specs = []
    for i in range(int(ti.num)):
        info = ti.info[i]
        if not (0 <= info.dtype < len(_DTYPES)):
            raise FrameworkError(f"custom filter tensor {i}: bad dtype code "
                                 f"{info.dtype}")
        if not (1 <= info.rank <= RANK_LIMIT):
            raise FrameworkError(f"custom filter tensor {i}: bad rank "
                                 f"{info.rank}")
        shape = tuple(int(info.dims[r]) for r in range(int(info.rank)))
        specs.append(TensorSpec.from_shape(shape, _DTYPES[info.dtype]))
    return TensorsSpec(tuple(specs))


def _refuse_bf16(what: str) -> FrameworkError:
    return FrameworkError(
        f"custom filter {what} is bfloat16, which has no dtype code in the "
        "nnstpu_custom.h ABI; cast it upstream (tensor_transform mode=typecast)")


def _host_input(x, i: int) -> np.ndarray:
    """Input ``i`` on the host, in one copy when it lies on the card."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        raise _refuse_bf16(f"input {i}")
    x = host_value(x)
    if x.dtype == bfloat16:
        raise _refuse_bf16(f"input {i}")
    return x


@register_filter("custom", aliases=("custom-so", "cpp"))
class CustomSoFramework(Framework):
    """dlopen'd vtable filter.  ``model`` = path to the .so; the
    ``custom=`` property string is passed verbatim to the filter's init."""

    name = "custom"

    def __init__(self):
        super().__init__()
        self._lib: Optional[ctypes.CDLL] = None
        self._vt: Optional[_CustomClass] = None
        self._priv: Optional[ctypes.c_void_p] = None
        self._in: Optional[TensorsSpec] = None
        self._out: Optional[TensorsSpec] = None

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        model = str(props.get("model", ""))
        if not model.endswith(".so") or not os.path.exists(model):
            raise FrameworkError(
                f"custom filter needs an existing .so path, got {model!r}")
        try:
            self._lib = ctypes.CDLL(model)
        except OSError as e:
            raise FrameworkError(f"cannot dlopen {model!r}: {e}") from e
        try:
            get = self._lib.nnstpu_custom_get
        except AttributeError as e:
            raise FrameworkError(
                f"{model!r} exports no nnstpu_custom_get symbol "
                "(see native/include/nnstpu_custom.h)") from e
        get.restype = ctypes.POINTER(_CustomClass)
        vt_ptr = get()
        if not vt_ptr:
            raise FrameworkError(f"{model!r}: nnstpu_custom_get returned NULL")
        vt = vt_ptr.contents
        if int(vt.abi_version) != ABI_VERSION:
            raise FrameworkError(
                f"{model!r}: ABI version {int(vt.abi_version)} != "
                f"{ABI_VERSION}")
        self._vt = vt
        custom = props.get("custom")
        priv = vt.init(str(custom).encode() if custom else None)
        # NULL priv is legal for stateless filters UNLESS init signals
        # failure; the ABI uses NULL for failure, so require non-NULL when
        # the filter was given props to parse.
        self._priv = ctypes.c_void_p(priv)
        if custom and not priv:
            raise FrameworkError(f"{model!r}: init({custom!r}) failed")
        try:
            ti = _TensorsInfo()
            if vt.get_input_info(self._priv, ctypes.byref(ti)) != 0:
                raise FrameworkError(f"{model!r}: get_input_info failed")
            self._in = _spec_from_info(ti)
            to = _TensorsInfo()
            if vt.get_output_info(self._priv, ctypes.byref(to)) != 0:
                raise FrameworkError(f"{model!r}: get_output_info failed")
            self._out = _spec_from_info(to)
        except FrameworkError:
            # framework=auto probes discard failed candidates without
            # close(): release the .so's init-allocated state here.
            vt.finish(self._priv)
            self._vt = None
            self._priv = None
            raise

    def get_model_info(self):
        return self._in, self._out

    def invoke(self, inputs: Sequence) -> List[np.ndarray]:
        vt, out_spec = self._vt, self._out
        if vt is None:
            raise FrameworkError("custom filter not opened")
        if len(inputs) != len(self._in):
            raise FrameworkError(
                f"custom filter expects {len(self._in)} inputs, got "
                f"{len(inputs)}")
        arrs = []
        for i, (a, spec) in enumerate(zip(inputs, self._in)):
            a = np.ascontiguousarray(_host_input(a, i), dtype=spec.dtype)
            if a.size != int(np.prod(spec.shape)):
                raise FrameworkError(
                    f"custom filter input size {a.size} != spec {spec.shape}")
            arrs.append(a)
        outs = [np.empty(s.shape, s.dtype) for s in out_spec]
        in_ptrs = (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        rc = vt.invoke(self._priv, in_ptrs, out_ptrs)
        if rc != 0:
            raise FrameworkError(f"custom filter invoke failed (rc={rc})")
        return outs

    def close(self) -> None:
        if self._vt is not None and self._priv is not None:
            self._vt.finish(self._priv)
        self._vt = None
        self._priv = None
        self._lib = None


def include_dir() -> str:
    """Directory holding nnstpu_custom.h / nnstpu_cppclass.hh — for user
    build scripts: ``g++ -I$(python -c 'from nnstreamer_tpu_torch.filters
    import custom_so; print(custom_so.include_dir())') ...``"""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "include")
