"""Tensor type system: the ABI every element shares.

Port of ``nnstreamer_tpu/core/types.py`` (the reference's
``tensor_common.c`` + ``tensor_typedef.h`` plumbing):

* ``GstTensorInfo``  -> :class:`TensorSpec`   (name, dtype, dims)
* ``GstTensorsInfo`` -> :class:`TensorsSpec`  (up to ``TENSOR_COUNT_LIMIT`` specs)

dtypes are numpy dtypes; a spec of a torch tensor maps its dtype through
:func:`numpy_dtype`.  ``bfloat16`` is ``ml_dtypes``' numpy type where
that package is installed, and otherwise a 2-byte stand-in that only
names the type in a spec: a bf16 payload then stays a torch tensor.  dims keep nnstreamer's innermost-first string
syntax ("3:224:224:1" = C:W:H:N); :attr:`TensorSpec.shape` is the
outermost-first shape torch and numpy use.
"""

from __future__ import annotations

import dataclasses
import math
import re
from enum import Enum
from typing import Iterable, Sequence, Tuple, Union

import numpy as np

try:  # bfloat16 as a numpy extension dtype, when available
    import ml_dtypes

    bfloat16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover - depends on the installation
    bfloat16 = np.dtype([("bfloat16", "<u2")])

#: Maximum rank of a single tensor (reference: NNS_TENSOR_RANK_LIMIT == 16).
TENSOR_RANK_LIMIT = 16
#: Maximum number of tensors in one stream buffer (reference: 16 + "extra").
TENSOR_COUNT_LIMIT = 256


class TensorFormat(str, Enum):
    """Stream-level tensor format (reference: _tensor_format)."""

    STATIC = "static"  # shapes fixed at negotiation time
    FLEXIBLE = "flexible"  # every buffer carries its own spec header
    SPARSE = "sparse"  # COO index+value wire format


# name -> numpy dtype. Reference: tensor_element_typename[] in tensor_common.c.
_DTYPE_NAMES = {
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int16": np.dtype(np.int16),
    "uint16": np.dtype(np.uint16),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
    "int64": np.dtype(np.int64),
    "uint64": np.dtype(np.uint64),
    "float16": np.dtype(np.float16),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
}
_DTYPE_NAMES["bfloat16"] = bfloat16
_DTYPE_TO_NAME = {v: k for k, v in reversed(_DTYPE_NAMES.items())}


def dtype_from_name(name: str) -> np.dtype:
    """Map a pipeline-string type name to a numpy dtype."""
    key = name.strip().lower()
    if key in _DTYPE_NAMES:
        return _DTYPE_NAMES[key]
    try:
        return np.dtype(key)
    except TypeError as e:
        raise ValueError(f"unknown tensor dtype name: {name!r}") from e


def dtype_name(dtype) -> str:
    dt = np.dtype(dtype)
    if dt in _DTYPE_TO_NAME:
        return _DTYPE_TO_NAME[dt]
    return dt.name


def numpy_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype (``torch.int32`` ->
    ``int32``).  Torch dtypes print as ``torch.<name>``."""
    s = str(dtype)
    if s.startswith("torch."):
        return dtype_from_name(s[len("torch."):])
    return np.dtype(dtype)


def parse_dims(text: str) -> Tuple[int, ...]:
    """Parse an nnstreamer dimension string, e.g. ``"3:224:224:1"``.

    Innermost dimension first (reference: gst_tensor_parse_dimension).
    Trailing ``0`` components are dropped.  Rank is capped at
    :data:`TENSOR_RANK_LIMIT`.
    """
    parts = [p for p in text.strip().split(":") if p != ""]
    if not parts:
        raise ValueError(f"empty dimension string: {text!r}")
    if len(parts) > TENSOR_RANK_LIMIT:
        raise ValueError(
            f"rank {len(parts)} exceeds TENSOR_RANK_LIMIT={TENSOR_RANK_LIMIT}: {text!r}"
        )
    dims = []
    for p in parts:
        v = int(p)
        if v < 0:
            raise ValueError(f"negative dimension in {text!r}")
        dims.append(v)
    while dims and dims[-1] == 0:
        dims.pop()
    if not dims or any(d == 0 for d in dims):
        raise ValueError(f"invalid (zero) dimension inside {text!r}")
    return tuple(dims)


def dims_to_string(dims: Sequence[int]) -> str:
    return ":".join(str(int(d)) for d in dims)


def dims_equal(a: Sequence[int], b: Sequence[int]) -> bool:
    """Compare dims ignoring trailing 1s (reference: gst_tensor_dimension_is_equal)."""
    la, lb = list(a), list(b)
    while la and la[-1] == 1:
        la.pop()
    while lb and lb[-1] == 1:
        lb.pop()
    return la == lb


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Static description of one tensor in a stream (reference: GstTensorInfo).

    ``dims`` is innermost-first (nnstreamer order); :attr:`shape` is the
    outermost-first shape.
    """

    dims: Tuple[int, ...]
    dtype: np.dtype = np.dtype(np.uint8)
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if len(self.dims) > TENSOR_RANK_LIMIT:
            raise ValueError(f"rank>{TENSOR_RANK_LIMIT}: {self.dims}")
        # Zero-size dims are legal for concrete arrays (an empty token
        # piece in a FLEXIBLE stream); the string parse path rejects 0.
        if any(d < 0 for d in self.dims):
            raise ValueError(f"negative dim: {self.dims}")

    @classmethod
    def from_string(cls, dims: str, dtype: str = "uint8", name: str = "") -> "TensorSpec":
        return cls(parse_dims(dims), dtype_from_name(dtype), name)

    @classmethod
    def from_shape(cls, shape: Sequence[int], dtype=np.uint8, name: str = "") -> "TensorSpec":
        """Build from an outermost-first shape."""
        return cls(tuple(reversed([int(s) for s in shape])), numpy_dtype(dtype), name)

    @classmethod
    def of(cls, array) -> "TensorSpec":
        """Spec describing a concrete numpy array or torch tensor."""
        return cls.from_shape(tuple(array.shape), array.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(reversed(self.dims))

    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def count(self) -> int:
        return int(math.prod(self.dims)) if self.dims else 0

    @property
    def nbytes(self) -> int:
        return self.count * self.dtype.itemsize

    def is_compatible(self, other: "TensorSpec") -> bool:
        return self.dtype == other.dtype and dims_equal(self.dims, other.dims)

    def to_string(self) -> str:
        return f"{dims_to_string(self.dims)},{dtype_name(self.dtype)}"


@dataclasses.dataclass(frozen=True)
class TensorsSpec:
    """Description of all tensors in one stream buffer (GstTensorsInfo/Config).

    ``rate`` is the stream framerate as a (numerator, denominator) fraction;
    (0, 1) means "not applicable / not negotiated".
    """

    specs: Tuple[TensorSpec, ...] = ()
    format: TensorFormat = TensorFormat.STATIC
    rate: Tuple[int, int] = (0, 1)

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        object.__setattr__(self, "format", TensorFormat(self.format))
        if len(self.specs) > TENSOR_COUNT_LIMIT:
            raise ValueError(f"too many tensors: {len(self.specs)}")

    @classmethod
    def from_string(
        cls,
        dimensions: str,
        types: str = "",
        names: str = "",
        format: Union[str, TensorFormat] = TensorFormat.STATIC,
        rate: Tuple[int, int] = (0, 1),
    ) -> "TensorsSpec":
        """Parse comma-separated per-tensor ``dimensions``/``types``/``names``
        (the reference's ``dimensions=3:224:224,10 types=uint8,float32``)."""
        dim_parts = [d for d in dimensions.split(",") if d.strip()]
        type_parts = [t for t in types.split(",") if t.strip()] if types else []
        name_parts = names.split(",") if names else []
        specs = []
        for i, d in enumerate(dim_parts):
            t = type_parts[i] if i < len(type_parts) else "uint8"
            n = name_parts[i].strip() if i < len(name_parts) else ""
            specs.append(TensorSpec.from_string(d, t, n))
        return cls(tuple(specs), TensorFormat(format), rate)

    @classmethod
    def of(cls, arrays: Iterable, format=TensorFormat.STATIC, rate=(0, 1)) -> "TensorsSpec":
        return cls(tuple(TensorSpec.of(a) for a in arrays), format, rate)

    def __len__(self) -> int:
        return len(self.specs)

    def __getitem__(self, i: int) -> TensorSpec:
        return self.specs[i]

    def __iter__(self):
        return iter(self.specs)

    @property
    def is_flexible(self) -> bool:
        return self.format == TensorFormat.FLEXIBLE

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs)

    def is_compatible(self, other: "TensorsSpec") -> bool:
        if self.format != other.format:
            return False
        if self.format != TensorFormat.STATIC:
            return True  # flexible/sparse: per-buffer specs decide
        if len(self.specs) != len(other.specs):
            return False
        return all(a.is_compatible(b) for a, b in zip(self.specs, other.specs))

    def replace(self, **kw) -> "TensorsSpec":
        return dataclasses.replace(self, **kw)

    def to_string(self) -> str:
        dims = ",".join(dims_to_string(s.dims) for s in self.specs)
        types = ",".join(dtype_name(s.dtype) for s in self.specs)
        return f"num={len(self.specs)} dims={dims} types={types} fmt={self.format.value}"

    def __str__(self) -> str:  # pragma: no cover
        return f"TensorsSpec({self.to_string()})"


_FRACTION_RE = re.compile(r"^\s*(\d+)\s*/\s*(\d+)\s*$")


def parse_fraction(text: Union[str, Tuple[int, int]]) -> Tuple[int, int]:
    """Parse a framerate fraction like ``"30/1"`` (GstCaps fraction field)."""
    if isinstance(text, tuple):
        return int(text[0]), int(text[1])
    m = _FRACTION_RE.match(str(text))
    if not m:
        try:
            return int(text), 1
        except ValueError:
            raise ValueError(f"bad fraction: {text!r}") from None
    return int(m.group(1)), int(m.group(2))
