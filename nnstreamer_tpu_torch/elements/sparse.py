"""Sparse tensor wire format: tensor_sparse_enc / tensor_sparse_dec.

Port of ``nnstreamer_tpu/elements/sparse.py``; the wire bytes are the JAX
package's, bitwise.  A card tensor is fetched once to encode it; a
bfloat16 tensor's values travel as their raw 16 bits, and decode to a
bfloat16 torch tensor where numpy has no bfloat16 type (no
``ml_dtypes``).  Reference analog: ``gsttensor_sparseenc.c`` /
``gsttensor_sparsedec.c`` / ``gsttensor_sparseutil.c``: COO (index,
value) pairs to cut bandwidth for sparse data before IPC/network hops.

Wire layout per tensor (little-endian), mirroring the reference's
self-describing header idea:

    uint32 magic 0x53505253 ("SPRS") | uint32 rank | uint32 dims[rank]
    | uint32 dtype_name_len | dtype_name utf-8 | uint64 nnz
    | uint32 indices[nnz] (flat, C-order of the numpy shape) | values[nnz]

Encoded output is a single uint8 tensor per input tensor (FLEXIBLE stream).
"""

from __future__ import annotations

import struct
import numpy as np
import torch

from ..core.buffer import Buffer, _to_numpy
from ..core.caps import Caps, MediaType
from ..core.registry import register_element
from ..core.types import (TensorFormat, TensorsSpec, bfloat16, dtype_from_name,
                          dtype_name)
from .base import Element, ElementError, SRC

_MAGIC = 0x53505253


def _pack(shape, name: str, nz: np.ndarray, values: bytes) -> np.ndarray:
    header = struct.pack(f"<II{len(shape)}II", _MAGIC, len(shape),
                         *[int(d) for d in shape], len(name))
    body = (name.encode() + struct.pack("<Q", len(nz))
            + nz.astype(np.uint32).tobytes() + values)
    return np.frombuffer(header + body, np.uint8)


def sparse_encode_array(x) -> np.ndarray:
    """One tensor (numpy, or torch on any device) -> its wire bytes."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        flat = x.detach().cpu().reshape(-1)
        nz = torch.nonzero(flat).reshape(-1).numpy()
        values = flat.view(torch.int16).numpy()[nz].tobytes()
        return _pack(tuple(x.shape), "bfloat16", nz, values)
    x = _to_numpy(x)
    flat = x.ravel()
    nz = np.flatnonzero(flat)
    return _pack(x.shape, dtype_name(x.dtype), nz, flat[nz].tobytes())


def sparse_decode_array(blob):
    """Wire bytes -> the dense tensor (numpy; a bfloat16 torch tensor where
    numpy has no bfloat16 type)."""
    raw = bytes(_to_numpy(blob).astype(np.uint8, copy=False).tobytes())
    magic, rank = struct.unpack_from("<II", raw, 0)
    if magic != _MAGIC:
        raise ElementError("not a sparse-encoded tensor (bad magic)")
    off = 8
    shape = struct.unpack_from(f"<{rank}I", raw, off)
    off += 4 * rank
    (name_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    dtype = dtype_from_name(raw[off:off + name_len].decode())
    off += name_len
    (nnz,) = struct.unpack_from("<Q", raw, off)
    off += 8
    idx = np.frombuffer(raw, np.uint32, count=nnz, offset=off)
    off += 4 * nnz
    stand_in = dtype == bfloat16 and bfloat16.names is not None
    vdtype = np.dtype(np.int16) if stand_in else dtype
    values = np.frombuffer(raw, vdtype, count=nnz, offset=off)
    out = np.zeros(int(np.prod(shape)) if shape else 1, vdtype)
    out[idx] = values
    if stand_in:
        return torch.from_numpy(out).view(torch.bfloat16).reshape(shape)
    return out.reshape(shape)


@register_element("tensor_sparse_enc", aliases=("tensor_sparseenc",))
class TensorSparseEnc(Element):
    kind = "tensor_sparse_enc"

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        caps = Caps.new(MediaType.FLEX_TENSORS)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process(self, pad, buf: Buffer):
        blobs = [sparse_encode_array(t) for t in buf.tensors]
        spec = TensorsSpec.of(blobs, format=TensorFormat.SPARSE)
        return [(SRC, buf.with_tensors(blobs, spec=spec))]


@register_element("tensor_sparse_dec", aliases=("tensor_sparsedec",))
class TensorSparseDec(Element):
    kind = "tensor_sparse_dec"

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        self.out_caps = {p: Caps.new(MediaType.TENSORS) for p in out_pads}
        return self.out_caps

    def process(self, pad, buf: Buffer):
        outs = [sparse_decode_array(t) for t in buf.tensors]
        return [(SRC, buf.with_tensors(outs, spec=TensorsSpec.of(outs)))]
