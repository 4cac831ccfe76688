"""Checkpoint-file readers and writers: safetensors / npz <-> name->tensor
dicts.

Port of ``nnstreamer_tpu/models/checkpoint.py``.  The format is the same
trivial one — u64 little-endian header length, a JSON header mapping
tensor names to ``{dtype, shape, data_offsets}``, then raw little-endian
tensor bytes — read through numpy memmaps, so a 13 GB checkpoint pages
in lazily instead of being read through Python I/O.

Where the JAX package hands back numpy arrays, this module hands back
CPU ``torch.Tensor`` s over the same memmaps.  A BF16 tensor is read as
``uint16`` and reinterpreted as ``torch.bfloat16``: it needs no numpy
bfloat16 type (``ml_dtypes``), which an installation without JAX lacks.
The writers take torch tensors (any device) or numpy arrays.

Supports single files, HF sharded checkpoints via
``model.safetensors.index.json``, and ``.npz`` archives (same tensor
naming).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

#: safetensors dtype code -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_ST_CODES = {tdt: code for code, (_, tdt) in _ST_DTYPES.items()}


class CheckpointError(ValueError):
    pass


def memmap_tensor(path: str, offset: int, nbytes: int, stored, shape,
                  dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor over ``nbytes`` of ``path`` from ``offset``, stored as
    numpy ``stored`` and seen as ``dtype`` (bf16 from ``uint16``).  The
    map is copy-on-write, so the tensor is writable without touching the
    file."""
    mm = np.memmap(path, dtype=np.uint8, mode="c", offset=offset,
                   shape=(nbytes,))
    t = torch.from_numpy(mm.view(stored).reshape(shape))
    return t.view(dtype) if t.dtype != dtype else t


def as_tensor(arr) -> torch.Tensor:
    """A numpy array (``ml_dtypes`` bfloat16 included) or a tensor as a
    tensor, sharing memory where it can."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """``t``'s payload as a contiguous numpy array on the host (bf16 as its
    raw ``uint16`` patterns), for writing to a file."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Memmap-backed tensors of one .safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise CheckpointError(f"{path}: truncated safetensors header")
        n = struct.unpack("<Q", head)[0]
        if n > 100 * 1024 * 1024:
            raise CheckpointError(
                f"{path}: implausible header size {n} — not safetensors?")
        try:
            header = json.loads(f.read(n))
        except ValueError as e:
            raise CheckpointError(f"{path}: bad safetensors JSON: {e}") from e
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in _ST_DTYPES:
            raise CheckpointError(
                f"{path}: tensor {name!r} has unsupported dtype {code}")
        stored, tdt = _ST_DTYPES[code]
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = np.dtype(stored).itemsize
        want = int(np.prod(shape, dtype=np.int64)) * itemsize if shape \
            else itemsize
        if hi - lo != want:
            raise CheckpointError(
                f"{path}: tensor {name!r} byte span {hi - lo} != "
                f"shape/dtype size {want}")
        out[name] = memmap_tensor(path, base + lo, hi - lo, stored, shape, tdt)
    return out


def load_tensors(path: str) -> Dict[str, torch.Tensor]:
    """Load any supported checkpoint layout into a name->tensor dict.

    ``path`` may be a .safetensors file, a HF ``*.safetensors.index.json``
    shard index (or a directory containing one), or a .npz archive.
    """
    if os.path.isdir(path):
        idx = os.path.join(path, "model.safetensors.index.json")
        single = os.path.join(path, "model.safetensors")
        if os.path.exists(idx):
            path = idx
        elif os.path.exists(single):
            path = single
        else:
            raise CheckpointError(
                f"{path}: no model.safetensors[.index.json] in directory")
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        shards = {}
        base = os.path.dirname(path)
        out: Dict[str, torch.Tensor] = {}
        for name, shard in index["weight_map"].items():
            if shard not in shards:
                shards[shard] = read_safetensors(os.path.join(base, shard))
            out[name] = shards[shard][name]
        return out
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: as_tensor(z[k]) for k in z.files}
    raise CheckpointError(
        f"{path}: unsupported checkpoint format (want .safetensors, "
        ".safetensors.index.json, or .npz)")


def _header(tensors: Iterable[Tuple[str, torch.Tensor]]):
    header, off = {}, 0
    for name, t in tensors:
        code = _ST_CODES.get(t.dtype)
        if code is None:
            raise CheckpointError(f"unsupported dtype {t.dtype} for {name}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    return header


def write_safetensors(path: str, tensors: Dict[str, object]) -> None:
    """Emit a .safetensors file, one tensor at a time (tests, converting
    weights for reuse).  Values are torch tensors (any device) or numpy
    arrays."""
    items = [(name, as_tensor(v)) for name, v in tensors.items()]
    raw = json.dumps(_header(items)).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            host_bytes(t).tofile(f)
