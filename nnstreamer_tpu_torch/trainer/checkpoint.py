"""Serve-stream snapshot files (drain/adopt).

Port of ``save_stream_snapshot`` / ``load_stream_snapshot`` of
``nnstreamer_tpu/trainer/checkpoint.py``: one drained continuous-serving
stream (:meth:`~..pipeline.runtime.Pipeline.drain_stream`) as a single
pickle, with a version number an adopt checks before it restores
anything.  Training's own checkpoints come with the training slice.

A snapshot's KV blocks are bf16 or f32 tensors.  numpy has no bfloat16
of its own (the JAX package pickles ``ml_dtypes`` arrays, and a torch
install without JAX may lack ``ml_dtypes``), so this module writes each
torch tensor as a numpy array tagged with its torch dtype
(:data:`_TENSOR_TAG`), a bf16 one as its raw ``uint16`` bits, and reads
it back as that torch tensor (bf16 through a view): the port's own files
(``snapshot_version`` 2) load without ``ml_dtypes`` and give back what
was saved.  It also reads the JAX package's files (version 1), whose
blocks are numpy arrays (``ml_dtypes`` bf16 or f32; a bf16 one needs
``ml_dtypes`` to unpickle), and hands bf16 ones back as torch bf16.

The JAX package's loader refuses a version-2 file by its version: its
adopt could not read the raw bits or the torch generator state a sampled
port snapshot carries.  Unpickle only files this program wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

#: the version this module writes; the JAX package's files are version 1
STREAM_SNAPSHOT_VERSION = 2
_READABLE_VERSIONS = (1, STREAM_SNAPSHOT_VERSION)
#: key of the dict that stands for a torch tensor: its dtype's name, with
#: the data as a numpy array (a bf16 tensor's raw bits as uint16)
_TENSOR_TAG = "__torch_tensor__"


def _to_file(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _to_file(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_file(v) for v in x)
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return {_TENSOR_TAG: name, "data": t.numpy().view(
            np.uint16) if name == "bfloat16" else t.numpy()}
    return x


def _from_file(x: Any) -> Any:
    if isinstance(x, dict):
        if _TENSOR_TAG in x:
            data = np.ascontiguousarray(x["data"])
            if x[_TENSOR_TAG] == "bfloat16":
                return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(data)
        return {k: _from_file(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_from_file(v) for v in x)
    return host_tensor(x) if _is_numpy_bf16(x) else x


def _is_numpy_bf16(x: Any) -> bool:
    return isinstance(x, np.ndarray) and x.dtype.name == "bfloat16" \
        and x.dtype.itemsize == 2


def host_tensor(x: Any) -> torch.Tensor:
    """A snapshot's array (a torch tensor, a numpy array, an ``ml_dtypes``
    bf16 numpy array) as a CPU torch tensor of the same dtype, without a
    copy where a view will do."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if _is_numpy_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_stream_snapshot(path: str, snapshot: Dict[str, Any]) -> str:
    """Persist one drained serve-stream snapshot as a single pickle (tensors
    as host arrays, bf16 as raw bits); returns the path written."""
    blob = dict(_to_file(snapshot))
    blob["snapshot_version"] = STREAM_SNAPSHOT_VERSION
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return path


def load_stream_snapshot(path: str) -> Dict[str, Any]:
    """Read a snapshot written by :func:`save_stream_snapshot` (or by the
    JAX package's); raises ``ValueError`` on a version the adopt path
    does not understand."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    ver = blob.pop("snapshot_version", None)
    if ver not in _READABLE_VERSIONS:
        raise ValueError(
            f"stream snapshot version {ver!r} unsupported "
            f"(expected one of {_READABLE_VERSIONS})")
    return _from_file(blob)
