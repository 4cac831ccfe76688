"""Trainer checkpoints and serve-stream snapshot files.

Port of ``nnstreamer_tpu/trainer/checkpoint.py``.

**Checkpoints** (:func:`save_checkpoint`, :func:`load_checkpoint`): the
JAX package's portable form, one pickle of ``{"params", "opt_state",
"step"}`` with every leaf a host numpy array (the port has no orbax).
``opt_state`` is the port trainer's own (``trainer/subplugin.py``: the
optimizer's name, its step count and its per-parameter moments).  With
``fsync=True`` the blob goes to a temporary sibling, is flushed and
``os.fsync``'d, and is renamed over the path: a crash mid-write leaves the
previous checkpoint whole.  A checkpoint is read by a restricted
unpickler that builds numpy arrays and nothing else: the JAX package's
``opt_state`` holds pickled optax classes, which the port cannot import,
so such a file (and an orbax directory) raises :class:`CheckpointError`
by name.

**Snapshots**: one drained continuous-serving stream
(:meth:`~..pipeline.runtime.Pipeline.drain_stream`) as a single pickle,
with a version number an adopt checks before it restores anything.

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
from typing import Any, Dict, Optional, Tuple

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


class CheckpointError(ValueError):
    """A checkpoint this port cannot read."""


def to_host_tree(tree: Any) -> Any:
    """``tree`` with every array leaf (a torch tensor on any device, a
    numpy array) as a host numpy array; dicts, lists and tuples keep their
    structure, other leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: to_host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def save_checkpoint(path: str, params: Any, opt_state: Any = None, step: int = 0,
                    fsync: bool = False) -> str:
    """Write ``(params, opt_state, step)`` as one pickle of host arrays;
    returns the absolute path written.  ``fsync=True`` writes a temporary
    sibling, flushes and ``os.fsync``'s it and renames it over ``path``."""
    blob = {"params": to_host_tree(params), "opt_state": to_host_tree(opt_state),
            "step": int(step)}
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not fsync:
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        return path
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # a failed write leaves no temporary behind
            os.remove(tmp)
    return path


class _ArraysOnly(pickle.Unpickler):
    """Builds numpy arrays, dicts, lists and scalars; any other class
    raises :class:`CheckpointError` naming it."""

    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module.split(".")[0] == "optax":
            raise CheckpointError(
                f"{self.path}: a JAX-written checkpoint (its opt_state holds "
                f"optax's {name}); the port cannot read optax optimizer state")
        raise CheckpointError(f"{self.path}: holds {module}.{name}, which a "
                              "checkpoint of this port never does")


def load_checkpoint(path: str) -> Tuple[Any, Optional[Any], int]:
    """Read a checkpoint written by :func:`save_checkpoint`; returns
    ``(params, opt_state, step)`` as host numpy trees.  A JAX-written
    checkpoint whose ``opt_state`` is optax's, or an orbax directory,
    raises :class:`CheckpointError`; one written by the JAX package with
    no ``opt_state`` reads."""
    if os.path.isdir(path):
        raise CheckpointError(
            f"{path}: an orbax checkpoint directory; the port reads the "
            "portable pickle form only")
    with open(path, "rb") as f:
        blob = _ArraysOnly(f, path).load()
    return blob["params"], blob.get("opt_state"), int(blob.get("step", 0))


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
