"""Embedding bridge for the native C API (native/src/nnstpu_capi.cpp).

Port of ``nnstreamer_tpu/capi.py`` (reference analog: the external ML
C-API's single-shot surface — ``ml_single_open`` / ``ml_single_invoke`` /
``ml_single_close`` over ``gsttensor_filter_single.c`` — and its pipeline
surface).  The C library embeds CPython and calls THIS module; tensors
cross the boundary as raw little-endian bytes and are shaped and typed
from the model's negotiated specs, exactly like the reference's
``ml_tensors_data`` payloads.  The functions use integer handles (not
PyObject pointers) so the C side never manages Python object lifetimes.

What differs from the JAX module:

* a model runs where its framework's ``accelerator=`` property says: on
  the card by default, and with no card, opening a card framework fails
  with the port's "no CUDA device" message, which reaches the C caller's
  ``err``.  There is no platform pin to honour at a fresh embed (the JAX
  module's ``_on_fresh_embed``) and no silent CPU fallback: a C caller
  who wants the CPU names it in a pipeline description
  (``accelerator=true:cpu``) or uses a host framework (``custom``);
* outputs come to the host through one
  :func:`~.core.buffer.host_value` copy (a card tensor has no
  ``np.asarray``); ``bfloat16`` crosses as its raw 2-byte words, typed
  ``bfloat16`` in the spec string, and comes in the same way;
* every payload is copied into memory of its own before it enters a
  model or a pipeline (``np.frombuffer`` over the caller's bytes would be
  read-only, and torch refuses to own such memory).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.buffer import host_value
from .core.types import TensorsSpec, bfloat16, dims_to_string, dtype_name

_handles: Dict[int, object] = {}
_next_id = [1]
_lock = threading.Lock()


def _spec_str(spec: TensorsSpec) -> str:
    """``dims,dtype`` per tensor, ';'-joined: "3:8:8:1,float32;..." """
    if spec is None:
        return ""
    return ";".join(t.to_string() for t in spec.specs)


def _from_blob(blob: bytes, dtype: np.dtype, shape: Sequence[int] = (-1,)):
    """A payload as a writable array of its own (bf16: a CPU tensor)."""
    if dtype == bfloat16:
        return torch.frombuffer(bytearray(blob), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(bytearray(blob), dtype).reshape(shape)


def _to_blob(x) -> Tuple[bytes, Tuple[int, ...], str]:
    """(bytes, outermost-first shape, dtype name) of an output on the host."""
    x = host_value(x)
    if isinstance(x, torch.Tensor):  # bf16, which numpy cannot hold
        return (x.contiguous().view(torch.int16).numpy().tobytes(), tuple(x.shape),
                "bfloat16")
    a = np.ascontiguousarray(x)
    return a.tobytes(), a.shape, dtype_name(a.dtype)


def _register(kind: str, obj) -> int:
    with _lock:
        hid = _next_id[0]
        _next_id[0] += 1
        _handles[hid] = (kind, obj)
    return hid


def _get(hid: int, kind: str):
    entry = _handles.get(int(hid))
    if entry is None:
        raise KeyError(f"invalid {kind} handle {hid}")
    if entry[0] != kind:
        # nnstpu_single_h and nnstpu_pipeline_h are both long long in C —
        # a cross-surface mixup must fail loudly, not corrupt state
        raise TypeError(
            f"handle {hid} is a {entry[0]} handle, not {kind}")
    return entry[1]


def single_open(model: str, framework: str = "auto", custom: str = "", **props) -> int:
    """Returns a handle id; raises with a clear message on failure.
    ``props`` are further filter properties (``accelerator=`` and the
    like) for Python callers; the C entry passes none."""
    from .elements.filter import SingleShot

    if custom:
        props["custom"] = custom
    s = SingleShot(framework=framework or "auto", model=model, **props)
    return _register("single", s)


def single_info(hid: int) -> Tuple[str, str]:
    s = _get(hid, "single")
    return _spec_str(s.in_spec), _spec_str(s.out_spec)


def single_invoke_bytes(hid: int, blobs: List[bytes]) -> List[bytes]:
    s = _get(hid, "single")
    specs = s.in_spec.specs if s.in_spec is not None else None
    if specs is None:
        raise ValueError(
            "model has no static input spec; the C API needs one to type "
            "raw byte payloads")
    if len(blobs) != len(specs):
        raise ValueError(
            f"model takes {len(specs)} input tensor(s), got {len(blobs)}")
    arrays = []
    for i, (blob, spec) in enumerate(zip(blobs, specs)):
        if len(blob) != spec.nbytes:
            raise ValueError(
                f"input {i}: {len(blob)} bytes, spec "
                f"{dims_to_string(spec.dims)},{dtype_name(spec.dtype)} "
                f"needs {spec.nbytes}")
        arrays.append(_from_blob(blob, spec.dtype, spec.shape))
    return [_to_blob(o)[0] for o in s.invoke(arrays)]


def single_close(hid: int) -> None:
    _get(hid, "single")  # loud type/validity check BEFORE unregistering
    with _lock:
        entry = _handles.pop(int(hid), None)
    if entry is not None:
        entry[1].close()


# -- pipeline surface (reference: ml_pipeline_construct / src_input_data /
#    sink callbacks / destroy over the gst-launch DSL) ----------------------

def pipeline_open(desc: str) -> int:
    """Construct AND start a pipeline from the gst-launch-style string."""
    from . import Pipeline

    p = Pipeline(desc)
    p.start()
    return _register("pipeline", p)


def pipeline_push(hid: int, name: str, blobs: List[bytes]) -> None:
    """Feed one buffer (one blob per tensor) into appsrc ``name``; bytes
    are typed/shaped from the source's negotiated caps spec, or ride as
    raw uint8 when the caps carry none (the reference's flexible path)."""
    p = _get(hid, "pipeline")
    el = p.element(name)
    spec = getattr(el, "_caps", None)
    spec = spec.spec if spec is not None else None
    if spec is not None and spec.specs and not spec.is_flexible:
        if len(blobs) != len(spec.specs):
            raise ValueError(
                f"appsrc {name!r} caps carry {len(spec.specs)} tensor(s), "
                f"got {len(blobs)}")
        arrays = []
        for i, (blob, t) in enumerate(zip(blobs, spec.specs)):
            if len(blob) != t.nbytes:
                raise ValueError(
                    f"tensor {i}: {len(blob)} bytes, spec {t.to_string()} "
                    f"needs {t.nbytes}")
            arrays.append(_from_blob(blob, t.dtype, t.shape))
        p.push(name, arrays)
    elif spec is not None and spec.specs:
        # FLEXIBLE stream: per-buffer sizes legally vary — type each blob
        # from the caps dtype and ride rank-1 (per-buffer shape is the
        # producer's business, exactly like Pipeline.push of a raw array)
        p.push(name, [_from_blob(b, spec.specs[min(i, len(spec.specs) - 1)].dtype)
                      for i, b in enumerate(blobs)])
    else:
        p.push(name, [_from_blob(b, np.dtype(np.uint8)) for b in blobs])


def pipeline_pull(hid: int, name: str,
                  timeout: float = 30.0) -> Tuple[List[bytes], str]:
    """Pop one buffer from sink ``name``: (per-tensor bytes, spec desc)."""
    p = _get(hid, "pipeline")
    buf = p.pull(name, timeout=timeout)
    out = [_to_blob(t) for t in buf.tensors]
    desc = ";".join(f"{dims_to_string(tuple(reversed(shape)))},{dt}"
                    for _, shape, dt in out)
    return [b for b, _, _ in out], desc


def pipeline_eos(hid: int, name: str = "") -> None:
    p = _get(hid, "pipeline")
    if name:
        p.eos(name)
    else:
        p.eos()


def pipeline_close(hid: int) -> None:
    _get(hid, "pipeline")  # loud type/validity check BEFORE unregistering
    with _lock:
        entry = _handles.pop(int(hid), None)
    if entry is not None:
        entry[1].stop()
