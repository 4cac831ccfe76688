"""Model zoo: named models loadable by ``tensor_filter``.

Port of ``nnstreamer_tpu/models/zoo.py``, cut to the llama presets and
the vision models of configs #1 and #2 (``mobilenet_v1``,
``ssd_mobilenet``).  A model is a ``ModelBundle`` (callable, params, IO specs); the zoo maps
pipeline-string names (``model=llama2_7b``) to builder functions that
take the filter's parsed ``custom=`` options and the device to build on.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
from typing import Callable, Dict, List, Optional

import torch

from ..core.types import TensorsSpec


@dataclasses.dataclass
class ModelBundle:
    """A runnable model: apply fn + params + IO specs."""

    apply_fn: Callable  # (params, *inputs) -> output
    params: object
    in_spec: Optional[TensorsSpec]
    out_spec: Optional[TensorsSpec]
    name: str = "model"
    #: model geometry the llm framework drives its decode loop with
    config: object = None


_builders: Dict[str, Callable[[Dict[str, str], torch.device], ModelBundle]] = {}
_lock = threading.Lock()
_builtin_loaded = False


def register_model(name: str, builder=None):
    """``register_model("llama_tiny", builder)`` on a
    ``builder(opts, device) -> ModelBundle``."""

    def do(b):
        with _lock:
            _builders[name] = b
        return b

    return do(builder) if builder is not None else do


def _ensure_builtin():
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        for mod in ("llama", "mobilenet", "ssd"):
            importlib.import_module(f"nnstreamer_tpu_torch.models.{mod}")


def model_names() -> List[str]:
    _ensure_builtin()
    with _lock:
        return sorted(_builders)


def build(name: str, opts: Optional[Dict[str, str]] = None, *,
          device) -> ModelBundle:
    """Resolve a zoo name to a bundle built on ``device`` (required: no
    builder of this package picks the CPU by itself)."""
    _ensure_builtin()
    with _lock:
        b = _builders.get(str(name))
    if b is None:
        raise KeyError(f"unknown model {name!r}; zoo has {model_names()}")
    return b(dict(opts or {}), torch.device(device))
