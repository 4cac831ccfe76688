"""Model zoo: named models loadable by ``tensor_filter``.

Port of ``nnstreamer_tpu/models/zoo.py``, cut to the llama presets and
the vision and audio models of BASELINE's configs #1-#4
(``mobilenet_v1``; ``ssd_mobilenet``, ``yolov5``, ``yolov8``,
``yolov5s``; ``posenet``; ``deeplab_mobilenet``; ``speech_commands``,
``wav2vec2``).  A model is a ``ModelBundle`` (callable, params, IO specs); the zoo maps
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
    #: a REDUCED output variant for the residency planner
    #: (``pipeline/residency.py``): a thunk returning a bundle that shares
    #: this bundle's params but emits a smaller output (deeplab's
    #: native-stride score map).  The planner selects it only when every
    #: consumer below the filter admits any tensor geometry.  None = no
    #: reduced form exists, or the caller pinned the output.
    reduced_variant: Optional[Callable[[], "ModelBundle"]] = None
    #: what the reduced variant is (logged when selected)
    reduced_desc: str = ""


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
        for mod in ("llama", "mobilenet", "ssd", "yolo", "posenet",
                    "segment", "audio"):
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
