"""Model zoo: named models loadable by ``tensor_filter``.

Port of ``nnstreamer_tpu/models/zoo.py``, cut to the llama presets,
the vision and audio models of BASELINE's configs #1-#4
(``mobilenet_v1``; ``ssd_mobilenet``, ``yolov5``, ``yolov8``,
``yolov5s``; ``posenet``; ``deeplab_mobilenet``; ``speech_commands``,
``wav2vec2``) and the test models ``passthrough``, ``scaler`` and
``average``.  A model is a ``ModelBundle`` (callable, params, IO specs); the zoo maps
pipeline-string names (``model=llama2_7b``) to builder functions that
take the filter's parsed ``custom=`` options and the device to build on.
``model=`` also takes a model FILE: a ``.tflite`` (``models/tflite.py``)
or ``.onnx`` (``models/onnx.py``) graph, or a Llama-family checkpoint
(``.gguf``, ``.safetensors``, a ``*.safetensors.index.json`` shard
index, a HF checkpoint directory or an ``.npz``), each built on the
filter's device; and a ``pkg.mod:attr`` import string.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode

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
    #: the text tokenizer a model file carries (a GGUF's ``tokenizer.ggml.*``
    #: vocab, models/tokenizer.py); the llm framework prefers it to its
    #: byte-level fallback
    tokenizer: object = None
    #: a (partial) tree of ``parallel.sharding.P`` over ``params``: the
    #: leaves to cut over a mesh's ``model`` axis (None: replicate all)
    param_pspecs: object = None


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
                    "segment", "audio", "testmodels"):
            importlib.import_module(f"nnstreamer_tpu_torch.models.{mod}")


def model_names() -> List[str]:
    _ensure_builtin()
    with _lock:
        return sorted(_builders)


#: model-file suffixes (the JAX package's)
_FILE_SUFFIXES = (".safetensors", ".safetensors.index.json", ".npz", ".gguf",
                  ".tflite", ".onnx")


class _MetaBuild(TorchFunctionMode):
    """Everything a builder makes lands on the meta device: factory calls
    and ``Tensor.to`` get ``device="meta"``, numpy arrays taken in become
    meta tensors.  A builder's own CPU generators still draw (on meta, a
    draw is a shape), so a model of any size is built without storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _constructors():
            kwargs["device"] = "meta"
        elif func in (torch.Tensor.to, torch.Tensor.cuda):
            args = tuple("meta" if isinstance(a, (torch.device, str)) else a
                         for a in args)
            if "device" in kwargs:
                kwargs["device"] = "meta"
            kwargs.pop("non_blocking", None)
            if func is torch.Tensor.cuda:
                return args[0]
        elif func is torch.Tensor.pin_memory:
            return args[0]
        out = func(*args, **kwargs)
        if func in (torch.from_numpy, torch.as_tensor) and \
                isinstance(out, torch.Tensor):
            out = out.to("meta")
        return out


def _constructors():
    from torch.utils._device import _device_constructors

    return _device_constructors()


def build(name: str, opts: Optional[Dict[str, str]] = None, *,
          device) -> ModelBundle:
    """Resolve a model to a bundle built on ``device`` (required: no
    builder of this package picks the CPU by itself).

    Accepts zoo names, ``.tflite`` and ``.onnx`` graphs, Llama-family
    model files and checkpoint directories (``llama.build_from_checkpoint``)
    and ``pkg.mod:attr``
    import strings (attr may be a bundle or a ``builder(opts, device)``).
    ``device="meta"`` builds the model abstractly (:class:`_MetaBuild`)."""
    _ensure_builtin()
    opts = dict(opts or {})
    key = str(name)
    dev = torch.device(device)
    if dev.type == "meta":  # abstract: built on the CPU's path, no storage
        with _MetaBuild():
            return build(name, opts, device="cpu")
    with _lock:
        b = _builders.get(key)
    if b is not None:
        return b(opts, dev)
    is_ckpt_dir = os.path.isdir(key) and (
        os.path.exists(os.path.join(key, "model.safetensors.index.json"))
        or os.path.exists(os.path.join(key, "model.safetensors")))
    if key.endswith(_FILE_SUFFIXES) or is_ckpt_dir:
        if not os.path.exists(key):
            raise KeyError(f"model file not found: {key}")
        if key.endswith(".tflite"):
            from . import tflite

            return tflite.load_bundle(key, opts, device=dev)
        if key.endswith(".onnx"):
            from . import onnx

            return onnx.load_bundle(key, opts, device=dev)
        from . import llama

        return llama.build_from_checkpoint(key, opts, device=dev)
    if ":" in key:
        mod_name, attr = key.split(":", 1)
        obj = getattr(importlib.import_module(mod_name), attr)
        if isinstance(obj, ModelBundle):
            return obj
        if callable(obj):
            out = obj(opts, dev)
            if isinstance(out, ModelBundle):
                return out
    raise KeyError(f"unknown model {name!r}; zoo has {model_names()}")
