"""Sub-plugin and element registries.

Port of ``nnstreamer_tpu/core/registry.py`` (reference:
``nnstreamer_subplugin.c`` name->vtable hash plus GStreamer's element
factory).  Sub-plugins are Python classes registered under a (kind, name)
key via decorators; the built-in modules are imported lazily on first
lookup, and after them the user's plugin modules that the config lists
(``NNS_TPU_PLUGINS=pkg.mod:pkg2.mod2``, the JAX package's variable, or
``[common] plugin_modules``): an absent one is skipped, one that exists
and fails to import raises.  This registry is the port's own: registering
here never touches the JAX package's registry.
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from .log import logger

KIND_ELEMENT = "element"
KIND_FILTER = "filter"
KIND_DECODER = "decoder"
KIND_CONVERTER = "converter"
KIND_TRAINER = "trainer"

_registry: Dict[Tuple[str, str], type] = {}
_aliases: Dict[Tuple[str, str], str] = {}
_lock = threading.RLock()
_builtins_loaded = False
log = logger(__name__)

#: Modules imported lazily on first lookup; each registers its plugins at
#: import time.  The port carries the elements of the LLM stream paths
#: (appsrc ! tensor_filter framework=llm ! tensor_sink), of the query
#: front door in front of them (tensor_query_serversrc/serversink/client),
#: of the vision and audio paths (videotestsrc, audiotestsrc,
#: tensor_converter, tensor_transform, tensor_filter framework=jax,
#: tensor_decoder with image_labeling, bounding_boxes, pose_estimation,
#: image_segment and ctc), the routing elements (tee, tensor_mux,
#: tensor_demux, tensor_merge, tensor_split, join, tensor_crop,
#: fakesink), the serialisation converters and decoders (flatbuf,
#: flexbuf, protobuf, python3, octet_stream), direct_video and
#: tensor_region, the file and sensor sources (filesrc, tensor_src_iio,
#: v4l2src), filesink, tensor_aggregator, the GStreamer base elements
#: (queue, compositor, videoconvert, videoscale), tensor_if,
#: tensor_rateadjust, tensor_reposink/reposrc, tensor_sparse_enc/dec,
#: tensor_debug, the remote transports (edgesink/edgesrc, mqttsink/mqttsrc,
#: tensor_sink_grpc/tensor_src_grpc, shmsink/shmsrc), datareposink/src,
#: tensor_trainer with its trainer sub-plugin (``jax``), the python3,
#: torch/pytorch, onnxruntime and tflite frameworks, the loadable .so
#: filters (custom, custom-so, cpp), and the custom-easy framework of the
#: tests.
_BUILTIN_MODULES = [
    "nnstreamer_tpu_torch.elements.source",
    "nnstreamer_tpu_torch.elements.converter",
    "nnstreamer_tpu_torch.elements.transform",
    "nnstreamer_tpu_torch.elements.filter",
    "nnstreamer_tpu_torch.elements.decoder",
    "nnstreamer_tpu_torch.elements.routing",
    "nnstreamer_tpu_torch.elements.crop",
    "nnstreamer_tpu_torch.elements.sink",
    "nnstreamer_tpu_torch.elements.query",
    "nnstreamer_tpu_torch.elements.aggregator",
    "nnstreamer_tpu_torch.elements.video",
    "nnstreamer_tpu_torch.elements.cond",
    "nnstreamer_tpu_torch.elements.rate",
    "nnstreamer_tpu_torch.elements.repo",
    "nnstreamer_tpu_torch.elements.sparse",
    "nnstreamer_tpu_torch.elements.debug",
    "nnstreamer_tpu_torch.elements.edge",
    "nnstreamer_tpu_torch.elements.mqtt",
    "nnstreamer_tpu_torch.elements.grpc_io",
    "nnstreamer_tpu_torch.elements.shm",
    "nnstreamer_tpu_torch.elements.datarepo",
    "nnstreamer_tpu_torch.elements.trainer",
    "nnstreamer_tpu_torch.filters.llm",
    "nnstreamer_tpu_torch.filters.device_fw",
    "nnstreamer_tpu_torch.filters.custom_easy",
    "nnstreamer_tpu_torch.filters.custom_so",
    "nnstreamer_tpu_torch.filters.python3",
    "nnstreamer_tpu_torch.filters.torch_fw",
    "nnstreamer_tpu_torch.filters.gated",
    "nnstreamer_tpu_torch.trainer.subplugin",
    "nnstreamer_tpu_torch.decoders.image_labeling",
    "nnstreamer_tpu_torch.decoders.bounding_boxes",
    "nnstreamer_tpu_torch.decoders.pose",
    "nnstreamer_tpu_torch.decoders.image_segment",
    "nnstreamer_tpu_torch.decoders.direct_video",
    "nnstreamer_tpu_torch.decoders.serialize",
    "nnstreamer_tpu_torch.decoders.ctc",
    "nnstreamer_tpu_torch.converters.serialize",
]


def register(kind: str, name: str, cls=None, *, aliases: Iterable[str] = ()):
    """Register ``cls`` under (kind, name); usable as a decorator."""

    def do(c):
        with _lock:
            _registry[(kind, name)] = c
            for a in aliases:
                _aliases[(kind, a)] = name
        return c

    return do(cls) if cls is not None else do


def register_element(name: str, cls=None, **kw):
    return register(KIND_ELEMENT, name, cls, **kw)


def register_filter(name: str, cls=None, **kw):
    return register(KIND_FILTER, name, cls, **kw)


def register_decoder(name: str, cls=None, **kw):
    return register(KIND_DECODER, name, cls, **kw)


def register_converter(name: str, cls=None, **kw):
    return register(KIND_CONVERTER, name, cls, **kw)


def register_trainer(name: str, cls=None, **kw):
    return register(KIND_TRAINER, name, cls, **kw)


def _ensure_builtins():
    global _builtins_loaded
    if _builtins_loaded:
        return
    with _lock:
        if _builtins_loaded:
            return
        _builtins_loaded = True  # set first: modules may look things up
        from .config import get_config

        for mod in _BUILTIN_MODULES + get_config().plugin_modules:
            try:
                importlib.import_module(mod)
            except ImportError as e:
                # the module itself absent (optional, not installed): fine;
                # a module that exists and fails to import is a real bug
                # whose elements would silently vanish: raise
                if e.name != mod:
                    raise
                log.debug("plugin module %s absent: %s", mod, e)


def lookup(kind: str, name: str) -> Optional[type]:
    _ensure_builtins()
    with _lock:
        key = (kind, name)
        if key in _aliases:
            key = (kind, _aliases[key])
        return _registry.get(key)


def get(kind: str, name: str) -> type:
    cls = lookup(kind, name)
    if cls is None:
        raise KeyError(
            f"no {kind} sub-plugin named {name!r}; known: {sorted(names(kind))}"
        )
    return cls


def names(kind: str) -> List[str]:
    _ensure_builtins()
    with _lock:
        return sorted(n for k, n in _registry if k == kind)


def aliases_of(kind: str, name: str) -> List[str]:
    """Registered aliases resolving to ``(kind, name)`` (introspection)."""
    _ensure_builtins()
    with _lock:
        return sorted(alias for (k, alias), target in _aliases.items()
                      if k == kind and target == name)
