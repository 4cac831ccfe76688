"""Sub-plugin and element registries.

Port of ``nnstreamer_tpu/core/registry.py`` (reference:
``nnstreamer_subplugin.c`` name->vtable hash plus GStreamer's element
factory).  Sub-plugins are Python classes registered under a (kind, name)
key via decorators; the built-in modules are imported lazily on first
lookup.  This registry is the port's own: registering here never touches
the JAX package's registry.
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, Iterable, List, Optional, Tuple

KIND_ELEMENT = "element"
KIND_FILTER = "filter"
KIND_DECODER = "decoder"

_registry: Dict[Tuple[str, str], type] = {}
_aliases: Dict[Tuple[str, str], str] = {}
_lock = threading.RLock()
_builtins_loaded = False

#: Modules imported lazily on first lookup; each registers its plugins at
#: import time.  The port carries the elements of the LLM stream paths
#: (appsrc ! tensor_filter framework=llm ! tensor_sink), of the query
#: front door in front of them (tensor_query_serversrc/serversink/client)
#: and of the vision and audio paths (videotestsrc, audiotestsrc,
#: tensor_converter, tensor_transform, tensor_filter framework=jax,
#: tensor_decoder with image_labeling, bounding_boxes, pose_estimation,
#: image_segment and ctc).
_BUILTIN_MODULES = [
    "nnstreamer_tpu_torch.elements.source",
    "nnstreamer_tpu_torch.elements.converter",
    "nnstreamer_tpu_torch.elements.transform",
    "nnstreamer_tpu_torch.elements.filter",
    "nnstreamer_tpu_torch.elements.decoder",
    "nnstreamer_tpu_torch.elements.sink",
    "nnstreamer_tpu_torch.elements.query",
    "nnstreamer_tpu_torch.filters.llm",
    "nnstreamer_tpu_torch.filters.device_fw",
    "nnstreamer_tpu_torch.decoders.image_labeling",
    "nnstreamer_tpu_torch.decoders.bounding_boxes",
    "nnstreamer_tpu_torch.decoders.pose",
    "nnstreamer_tpu_torch.decoders.image_segment",
    "nnstreamer_tpu_torch.decoders.ctc",
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


def _ensure_builtins():
    global _builtins_loaded
    if _builtins_loaded:
        return
    with _lock:
        if _builtins_loaded:
            return
        _builtins_loaded = True  # set first: modules may look things up
        for mod in _BUILTIN_MODULES:
            importlib.import_module(mod)


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
