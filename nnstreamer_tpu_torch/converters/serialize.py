"""Converter sub-plugins: serialized bytes -> tensors.

Port of ``nnstreamer_tpu/converters/serialize.py`` (reference:
``tensor_converter_flatbuf`` / ``_protobuf`` / ``_flexbuf`` /
``_python3``): ``tensor_converter mode=flatbuf|flexbuf|protobuf`` reads
the one wire format of ``utils/wire.py`` that ``decoders/serialize.py``
writes, the JAX package's bytes included; ``mode=python3
script=module:function`` runs a user callable on the raw buffer.
"""

from __future__ import annotations

import importlib
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, _to_numpy
from ..core.registry import register_converter
from ..core.types import TensorsSpec
from ..utils.wire import decode_buffer


class _WireConverter:
    out_spec: Optional[TensorsSpec] = None

    def __init__(self, props):
        self.props = dict(props or {})

    def convert(self, buf: Buffer) -> Buffer:
        raw = np.ascontiguousarray(_to_numpy(buf.tensors[0]),
                                   np.uint8).tobytes()
        out, _ = decode_buffer(raw)
        out.pts = buf.pts if out.pts is None else out.pts
        return out


@register_converter("flexbuf")
class FlexbufConverter(_WireConverter):
    pass


@register_converter("flatbuf")
class FlatbufConverter(_WireConverter):
    pass


@register_converter("protobuf")
class ProtobufConverter(_WireConverter):
    pass


@register_converter("python3")
class Python3Converter:
    """User-scripted converter: ``mode=python3 script=module:function``,
    where the callable maps a Buffer to a Buffer (or to a tensor or a
    list of tensors, wrapped into one)."""

    out_spec: Optional[TensorsSpec] = None

    def __init__(self, props):
        self.props = dict(props or {})
        target = str(self.props.get("script", ""))
        if ":" not in target:
            raise ValueError("python3 converter needs script=module:function")
        mod, attr = target.split(":", 1)
        self.fn = getattr(importlib.import_module(mod), attr)

    def convert(self, buf: Buffer) -> Buffer:
        out = self.fn(buf)
        if not isinstance(out, Buffer):
            out = Buffer(list(out) if isinstance(out, (list, tuple))
                         else [np.asarray(out)])
        return out
