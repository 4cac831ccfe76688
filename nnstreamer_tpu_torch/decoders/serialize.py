"""Serialization decoders: tensors -> self-describing bytes.

Port of ``nnstreamer_tpu/decoders/serialize.py`` (reference:
``tensordec-flatbuf.cc`` / ``-flexbuf.cc`` / ``-protobuf.cc`` /
``-octetstream.c``).  ``flatbuf``, ``flexbuf`` and ``protobuf`` all write
the one wire format of ``utils/wire.py``, byte for byte the JAX
package's; ``octet_stream`` emits the tensors' raw bytes back to back.
Card tensors are fetched once per buffer by the ``tensor_decoder``
element (:meth:`~..core.buffer.Buffer.fetched`), however many branches
of a tee decode it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps, MediaType
from ..core.registry import register_decoder
from ..core.types import TensorsSpec
from ..utils.wire import _host_payload, encode_buffer
from .base import Decoder


class _WireDecoder(Decoder):
    host_decode = True

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        return Caps.new(MediaType.OCTET)

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        blob = np.frombuffer(encode_buffer(buf), np.uint8)
        return buf.with_tensors([blob], spec=None)


@register_decoder("flexbuf")
class FlexbufDecoder(_WireDecoder):
    mode = "flexbuf"


@register_decoder("flatbuf")
class FlatbufDecoder(_WireDecoder):
    mode = "flatbuf"


@register_decoder("protobuf")
class ProtobufDecoder(_WireDecoder):
    mode = "protobuf"


@register_decoder("octet_stream")
class OctetStream(Decoder):
    mode = "octet_stream"
    host_decode = True

    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        return Caps.new(MediaType.OCTET)

    def decode(self, tensors: List, buf: Buffer) -> Buffer:
        raw = b"".join(_host_payload(t)[2] for t in tensors)
        return buf.with_tensors([np.frombuffer(raw, np.uint8)], spec=None)
