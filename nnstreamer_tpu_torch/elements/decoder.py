"""tensor_decoder shell element.

Port of ``nnstreamer_tpu/elements/decoder.py`` (reference:
``gsttensor_decoder.c``): ``other/tensors`` -> media via the decoder
sub-plugin named by ``mode=`` (``image_labeling``, ``bounding_boxes``,
``pose_estimation``, ``image_segment``, ``ctc``, ``direct_video``,
``tensor_region``, ``flatbuf``, ``flexbuf``, ``protobuf``,
``octet_stream``).
The sub-plugin's device half and deferred host mapping are the element's
:meth:`~TensorDecoder.device_fn` and ``host_post``, so a decoder fuses
into the stage in front of it.
"""

from __future__ import annotations

from ..core.caps import Caps, MediaType
from ..core.registry import KIND_DECODER, get as registry_get, register_element
from .base import Element, ElementError, SRC


@register_element("tensor_decoder")
class TensorDecoder(Element):
    kind = "tensor_decoder"
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.TENSORS)}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        mode = self.props.get("mode")
        if not mode:
            raise ElementError("tensor_decoder needs mode=<subplugin>")
        cls = registry_get(KIND_DECODER, str(mode))
        self.decoder = cls(self.props)

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        caps = self.decoder.out_caps(src.spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process(self, pad, buf):
        # Tensors go to the decoder as they are (card tensors from an
        # unfused filter): a decoder that prefilters on the device
        # (bounding_boxes top-k) fetches only what it needs; a decoder
        # that reads everything on the host gets the buffer's one fetch,
        # shared with the other branches of a tee above it.
        if getattr(self.decoder, "host_decode", False):
            buf = buf.fetched()
        out = self.decoder.decode(list(buf.tensors), buf)
        # a decoder may un-batch one buffer into several (bounding_boxes
        # on batched streams emits one video frame per batch row)
        if isinstance(out, list):
            return [(SRC, o) for o in out]
        return [(SRC, out)]

    def device_fn(self, in_spec):
        return self.decoder.device_fn(in_spec)

    @property
    def host_post(self):
        """Deferred host mapping paired with the decoder's device_fn."""
        return self.decoder.host_post

    @property
    def admits_reduced_payload(self):
        """The residency planner's opt-in, the decoder's own
        (``pipeline/residency.py``): True only for a decode that holds
        whatever geometry it is given (``image_segment`` classmap)."""
        return getattr(self.decoder, "admits_reduced_payload", False)
