"""Decoder sub-plugin API.

Port of ``nnstreamer_tpu/decoders/base.py`` (reference:
``NNStreamerExternalDecoder`` in ``nnstreamer_plugin_api_decoder.h``):
the ``tensor_decoder`` shell element dispatches to a sub-plugin chosen by
``mode=``.  Options follow the reference convention: ``option1..option9``
carry mode-specific config (labels, output size, thresholds, ...).

A decoder opts in to the residency planner (``pipeline/residency.py``)
with ``admits_reduced_payload``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.types import TensorsSpec


class Decoder:
    """Base decoder sub-plugin: tensors -> media/overlay/meta."""

    mode: str = "base"

    def __init__(self, props: Dict[str, object]):
        # Keep the SAME dict the element was built with (not a copy): the
        # pipeline's unknown-property check needs the decoder's reads of
        # optionN/etc. recorded on the element's tracked props.
        self.props = props if isinstance(props, dict) else dict(props)

    def option(self, n: int, default: str = "") -> str:
        v = self.props.get(f"option{n}", default)
        return str(v) if v is not None else default

    # -- negotiation -------------------------------------------------------
    def out_caps(self, in_spec: Optional[TensorsSpec]) -> Caps:
        return Caps.any()

    # -- decode ------------------------------------------------------------
    def decode(self, tensors: List, buf: Buffer):
        raise NotImplementedError

    # -- fusion (optional) -------------------------------------------------
    def device_fn(self, in_spec: TensorsSpec):
        """``(fn, out_spec)``: the decode's device half as a torch callable
        for a fused stage; None => host decode only."""
        return None

    # When device_fn is provided, ``host_post`` (if also defined) maps the
    # fetched (small) device outputs into the final media buffer on the
    # host, lazily, at the pipeline edge.  None => the device outputs ARE
    # the final payload.
    host_post = None

    #: True for a decoder that reads every tensor on the host: the
    #: element hands it the buffer's one shared fetch
    #: (:meth:`~..core.buffer.Buffer.fetched`)
    host_decode = False

    #: residency planner opt-in: True when this decoder's output contract
    #: holds whatever geometry the model above emits (a native-stride
    #: score map instead of the full-resolution one).  A decoder that makes
    #: fixed-geometry media (overlays, canvases) stays False.
    admits_reduced_payload = False


def load_labels(path_or_name: str) -> List[str]:
    """Load a labels file (one label per line, reference format).  A few
    builtin names avoid needing data files in tests: ``imagenet-mini``,
    ``coco-mini``, ``digits``."""
    builtin = {
        "digits": [str(i) for i in range(10)],
        "imagenet-mini": [f"class_{i}" for i in range(1001)],
        "coco-mini": [f"obj_{i}" for i in range(91)],
    }
    if path_or_name in builtin:
        return builtin[path_or_name]
    with open(path_or_name, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]
