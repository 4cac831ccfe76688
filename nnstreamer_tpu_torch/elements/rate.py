"""tensor_rateadjust: throttle/duplicate frames to a target rate.

Port of ``nnstreamer_tpu/elements/rate.py`` (the tensors pass through as
they are, card tensors included).  Reference analog:
``gsttensor_rateadjust.c`` / ``tensor_rate``: drop or duplicate buffers
so the output stream hits ``framerate=N/D``, with QoS counters
(in/out/dropped/duplicated) exposed as properties.
"""

from __future__ import annotations

from typing import Optional

from ..core.buffer import Buffer
from ..core.caps import Caps, MediaType
from ..core.registry import register_element
from ..core.types import parse_fraction
from .base import Element, SRC


@register_element("tensor_rateadjust", aliases=("tensor_rate",))
class TensorRateAdjust(Element):
    kind = "tensor_rateadjust"
    PAD_TEMPLATES = {"sink": Caps.new(MediaType.TENSORS)}

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.target = parse_fraction(self.props.get("framerate", "30/1"))
        self.silent = bool(self.props.get("silent", True))
        self.n_in = 0
        self.n_out = 0
        self.n_dropped = 0
        self.n_duplicated = 0
        self._next_pts: Optional[int] = None  # next output slot in ns

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        spec = src.spec
        if spec is not None:
            spec = spec.replace(rate=self.target)
        self.out_caps = {p: Caps.tensors(spec) for p in out_pads}
        return self.out_caps

    def process(self, pad, buf: Buffer):
        self.n_in += 1
        num, den = self.target
        if num <= 0 or buf.pts is None:
            self.n_out += 1
            return [(SRC, buf)]
        frame_ns = int(1e9 * den / num)
        if self._next_pts is None:
            # Anchor the slot clock at the first observed pts — streams need
            # not start at t=0 (mid-stream segments, live sources).
            self._next_pts = buf.pts
        outs = []
        # emit one copy per output slot covered by this input's timestamp;
        # drop inputs that land before the next slot.
        while buf.pts >= self._next_pts:
            out = buf.with_tensors(buf.tensors, spec=buf.spec)
            out.pts = self._next_pts
            outs.append((SRC, out))
            self._next_pts += frame_ns
            self.n_out += 1
            if len(outs) > 1:
                self.n_duplicated += 1
        if not outs:
            self.n_dropped += 1
        return outs
