"""Source elements.

Port of the ``appsrc`` of ``nnstreamer_tpu/elements/source.py``: the
application-driven source.  Sources produce host buffers; the stage that
consumes them moves payloads to the card.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.buffer import Buffer, Event
from ..core.caps import Caps, parse_caps_string
from ..core.registry import register_element
from .base import SourceElement


@register_element("appsrc")
class AppSrc(SourceElement):
    """Application-driven source: ``pipeline.push(name, array)`` feeds it.

    Props: ``caps`` (caps string describing what the app will push),
    ``max-buffers`` (feed queue bound), ``block`` (push blocks when full;
    ``block=false`` lets the feed queue grow unbounded, as GStreamer's
    appsrc does).
    """

    kind = "appsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        cap = self.props.get("caps")
        self._caps = parse_caps_string(str(cap)) if cap else Caps.any()
        self.block = bool(self.props.get("block", True))
        cap_n = int(self.props.get("max_buffers", 64))
        self._q: _queue.Queue = _queue.Queue(
            maxsize=cap_n if self.block else 0)
        self._eos = threading.Event()

    def configure(self, in_caps, out_pads):
        self.out_caps = {p: self._caps for p in out_pads}
        return self.out_caps

    # -- app API -----------------------------------------------------------
    def push(self, data, pts: Optional[int] = None) -> None:
        if self._eos.is_set():
            raise RuntimeError("appsrc already EOS")
        if isinstance(data, Buffer):
            buf = data
        elif isinstance(data, (list, tuple)):
            buf = Buffer(list(data), pts=pts)
        elif isinstance(data, str):
            buf = Buffer([np.frombuffer(data.encode("utf-8"), np.uint8)], pts=pts)
        elif isinstance(data, (bytes, bytearray)):
            buf = Buffer([np.frombuffer(bytes(data), np.uint8)], pts=pts)
        else:
            buf = Buffer([data if isinstance(data, torch.Tensor)
                          else np.asarray(data)], pts=pts)
        self._q.put(buf)

    def signal_eos(self) -> None:
        self._eos.set()

    def generate(self) -> Iterator[Union[Buffer, Event]]:
        stop = getattr(self, "_stop_event", None)
        while True:
            try:
                yield self._q.get(timeout=0.05)
            except _queue.Empty:
                if self._eos.is_set() and self._q.empty():
                    return
                # stop() without EOS: exit instead of pinning the runner
                if stop is not None and stop.is_set():
                    return
