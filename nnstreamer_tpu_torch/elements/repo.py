"""tensor_repo: named in-process slots enabling pipeline loops/recurrence.

Port of ``nnstreamer_tpu/elements/repo.py``; the slots are the port's own
(a JAX pipeline's slot of the same name is another slot), and a buffer
is stored on the host (``Buffer.to_host``).  Reference analog:
``gsttensor_reposrc.c`` / ``gsttensor_reposink.c`` / ``tensor_repo.c``:
the output of iteration N becomes the input of iteration N+1 without a
graph cycle (reposrc has no in-edge, so the DAG check holds; the loop
closes through the shared slot).

Slots are process-global, keyed by ``slot-name`` (upstream uses integer
``slot-index``; both accepted).  ``reposrc`` needs an initial value to kick
off the recurrence: ``init-dims``/``init-type`` (zeros) — the reference gets
this from its negotiated caps and empty buffers.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Dict

import numpy as np

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.registry import register_element
from ..core.types import TensorsSpec
from .base import SinkElement, SourceElement


class _Slot:
    def __init__(self):
        self.q: _queue.Queue = _queue.Queue(maxsize=64)
        self.eos = threading.Event()


_slots: Dict[str, _Slot] = {}
_slots_lock = threading.Lock()


def _slot(name: str) -> _Slot:
    with _slots_lock:
        if name not in _slots:
            _slots[name] = _Slot()
        return _slots[name]


def reset_slots() -> None:
    """Test helper: clear all repo slots."""
    with _slots_lock:
        _slots.clear()


def _slot_key(props) -> str:
    return str(props.get("slot_name", props.get("slot_index", "0")))


@register_element("tensor_reposink")
class TensorRepoSink(SinkElement):
    kind = "tensor_reposink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self._slot = _slot(_slot_key(self.props))

    def start(self):
        # A fresh stream re-arms the slot: without this, a second pipeline
        # reusing the slot name would see the EOS latch from the previous
        # run and end its recurrence immediately.
        self._slot.eos.clear()

    def process(self, pad, buf: Buffer):
        self._slot.q.put(buf.to_host())
        return []

    def stop(self):
        self._slot.eos.set()


@register_element("tensor_reposrc")
class TensorRepoSrc(SourceElement):
    kind = "tensor_reposrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self._slot = _slot(_slot_key(self.props))
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.init_dims = self.props.get("init_dims")
        self.init_type = str(self.props.get("init_type", "float32"))

    def configure(self, in_caps, out_pads):
        spec = None
        if self.init_dims:
            spec = TensorsSpec.from_string(str(self.init_dims), self.init_type)
        self.out_caps = {p: Caps.tensors(spec) for p in out_pads}
        self._spec = spec
        return self.out_caps

    def generate(self):
        emitted = 0
        if self._spec is not None:
            init = [np.zeros(s.shape, s.dtype) for s in self._spec]
            yield Buffer(init, spec=self._spec)
            emitted += 1
        while self.num_buffers < 0 or emitted < self.num_buffers:
            try:
                buf = self._slot.q.get(timeout=0.1)
            except _queue.Empty:
                if self._slot.eos.is_set() and self._slot.q.empty():
                    return
                stop = getattr(self, "_stop_event", None)
                if stop is not None and stop.is_set():
                    return
                continue
            yield buf
            emitted += 1
