"""tensor_aggregator: window/stride accumulation along a dim.

Port of ``nnstreamer_tpu/elements/aggregator.py`` (reference:
``gsttensor_aggregator.c``): frames gathered into windows along one dim,
the time-series and audio windowing primitive.

Props (reference names):
* ``frames-in``    -- frames contained in one incoming buffer (along the dim)
* ``frames-out``   -- frames per outgoing buffer (window size)
* ``frames-flush`` -- frames dropped after each output (stride; 0 =>
                      frames-out, non-overlapping windows)
* ``frames-dim``   -- nnstreamer dim index to count frames along (the
                      array axis is ``rank - 1 - dim``)
* ``concat``       -- true (default): one concatenated tensor per window;
                      false: the window's frames stay separate tensors in
                      one buffer

**Device mode** (``device=true``): the window carry stays in device memory
between buffers instead of a host concatenate.  The ring is allocated
once, at the first buffer, as two ``need + step`` slots along the frames
axis in one tensor (``need`` = window, ``step`` = samples a buffer), on
the device of the element below it that is bound to one (the planner sets
``ring_device``; with none, the card).  A buffer is appended with one
copy at the valid watermark, a host int, so nothing is read back from
the card.  Each complete window is copied out into a tensor of its own
(never a view of the ring: the stage below may still hold window *k*
while buffer *k+1* is written), and the advance copies what is kept into
the other slot, so no copy overlaps its own source.  So the stage makes
one ring allocation for its lifetime and a fixed number of launches a
buffer (one append, and a copy-out and a compaction a window), all on
the thread's current stream.  Windows are bitwise the host path's (pure
data movement).  The residency planner counts the edges below it
device-resident (``device_resident``).  A partial window is dropped at
EOS, in both modes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.buffer import Buffer, upload
from ..core.caps import Caps
from ..core.registry import register_element
from ..core.types import TensorSpec, TensorsSpec
from .base import Element, ElementError, SRC


def _host(x):
    """A payload as a host array: numpy, or a CPU tensor for bf16 (which
    numpy has no type for without ``ml_dtypes``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


@register_element("tensor_aggregator")
class TensorAggregator(Element):
    kind = "tensor_aggregator"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.frames_in = int(self.props.get("frames_in", 1))
        self.frames_out = int(self.props.get("frames_out", 1))
        self.frames_flush = int(self.props.get("frames_flush", 0)) or self.frames_out
        self.frames_dim = int(self.props.get("frames_dim", 3))
        self.concat = str(self.props.get("concat", "true")).lower() not in (
            "false", "0", "no")
        self.device = str(self.props.get("device", "false")).lower() in (
            "true", "1", "yes")
        if self.device and not self.concat:
            raise ElementError(
                "tensor_aggregator device=true requires concat=true (the "
                "HBM ring carries ONE windowed tensor; multi-tensor "
                "windows stay on the host path)")
        #: read by the residency planner: the edges below carry card tensors
        self.device_resident = self.device
        #: where the ring lives: the planner sets the device of the element
        #: below bound to one (None: the card)
        self.ring_device: Optional[torch.device] = None
        #: ring allocations so far (one for the stage's lifetime)
        self.ring_allocations = 0
        self._window = None
        # device mode: both ring slots in one tensor, the slot in use, the
        # valid watermark (a host int) and the first buffer's signature
        self._rings: Optional[torch.Tensor] = None
        self._cur = 0
        self._valid = 0
        self._sig = None

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        spec = src.spec
        out_spec = None
        if spec is not None and len(spec) == 1:
            dims = list(spec[0].dims)
            if self.frames_dim >= len(dims):
                raise ElementError(
                    f"frames-dim {self.frames_dim} out of range for rank {len(dims)}")
            frame = dims[self.frames_dim] // self.frames_in
            if self.concat:
                dims[self.frames_dim] = frame * self.frames_out
                out_spec = TensorsSpec(
                    (TensorSpec(tuple(dims), spec[0].dtype),), rate=spec.rate)
            else:
                dims[self.frames_dim] = frame
                one = TensorSpec(tuple(dims), spec[0].dtype)
                out_spec = TensorsSpec(
                    tuple(one for _ in range(self.frames_out)), rate=spec.rate)
        caps = Caps.tensors(out_spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    # -- device mode ---------------------------------------------------------
    def _open_ring(self, x: torch.Tensor) -> None:
        """Fix the stage's signature from the first buffer and allocate the
        ring (both slots) on the ring's device."""
        shape = tuple(x.shape)
        axis = len(shape) - 1 - self.frames_dim
        if axis < 0:
            raise ElementError(
                f"frames-dim {self.frames_dim} out of range for rank {len(shape)}")
        step = shape[axis]
        frame_len = step // self.frames_in
        ring_shape = list(shape)
        ring_shape[axis] = self.frames_out * frame_len + step
        dev = self.ring_device
        if dev is None:
            from ..filters.base import resolve_device

            dev = resolve_device("")
        self._sig = (shape, x.dtype)
        self._axis, self._step = axis, step
        self._need = self.frames_out * frame_len
        self._stride = self.frames_flush * frame_len
        self._rings = torch.zeros((2, *ring_shape), dtype=x.dtype, device=dev)
        self.ring_allocations += 1
        self._cur = 0
        self._valid = 0

    def _process_device(self, buf: Buffer):
        """Append the buffer at the watermark, then emit every complete
        window as a tensor of its own, advancing by the flush stride."""
        if len(buf.tensors) != 1:
            raise ElementError(
                "tensor_aggregator device=true aggregates ONE tensor per "
                f"buffer, got {len(buf.tensors)}")
        x = buf.tensors[0]
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if self._rings is None:
            self._open_ring(x)
        elif (tuple(x.shape), x.dtype) != self._sig:
            raise ElementError(
                f"{self.name}: buffer {tuple(x.shape)} {x.dtype} differs from "
                f"the stage's first {self._sig[0]} {self._sig[1]}")
        dev = self._rings.device
        if x.device != dev:
            # the host ingest boundary: one copy up, then the carry stays
            x = upload(x, dev)
        axis = self._axis
        ring = self._rings[self._cur]
        ring.narrow(axis, self._valid, self._step).copy_(x)
        self._valid += self._step
        outs: List = []
        while self._valid >= self._need:
            win = ring.narrow(axis, 0, self._need).clone(
                memory_format=torch.contiguous_format)
            keep = self._valid - self._stride
            if keep > 0:
                other = self._rings[1 - self._cur]
                other.narrow(axis, 0, keep).copy_(ring.narrow(axis, self._stride, keep))
                self._cur = 1 - self._cur
                ring = other
            # as the host path: a flush past the end of the window forgets
            # at most what exists (an over-long flush carries no debt)
            self._valid = max(0, keep)
            outs.append((SRC, buf.with_tensors([win], spec=None)))
        return outs

    # -- streaming -------------------------------------------------------------
    def process(self, pad, buf: Buffer):
        if self.device:
            return self._process_device(buf)
        x = _host(buf.tensors[0])
        axis = x.ndim - 1 - self.frames_dim
        if self._window is None:
            self._window = x
        elif isinstance(x, torch.Tensor):
            self._window = torch.cat([self._window, x], dim=axis)
        else:
            self._window = np.concatenate([self._window, x], axis=axis)
        outs: List = []
        # one incoming buffer carries frames_in frames; a window counts frames
        frame_len = x.shape[axis] // self.frames_in  # samples a frame
        need = self.frames_out * frame_len
        stride = self.frames_flush * frame_len
        while self._window.shape[axis] >= need:
            sl = [slice(None)] * self._window.ndim
            sl[axis] = slice(0, need)
            window = self._window[tuple(sl)]
            if self.concat:
                tensors = [window]
            else:
                tensors = []
                for i in range(self.frames_out):
                    fsl = [slice(None)] * window.ndim
                    fsl[axis] = slice(i * frame_len, (i + 1) * frame_len)
                    tensors.append(window[tuple(fsl)])
            outs.append((SRC, buf.with_tensors(tensors, spec=None)))
            keep = [slice(None)] * self._window.ndim
            keep[axis] = slice(stride, None)
            self._window = self._window[tuple(keep)]
        return outs

    def finalize(self):
        # both paths drop a partial window at EOS; device mode also frees
        # the ring (a stream after EOS allocates a new one)
        self._window = None
        self._rings = None
        self._sig = None
        self._valid = 0
        return []

    def stop(self) -> None:
        self._rings = None
        self._sig = None
        self._valid = 0
