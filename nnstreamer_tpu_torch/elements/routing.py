"""Stream routing elements: tee, mux, demux, merge, split, join.

Port of ``nnstreamer_tpu/elements/routing.py`` (reference:
``gsttensor_mux.c``, slowest-pad timestamp sync; ``gsttensor_merge.c``,
concat along a dim; ``gsttensor_demux.c``, ``tensorpick``;
``gsttensor_split.c``, ``tensorseg``; ``gst/join/gstjoin.c``, N:1
first-come forwarding; and GStreamer core's ``tee``).

Properties use nnstreamer's innermost-first dim indices; the array axis
is ``rank - 1 - dim``.  Tensors pass through as they are, numpy arrays or
torch tensors on any device: mux, demux, tee and join never copy them,
and merge concatenates card tensors on the card.

A ``tee`` hands the SAME buffer object to every branch, as the JAX
package does.  A port tensor is mutable where a jax Array is not, so no
element of the port writes into a tensor it did not allocate: a branch
that holds a buffer (``tensor_crop``'s pending frame) reads what the
source gave it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.log import logger, metrics
from ..core.registry import register_element
from ..core.types import TensorSpec, TensorsSpec
from .base import Element, ElementError, SRC

log = logger(__name__)

#: held base-pad buffers a ``basepad`` mux keeps before it evicts the
#: oldest (a non-base pad that never catches up)
BASEPAD_HOLD = 64


def pad_index(pad: str) -> int:
    """The number of a request pad (``sink_10`` -> 10; else 0)."""
    if "_" in pad:
        try:
            return int(pad.rsplit("_", 1)[1])
        except ValueError:
            return 0
    return 0


@register_element("tee")
class Tee(Element):
    """Copy every input buffer to all linked src pads (the same object:
    see the module docstring)."""

    kind = "tee"

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        self.out_caps = {p: src for p in out_pads}
        return self.out_caps

    def process(self, pad, buf):
        return [(p, buf) for p in self.out_caps]


class _SyncModes:
    """``sync-mode`` of tensor_mux and tensor_merge (reference:
    ``gsttensor_mux.c`` / ``gsttensor_merge.c``):

    * ``slowest`` (default): emit when EVERY sink pad has contributed; the
      runtime's collation does it (``sync_policy="all"``); output pts =
      the largest input pts;
    * ``basepad``: ``sync-option=<pad index>[:<duration ns>]``; each base
      pad buffer emits one output with the latest buffer seen on every
      other pad (which gate only until their first buffer); output pts =
      the base buffer's.  With a duration a base buffer is held (in order,
      at most :data:`BASEPAD_HOLD`, the oldest evicted and counted in
      ``<name>.basepad_evicted``) until every other pad's latest buffer
      is no older than ``base pts - duration``; EOS flushes the held ones
      with the last-seen buffers;
    * ``refresh``: a buffer on ANY pad emits an output with the other
      pads' latest buffers; output pts = the arriving buffer's.

    ``basepad`` and ``refresh`` set the element's ``sync_policy`` to
    ``"any"`` and collate in ``process`` (one stage thread: no lock).
    """

    def _init_sync(self) -> None:
        self.sync_mode = str(self.props.get("sync_mode", "slowest")).lower()
        if self.sync_mode not in ("slowest", "basepad", "refresh"):
            raise ElementError(
                f"{self.name}: unknown sync-mode {self.sync_mode!r} "
                "(slowest|basepad|refresh)")
        parts = str(self.props.get("sync_option", "") or "0").split(":")
        self._base_idx = int(parts[0] or 0)
        self._base_window_ns = (int(parts[1])
                                if len(parts) > 1 and parts[1] else None)
        # a single-pad mux in slowest mode skips the runtime's collation
        # and reaches process(), where this degenerates to a pass-through
        self._latest: Dict[str, Buffer] = {}
        self._pending_base: List[Buffer] = []
        if self.sync_mode != "slowest":
            self.sync_policy = "any"

    def _base_pad(self) -> str:
        pads = sorted(self.in_caps, key=pad_index)
        if self._base_idx >= len(pads):
            raise ElementError(
                f"{self.name}: basepad {self._base_idx} out of range "
                f"({len(pads)} sink pads)")
        return pads[self._base_idx]

    def process(self, pad, buf: Buffer):
        # basepad/refresh only (slowest collates in the runtime)
        self._latest[pad] = buf
        if self.sync_mode == "basepad":
            if pad == self._base_pad():
                self._pending_base.append(buf)
                if len(self._pending_base) > BASEPAD_HOLD:
                    del self._pending_base[0]
                    metrics.count(f"{self.name}.basepad_evicted")
                    log.warning("%s: basepad queue full (%d); evicting the "
                                "oldest held base buffer: a non-base pad is "
                                "stalled", self.name, BASEPAD_HOLD)
            if not set(self.in_caps) <= set(self._latest):
                return []  # every pad's first buffer first
            return self._drain_basepad()
        if not set(self.in_caps) <= set(self._latest):
            return []
        return self._emit_with(dict(self._latest), buf)

    def _emit_with(self, group: Dict[str, Buffer], driving: Buffer):
        outs = self.process_group(group)
        for _, o in outs:
            o.pts = driving.pts  # the driving buffer's timestamp
            o.seqno = driving.seqno
        return outs

    def _in_window(self, base_buf: Buffer) -> bool:
        """True when no other pad's latest buffer is older than
        ``base pts - duration``."""
        if self._base_window_ns is None or base_buf.pts is None:
            return True
        base = self._base_pad()
        return all(p == base or lb.pts is None
                   or lb.pts >= base_buf.pts - self._base_window_ns
                   for p, lb in self._latest.items())

    def _drain_basepad(self):
        base = self._base_pad()
        outs = []
        while self._pending_base:
            b = self._pending_base[0]
            if not self._in_window(b):
                break  # held, in order, until the stale pad catches up
            self._pending_base.pop(0)
            outs.extend(self._emit_with({**self._latest, base: b}, b))
        return outs

    def finalize(self):
        outs = []
        if (self.sync_mode == "basepad"
                and set(self.in_caps) <= set(self._latest)):
            base = self._base_pad()
            for b in self._pending_base:
                outs.extend(self._emit_with({**self._latest, base: b}, b))
        self._pending_base = []
        return outs


@register_element("tensor_mux")
class TensorMux(_SyncModes, Element):
    """N tensor streams -> one buffer carrying all their tensors, in pad
    order.  Props: ``sync-mode``, ``sync-option`` (:class:`_SyncModes`)."""

    kind = "tensor_mux"
    sync_policy = "all"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self._init_sync()

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        specs: List[TensorSpec] = []
        known = True
        for pad in sorted(in_caps):
            s = in_caps[pad].spec
            if s is None:
                known = False
                break
            specs.extend(s.specs)
        caps = Caps.tensors(TensorsSpec(tuple(specs)) if known else None)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process_group(self, bufs: Dict[str, Buffer]):
        tensors = []
        pts = None
        meta: Dict[str, object] = {}
        for pad in sorted(bufs):
            b = bufs[pad]
            tensors.extend(b.tensors)
            meta.update(b.meta)
            if b.pts is not None:
                pts = b.pts if pts is None else max(pts, b.pts)
        return [(SRC, Buffer(tensors, pts=pts, meta=meta))]


@register_element("tensor_demux")
class TensorDemux(Element):
    """One buffer -> one stream per (picked) tensor: ``tensorpick="0,2"``
    selects tensors for ``src_0, src_1, ...`` in pick order.
    ``by-meta=<key>`` routes the WHOLE buffer to ``src_<int(meta[key])>``
    instead (absent or invalid: ``src_0``)."""

    kind = "tensor_demux"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        pick = str(self.props.get("tensorpick", ""))
        self.pick = [int(v) for v in pick.split(",") if v != ""] if pick else None
        self.by_meta = str(self.props.get("by-meta",
                                          self.props.get("by_meta", "")))

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        spec = src.spec
        self.out_caps = {}
        for i, p in enumerate(sorted(out_pads, key=pad_index)):
            if self.by_meta:
                self.out_caps[p] = src  # the whole buffer passes
                continue
            sub = None
            if spec is not None:
                idx = self.pick[i] if self.pick else i
                if idx < len(spec):
                    sub = TensorsSpec((spec[idx],), rate=spec.rate)
            self.out_caps[p] = Caps.tensors(sub)
        return self.out_caps

    def process(self, pad, buf: Buffer):
        pads = sorted(self.out_caps, key=pad_index)
        if self.by_meta:
            try:
                idx = int(buf.meta.get(self.by_meta, 0) or 0)
            except (TypeError, ValueError):
                idx = 0
            return [(pads[max(0, min(idx, len(pads) - 1))], buf)]
        outs = []
        for i, p in enumerate(pads):
            idx = self.pick[i] if self.pick else i
            if idx >= len(buf.tensors):
                raise ElementError(f"demux pick {idx} out of range (buffer "
                                   f"has {len(buf.tensors)})")
            outs.append((p, buf.with_tensors([buf.tensors[idx]], spec=None)))
        return outs


def _concat(arrays, axis: int):
    """numpy arrays concatenate on the host; any torch tensor among them
    puts the result where the first torch tensor lies."""
    if not any(isinstance(a, torch.Tensor) for a in arrays):
        return np.concatenate([np.asarray(a) for a in arrays], axis=axis)
    dev = next(a.device for a in arrays if isinstance(a, torch.Tensor))
    return torch.cat([torch.as_tensor(a).to(dev) for a in arrays], dim=axis)


@register_element("tensor_merge")
class TensorMerge(_SyncModes, Element):
    """Concatenate one tensor from each sink pad along a dim (upstream's
    ``linear`` mode): ``option=<dim>`` (innermost-first), and
    ``sync-mode`` / ``sync-option`` (:class:`_SyncModes`)."""

    kind = "tensor_merge"
    sync_policy = "all"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.dim = int(self.props.get("option", 0))
        self._init_sync()

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        spec = None
        in_specs = []
        for pad in sorted(in_caps):
            s = in_caps[pad].spec
            if s is None or len(s) != 1:
                in_specs = None
                break
            in_specs.append(s[0])
        if in_specs:
            rank = in_specs[0].rank
            if self.dim >= rank:
                raise ElementError(f"merge dim {self.dim} out of range (rank {rank})")
            dims = list(in_specs[0].dims)
            dims[self.dim] = sum(s.dims[self.dim] for s in in_specs)
            spec = TensorsSpec((TensorSpec(tuple(dims), in_specs[0].dtype),))
        caps = Caps.tensors(spec)
        self.out_caps = {p: caps for p in out_pads}
        return self.out_caps

    def process_group(self, bufs: Dict[str, Buffer]):
        arrays = [bufs[p].tensors[0] for p in sorted(bufs)]
        out = _concat(arrays, arrays[0].ndim - 1 - self.dim)
        pts = max((b.pts for b in bufs.values() if b.pts is not None),
                  default=None)
        return [(SRC, Buffer([out], pts=pts))]


@register_element("tensor_split")
class TensorSplit(Element):
    """Split one tensor into segments along a dim: ``tensorseg="2,3,4"``
    (sizes along the dim), ``dim=<index>`` (innermost-first, default 0).
    Every segment needs a linked pad.  The segments are views."""

    kind = "tensor_split"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        seg = str(self.props.get("tensorseg", ""))
        self.segments = [int(v) for v in seg.replace(":", ",").split(",") if v != ""]
        self.dim = int(self.props.get("dim", 0))

    def configure(self, in_caps, out_pads):
        self.in_caps = dict(in_caps)
        src = next(iter(in_caps.values()), Caps.any())
        spec = src.spec
        self.out_caps = {}
        pads = sorted(out_pads, key=pad_index)
        if self.segments and len(pads) != len(self.segments):
            raise ElementError(
                f"split has {len(pads)} out pads but {len(self.segments)} "
                "segments: every segment needs a linked pad")
        for i, p in enumerate(pads):
            sub = None
            if spec is not None and len(spec) == 1 and self.segments:
                dims = list(spec[0].dims)
                if self.dim >= len(dims):
                    raise ElementError(f"split dim {self.dim} out of range")
                dims[self.dim] = self.segments[i]
                sub = TensorsSpec((TensorSpec(tuple(dims), spec[0].dtype),))
            self.out_caps[p] = Caps.tensors(sub)
        return self.out_caps

    def process(self, pad, buf: Buffer):
        x = buf.tensors[0]
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        axis = x.ndim - 1 - self.dim
        sizes = self.segments or [x.shape[axis]]
        if sum(sizes) != x.shape[axis]:
            raise ElementError(
                f"split sizes {sizes} do not cover dim size {x.shape[axis]}")
        outs = []
        off = 0
        for n, p in zip(sizes, sorted(self.out_caps, key=pad_index)):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(off, off + n)
            outs.append((p, buf.with_tensors([x[tuple(sl)]], spec=None)))
            off += n
        return outs


@register_element("join")
class Join(Element):
    """N:1 first-come forwarding without sync, to reunite branches."""

    kind = "join"

    def process(self, pad, buf):
        return [(SRC, buf)]
