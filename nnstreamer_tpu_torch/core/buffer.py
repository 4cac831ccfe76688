"""Stream buffers: the unit of data flowing between pipeline stages.

Port of ``nnstreamer_tpu/core/buffer.py`` (reference: ``GstBuffer``
carrying one ``GstMemory`` chunk per tensor plus pts/duration metadata).

A chunk's payload is either a host numpy array or a torch tensor, which
may already sit in GPU memory.  Host boundaries (app ingest, sink pull)
are the only places payloads cross between host and card.

A fused stage whose tail decoder finishes its decode on the host emits a
buffer with a deferred mapping (``meta["_host_post"]``): its tensors are
the decoder's small device outputs, already on their way to pinned host
memory (``meta["_d2h_done"]``, the event that copy records).
:meth:`Buffer.resolve` waits for that copy and applies the mapping; the
runtime does so at a sink's pull or callback, or before a host element.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .types import TensorsSpec

_seq = itertools.count()


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Buffer:
    """One pipeline buffer: a tuple of tensors + timing + metadata.

    ``tensors`` entries are numpy arrays or torch tensors.  ``spec``
    describes them; for FLEXIBLE streams it is derived per buffer.  ``pts``
    is the presentation timestamp in nanoseconds; ``meta`` carries
    cross-element metadata (reference: GstMeta).
    """

    tensors: List[Any]
    spec: Optional[TensorsSpec] = None
    pts: Optional[int] = None
    duration: Optional[int] = None
    seqno: int = dataclasses.field(default_factory=lambda: next(_seq))
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.spec is None:
            self.spec = TensorsSpec.of(self.tensors)

    def __len__(self) -> int:
        return len(self.tensors)

    def __getitem__(self, i: int):
        return self.tensors[i]

    @property
    def on_device(self) -> bool:
        return all(_on_card(t) for t in self.tensors)

    def with_tensors(self, tensors: Sequence[Any], spec: Optional[TensorsSpec] = None) -> "Buffer":
        """New buffer with same timing/meta but different payload."""
        return Buffer(
            list(tensors),
            spec=spec,
            pts=self.pts,
            duration=self.duration,
            seqno=self.seqno,
            meta=dict(self.meta),
        )

    def resolve(self) -> "Buffer":
        """Apply a deferred device->media mapping (set by fused stages whose
        tail decoder runs on the card and finishes the decode on the
        host); a buffer without one is returned as it is."""
        post = self.meta.get("_host_post")
        if post is None:
            return self
        base = self._on_host()
        base.meta.pop("_host_post", None)
        return post(base.tensors, base)

    def _on_host(self) -> "Buffer":
        done = self.meta.get("_d2h_done")
        if done is not None:
            done.synchronize()  # the copy into pinned memory has landed
        out = self.with_tensors([_to_numpy(t) for t in self.tensors])
        out.meta.pop("_d2h_done", None)
        return out

    def to_host(self) -> "Buffer":
        """Copy every tensor to host numpy (waits for the card); a deferred
        mapping is applied."""
        if "_host_post" in self.meta:
            return self.resolve()
        return self._on_host()

    def to_device(self, device) -> "Buffer":
        """Move every tensor onto ``device`` (numpy payloads become torch
        tensors first)."""
        arrs = [(t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(t))).to(device) for t in self.tensors]
        return self.with_tensors(arrs)


def upload(x, device) -> torch.Tensor:
    """A host array (or tensor) as a fresh tensor on ``device``: one small
    copy, staged through pinned memory so that it does not wait for the
    card."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def start_fetch(tensors: Sequence[torch.Tensor]):
    """Start copying card tensors into fresh pinned host tensors on the
    current stream -> (host tensors, the event that marks the copies
    done).  The host tensors must not be read before the event."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def stack_tensors(rows: Sequence[Sequence[Any]], pad_to: Optional[int] = None):
    """Stack per-buffer tensor rows (all the same signature) on a new
    leading axis -> a tuple of ``[B, ...]`` tensors; ``pad_to`` repeats the
    last row up to that many rows."""
    rows = list(rows)
    if pad_to is not None and pad_to > len(rows):
        rows += [rows[-1]] * (pad_to - len(rows))
    return tuple(torch.stack([torch.as_tensor(r[t]) for r in rows])
                 for t in range(len(rows[0])))


def split_rows(arrays: Sequence[Any], n: int) -> List[Tuple]:
    """Inverse of :func:`stack_tensors`: ``[B, ...]`` tensors -> n
    per-buffer tensor tuples (rows past n are dropped)."""
    return [tuple(a[i] for a in arrays) for i in range(n)]


@dataclasses.dataclass
class Event:
    """In-band stream event (reference: GstEvent — EOS, caps, error)."""

    kind: str  # "eos" | "caps" | "error"
    payload: Any = None

    @classmethod
    def eos(cls) -> "Event":
        return cls("eos")

    @classmethod
    def error(cls, exc: BaseException) -> "Event":
        return cls("error", exc)

