"""nns-armor: poison-pill quarantine, dead-letter queue, and the
repeat-offender circuit breaker (docs/ROBUSTNESS.md).

Port of ``nnstreamer_tpu/utils/armor.py``, copied whole: the query
server answers wire rejects and poison terminators with the same typed
meta, and ``Pipeline(quarantine=...)`` quarantines through it.

A public front door sees requests that crash workers as a matter of
course.  Without this module a stage exception kills the pipeline.  With
``Pipeline(quarantine=...)``:

* the triggering request is **quarantined** — serialized via the wire
  codec into a bounded dead-letter-queue directory with the error, the
  tenant, and the flight-recorder ring excerpt attached (``_dlq`` meta),
  so the poison pill is reproducible offline (``decode_buffer`` the
  file back) instead of gone;
* the client receives a typed ``abort_reason=poison`` terminator (the
  serversink routes it by the request's own conn/msg meta) and the
  pipeline keeps serving everyone else;
* N poisons from one tenant inside a sliding window trip a **circuit
  breaker** that flips the per-tenant ``tenant_admission`` override
  to ``shed`` on every query-server core of the pipeline — the
  repeat offender is auto-shed at admission until the breaker is reset
  (span-stamped ``armor.breaker``).

Everything here is host-side value movement: no device work.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.log import logger, metrics
#: META_POISON marks a poison terminator: runners forward such buffers
#: WITHOUT invoking the stage (they are answers, not work), sinks
#: deliver them like any response.  META_DLQ carries the DLQ record
#: context on a quarantined entry.  Both are declared in the shared
#: protocol registry (core/meta_keys.py) and re-exported here.
from ..core.meta_keys import (  # noqa: F401  (re-export)
    ABORT_REASON_POISON, META_ABORT_REASON, META_DLQ, META_POISON,
    META_STREAM_ABORTED, META_STREAM_INDEX, META_STREAM_LAST,
)
from . import tracing, wire

log = logger(__name__)

_DLQ_PREFIX = "poison-"
_DLQ_SUFFIX = ".nns"

#: DLQ file framing: u32 magic "NDLQ" | u32 crc32(payload) | payload
#: (payload = wire.encode_buffer of the poisoned request + _dlq meta)
DLQ_MAGIC = 0x4E444C51


@dataclasses.dataclass
class QuarantinePolicy:
    """``Pipeline(quarantine=...)`` accepts a directory path, a dict of
    these fields, or an instance.  ``dir`` is the DLQ directory (created
    on first use).  ``max_entries``/``max_bytes`` bound the DLQ —
    oldest entries are evicted first, the poison stream must never fill
    a disk.  ``breaker_threshold`` poisons from ONE tenant within
    ``breaker_window_s`` seconds trip the breaker (0 disables it)."""

    dir: str = ""
    max_entries: int = 256
    max_bytes: int = 64 << 20
    breaker_threshold: int = 3
    breaker_window_s: float = 30.0

    @classmethod
    def of(cls, obj) -> "QuarantinePolicy":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            return cls(dir=obj)
        if isinstance(obj, dict):
            unknown = set(obj) - {f.name for f in
                                  dataclasses.fields(cls)}
            if unknown:
                raise ValueError(
                    f"unknown quarantine policy keys {sorted(unknown)}")
            return cls(**obj)
        raise ValueError(
            f"quarantine must be a DLQ directory path, a policy dict, "
            f"or a QuarantinePolicy, got {type(obj).__name__}")


def load_dlq_entry(path: str):
    """Read one DLQ file back into ``(buffer, flags)`` —
    CRC-verified, then :func:`~.wire.decode_buffer`
    (the quarantined request's tensors + its ``_dlq`` context meta)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise wire.WireError(f"DLQ file {path} too short")
    magic, crc = struct.unpack_from("<II", raw, 0)
    if magic != DLQ_MAGIC:
        raise wire.WireError(f"DLQ file {path} has bad magic")
    payload = raw[8:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise wire.WireError(f"DLQ file {path} failed its CRC")
    return wire.decode_buffer(payload)


class DeadLetterQueue:
    """Bounded directory of quarantined requests."""

    _GUARDED_BY = {"_n": "_lock"}

    def __init__(self, path: str, max_entries: int = 256,
                 max_bytes: int = 64 << 20):
        self.path = path
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1 << 12, int(max_bytes))
        self._lock = threading.Lock()
        self._n = 0

    def entries(self) -> List[str]:
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return []
        return sorted(os.path.join(self.path, n) for n in names
                      if n.startswith(_DLQ_PREFIX)
                      and n.endswith(_DLQ_SUFFIX))

    def _evict_locked(self, incoming_bytes: int) -> None:
        entries = self.entries()
        total = 0
        sizes = {}
        for p in entries:
            try:
                sizes[p] = os.path.getsize(p)
            except OSError:
                sizes[p] = 0
            total += sizes[p]
        while entries and (len(entries) >= self.max_entries
                           or total + incoming_bytes > self.max_bytes):
            victim = entries.pop(0)  # oldest first: keep recent poisons
            try:
                os.unlink(victim)
            except OSError:
                pass
            total -= sizes.get(victim, 0)
            metrics.count("armor.dlq_evicted")

    def put(self, buf, *, error: str, stage: str,
            tenant: Optional[str] = None,
            ring: Optional[List[str]] = None) -> str:
        """Serialize one poisoned request into the DLQ; returns the file
        path.  The record is the request's own wire encoding with a
        ``_dlq`` meta object attached: ``{error, stage, tenant, t,
        ring}`` — everything a post-mortem replay needs."""
        host = buf.to_host() if hasattr(buf, "to_host") else buf
        rec = host.with_tensors([np.asarray(t) for t in host.tensors])
        rec.meta.pop("_host_post", None)
        rec.meta[META_DLQ] = {
            "error": str(error)[:2000],
            "stage": stage,
            "tenant": tenant,
            "t": time.time(),
            "ring": list(ring or [])[-40:],
        }
        payload = wire.encode_buffer(rec)
        frame = struct.pack(
            "<II", DLQ_MAGIC, zlib.crc32(payload) & 0xFFFFFFFF) + payload
        with self._lock:
            os.makedirs(self.path, exist_ok=True)
            self._evict_locked(len(frame))
            self._n += 1
            name = (f"{_DLQ_PREFIX}{time.time():.6f}-{self._n:06d}"
                    f"{_DLQ_SUFFIX}")
            path = os.path.join(self.path, name)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(frame)
            os.replace(tmp, path)  # readers never see a half write
        return path


class CircuitBreaker:
    """Sliding-window repeat-offender breaker over per-tenant poisons.

    ``threshold`` poisons from one tenant inside ``window_s`` seconds
    flip that tenant's admission override to ``shed`` through
    ``apply_fn(tenant, engage)`` (the pipeline wires this to every
    query-server core's ``tenant_admission`` map, the autoscaler's
    lever in the JAX package).  The trip latches until :meth:`reset`."""

    _GUARDED_BY = {"_hits": "_lock", "tripped": "_lock"}

    def __init__(self, threshold: int, window_s: float,
                 apply_fn: Callable[[str, bool], None],
                 recorder: Optional[tracing.FlightRecorder] = None):
        self.threshold = max(0, int(threshold))
        self.window_s = float(window_s)
        self.apply_fn = apply_fn
        self.recorder = recorder
        self._hits: Dict[str, collections.deque] = {}
        self.tripped: set = set()
        self._lock = threading.Lock()

    def record_poison(self, tenant: Optional[str]) -> bool:
        """One poison observed for ``tenant``; returns True when this
        poison TRIPS the breaker (edge, not level)."""
        if self.threshold <= 0 or tenant is None:
            return False
        now = time.monotonic()
        with self._lock:
            dq = self._hits.setdefault(
                tenant, collections.deque(maxlen=self.threshold))
            dq.append(now)
            if tenant in self.tripped:
                # self-healing latch: another actor (the autoscaler
                # relax edge shares the tenant_admission map) may have
                # popped or overwritten the override — a poison from a
                # TRIPPED tenant re-asserts it
                try:
                    self.apply_fn(tenant, True)
                except Exception:  # noqa: BLE001
                    log.exception("breaker re-assert failed for "
                                  "tenant %s", tenant)
                return False
            if len(dq) < self.threshold or now - dq[0] > self.window_s:
                return False
            self.tripped.add(tenant)
        try:
            self.apply_fn(tenant, True)
        except Exception:  # noqa: BLE001 - the breaker must never throw
            log.exception("breaker engage failed for tenant %s", tenant)
        metrics.count("armor.breaker_trips", tenant=tenant)
        log.warning(
            "armor: circuit breaker TRIPPED for tenant %s (%d poisons "
            "within %.1fs) — admission override flipped to shed",
            tenant, self.threshold, self.window_s)
        if self.recorder is not None and self.recorder.active:
            self.recorder.record(
                "armor.breaker", "armor", None, time.monotonic_ns(), 0,
                tenant=tenant, threshold=self.threshold,
                window_s=self.window_s, edge="trip")
        return True

    def reset(self, tenant: str) -> bool:
        with self._lock:
            if tenant not in self.tripped:
                return False
            self.tripped.discard(tenant)
            self._hits.pop(tenant, None)
        try:
            self.apply_fn(tenant, False)
        except Exception:  # noqa: BLE001
            log.exception("breaker reset failed for tenant %s", tenant)
        if self.recorder is not None and self.recorder.active:
            self.recorder.record(
                "armor.breaker", "armor", None, time.monotonic_ns(), 0,
                tenant=tenant, edge="reset")
        return True


class Armor:
    """One pipeline's quarantine surface: DLQ + breaker + the nan-guard
    flag, built by ``Pipeline(quarantine=..., nan_guard=...)`` and held
    on ``pipeline._armor`` (runners and the llm serve loop read it
    through the same attach pattern as ``_trace_rec``)."""

    def __init__(self, policy: QuarantinePolicy, *, nan_guard: bool,
                 apply_admission: Callable[[str, bool], None],
                 recorder: Optional[tracing.FlightRecorder] = None):
        self.policy = policy
        self.nan_guard = bool(nan_guard)
        self.recorder = recorder
        self.dlq = DeadLetterQueue(policy.dir, policy.max_entries,
                                   policy.max_bytes)
        self.breaker = CircuitBreaker(
            policy.breaker_threshold, policy.breaker_window_s,
            apply_admission, recorder=recorder)

    def quarantine(self, buf, *, error: BaseException, stage: str) -> str:
        """Quarantine one poisoned request: DLQ record (with the recent
        flight-recorder window attached when tracing is on), per-tenant
        poison counter, ``armor.quarantine`` span, breaker accounting.
        Never raises — the quarantine path runs inside a runner's
        exception handler."""
        tenant = buf.meta.get(tracing.META_TENANT) \
            if hasattr(buf, "meta") else None
        ring: List[str] = []
        rec = self.recorder if self.recorder is not None \
            else (tracing.recorder if tracing.recorder.active else None)
        if rec is not None and rec.active:
            try:
                ring = tracing.format_recent(5.0, rec)
            except Exception:  # noqa: BLE001
                ring = []
        path = ""
        if self.policy.dir:
            # nan_guard-only armor (no quarantine= DLQ dir) still
            # counts/answers/breaker-trips — it just has nowhere to
            # preserve the pill
            try:
                path = self.dlq.put(
                    buf, error=f"{type(error).__name__}: {error}",
                    stage=stage, tenant=tenant, ring=ring)
            except Exception:  # noqa: BLE001 - a full/broken disk must
                log.exception("armor: DLQ write failed")  # not kill us
        metrics.count("armor.quarantined", tenant=tenant)
        log.warning(
            "armor: quarantined poison request at stage %s (tenant=%s): "
            "%r -> %s", stage, tenant, error, path or "<dlq write failed>")
        if rec is not None and rec.active:
            tid = buf.meta.get(tracing.META_TRACE_ID) \
                if hasattr(buf, "meta") else None
            args = {"error": str(error)[:200]}
            if tenant is not None:
                args["tenant"] = tenant
            if path:
                args["dlq"] = os.path.basename(path)
            try:
                rec.record("armor.quarantine", stage, tid,
                           time.monotonic_ns(), 0, **args)
            except Exception:  # noqa: BLE001 - never raise from here
                pass
        self.breaker.record_poison(tenant)
        return path

    # -- nan guard ---------------------------------------------------------
    @staticmethod
    def nonfinite(buf) -> bool:
        """True when any float tensor of ``buf`` holds NaN/Inf.  Forces
        host materialization of device outputs — the cost of turning
        silent numeric corruption into a typed poison, paid only when
        ``nan_guard=True``."""
        for t in getattr(buf, "tensors", []):
            if isinstance(t, torch.Tensor):
                if t.is_floating_point() and t.numel() \
                        and not bool(torch.isfinite(t).all()):
                    return True
                continue
            a = np.asarray(t)
            if a.dtype.kind == "f" and a.size \
                    and not np.isfinite(a).all():
                return True
        return False


def poison_terminator(buf, error: BaseException):
    """The typed answer a poisoned request's client receives: an empty
    buffer keeping the request's routing meta (conn/msg/tenant/trace
    ids) with ``abort_reason="poison"``.  Runners forward it without
    invoking stages (:data:`META_POISON`); the serversink routes it like
    any response; streaming consumers see ``stream_aborted`` when the
    request was a token stream."""
    term = buf.with_tensors([])
    term.meta.pop("_host_post", None)
    term.meta[META_POISON] = True
    term.meta[META_ABORT_REASON] = ABORT_REASON_POISON
    term.meta["error"] = f"{type(error).__name__}: {str(error)[:200]}"
    if META_STREAM_INDEX in term.meta:
        term.meta[META_STREAM_LAST] = True
        term.meta[META_STREAM_ABORTED] = True
    return term
