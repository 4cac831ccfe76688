"""Tensor wire format: self-describing serialization of a Buffer.

Reference analog: the flatbuf/protobuf/flexbuf codecs
(``ext/nnstreamer/tensor_decoder/tensordec-flatbuf.cc`` etc., SURVEY
§2.5/2.6) that serialize ``other/tensors`` for IPC — and the framing
nnstreamer-edge puts on the wire (§2.7).  One codec serves all of:
``tensor_decoder mode=flexbuf``, ``tensor_converter mode=flexbuf``, the
tensor_query TCP protocol, and edge pub/sub.

Layout (little-endian):

    u32 magic "NNST" | u32 version | u32 flags | u32 num_tensors
    | i64 pts (-1 = none) | u64 seqno | u32 meta_len | meta (utf-8 JSON)
    per tensor:
      u32 rank | u32 dims[rank] (innermost-first) | u32 name_len
      | dtype_name utf-8 | u64 nbytes | raw bytes (C-order)

JSON meta keeps only JSON-representable entries; numpy scalars/arrays in
meta are converted (arrays to nested lists) — sufficient for detection/query
metadata.  Dropped (non-JSON) meta keys are counted (``wire.meta_dropped``)
and logged once per key at debug so journal/DLQ replays losing meta is
diagnosable, never silent.

Hardening (docs/ROBUSTNESS.md): every field the decoder reads is
attacker-controlled on the public front door.  :func:`decode_buffer` and
:func:`read_frame` therefore enforce strict, configurable
:class:`WireLimits` — max rank/dims/tensor bytes/meta bytes/tensor
count/frame bytes, a dtype-name whitelist, and declared-vs-actual length
cross-checks — and EVERY reject raises the typed :exc:`WireError`
(a ``ValueError`` subclass, so pre-armor ``except ValueError`` handlers
keep working).  A crafted header can no longer surface as a raw
``struct.error`` in a server read loop or trigger a multi-gigabyte
allocation: declared sizes are validated BEFORE any allocation, and
socket reads are chunked (``_RECV_CHUNK``) so ``recv`` never allocates
more than 1 MiB at a time.  CRC framing (``read_frame``/``write_frame``)
is mandatory on every framed transport.

Port of ``nnstreamer_tpu/utils/wire.py``: the same bytes for the same
buffers, so a client of either package talks to a server of the other.
Three changes, none to the format:

* framing computes its CRC with ``zlib.crc32`` and assembles a frame with
  one ``b"".join``, exactly what the JAX package's fallback computes when
  its native library is absent (this package has no native library);
* a torch tensor is copied to the host explicitly, once, before its
  bytes are taken (a tensor on the card cannot go through
  ``np.asarray``);
* ``bfloat16`` is encoded from, and decoded into, torch tensors through
  2-byte views, so the codec does not need ``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.log import logger, metrics
from ..core.types import _DTYPE_NAMES, dtype_from_name, dtype_name

log = logger(__name__)

MAGIC = 0x4E4E5354  # "NNST"
VERSION = 1

_HDR_FMT = "<IIIIqQI"
_HDR_SIZE = struct.calcsize(_HDR_FMT)

#: max bytes a single ``recv`` may be asked for (bounds the transient
#: allocation a hostile length prefix can force inside ``_read_exact``)
_RECV_CHUNK = 1 << 20


class WireError(ValueError):
    """Typed reject of a wire frame/payload that violates the format or
    the configured :class:`WireLimits`.

    Subclasses ``ValueError`` so every pre-armor handler (the query
    client rx loop's ``except ValueError``) keeps catching it; new code
    should catch ``WireError`` and answer/count it per tenant instead of
    tearing the connection down (docs/ROBUSTNESS.md)."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass(frozen=True)
class WireLimits:
    """Bounds enforced by :func:`decode_buffer` / :func:`read_frame`.

    Defaults are deliberately generous for trusted intra-host pipelines
    (a 256 MiB tensor is a 4K video batch, not a query request) and
    env-overridable for hardened front doors:
    ``NNS_TPU_WIRE_MAX_TENSOR_BYTES``, ``NNS_TPU_WIRE_MAX_META_BYTES``,
    ``NNS_TPU_WIRE_MAX_FRAME_BYTES``, ``NNS_TPU_WIRE_MAX_TENSORS``,
    ``NNS_TPU_WIRE_MAX_RANK``.  The dtype whitelist is the codec's own
    name table (core/types) — a wire frame can never name a dtype the
    pipeline would not itself emit."""

    max_tensors: int = 64
    max_rank: int = 16
    max_dim: int = 1 << 28
    max_tensor_bytes: int = 256 << 20
    max_meta_bytes: int = 1 << 20
    max_name_len: int = 64
    max_frame_bytes: int = 512 << 20
    dtype_names: frozenset = frozenset(_DTYPE_NAMES) | {"bool", "bfloat16"}

    @classmethod
    def from_env(cls) -> "WireLimits":
        return cls(
            max_tensors=_env_int("NNS_TPU_WIRE_MAX_TENSORS", 64),
            max_rank=_env_int("NNS_TPU_WIRE_MAX_RANK", 16),
            max_tensor_bytes=_env_int(
                "NNS_TPU_WIRE_MAX_TENSOR_BYTES", 256 << 20),
            max_meta_bytes=_env_int(
                "NNS_TPU_WIRE_MAX_META_BYTES", 1 << 20),
            max_frame_bytes=_env_int(
                "NNS_TPU_WIRE_MAX_FRAME_BYTES", 512 << 20),
        )


#: process defaults (env-resolved once at import; tests construct their
#: own tighter WireLimits and pass them explicitly)
DEFAULT_LIMITS = WireLimits.from_env()


#: meta keys already debug-logged as dropped (bounded; once per key)
_warned_meta_keys: set = set()


def _meta_safe(meta: dict) -> dict:
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
        else:
            try:
                json.dumps(v)
                out[k] = v
            except (TypeError, ValueError):
                # Non-JSON meta cannot ride the wire (or a journal/DLQ
                # record) — count the drop and say so ONCE per key, so a
                # replay missing meta is diagnosable, never a mystery.
                metrics.count("wire.meta_dropped")
                if k not in _warned_meta_keys:
                    if len(_warned_meta_keys) > 1024:
                        _warned_meta_keys.clear()
                    _warned_meta_keys.add(k)
                    log.debug(
                        "wire: dropping non-JSON meta key %r (%s) from "
                        "encoded buffer; further drops of this key are "
                        "counted in wire.meta_dropped only",
                        k, type(v).__name__)
                continue
    return out


def _host_payload(t) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of one tensor.  A torch tensor
    is copied to the host once, explicitly; bf16 goes through a 2-byte
    integer view, so neither side needs a numpy bfloat16."""
    if isinstance(t, torch.Tensor):
        h = t.detach().cpu().contiguous()
        if h.dtype == torch.bfloat16:
            return (tuple(h.shape), "bfloat16",
                    h.view(torch.int16).numpy().tobytes())
        a = h.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(t))
    return a.shape, dtype_name(a.dtype), a.tobytes()


def _bf16_tensor(raw: bytes, off: int, count: int,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """A decoded bf16 tensor: the payload's 2-byte words, viewed as
    bfloat16 (a copy, so the tensor owns writable memory)."""
    words = np.frombuffer(raw, np.int16, count=count, offset=off)
    return torch.from_numpy(words.copy()).view(torch.bfloat16).reshape(shape)


def encode_buffer(buf: Buffer, flags: int = 0) -> bytes:
    meta = json.dumps(_meta_safe(buf.meta)).encode("utf-8")
    parts = [
        struct.pack(
            _HDR_FMT,
            MAGIC,
            VERSION,
            flags,
            len(buf.tensors),
            buf.pts if buf.pts is not None else -1,
            buf.seqno,
            len(meta),
        ),
        meta,
    ]
    for t in buf.tensors:
        shape, name, raw = _host_payload(t)
        if name.strip().lower() not in DEFAULT_LIMITS.dtype_names:
            # symmetric with the decode whitelist: fail LOUDLY at
            # encode instead of producing bytes (a DLQ record, a
            # journal entry) the decoder can never read back
            raise WireError(
                f"dtype {name!r} is not wire-serializable "
                f"(whitelist: {sorted(DEFAULT_LIMITS.dtype_names)})")
        dname = name.encode()
        dims = [int(d) for d in reversed(shape)]  # innermost-first
        parts.append(
            struct.pack(f"<I{len(dims)}II", len(dims), *dims, len(dname))
        )
        parts.append(dname)
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _unpack(fmt: str, raw: bytes, off: int, what: str):
    """``struct.unpack_from`` with truncation surfaced as a typed
    :exc:`WireError` instead of an uncaught ``struct.error``."""
    try:
        return struct.unpack_from(fmt, raw, off)
    except struct.error as e:
        raise WireError(f"truncated wire payload ({what}): {e}") from None


def decode_buffer(raw: bytes,
                  limits: WireLimits = None) -> Tuple[Buffer, int]:
    """Decode one buffer; returns (buffer, flags).

    Every malformed/oversized field raises :exc:`WireError` — declared
    sizes are bounds-checked against ``limits`` (default
    :data:`DEFAULT_LIMITS`) and cross-checked against the actual payload
    BEFORE any array is materialized, so a hostile header cannot crash
    the caller with ``struct.error`` or force a giant allocation."""
    lim = limits or DEFAULT_LIMITS
    magic, version, flags, n, pts, seqno, meta_len = _unpack(
        _HDR_FMT, raw, 0, "header")
    if magic != MAGIC:
        raise WireError("bad wire magic")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version}")
    if n > lim.max_tensors:
        raise WireError(
            f"tensor count {n} exceeds limit {lim.max_tensors}")
    if meta_len > lim.max_meta_bytes:
        raise WireError(
            f"meta length {meta_len} exceeds limit {lim.max_meta_bytes}")
    off = _HDR_SIZE
    if off + meta_len > len(raw):
        raise WireError(
            f"declared meta length {meta_len} overruns payload "
            f"({len(raw) - off} bytes left)")
    if meta_len:
        try:
            meta = json.loads(raw[off:off + meta_len].decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise WireError(f"bad wire meta json: {e}") from None
        if not isinstance(meta, dict):
            raise WireError(
                f"wire meta must be a JSON object, got "
                f"{type(meta).__name__}")
    else:
        meta = {}
    off += meta_len
    tensors: List[Any] = []
    for ti in range(n):
        (rank,) = _unpack("<I", raw, off, f"tensor {ti} rank")
        off += 4
        if rank > lim.max_rank:
            raise WireError(
                f"tensor {ti} rank {rank} exceeds limit {lim.max_rank}")
        dims = _unpack(f"<{rank}I", raw, off, f"tensor {ti} dims")
        off += 4 * rank
        (name_len,) = _unpack("<I", raw, off, f"tensor {ti} name_len")
        off += 4
        if name_len > lim.max_name_len:
            raise WireError(
                f"tensor {ti} dtype name length {name_len} exceeds "
                f"limit {lim.max_name_len}")
        if off + name_len > len(raw):
            raise WireError(f"tensor {ti} dtype name overruns payload")
        try:
            name = raw[off:off + name_len].decode("utf-8")
        except UnicodeDecodeError:
            raise WireError(
                f"tensor {ti} dtype name is not utf-8") from None
        key = name.strip().lower()
        if key not in lim.dtype_names:
            # whitelist BEFORE dtype_from_name's permissive numpy
            # fallback: the wire may only name dtypes the codec emits
            raise WireError(
                f"tensor {ti} dtype {name!r} not in the wire whitelist")
        dtype = (np.dtype(np.int16) if key == "bfloat16"
                 else dtype_from_name(key))
        off += name_len
        (nbytes,) = _unpack("<Q", raw, off, f"tensor {ti} nbytes")
        off += 8
        if nbytes > lim.max_tensor_bytes:
            raise WireError(
                f"tensor {ti} declares {nbytes} bytes, limit "
                f"{lim.max_tensor_bytes}")
        expect = int(dtype.itemsize)
        for d in dims:
            if d > lim.max_dim:
                raise WireError(
                    f"tensor {ti} dim {d} exceeds limit {lim.max_dim}")
            expect *= int(d)
        if expect != nbytes:
            # the declared-vs-derived cross-check: dims x itemsize IS
            # the byte count; any mismatch is a forged header
            raise WireError(
                f"tensor {ti} declares {nbytes} bytes but dims "
                f"{tuple(int(d) for d in dims)} x {dtype} = {expect}")
        if off + nbytes > len(raw):
            raise WireError(
                f"tensor {ti} payload ({nbytes} bytes) overruns frame "
                f"({len(raw) - off} bytes left)")
        shape = tuple(reversed(dims))
        if key == "bfloat16":
            tensors.append(_bf16_tensor(raw, off, nbytes // 2, shape))
        else:
            arr = np.frombuffer(raw, dtype, count=nbytes // dtype.itemsize,
                                offset=off)
            tensors.append(arr.reshape(shape))
        off += nbytes
    if off != len(raw):
        raise WireError(
            f"{len(raw) - off} trailing bytes after the last declared "
            "tensor")
    buf = Buffer(tensors, pts=None if pts < 0 else pts, meta=meta)
    buf.seqno = seqno
    return buf, flags


def salvage_meta(raw: bytes,
                 limits: WireLimits = None) -> Optional[dict]:
    """Best-effort recovery of just the header meta of a payload
    :func:`decode_buffer` rejected — so a server can answer a malformed
    request's ``_query_msg`` with a TYPED reject instead of leaving the
    client to wait out its timeout.  Returns the meta dict when the
    header + meta section parse within limits, else None.  Never
    raises (it runs inside reject handlers)."""
    lim = limits or DEFAULT_LIMITS
    try:
        magic, version, _flags, _n, _pts, _seq, meta_len = \
            struct.unpack_from(_HDR_FMT, raw, 0)
        if magic != MAGIC or version != VERSION \
                or meta_len > lim.max_meta_bytes \
                or _HDR_SIZE + meta_len > len(raw):
            return None
        if not meta_len:
            return {}
        meta = json.loads(
            raw[_HDR_SIZE:_HDR_SIZE + meta_len].decode("utf-8"))
        return meta if isinstance(meta, dict) else None
    except Exception:  # noqa: BLE001 - salvage is best-effort by contract
        return None


def read_frame(sock, limits: WireLimits = None) -> Optional[bytes]:
    """Read one crc-protected, length-prefixed frame from a socket-like
    object (``u64 len | payload | u32 crc32``).

    With a socket timeout set, ``socket.timeout`` propagates ONLY while the
    stream is idle (no header byte read yet) — callers use that to poll
    their stop flags.  Once a frame has started, timeouts are swallowed and
    the read continues: dropping partially-read bytes would desync the
    length-prefixed stream for good.

    A declared length above ``limits.max_frame_bytes`` and a CRC mismatch
    both raise :exc:`WireError` — framing-level violations, after which
    the stream cannot be trusted to resync (callers drop the
    connection); per-frame payload problems surface later, from
    :func:`decode_buffer`, and are recoverable per frame."""
    lim = limits or DEFAULT_LIMITS
    hdr = _read_exact(sock, 8, idle_timeout=True)
    if hdr is None:
        return None
    (length,) = struct.unpack("<Q", hdr)
    if length > lim.max_frame_bytes:
        # reject BEFORE reading (or allocating for) the body: a forged
        # u64 length is the cheapest memory bomb there is
        raise WireError(
            f"frame declares {length} bytes, limit {lim.max_frame_bytes}")
    payload = _read_exact(sock, length)
    if payload is None:
        return None
    tail = _read_exact(sock, 4)
    if tail is None:
        return None
    (crc,) = struct.unpack("<I", tail)
    if _crc(payload) != crc:
        raise WireError("wire frame crc mismatch (corrupt stream)")
    return payload


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def write_frame(sock, payload: bytes) -> None:
    """Send one frame with length prefix + trailing crc32."""
    sock.sendall(frame_bytes(payload))


def frame_bytes(payload: bytes) -> bytes:
    """The exact bytes :func:`write_frame` would put on a socket
    (``u64 len | payload | u32 crc32``) — the file framing flight-recorder
    ring dumps use (utils/tracing.dump_ring)."""
    payload = bytes(payload)
    return b"".join((struct.pack("<Q", len(payload)), payload,
                     struct.pack("<I", _crc(payload))))


def unframe_bytes(raw: bytes, limits: WireLimits = None) -> bytes:
    """Validate and strip the :func:`frame_bytes` framing from an
    in-memory frame (a ring-dump file read whole).  Exactly one frame
    must span the input; length and crc violations raise
    :exc:`WireError` like the socket reader's."""
    lim = limits or DEFAULT_LIMITS
    if len(raw) < 12:
        raise WireError(f"framed blob too short ({len(raw)} bytes)")
    (length,) = struct.unpack_from("<Q", raw, 0)
    if length > lim.max_frame_bytes:
        raise WireError(
            f"frame declares {length} bytes, limit {lim.max_frame_bytes}")
    if len(raw) != 8 + length + 4:
        raise WireError(
            f"framed blob is {len(raw)} bytes, expected "
            f"{8 + length + 4} for the declared payload")
    payload = raw[8:8 + length]
    (crc,) = struct.unpack_from("<I", raw, 8 + length)
    if _crc(payload) != crc:
        raise WireError("wire frame crc mismatch (corrupt dump)")
    return payload


def _read_exact(sock, n: int, idle_timeout: bool = False) -> Optional[bytes]:
    import socket as _socket

    chunks = []
    got = 0
    while got < n:
        try:
            # chunked: recv(k) may allocate k bytes up front, so a huge
            # remaining count must never reach it in one call
            chunk = sock.recv(min(n - got, _RECV_CHUNK))
        except _socket.timeout:
            if idle_timeout and got == 0:
                raise
            continue  # mid-frame stall: keep the partial bytes, keep reading
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
