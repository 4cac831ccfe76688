"""Shared-memory pipeline hand-off elements.

Port of ``nnstreamer_tpu/elements/shm.py`` (reference analog: GStreamer's
``shmsink``/``shmsrc``, linking pipelines across processes on one host
without the TCP stack), carrying ``other/tensors`` buffers in the
standard wire format.

The JAX package backs them with its C++ ring (``nnstreamer_tpu/native``).
This package keeps a ring of its own, :class:`ShmRing`, in plain Python
over ``multiprocessing.shared_memory``, with the same layout and
semantics: ``Header | slot_lens[nslots] u64 | slots``, one producer and
one consumer, the producer writing a slot's length before it advances
the head, a full ring refusing the put, closing signalling the consumer,
an oversize payload raising, a live duplicate name refused, and the
creator unlinking the segment.  Its backing store is swappable:
``backing=memory`` keeps the segment in a ``bytearray`` of this process
(the ring's logic, tested in one process), ``posix`` (the default) in
POSIX shared memory across processes.

``shmsink socket-path=/name`` publishes; ``shmsrc socket-path=/name`` in a
second process (or the same one) consumes.  The sink blocks when the ring
is full (backpressure) unless ``drop=true``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, Optional

from ..core.buffer import Buffer
from ..core.caps import Caps
from ..core.log import metrics
from ..core.registry import register_element
from ..utils.wire import decode_buffer, encode_buffer
from .base import ElementError, SinkElement, SourceElement

#: the C++ ``RingHeader``: magic u32, nslots u32, slot_bytes u64,
#: owner_pid u64, head u64, tail u64, closed u32 (+ 4 bytes of padding)
_HDR = struct.Struct("<IIQQQQI4x")
_MAGIC = 0x4E535247  # 'NSRG'
_OFF_HEAD, _OFF_TAIL, _OFF_CLOSED = 24, 32, 40
_U32, _U64 = struct.Struct("<I"), struct.Struct("<Q")


def ring_bytes(nslots: int, slot_bytes: int) -> int:
    return _HDR.size + nslots * 8 + nslots * slot_bytes


class _PosixStore:
    """Segments in POSIX shared memory (``/dev/shm``)."""

    @staticmethod
    def _shm(name, create=False, size=0):
        from multiprocessing import resource_tracker, shared_memory

        seg = shared_memory.SharedMemory(name.lstrip("/"), create=create, size=size)
        # the ring's creator unlinks it in free(), as the C++ ring does (a
        # dead creator's ring is reclaimed by the next create); the
        # tracker must not unlink it when a process that opened it exits
        resource_tracker.unregister(seg._name, "shared_memory")
        return seg

    def create(self, name: str, size: int):
        seg = self._shm(name, create=True, size=size)
        return seg, seg.buf

    def open(self, name: str):
        seg = self._shm(name)
        return seg, seg.buf

    @staticmethod
    def close(seg) -> None:
        seg.close()

    @staticmethod
    def unlink(seg) -> None:
        from multiprocessing import shared_memory

        shared_memory._posixshmem.shm_unlink(seg._name)  # no tracker message


class _MemoryStore:
    """Segments in ``bytearray``s of this process, by name."""

    def __init__(self):
        self._segs: Dict[str, bytearray] = {}
        self._lock = threading.Lock()

    def create(self, name: str, size: int):
        with self._lock:
            if name in self._segs:
                raise FileExistsError(f"segment {name!r} exists")
            seg = self._segs[name] = bytearray(size)
        return name, memoryview(seg)

    def open(self, name: str):
        with self._lock:
            seg = self._segs.get(name)
        if seg is None:
            raise FileNotFoundError(f"no segment {name!r}")
        return name, memoryview(seg)

    @staticmethod
    def close(seg) -> None:
        pass

    def unlink(self, name) -> None:
        with self._lock:
            self._segs.pop(name, None)


STORES = {"posix": _PosixStore(), "memory": _MemoryStore()}


def _store(backing: str):
    try:
        return STORES[backing]
    except KeyError:
        raise ElementError(f"shm backing {backing!r}: one of {sorted(STORES)}") from None


def _owner_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class ShmRing:
    """SPSC ring of fixed-size slots in a named segment.

    Producer: ``ring = ShmRing.create(name, nslots, slot_bytes)`` then
    ``ring.try_put(bytes)``; consumer: ``ShmRing.open(name)`` then
    ``ring.try_get()``.  ``backing`` names the store (``posix`` or
    ``memory``)."""

    def __init__(self, store, seg, buf, name: str, owner: bool):
        self._store, self._seg, self._buf = store, seg, buf
        self.name = name
        self._owner = owner
        _magic, self.nslots, self.slot_bytes, _pid, _h, _t, _c = _HDR.unpack_from(buf, 0)
        self._lens = _HDR.size
        self._slots = _HDR.size + 8 * self.nslots

    @classmethod
    def create(cls, name: str, nslots: int = 8, slot_bytes: int = 1 << 20,
               backing: str = "posix") -> "ShmRing":
        store = _store(backing)
        size = ring_bytes(nslots, slot_bytes)
        try:
            seg, buf = store.create(name, size)
        except FileExistsError:
            # reclaim only a ring whose producer is demonstrably gone:
            # unlinking a live producer's ring would fork the stream
            if _owner_alive(cls._peek_owner(store, name)):
                raise FileExistsError(
                    f"shm ring {name!r} is owned by a live producer") from None
            old, _ = store.open(name)
            store.unlink(old)
            store.close(old)
            seg, buf = store.create(name, size)
        _HDR.pack_into(buf, 0, 0, nslots, slot_bytes, os.getpid(), 0, 0, 0)
        # the magic last: a consumer polling for the ring must not see it
        # before the geometry is in place
        _U32.pack_into(buf, 0, _MAGIC)
        return cls(store, seg, buf, name, owner=True)

    @staticmethod
    def _peek_owner(store, name: str) -> int:
        try:
            seg, buf = store.open(name)
        except (OSError, ValueError):  # gone, or not sized yet
            return 0
        try:
            if len(buf) < _HDR.size:
                return 0
            magic, _n, _s, pid, _h, _t, _c = _HDR.unpack_from(buf, 0)
            return pid if magic == _MAGIC else 0
        finally:
            del buf
            store.close(seg)

    @classmethod
    def open(cls, name: str, backing: str = "posix") -> "ShmRing":
        store = _store(backing)
        try:
            seg, buf = store.open(name)
        except ValueError:
            # the producer's segment exists but is not sized yet (opened
            # between its shm_open and ftruncate): nothing to map, so the
            # ring is not ready, the same as a header without its magic
            raise OSError(f"shm ring {name!r} is not ready (producer not up?)") from None
        ok = len(buf) >= _HDR.size
        if ok:
            magic, nslots, slot_bytes = _HDR.unpack_from(buf, 0)[:3]
            ok = magic == _MAGIC and len(buf) >= ring_bytes(nslots, slot_bytes)
        if not ok:
            del buf
            store.close(seg)
            raise OSError(f"shm ring {name!r} is not ready (producer not up?)")
        return cls(store, seg, buf, name, owner=False)

    def _get(self, s: struct.Struct, off: int) -> int:
        return s.unpack_from(self._buf, off)[0]

    def try_put(self, data) -> bool:
        n = len(data)
        if n > self.slot_bytes:
            raise ValueError(f"payload {n}B > slot {self.slot_bytes}B")
        if self.closed:
            return False
        head = self._get(_U64, _OFF_HEAD)
        if head - self._get(_U64, _OFF_TAIL) >= self.nslots:
            return False  # full
        i = head % self.nslots
        off = self._slots + i * self.slot_bytes
        self._buf[off:off + n] = data
        _U64.pack_into(self._buf, self._lens + 8 * i, n)
        _U64.pack_into(self._buf, _OFF_HEAD, head + 1)  # publish last
        return True

    def try_get(self) -> Optional[bytes]:
        tail = self._get(_U64, _OFF_TAIL)
        if tail == self._get(_U64, _OFF_HEAD):
            return None  # empty
        i = tail % self.nslots
        n = self._get(_U64, self._lens + 8 * i)
        off = self._slots + i * self.slot_bytes
        data = bytes(self._buf[off:off + n])
        _U64.pack_into(self._buf, _OFF_TAIL, tail + 1)
        return data

    @property
    def closed(self) -> bool:
        return bool(self._get(_U32, _OFF_CLOSED))

    def close_write(self) -> None:
        _U32.pack_into(self._buf, _OFF_CLOSED, 1)

    def free(self) -> None:
        """Unmap; the creator also unlinks the segment."""
        if self._buf is None:
            return
        self._buf = None
        if self._owner:
            self._store.unlink(self._seg)
        self._store.close(self._seg)


def _ring_name(props) -> str:
    name = str(props.get("socket_path", props.get("name_prop", "")) or "")
    if not name:
        raise ElementError("shm element needs socket-path=<shm name>")
    return name if name.startswith("/") else "/" + name


@register_element("shmsink")
class ShmSink(SinkElement):
    """Publish buffers into a shared-memory ring.

    Props: ``socket-path`` (shm name), ``shm-size`` (slot bytes, default
    1 MiB), ``buffers`` (ring slots, default 8), ``drop`` (drop newest when
    full instead of blocking), ``backing`` (``posix`` or ``memory``).
    """

    kind = "shmsink"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.ring_name = _ring_name(self.props)
        self.slot_bytes = int(self.props.get("shm_size", 1 << 20))
        self.nslots = int(self.props.get("buffers", 8))
        self.drop = bool(self.props.get("drop", False))
        self.backing = str(self.props.get("backing", "posix"))
        self._ring: Optional[ShmRing] = None

    def start(self) -> None:
        self._ring = ShmRing.create(self.ring_name, self.nslots, self.slot_bytes,
                                    backing=self.backing)

    def stop(self) -> None:
        if self._ring is not None:
            self._ring.close_write()
            self._ring.free()
            self._ring = None

    def process(self, pad, buf: Buffer):
        payload = encode_buffer(buf.resolve())
        stop = getattr(self, "_stop_event", None)
        while not self._ring.try_put(payload):
            if self.drop:
                metrics.count(f"{self.name}.dropped")
                return []
            if stop is not None and stop.is_set():
                return []
            time.sleep(0.001)  # ring full: backpressure
        metrics.count(f"{self.name}.frames")
        return []

    def finalize(self):
        if self._ring is not None:
            self._ring.close_write()
        return []


@register_element("shmsrc")
class ShmSrc(SourceElement):
    """Consume buffers from a shared-memory ring published by ``shmsink``.

    Props: ``socket-path``, ``num-buffers`` (-1 = until producer closes),
    ``connect-timeout`` seconds to wait for the producer's ring to appear,
    ``backing`` (``posix`` or ``memory``).
    """

    kind = "shmsrc"

    def __init__(self, props=None, name=None):
        super().__init__(props, name)
        self.ring_name = _ring_name(self.props)
        self.num_buffers = int(self.props.get("num_buffers", -1))
        self.connect_timeout = float(self.props.get("connect_timeout", 10.0))
        self.backing = str(self.props.get("backing", "posix"))
        self._ring: Optional[ShmRing] = None

    def configure(self, in_caps, out_pads):
        self.out_caps = {p: Caps.any() for p in out_pads}
        return self.out_caps

    def start(self) -> None:
        deadline = time.monotonic() + self.connect_timeout
        while True:
            try:
                self._ring = ShmRing.open(self.ring_name, backing=self.backing)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)

    def stop(self) -> None:
        if self._ring is not None:
            self._ring.free()
            self._ring = None

    def generate(self):
        n = 0
        stop = getattr(self, "_stop_event", None)
        while self.num_buffers < 0 or n < self.num_buffers:
            data = self._ring.try_get()
            if data is None:
                if self._ring.closed:
                    # Producer EOS'd — but a buffer may have been committed
                    # between our empty read and the close: drain fully.
                    data = self._ring.try_get()
                    if data is None:
                        return
                elif stop is not None and stop.is_set():
                    return
                else:
                    time.sleep(0.001)
                    continue
            buf, _flags = decode_buffer(data)
            metrics.count(f"{self.name}.frames")
            n += 1
            yield buf
