"""The port's shared-memory ring and shmsink / shmsrc, in one process over
the ring's ``bytearray`` backing (``backing=memory``).

The ring keeps the C++ ring's layout (``nnstreamer_tpu/native/src/
nnstpu.cpp``: ``Header | slot_lens[nslots] u64 | slots``) and its
semantics, case by case as ``tests/test_native.py`` holds the C++ one:
capacity, close, oversize, a live duplicate name.  A slot holds the JAX
package's wire bytes for the same buffer.  The POSIX segment across two
processes runs only in ``chip_smoke.py``.
"""

import itertools
import struct
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.utils import wire as jwire
from nnstreamer_tpu_torch.elements import shm

WAIT = 10.0
_names = itertools.count()


@pytest.fixture
def name():
    """A segment name of this test's own; nothing is left behind."""
    n = f"/nnstpu_test_{next(_names)}"
    yield n
    assert n not in shm.STORES["memory"]._segs


def test_header_is_the_cpp_ring_header():
    # magic u32, nslots u32, slot_bytes u64, owner_pid u64, head u64,
    # tail u64, closed u32, padding to 8: sizeof(RingHeader) == 48
    assert shm._HDR.size == 48
    assert (shm._OFF_HEAD, shm._OFF_TAIL, shm._OFF_CLOSED) == (24, 32, 40)
    assert shm.ring_bytes(4, 256) == 48 + 4 * 8 + 4 * 256


def test_layout_of_a_written_ring(name):
    r = shm.ShmRing.create(name, 4, 64, backing="memory")
    try:
        assert r.try_put(b"abc") and r.try_put(b"hello")
        raw = r._buf
        magic, nslots, slot_bytes, pid, head, tail, closed = shm._HDR.unpack_from(raw, 0)
        assert (magic, nslots, slot_bytes, head, tail, closed) == (
            0x4E535247, 4, 64, 2, 0, 0)
        assert pid > 0
        lens = struct.unpack_from("<4Q", raw, 48)
        assert lens[:2] == (3, 5)
        slots = 48 + 4 * 8
        assert bytes(raw[slots:slots + 3]) == b"abc"
        assert bytes(raw[slots + 64:slots + 69]) == b"hello"
    finally:
        r.free()


def test_roundtrip_and_capacity(name):
    r = shm.ShmRing.create(name, 4, 256, backing="memory")
    try:
        c = shm.ShmRing.open(name, backing="memory")
        assert c.try_get() is None
        for i in range(4):
            assert r.try_put(bytes([i]) * (i + 1))
        assert not r.try_put(b"overflow")  # full
        for i in range(4):
            assert c.try_get() == bytes([i]) * (i + 1)
        assert r.try_put(b"again")
        assert c.try_get() == b"again"
        c.free()
    finally:
        r.free()


def test_wraps_around_many_times(name):
    r = shm.ShmRing.create(name, 3, 16, backing="memory")
    c = shm.ShmRing.open(name, backing="memory")
    try:
        got = []
        for i in range(20):
            assert r.try_put(str(i).encode())
            if i % 2:
                got += [c.try_get(), c.try_get()]
        assert got == [str(i).encode() for i in range(20)]
    finally:
        c.free()
        r.free()


def test_close_signals_consumer(name):
    r = shm.ShmRing.create(name, 2, 64, backing="memory")
    c = shm.ShmRing.open(name, backing="memory")
    try:
        assert r.try_put(b"last")
        assert not c.closed
        r.close_write()
        assert c.closed and r.closed
        assert not r.try_put(b"after")  # a closed ring takes nothing more
        assert c.try_get() == b"last"  # what was committed still drains
    finally:
        c.free()
        r.free()


def test_oversize_payload_rejected(name):
    r = shm.ShmRing.create(name, 2, 16, backing="memory")
    try:
        with pytest.raises(ValueError):
            r.try_put(b"x" * 17)
        assert r.try_put(b"x" * 16)
    finally:
        r.free()


def test_create_refuses_live_duplicate(name):
    r = shm.ShmRing.create(name, 2, 64, backing="memory")
    try:
        with pytest.raises(OSError):
            shm.ShmRing.create(name, 2, 64, backing="memory")
    finally:
        r.free()
    # after free (the owner unlinked it) the name is reusable
    shm.ShmRing.create(name, 2, 64, backing="memory").free()


def test_create_reclaims_a_dead_owners_ring(name):
    r = shm.ShmRing.create(name, 2, 64, backing="memory")
    struct.pack_into("<Q", r._buf, 16, 0)  # no owner: as after a crash
    r2 = shm.ShmRing.create(name, 4, 32, backing="memory")
    try:
        assert (r2.nslots, r2.slot_bytes) == (4, 32)
    finally:
        r2.free()


def test_open_before_create_and_unknown_backing(name):
    with pytest.raises(OSError):
        shm.ShmRing.open(name, backing="memory")
    with pytest.raises(Exception, match="backing"):
        shm.ShmRing.create(name, 2, 64, backing="tape")


def test_an_unsized_segment_is_not_ready_and_shmsrc_waits(name, monkeypatch):
    """A POSIX segment opened between the producer's ``shm_open`` and its
    ``ftruncate`` has nothing to map (``SharedMemory`` raises
    ``ValueError``): the ring is not ready yet, and ``shmsrc`` waits on
    as it does for a ring that is not there."""
    store = shm.STORES["memory"]
    real, calls = store.open, []

    def unsized_twice(n):
        calls.append(n)
        if len(calls) <= 2:
            raise ValueError("cannot mmap an empty file")
        return real(n)

    monkeypatch.setattr(store, "open", unsized_twice)
    ring = shm.ShmRing.create(name, 2, 64, backing="memory")
    try:
        with pytest.raises(OSError, match="not ready"):
            shm.ShmRing.open(name, backing="memory")
        src = shm.ShmSrc({"socket_path": name, "backing": "memory",
                          "connect_timeout": str(WAIT)})
        src.start()
        assert len(calls) == 3 and src._ring is not None
        src.stop()
    finally:
        ring.free()


def test_a_slot_holds_the_jax_wire_bytes(name):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.integers(0, 255, (2, 5), dtype=np.uint8)]
    with ntt.Pipeline(f"appsrc name=src ! shmsink socket-path={name} backing=memory "
                      "buffers=4") as p:
        ring = shm.ShmRing.open(name, backing="memory")
        p.push("src", ntt.Buffer(arrays, pts=77, seqno=9, meta={"k": "v"}))
        deadline = time.monotonic() + WAIT
        data = None
        while data is None and time.monotonic() < deadline:
            data = ring.try_get()
        ring.free()
        p.eos("src")
        p.wait(timeout=WAIT)
    assert data == jwire.encode_buffer(nt.Buffer(arrays, pts=77, seqno=9, meta={"k": "v"}))


def _pair(name, n, extra=""):
    sink = ntt.Pipeline(f"appsrc name=src ! shmsink socket-path={name} backing=memory "
                        f"buffers=2 {extra}")
    src = ntt.Pipeline(f"shmsrc socket-path={name} backing=memory num-buffers={n} "
                       "connect-timeout=5 ! tensor_sink name=out to-host=false")
    return sink, src


def test_shmsink_feeds_shmsrc_in_order(name):
    gen = torch.Generator().manual_seed(1)
    bufs = [ntt.Buffer([torch.randn(2, 3, generator=gen).to(torch.bfloat16),
                        np.arange(i, i + 4, dtype=np.int32)], pts=100 + i)
            for i in range(6)]
    for b in bufs:
        b.meta["label"] = f"f{b.pts}"
    sink, src = _pair(name, len(bufs))
    with sink, src:
        for b in bufs:  # the ring holds 2: the sink blocks until src reads
            sink.push("src", b)
        got = [src.pull("out", timeout=WAIT) for _ in bufs]
        sink.eos("src")
        sink.wait(timeout=WAIT)
        src.wait(timeout=WAIT)
    for g, w in zip(got, bufs):
        assert g.pts == w.pts and g.meta["label"] == w.meta["label"]
        assert g.tensors[0].dtype == torch.bfloat16 and torch.equal(g.tensors[0], w.tensors[0])
        assert np.array_equal(g.tensors[1], w.tensors[1])


def test_shmsrc_drains_then_ends_at_the_producers_eos(name):
    sink, src = _pair(name, -1)
    with sink:
        sink.push("src", np.arange(3, dtype=np.int16))
        with src:
            first = src.pull("out", timeout=WAIT)
            sink.push("src", np.arange(3, 6, dtype=np.int16))
            sink.eos("src")
            sink.wait(timeout=WAIT)
            second = src.pull("out", timeout=WAIT)
            src.wait(timeout=WAIT)  # closed and drained: EOS
    assert first.tensors[0].tolist() == [0, 1, 2]
    assert second.tensors[0].tolist() == [3, 4, 5]


def test_shmsink_drop_drops_the_newest_when_full(name):
    from nnstreamer_tpu_torch.core.log import metrics

    with ntt.Pipeline(f"appsrc name=src ! shmsink name=snk socket-path={name} "
                      "backing=memory buffers=2 drop=true") as p:
        ring = shm.ShmRing.open(name, backing="memory")
        for i in range(5):
            p.push("src", np.full((2,), i, np.uint8))
        p.eos("src")
        p.wait(timeout=WAIT)
        kept = []
        while (data := ring.try_get()) is not None:
            kept.append(data)
        ring.free()
    assert len(kept) == 2
    assert metrics.snapshot().get("snk.dropped", 0) >= 3


def test_shmsrc_without_a_producer_times_out(name):
    with pytest.raises(Exception):
        with ntt.Pipeline(f"shmsrc socket-path={name} backing=memory connect-timeout=0.1 "
                          "! tensor_sink name=out"):
            pass


def test_shm_element_needs_a_name():
    with pytest.raises(Exception, match="socket-path"):
        ntt.Pipeline("appsrc name=src ! shmsink")
