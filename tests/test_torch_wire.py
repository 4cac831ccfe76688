"""The port's host modules of the query front door against the JAX
package's: the tensor wire codec byte for byte (frames, corrupt-frame
rejects, bf16 without ``ml_dtypes``), the request journal's records, the
flight recorder's ring dumps, the stream registry and the tenant-labelled
metrics."""

import os
import socket
import struct
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
from nnstreamer_tpu.utils import journal as jjournal
from nnstreamer_tpu.utils import tracing as jtracing
from nnstreamer_tpu.utils import wire as jwire
from nnstreamer_tpu_torch.core.buffer import Buffer as PBuffer
from nnstreamer_tpu_torch.core.log import Metrics
from nnstreamer_tpu_torch.utils import elastic as pelastic
from nnstreamer_tpu_torch.utils import journal as pjournal
from nnstreamer_tpu_torch.utils import tracing as ptracing
from nnstreamer_tpu_torch.utils import wire as pwire

REPO = Path(__file__).resolve().parent.parent

#: meta a served token carries over the wire: stream keys, tenant, the
#: client's message id and trace parent
META = {"_query_msg": 3, "stream_id": (5 << 32) | 9, "stream_index": 2,
        "stream_last": True, "emit_t": 12.5, "_tenant": "gold",
        "_tparent": (7 << 32) | 1}


def _arrays(kind, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "int32": [rng.integers(-9, 9, (3, 4)).astype(np.int32)],
        "uint8": [rng.integers(0, 255, (7,), dtype=np.uint8)],
        "float32": [rng.standard_normal((2, 3, 5)).astype(np.float32)],
        "bfloat16": [rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)],
        "token": [np.asarray([417], np.int32), np.frombuffer(b"ab", np.uint8)],
        "empty": [],
    }[kind]


def _torch_of(a):
    """The same values as a torch tensor (bf16 through its 2-byte bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _pair(kind, meta):
    arrs = _arrays(kind)
    jb = nt.Buffer(list(arrs), pts=1234, meta=dict(meta))
    jb.seqno = 77
    pb = PBuffer(list(arrs), pts=1234, meta=dict(meta), seqno=77)
    return jb, pb, arrs


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


KINDS = ["int32", "uint8", "float32", "bfloat16", "token", "empty"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("meta", [{}, META], ids=["nometa", "meta"])
def test_encode_is_byte_identical_to_jax(kind, meta):
    jb, pb, _ = _pair(kind, meta)
    raw = jwire.encode_buffer(jb)
    assert pwire.encode_buffer(pb) == raw
    assert pwire.frame_bytes(raw) == bytes(jwire.frame_bytes(raw))


@pytest.mark.parametrize("kind", ["int32", "float32", "bfloat16", "token"])
def test_torch_tensors_encode_as_their_numpy_values(kind):
    arrs = _arrays(kind)
    as_np = pwire.encode_buffer(PBuffer(list(arrs), meta=dict(META), seqno=1))
    as_torch = pwire.encode_buffer(
        PBuffer([_torch_of(a) for a in arrs], meta=dict(META), seqno=1))
    assert as_torch == as_np


@pytest.mark.parametrize("kind", KINDS)
def test_each_side_decodes_the_others_frames(kind):
    jb, pb, arrs = _pair(kind, META)
    from_jax, _ = pwire.decode_buffer(jwire.encode_buffer(jb))
    from_port, _ = jwire.decode_buffer(pwire.encode_buffer(pb))
    for got in (from_jax, from_port):
        assert got.meta == META and got.pts == 1234 and got.seqno == 77
        assert len(got.tensors) == len(arrs)
        for t, a in zip(got.tensors, arrs):
            assert tuple(t.shape) == a.shape
            np.testing.assert_array_equal(_bits(t), _bits(a))
    # the port decodes bf16 into torch, everything else into numpy
    for t, a in zip(from_jax.tensors, arrs):
        want = torch.Tensor if a.dtype == ml_dtypes.bfloat16 else np.ndarray
        assert isinstance(t, want)


def test_salvage_meta_agrees():
    raw = jwire.encode_buffer(nt.Buffer(_arrays("token"), meta=dict(META)))
    broken = raw[:-3]  # the tensor section is cut, the meta survives
    assert pwire.salvage_meta(broken) == jwire.salvage_meta(broken) == META
    assert pwire.salvage_meta(b"junk") is jwire.salvage_meta(b"junk") is None


class _Stream:
    """A socket-like reader over fixed bytes."""

    def __init__(self, data: bytes):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def _framed():
    return bytes(jwire.frame_bytes(
        jwire.encode_buffer(nt.Buffer(_arrays("token"), meta=dict(META)))))


def _bad_crc():
    f = bytearray(_framed())
    f[-1] ^= 0xFF
    return bytes(f)


def _oversize():
    return struct.pack("<Q", (512 << 20) + 1) + b"x" * 16


@pytest.mark.parametrize("make", [_bad_crc, _oversize],
                         ids=["bad_crc", "oversize_length"])
def test_both_sides_reject_the_same_corrupt_frame(make):
    raw = make()
    for mod in (jwire, pwire):
        with pytest.raises(mod.WireError):
            mod.read_frame(_Stream(raw))
        with pytest.raises(mod.WireError):
            mod.unframe_bytes(raw)


@pytest.mark.parametrize("mutate", [
    lambda r: b"XXXX" + r[4:],                      # bad magic
    lambda r: r[:-1],                               # truncated tensor
    lambda r: r + b"\x00",                          # trailing byte
    lambda r: r.replace(b"int32", b"int64", 1),     # dims x itemsize lie
], ids=["magic", "truncated", "trailing", "nbytes"])
def test_both_sides_reject_the_same_bad_payload(mutate):
    raw = mutate(jwire.encode_buffer(nt.Buffer(_arrays("token"),
                                               meta=dict(META))))
    with pytest.raises(jwire.WireError):
        jwire.decode_buffer(raw)
    with pytest.raises(pwire.WireError):
        pwire.decode_buffer(raw)


def test_frames_cross_a_real_socket_both_ways():
    a, b = socket.socketpair()
    try:
        payload = jwire.encode_buffer(nt.Buffer(_arrays("float32"),
                                                meta=dict(META)))
        pwire.write_frame(a, payload)
        assert jwire.read_frame(b) == payload
        jwire.write_frame(b, payload)
        assert pwire.read_frame(a) == payload
    finally:
        a.close()
        b.close()


def test_bf16_wire_without_ml_dtypes():
    """bf16 goes through torch's 2-byte views: in a process where
    ``ml_dtypes`` cannot be imported, a bf16 tensor encodes to the bytes
    the JAX package writes and decodes back bit for bit."""
    arr = _arrays("bfloat16")[0]
    want = jwire.encode_buffer(nt.Buffer([arr], meta={"k": 1}))
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from nnstreamer_tpu_torch.core.buffer import Buffer\n"
        "from nnstreamer_tpu_torch.utils import wire\n"
        "bits = np.frombuffer(bytes.fromhex(sys.argv[1]), np.int16)"
        f".reshape({arr.shape})\n"
        "t = torch.from_numpy(bits.copy()).view(torch.bfloat16)\n"
        "raw = wire.encode_buffer(Buffer([t], meta={'k': 1}, seqno=0))\n"
        "back, _ = wire.decode_buffer(raw)\n"
        "u = back.tensors[0]\n"
        "assert u.dtype == torch.bfloat16 and torch.equal(u, t)\n"
        "assert 'ml_dtypes' not in sys.modules or sys.modules['ml_dtypes'] is None\n"
        "print(raw.hex())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, arr.view(np.int16).tobytes().hex()],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = bytes.fromhex(out.stdout.strip())
    # the seqno differs (the JAX buffer minted its own): compare the rest
    hdr = struct.calcsize("<IIIIqQI")
    assert got[:hdr - 12] == want[:hdr - 12] and got[hdr:] == want[hdr:]


# -- journal, flight recorder, registry, metrics -----------------------------

def test_journal_records_replay_across_packages(tmp_path):
    """The journal's record layout is shared: requests the JAX package
    journaled and did not answer are what the port recovers, and the
    other way round."""
    for writer, reader in ((jjournal, pjournal), (pjournal, jjournal)):
        d = tmp_path / writer.__name__.split(".")[0]
        j = writer.Journal(str(d), fsync="off")
        seqs = [j.append(f"req{i}".encode(), tenant="t") for i in range(4)]
        j.ack(seqs[1])
        j.close()
        r = reader.Journal(str(d), fsync="off")
        got = [(s, p) for s, p in r.recovered_unanswered]
        r.close()
        assert got == [(seqs[i], f"req{i}".encode()) for i in (0, 2, 3)]


def test_ring_dump_loads_in_the_jax_package(tmp_path):
    rec = ptracing.FlightRecorder("ring", capacity=16)
    rec.record("ingress", "src", ptracing.next_trace_id(), 10, 0, pts=1)
    rec.record("stage", "f", None, 20, 5, tenant="gold")
    path = str(tmp_path / "ring.nns")
    assert ptracing.dump_ring(path, rec, proc="port") == 2
    ring = jtracing.load_ring(path)
    assert ring["proc"] == "port" and ring["epoch"] == ptracing.trace_epoch()
    assert [(s.kind, s.stage, s.ts, s.dur) for s in ring["spans"]] == \
        [("ingress", "src", 10, 0), ("stage", "f", 20, 5)]
    assert ptracing.load_ring(path)["spans"] == ring["spans"]


def test_trace_and_stream_ids_carry_the_process_epoch():
    tid = ptracing.next_trace_id()
    sid = pelastic.next_stream_id()
    assert tid >> 32 == sid >> 32 == ptracing.trace_epoch() > 0
    assert 0 < tid < (1 << 63) and 0 < sid < (1 << 63)
    assert pelastic.next_stream_id() != sid


def test_stream_registry_cancel_contract():
    calls = []
    sid = pelastic.next_stream_id()
    pelastic.register_stream(sid, lambda reason, force: calls.append(
        (reason, force)))
    try:
        assert sid in pelastic.live_stream_ids()
        assert pelastic.cancel_stream(str(sid), "dead-connection")
        assert pelastic.cancel_stream(sid, "x", force=True)
        assert calls == [("dead-connection", False), ("x", True)]
    finally:
        pelastic.unregister_stream(sid)
    assert pelastic.cancel_stream(sid) is False
    assert pelastic.cancel_stream(None) is False
    assert pelastic.cancel_stream("not-an-id") is False


def test_tenant_labelled_metrics():
    m = Metrics()
    m.count("query_server.in", tenant="gold")
    m.count("query_server.in", 2)
    m.observe_latency("out.e2e", 0.003, tenant="gold")
    m.gauge("query_server.backlog", 4.0)
    m.gauge("query_server.backlog", 1.0, tenant="gold")
    snap = m.snapshot()
    assert snap["query_server.in"] == 3
    assert snap["query_server.backlog"] == 4.0
    assert m.labeled_counters() == {("query_server.in", "gold"): 1.0}
    assert m.labeled_gauges() == {("query_server.backlog", "gold"): 1.0}
    assert m.tenants("out.e2e") == ["gold"]
    counts, total, n = m.histograms()["out.e2e"]
    assert n == 1 and sum(counts) == 1 and total == pytest.approx(0.003)
    assert m.percentile("out.e2e", 99, tenant="gold") == pytest.approx(0.003)
