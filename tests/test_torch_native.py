"""The port's native library (``nnstreamer_tpu_torch.native``) against the
JAX package's and against the port's Python paths: ``crc32``,
``strip_stride``, ``wire_gather`` and ``wire_check`` equal the JAX
package's natives, ``zlib`` and the port's wire codec on the same seeded
bytes; the C++ shared-memory ring and the port's Python ring
(``elements/shm.py``) hand buffers to each other across two processes,
both ways, bitwise; and ``shmsink`` / ``shmsrc`` of one package feed the
other's across two processes.

Counterpart of ``tests/test_native.py``.  No library is loaded in the
test worker: one child process per module loads both packages'
libraries (the JAX one built into a temporary cache), runs every case
and starts the second process of each cross-process case; the tests below
assert its results one by one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

CRC_SIZES = (0, 1, 7, 8, 64, 100_000)
STRIDES = ((4, 10, 16), (4, 10, 10), (37, 150, 163), (1, 5, 9))
RING_CASES = ("cpp_to_python", "python_to_cpp")
ELEMENT_CASES = ("port_sink_to_jax_src", "jax_sink_to_port_src")

#: the second process of a cross-process case: a ring consumer or a
#: shmsrc pipeline; prints what it got as JSON
PEER = textwrap.dedent(r"""
    import json, sys, time
    kind, name, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    deadline = time.monotonic() + 60
    if kind in ("cpp", "python"):
        if kind == "cpp":
            from nnstreamer_tpu_torch.native import ShmRing
            ring = ShmRing.open(name)
        else:
            from nnstreamer_tpu_torch.elements.shm import ShmRing
            ring = ShmRing.open(name, backing="posix")
        got = []
        while len(got) < n and time.monotonic() < deadline:
            b = ring.try_get()
            if b is None:
                time.sleep(0.001)
            else:
                got.append(b.hex())
        ring.free()
        print(json.dumps(got))
    else:
        mod = __import__("nnstreamer_tpu_torch" if kind == "port" else "nnstreamer_tpu")
        p = mod.Pipeline(f"shmsrc socket-path={name} num-buffers={n} connect-timeout=30 ! "
                         "tensor_sink name=out")
        with p:
            bufs = [p.pull("out", timeout=30) for _ in range(n)]
            p.wait(timeout=30)
        import numpy as np
        print(json.dumps([[np.asarray(b.tensors[0]).tobytes().hex(),
                           str(np.asarray(b.tensors[0]).dtype), b.pts,
                           b.meta.get("label")] for b in bufs]))
""")

CHILD = textwrap.dedent(r"""
    import json, os, struct, subprocess, sys, time, zlib
    import numpy as np

    from nnstreamer_tpu import native as jnative
    from nnstreamer_tpu_torch import native
    from nnstreamer_tpu_torch.elements import shm as pshm
    from nnstreamer_tpu_torch.utils import wire

    args = json.loads(sys.argv[1])
    assert jnative.available()
    out = {}
    rng = np.random.default_rng(11)

    for n in args["crc_sizes"]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        out[f"crc_{n}"] = [native.crc32(data), jnative.crc32(data), zlib.crc32(data)]
    a = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    out["chain"] = [native.crc32(b, seed=native.crc32(a)), native.crc32(a + b),
                    zlib.crc32(b, zlib.crc32(a))]

    for rows, row, stride in args["strides"]:
        src = rng.integers(0, 256, rows * stride, dtype=np.uint8)
        view = np.lib.stride_tricks.as_strided(src, (rows, row), (stride, 1))
        out[f"strip_{rows}_{row}_{stride}"] = [
            native.strip_stride(src, rows, row, stride).tobytes().hex(),
            jnative.strip_stride(src, rows, row, stride).tobytes().hex(),
            np.ascontiguousarray(view).tobytes().hex()]
    try:
        native.strip_stride(np.zeros(10, np.uint8), 4, 10, 16)
    except ValueError as e:
        out["strip_short"] = str(e)

    segs = [b"hello", rng.integers(0, 256, 333, dtype=np.uint8), b"", b"world"]
    frame = bytes(native.wire_gather(segs))
    payload = b"".join(s if isinstance(s, bytes) else s.tobytes() for s in segs)
    (crc,) = struct.unpack_from("<I", frame, 8 + len(payload))
    out["gather"] = [frame.hex(), bytes(jnative.wire_gather(segs)).hex(),
                     wire.frame_bytes(payload).hex()]
    out["hello"] = bytes(native.wire_gather([b"hello", b"world"])).hex()
    bad = payload[:-1] + bytes([payload[-1] ^ 1])
    out["check"] = [native.wire_check(payload, crc), native.wire_check(bad, crc),
                    jnative.wire_check(payload, crc), jnative.wire_check(bad, crc)]

    tag = f"{os.getpid()}"
    r = native.ShmRing.create(f"/nnstpu_tn_rt_{tag}", 4, 256)
    c = native.ShmRing.open(f"/nnstpu_tn_rt_{tag}")
    steps = [c.try_get() is None, r.nslots, r.slot_bytes]
    steps += [r.try_put(bytes([i]) * (i + 1)) for i in range(4)]
    steps.append(r.try_put(b"overflow"))
    steps += [c.try_get() == bytes([i]) * (i + 1) for i in range(4)]
    steps += [r.try_put(b"again"), c.try_get() == b"again"]
    c.free()
    r.free()
    out["roundtrip"] = steps
    r = native.ShmRing.create(f"/nnstpu_tn_close_{tag}", 2, 64)
    out["close"] = [r.closed]
    r.close_write()
    out["close"].append(r.closed)
    r.free()
    r = native.ShmRing.create(f"/nnstpu_tn_big_{tag}", 2, 16)
    try:
        r.try_put(b"x" * 17)
    except ValueError as e:
        out["oversize"] = str(e)
    r.free()
    r = native.ShmRing.create(f"/nnstpu_tn_live_{tag}", 2, 64)
    try:
        native.ShmRing.create(f"/nnstpu_tn_live_{tag}", 2, 64)
    except OSError as e:
        out["live"] = str(e)
    try:  # the Python ring honours the C++ ring's owner too
        pshm.ShmRing.create(f"/nnstpu_tn_live_{tag}", 2, 64, backing="posix")
    except FileExistsError as e:
        out["live_python"] = str(e)
    r.free()
    r2 = native.ShmRing.create(f"/nnstpu_tn_live_{tag}", 2, 64)
    r2.free()
    out["reusable"] = True

    def peer(kind, name, n):
        return subprocess.Popen([sys.executable, "-c", args["peer"], kind, name, str(n)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(proc):
        try:
            so, se = proc.communicate(timeout=90)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        assert proc.returncode == 0, se[-3000:]
        return json.loads(so.strip().splitlines()[-1])

    for case in args["ring_cases"]:
        name = f"/nnstpu_tn_{case}_{tag}"
        if case == "cpp_to_python":
            ring = native.ShmRing.create(name, 4, 4096)
            proc = peer("python", name, 24)
        else:
            ring = pshm.ShmRing.create(name, 4, 4096, backing="posix")
            proc = peer("cpp", name, 24)
        sent = [rng.integers(0, 256, int(rng.integers(1, 4097)), dtype=np.uint8).tobytes()
                for _ in range(24)]
        try:
            deadline = time.monotonic() + 60
            for p in sent:
                while not ring.try_put(p):
                    assert time.monotonic() < deadline, "consumer stalled"
                    time.sleep(0.001)
            got = finish(proc)
        finally:
            ring.close_write()
            ring.free()
        out[case] = [[p.hex() for p in sent], got,
                     os.path.exists("/dev/shm/" + name.lstrip("/"))]

    import nnstreamer_tpu as nt
    import nnstreamer_tpu_torch as ntt
    for case in args["element_cases"]:
        name = f"/nnstpu_tn_el_{case}_{tag}"
        src_mod, peer_kind = (ntt, "jax") if case.startswith("port") else (nt, "port")
        frames = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
        p = src_mod.Pipeline(f"appsrc name=src ! shmsink socket-path={name} buffers=4")
        with p:
            proc = peer(peer_kind, name, len(frames))
            for i, f in enumerate(frames):
                buf = src_mod.Buffer([f], pts=1000 + i)
                buf.meta["label"] = f"frame{i}"
                p.push("src", buf)
            p.eos()
            p.wait(timeout=30)
            got = finish(proc)
        out[case] = [[[f.tobytes().hex(), "float32", 1000 + i, f"frame{i}"]
                      for i, f in enumerate(frames)], got]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    td = tmp_path_factory.mktemp("native")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               NNSTPU_CACHE=str(td / "jax_cache"))
    env.pop("XLA_FLAGS", None)
    args = dict(crc_sizes=CRC_SIZES, strides=STRIDES, ring_cases=RING_CASES,
                element_cases=ELEMENT_CASES, peer=PEER)
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(args)], cwd=str(td),
                          env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n", CRC_SIZES)
def test_crc32_matches_zlib_and_the_jax_library(seen, n):
    port, jax_lib, ref = seen[f"crc_{n}"]
    assert port == jax_lib == ref & 0xFFFFFFFF


def test_seeded_chaining(seen):
    chained, whole, ref = seen["chain"]
    assert chained == whole == ref


@pytest.mark.parametrize("rows,row,stride", STRIDES)
def test_strip_stride_matches_numpy_and_the_jax_library(seen, rows, row, stride):
    port, jax_lib, ref = seen[f"strip_{rows}_{row}_{stride}"]
    assert port == jax_lib == ref
    assert len(bytes.fromhex(port)) == rows * row


def test_strip_stride_refuses_a_short_source(seen):
    assert "smaller than rows*stride" in seen["strip_short"]


def test_wire_gather_frame_layout(seen):
    import struct

    frame = bytes.fromhex(seen["hello"])
    (ln,) = struct.unpack_from("<Q", frame, 0)
    assert ln == 10
    assert frame[8:18] == b"helloworld"
    (crc,) = struct.unpack_from("<I", frame, 18)
    assert crc == zlib.crc32(b"helloworld")


def test_wire_gather_equals_the_jax_library_and_the_ports_codec(seen):
    port, jax_lib, codec = seen["gather"]
    assert port == jax_lib == codec


def test_wire_check(seen):
    assert seen["check"] == [True, False, True, False]


def test_ring_roundtrip_and_capacity(seen):
    empty, nslots, slot_bytes, *rest = seen["roundtrip"]
    assert empty and (nslots, slot_bytes) == (4, 256)
    puts, overflow, gets, again = rest[:4], rest[4], rest[5:9], rest[9:]
    assert all(puts) and not overflow and all(gets) and all(again)


def test_ring_close_signals_consumer(seen):
    assert seen["close"] == [False, True]


def test_ring_oversize_payload_rejected(seen):
    assert "payload 17B > slot 16B" in seen["oversize"]


def test_ring_create_refuses_live_duplicate(seen):
    assert "create failed" in seen["live"]
    assert "live producer" in seen["live_python"]
    assert seen["reusable"]


@pytest.mark.parametrize("case", RING_CASES)
def test_rings_interoperate_across_processes(seen, case):
    sent, got, left = seen[case]
    assert got == sent
    assert not left, "the creator left its segment"


@pytest.mark.parametrize("case", ELEMENT_CASES)
def test_shm_elements_interoperate_across_packages(seen, case):
    sent, got = seen[case]
    assert got == sent


def test_native_sources_are_the_jax_packages():
    port = REPO / "nnstreamer_tpu_torch" / "native"
    jax_native = REPO / "nnstreamer_tpu" / "native"
    ours = (port / "src" / "nnstpu.cpp").read_text().splitlines()
    theirs = (jax_native / "src" / "nnstpu.cpp").read_text().splitlines()
    assert ours[3:] == theirs[1:]  # a header of three lines for one


def test_native_module_builds_into_the_checkout():
    from nnstreamer_tpu_torch import native

    assert native.BUILD_DIR == REPO / "build" / "torch_native"
    for name in native.LIBRARIES:
        path = native.library_path(name)
        assert path.parent == native.BUILD_DIR and path.name.startswith(f"lib{name}-")
    with pytest.raises(ValueError, match="no native library"):
        native.library_path("nnstpu_missing")


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    from nnstreamer_tpu_torch import native

    src = tmp_path / "broken.cc"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="native build failed") as e:
        native.compile_all([native.filter_job(src, tmp_path)])
    assert "broken.cc" in str(e.value) and "error" in str(e.value)
    assert not list(tmp_path.glob("*.so"))
