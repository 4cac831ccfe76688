"""The rest of the port's ``elements/sink.py`` against the JAX package's,
on the CPU: ``filesink``'s bytes (float32, uint8 and bfloat16, a bf16
torch tensor written as its raw 16 bits), ``TensorSink.try_pop`` (None
while the sink is empty and while a buffer's fetch is still resolving,
then the buffer, its ``max-inflight`` credit released once) and
``depth``."""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.buffer import Buffer as JBuffer
from nnstreamer_tpu.elements.sink import FileSink as JFileSink
from nnstreamer_tpu.elements.sink import TensorSink as JTensorSink
from nnstreamer_tpu_torch.core.buffer import Buffer
from nnstreamer_tpu_torch.elements.sink import FileSink, TensorSink, raw_bytes
from nnstreamer_tpu_torch.elements.source import _InflightCredit


def _payloads(dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    if dtype == "uint8":
        return [rng.integers(0, 256, (4, 7), dtype=np.uint8)]
    if dtype == "float32":
        return [a, a[:, ::2]]  # a strided view is written in C order
    return [a.astype(ml_dtypes.bfloat16)]


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_filesink_bytes_equal_the_jax_filesinks(tmp_path, dtype, as_tensor):
    arrays = _payloads(dtype)
    want_path, got_path = tmp_path / "jax.bin", tmp_path / "port.bin"
    j = JFileSink({"location": str(want_path)})
    j.start()
    t = FileSink({"location": str(got_path)})
    t.start()
    for i in range(2):
        j.process("sink", JBuffer(list(arrays), pts=i))
        if as_tensor:
            tensors = [torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
                torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(
                np.ascontiguousarray(a)) for a in arrays]
            if dtype == "float32":
                tensors[1] = torch.from_numpy(arrays[0])[:, ::2]  # strided
        else:
            tensors = list(arrays)
        t.process("sink", Buffer(tensors, pts=i))
    j.stop()
    t.stop()
    assert got_path.read_bytes() == want_path.read_bytes()
    assert len(want_path.read_bytes()) == 2 * sum(a.nbytes for a in arrays)


def test_raw_bytes_of_bf16_are_its_uint16_bits():
    x = torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)
    want = np.array([1.0, -2.5, 3.140625], ml_dtypes.bfloat16).tobytes()
    assert raw_bytes(x) == want == x.view(torch.int16).numpy().tobytes()


def test_filesink_pipeline_equals_the_jax_packages(tmp_path):
    desc = ("videotestsrc num-buffers=3 width=8 height=6 pattern=smpte ! "
            "tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:255.0 ! filesink location={out}")
    outs = {}
    for lib in (ntt, nt):
        path = tmp_path / f"{lib.__name__}.bin"
        p = lib.Pipeline(desc.format(out=path))
        with p:
            p.wait(timeout=30)
        outs[lib] = path.read_bytes()
    assert outs[ntt] == outs[nt] and len(outs[ntt]) == 3 * 8 * 6 * 3 * 4


def _credited(x, sem):
    b = Buffer([x])
    b.meta["_inflight_credit"] = _InflightCredit(sem)
    return b


def test_try_pop_empty_then_a_host_buffer():
    sink = TensorSink({}, name="out")
    jsink = JTensorSink({}, name="out")
    assert sink.try_pop() is None and jsink.try_pop() is None
    assert sink.depth == jsink.depth == 0
    sem = threading.Semaphore(0)
    x = np.arange(6, dtype=np.int32)
    sink.process("sink", _credited(x, sem))
    jsink.process("sink", JBuffer([x]))
    assert sink.depth == jsink.depth == 1
    got, want = sink.try_pop(), jsink.try_pop()
    np.testing.assert_array_equal(got.tensors[0], want.tensors[0])
    assert sink.depth == jsink.depth == 0
    assert sem.acquire(timeout=0) and not sem.acquire(timeout=0)  # released once
    assert sink.try_pop() is None


def test_try_pop_parks_a_resolving_fetch_then_returns_it(monkeypatch):
    """A torch tensor goes through the fetch window: while its
    materialization is held, try_pop parks the future and returns None;
    once it is done, try_pop returns the buffer (and only once)."""
    gate = threading.Event()
    entered = threading.Event()
    real = Buffer.to_host

    def held(self):
        entered.set()
        assert gate.wait(timeout=10)
        return real(self)

    monkeypatch.setattr(Buffer, "to_host", held)
    sink = TensorSink({"fetch_depth": 2}, name="out")
    sem = threading.Semaphore(0)
    try:
        sink.process("sink", _credited(torch.arange(5.0), sem))
        sink.process("sink", _credited(torch.arange(3.0), sem))
        assert entered.wait(timeout=10)
        assert sink.depth == 2
        assert sink.try_pop() is None  # still resolving: parked
        assert sink._parked is not None and sink.depth == 1
        assert sink.try_pop() is None
        assert not sem.acquire(timeout=0)  # nothing delivered yet
        gate.set()
        sink._parked.result(timeout=10)
        first = sink.try_pop()
        np.testing.assert_array_equal(first.tensors[0], np.arange(5.0))
        deadline = time.monotonic() + 10
        second = None
        while second is None and time.monotonic() < deadline:
            second = sink.try_pop()
            time.sleep(0.01)
        np.testing.assert_array_equal(second.tensors[0], np.arange(3.0))
        assert sink.try_pop() is None and sink.depth == 0
        assert sem.acquire(timeout=0) and sem.acquire(timeout=0)
        assert not sem.acquire(timeout=0)  # each credit released once
    finally:
        gate.set()
        sink.stop()


def test_try_pop_in_a_pipeline():
    p = ntt.Pipeline("appsrc name=src ! tensor_sink name=out")
    sink = p.element("out")
    with p:
        assert sink.try_pop() is None
        p.push("src", np.ones(4, np.float32))
        deadline = time.monotonic() + 10
        got = None
        while got is None and time.monotonic() < deadline:
            got = sink.try_pop()
            time.sleep(0.01)
        np.testing.assert_array_equal(got.tensors[0], np.ones(4, np.float32))
        p.eos("src")
        p.wait(timeout=30)
    assert sink.depth == 0
