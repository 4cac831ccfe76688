"""The continuous loop's serving timeline, spans and tenant KV quotas
against the JAX package's ``_ContinuousLoop``: after the same serial
traffic the tenant-labelled ``llm.serve.ttft_ms`` / ``itl_ms`` /
``queue_ms`` / ``prefill_ms`` / ``decode_ms`` series hold as many samples
per tenant in both; under a ring recorder the same span kinds appear,
with as many ``serve.admit``, ``serve.prefill_chunk``,
``serve.prefix_hit`` and ``serve.cow_fork`` spans; over-quota tenants
are skipped in the same admission order (the JAX package's
``test_tenant_quota_skips_not_blocks`` and
``test_quota_charges_logical_blocks``); and a pipeline's ``trace_mode``
reaches the loop through the tensor_filter element."""

import threading
import time

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.log import metrics as jmetrics
from nnstreamer_tpu.filters.llm import LLMFramework as JaxLLM
from nnstreamer_tpu.utils import tracing as jtracing
from nnstreamer_tpu_torch.core.log import metrics as tmetrics
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.utils import tracing as ttracing
from tests.test_torch_continuous import REF_MODEL

torch.set_num_threads(2)

SERIES = ("llm.serve.ttft_ms", "llm.serve.itl_ms", "llm.serve.queue_ms",
          "llm.serve.prefill_ms", "llm.serve.decode_ms")
BASE = "max_new:5,stream_chunk:2,temperature:0.0,dtype:float32,serve:continuous"


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """In-order dispatch on the CPU backend (tests/test_torch_continuous.py)."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _pair(custom):
    jfw = JaxLLM()
    jfw.open({"model": "llama_tiny", "custom": custom})
    tfw = tllm.LLMFramework()
    tfw.open({"model": REF_MODEL, "custom": custom, "accelerator": "true:cpu"})
    return jfw, tfw


class Streams:
    """emit() targets by label; ``order`` lists each label at its first
    token and ``done`` holds an Event per label set at ``stream_last``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.order, self.toks, self.done = [], {}, {}

    def emit(self, label):
        self.toks[label] = []
        self.done[label] = threading.Event()

        def e(tensors, meta):
            with self.lock:
                if not self.toks[label]:
                    self.order.append(label)
                self.toks[label].append(int(np.asarray(tensors[0])[0]))
            if meta.get("stream_last"):
                self.done[label].set()
        return e


def _wait(cond, timeout=60.0, what=""):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _serve_serial(fw, traffic):
    """Each (prompt, tenant) submitted after the previous one drained."""
    st = Streams()
    for i, (prompt, tenant) in enumerate(traffic):
        meta = {"_tenant": tenant} if tenant is not None else {}
        fw.submit([prompt], meta, st.emit(i))
        assert fw.drain(120)
    return st


def _counts(m):
    out = {(name, t): h[2] for (name, t), h in m.labeled_histograms().items()
           if name in SERIES}
    out.update({(name, None): h[2] for name, h in m.histograms().items()
                if name in SERIES})
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def test_timeline_counts_per_tenant_equal_the_jax_loop():
    rng = np.random.default_rng(0)
    traffic = [(rng.integers(3, 500, (t,)).astype(np.int32), ten)
               for t, ten in ((6, "acme"), (11, "beta"), (4, "acme"), (9, None))]
    custom = BASE + ",slots:2,block_size:8,prefill_chunk:8"
    jfw, tfw = _pair(custom)
    try:
        deltas = []
        for fw, m in ((jfw, jmetrics), (tfw, tmetrics)):
            before = _counts(m)
            _serve_serial(fw, traffic)
            deltas.append(_delta(_counts(m), before))
    finally:
        jfw.close()
        tfw.close()
    jd, td = deltas
    assert td == jd
    # one TTFT and one phase split per stream, an ITL per later token
    assert td[("llm.serve.ttft_ms", "acme")] == 2
    assert td[("llm.serve.itl_ms", "beta")] == 4
    assert td[("llm.serve.decode_ms", None)] == 4


def _span_counts(rec, t0):
    out = {}
    for e in rec.events():
        if e.stage == "llm.serve" and e.ts >= t0:
            out[e.kind] = out.get(e.kind, 0) + 1
    return out


def test_spans_equal_the_jax_loop():
    """A cold prompt, a hit whose suffix starts inside a block (the fork:
    prefix 40, chunk 12, blocks of 8) and a second hit, served one after
    another under a ring recorder of each package."""
    rng = np.random.default_rng(1)
    pre = rng.integers(3, 500, (40,)).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(3, 500, (t,)).astype(np.int32)])
               for t in (5, 7, 9)]
    custom = BASE + ",slots:2,block_size:8,prefill_chunk:12"
    jfw, tfw = _pair(custom)
    counts = []
    try:
        for fw, rec in ((jfw, jtracing.FlightRecorder("ring")),
                        (tfw, ttracing.FlightRecorder("ring"))):
            fw._trace_rec = rec
            t0 = time.monotonic_ns()
            _serve_serial(fw, [(p, None) for p in prompts])
            counts.append(_span_counts(rec, t0))
    finally:
        jfw.close()
        tfw.close()
    jc, tc = counts
    assert set(tc) == set(jc)
    for kind in ("serve.admit", "serve.prefill_chunk", "serve.prefix_hit",
                 "serve.cow_fork"):
        assert tc.get(kind) == jc.get(kind), (kind, tc, jc)
    assert tc["serve.admit"] == 3 and tc["serve.prefix_hit"] == 2
    assert tc["serve.cow_fork"] >= 1 and tc["serve.decode"] >= 1


def test_no_recorder_no_spans():
    """A recorder in mode off: the loop records nothing."""
    tfw = tllm.LLMFramework()
    tfw.open({"model": REF_MODEL, "custom": BASE + ",slots:1,block_size:8,prefill_chunk:8",
              "accelerator": "true:cpu"})
    rec = ttracing.FlightRecorder("off")
    tfw._trace_rec = rec
    try:
        _serve_serial(tfw, [(np.arange(3, 9, dtype=np.int32), None)])
    finally:
        tfw.close()
    assert rec.events() == []


def _quota_skip_order(fw, quota_deferred):
    """The JAX package's test_tenant_quota_skips_not_blocks, recording the
    order of first tokens."""
    st = Streams()
    fw.submit([np.asarray([1, 2, 3], np.int32)], {"_tenant": "capped"},
              st.emit("capped"))
    assert st.done["capped"].wait(60)
    fw._serve.set_tenant_quota("capped", 0)
    q0 = quota_deferred()
    fw.submit([np.asarray([1, 2, 3], np.int32)], {"_tenant": "capped"},
              st.emit("capped2"))
    fw.submit([np.asarray([4, 5, 6], np.int32)], {"_tenant": "other"},
              st.emit("other"))
    assert st.done["other"].wait(60)
    assert not st.done["capped2"].is_set()
    assert quota_deferred() > q0
    fw._serve.set_tenant_quota("capped", None)
    assert st.done["capped2"].wait(60)
    assert fw.drain(60)
    return st.order, {k: len(v) for k, v in st.toks.items()}


def _metric(m, name):
    return lambda: m.snapshot().get(name, 0.0)


def test_tenant_quota_skips_not_blocks():
    custom = "max_new:10,serve:continuous,slots:2,stream_chunk:2,temperature:0.0,dtype:float32"
    jfw, tfw = _pair(custom)
    try:
        want = _quota_skip_order(jfw, _metric(jmetrics, "llm.serve.quota_deferred"))
        got = _quota_skip_order(tfw, _metric(tmetrics, "llm.serve.quota_deferred"))
    finally:
        jfw.close()
        tfw.close()
    assert got == want
    assert got[0] == ["capped", "other", "capped2"]


def _logical_quota_order(fw, quota_deferred):
    """The JAX package's test_quota_charges_logical_blocks: the second
    shared-prefix stream of one tenant defers on quota (8 + 8 logical
    blocks > 9) although sharing leaves physical blocks free, and is
    admitted once the first retires."""
    rng = np.random.default_rng(14)
    pre = rng.integers(1, 500, (32,), dtype=np.int32)
    pa, pb = [np.concatenate([pre, rng.integers(1, 500, (t,), np.int32)]) for t in (2, 3)]
    st = Streams()
    fw.submit([pa], {"_tenant": "acme"}, st.emit("a"))
    _wait(lambda: st.toks["a"], what="no first token")
    fw._serve.set_tenant_quota("acme", 9)
    q0 = quota_deferred()
    fw.submit([pb], {"_tenant": "acme"}, st.emit("b"))
    _wait(lambda: quota_deferred() > q0, 30, "expected a quota deferral")
    live = sum(s is not None for s in fw._serve._live_slots)
    free = len(fw._serve._free)
    assert fw.drain(180)
    a_done_first = st.done["a"].is_set()
    return st.order, {k: len(v) for k, v in st.toks.items()}, live, free > 2, a_done_first


def test_quota_charges_logical_blocks():
    custom = ("max_new:24,stream_chunk:2,temperature:0.0,dtype:float32,serve:continuous,"
              "slots:2,block_size:8,prefill_chunk:8")
    jfw, tfw = _pair(custom)
    try:
        want = _logical_quota_order(jfw, _metric(jmetrics, "llm.serve.quota_deferred"))
        got = _logical_quota_order(tfw, _metric(tmetrics, "llm.serve.quota_deferred"))
    finally:
        jfw.close()
        tfw.close()
    assert got == want
    order, lens, live, free_ok, _ = got
    assert order == ["a", "b"] and lens == {"a": 24, "b": 24}
    assert live == 1 and free_ok


def test_pipeline_trace_mode_reaches_the_loop():
    """``Pipeline(trace_mode="ring")``: the tensor_filter element hands its
    recorder to the loop before each submit, so serve.* spans land in the
    pipeline's flight recorder; the timeline feeds the tenant stamped at
    ingress."""
    desc = (f"appsrc name=src ! tensor_filter name=llm framework=llm model={REF_MODEL} "
            f"custom={BASE},slots:2,block_size:8,prefill_chunk:8 accelerator=true:cpu "
            "invoke-dynamic=true ! tensor_sink name=out")
    t0 = time.monotonic_ns()
    h0 = _counts(tmetrics)
    pipe = ntt.Pipeline(desc, trace_mode="ring")
    with pipe:
        for i, n in enumerate((5, 9)):
            pipe.push("src", ntt.Buffer([np.arange(3, 3 + n, dtype=np.int32)],
                                        meta={"req": i, "_tenant": "t9"}))
        bufs = [pipe.pull("out", timeout=60) for _ in range(10)]
        pipe.eos("src")
        pipe.wait(timeout=60)
    assert sum(bool(b.meta.get("stream_last")) for b in bufs) == 2
    spans = _span_counts(ttracing.recorder, t0)
    assert spans.get("serve.admit") == 2 and spans.get("serve.decode", 0) >= 1
    assert spans.get("serve.prefill_chunk") == 1 + 2
    d = _delta(_counts(tmetrics), h0)
    assert d[("llm.serve.ttft_ms", "t9")] == 2 and d[("llm.serve.itl_ms", "t9")] == 8
