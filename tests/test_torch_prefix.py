"""Prefix sharing in the port's continuous loop against the JAX
package's (``nnstreamer_tpu/filters/llm.py`` ``_ContinuousLoop`` with
``prefix_cache`` on, its default in both): after each step of a serial
sequence (submit, drain, next) the port's reference counts, prefix index
(chain hash -> block id), free-list order and prefix counters equal the
JAX loop's, on the same llama_tiny f32 weights; hit, miss and fork
streams are the JAX paged model's greedy choices, teacher-forced
(``tests/test_torch_continuous.py``); the allocator's contracts of the
JAX package's ``tests/test_spec_decode.py`` (``TestRefcountAllocator``,
``TestPrefixSharing``); the poison guard."""

import threading
import time

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.log import metrics as jmetrics
from nnstreamer_tpu.filters.llm import LLMFramework as JaxLLM
from nnstreamer_tpu_torch.core.log import metrics as tmetrics
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo
from nnstreamer_tpu_torch.utils.armor import DeadLetterQueue
from tests.test_torch_continuous import (REF_MODEL, _assert_same_greedy,
                                         _jax_tree)

torch.set_num_threads(2)

BASE = "max_new:5,stream_chunk:2,temperature:0.0,dtype:float32,serve:continuous"
COUNTERS = ("llm.serve.prefix_hits", "llm.serve.prefix_hit_blocks",
            "llm.serve.prefix_evictions", "llm.serve.cow_forks")


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """In-order dispatch for the JAX loop on the CPU backend (its host
    state is aliased by asynchronous dispatch; see
    ``tests/test_torch_continuous.py``)."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _counters(m):
    snap = m.snapshot()
    return {k: snap.get(k, 0.0) for k in COUNTERS}


def _open_pair(custom):
    jfw = JaxLLM()
    jfw.open({"model": "llama_tiny", "custom": custom})
    tfw = tllm.LLMFramework()
    tfw.open({"model": REF_MODEL, "custom": custom, "accelerator": "true:cpu"})
    return jfw, tfw


def _serve(fw, prompts, stagger=False, timeout=120.0):
    """Submit ``prompts`` (each after the previous one's first token when
    ``stagger``) and drain; ``index -> [(token, meta)]``."""
    got = {i: [] for i in range(len(prompts))}
    lock = threading.Lock()

    def emit_for(i):
        def emit(tensors, meta):
            with lock:
                got[i].append((int(np.asarray(tensors[0])[0]), meta))
        return emit

    for i, p in enumerate(prompts):
        fw.submit([p], {}, emit_for(i))
        deadline = time.monotonic() + timeout
        while stagger and not got[i]:
            assert time.monotonic() < deadline, f"stream {i}: no first token"
            time.sleep(0.002)
    assert fw.drain(timeout)
    return got


def _ids(emitted):
    return [t for t, _ in emitted]


def _state(loop):
    return dict(ref=[int(r) for r in loop._ref], free=list(loop._free),
                index=dict(loop._prefix_index))


def _assert_same_state(jloop, tloop, step):
    js, ts = _state(jloop), _state(tloop)
    assert ts["ref"] == js["ref"], step
    assert ts["index"] == js["index"], step
    assert ts["free"] == js["free"], step
    assert dict(tloop._block_hash) == dict(jloop._block_hash), step


def _shared(rng, prefix_len, suffixes):
    pre = rng.integers(3, 500, (prefix_len,)).astype(np.int32)
    return pre, [np.concatenate([pre, rng.integers(3, 500, (t,)).astype(np.int32)])
                 for t in suffixes]


def _run_serial(custom, waves, block_size, chunk):
    """Each wave through both loops, one wave at a time (submitted
    together, then drained); after each, the allocator state and the
    counters' growth must be equal, and every port stream is the JAX
    paged model's greedy choice."""
    jfw, tfw = _open_pair(custom)
    deltas = []
    try:
        for w, prompts in enumerate(waves):
            j0, t0 = _counters(jmetrics), _counters(tmetrics)
            _serve(jfw, prompts)
            got = _serve(tfw, prompts)
            j1, t1 = _counters(jmetrics), _counters(tmetrics)
            delta = {k: t1[k] - t0[k] for k in COUNTERS}
            assert delta == {k: j1[k] - j0[k] for k in COUNTERS}, w
            _assert_same_state(jfw._serve, tfw._serve, w)
            for i, p in enumerate(prompts):
                assert len(got[i]) == 5
                _assert_same_greedy(p, _ids(got[i]), "", block_size=block_size,
                                    chunk=chunk)
            deltas.append(delta)
        loop = tfw._serve
        assert sorted(loop._free) == list(range(loop.n_blocks))
        assert (loop._ref == 0).all()
        assert set(loop._prefix_index.values()) == set(loop._block_hash)
    finally:
        jfw.close()
        tfw.close()
    return deltas


# -- allocator state against the JAX loop ---------------------------------------

def test_hit_and_miss_state_equals_jax():
    """A cold prompt registers its full blocks; a prompt sharing its
    32-token prefix maps them (4 blocks, no fork: chunk = block); an
    unrelated prompt misses; the first prompt again hits its own blocks."""
    rng = np.random.default_rng(30)
    _, (a, b) = _shared(rng, 32, (3, 5))
    cold = rng.integers(3, 500, (11,)).astype(np.int32)
    deltas = _run_serial(BASE + ",slots:2,block_size:8,prefill_chunk:8",
                         [[a], [b], [cold], [a]], block_size=8, chunk=8)
    assert [d["llm.serve.prefix_hits"] for d in deltas] == [0, 1, 0, 1]
    assert deltas[1]["llm.serve.prefix_hit_blocks"] == 4
    assert sum(d["llm.serve.cow_forks"] for d in deltas) == 0


def test_fork_state_equals_jax():
    """prefill_chunk 4 under block_size 8: a prompt wholly in the cache
    restarts its prefill at 20, inside block 2, which is forked; two such
    prompts together fork twice, and the original replays off the
    unperturbed blocks."""
    rng = np.random.default_rng(31)
    p = rng.integers(3, 500, (24,)).astype(np.int32)
    deltas = _run_serial(BASE + ",slots:2,block_size:8,prefill_chunk:4",
                         [[p], [p], [p, p], [p]], block_size=8, chunk=4)
    assert [d["llm.serve.cow_forks"] for d in deltas] == [0, 1, 2, 1]
    assert deltas[1]["llm.serve.prefix_hit_blocks"] == 2


def test_eviction_under_churn_state_equals_jax():
    """slots:1 and a pool of 4 blocks: every admission recycles the
    previous stream's blocks and evicts its cache entries."""
    rng = np.random.default_rng(32)
    waves = [[rng.integers(3, 500, (t,)).astype(np.int32)] for t in (17, 19, 23, 18)]
    deltas = _run_serial(BASE + ",slots:1,block_size:8,kv_blocks:4,prefill_chunk:8",
                         waves, block_size=8, chunk=8)
    assert sum(d["llm.serve.prefix_evictions"] for d in deltas) > 0


def test_resting_blocks_not_counted_twice_state_equals_jax():
    """Pool of 12: the cached 64-token prefix rests as 8 free blocks, a
    cold stream holds 4.  A prompt on the prefix needs its 8 resting
    blocks plus 2 fresh ones, so it defers until the cold stream retires;
    then it hits and emits the reference tokens.  Both loops end in the
    same state."""
    rng = np.random.default_rng(24)
    pre = rng.integers(3, 500, (64,)).astype(np.int32)
    pc = rng.integers(3, 500, (17,)).astype(np.int32)
    pb = np.concatenate([pre, rng.integers(3, 500, (2,)).astype(np.int32)])
    custom = ("max_new:8,stream_chunk:2,temperature:0.0,dtype:float32,"
              "serve:continuous,slots:3,block_size:8,kv_blocks:12,prefill_chunk:8")
    jfw, tfw = _open_pair(custom)
    try:
        for fw in (jfw, tfw):
            _serve(fw, [pre])
        h0 = _counters(tmetrics)["llm.serve.prefix_hits"]
        j0 = _counters(jmetrics)["llm.serve.prefix_hits"]
        _serve(jfw, [pc, pb], stagger=True)
        got = _serve(tfw, [pc, pb], stagger=True)
        assert _counters(tmetrics)["llm.serve.prefix_hits"] - h0 == 1
        assert _counters(jmetrics)["llm.serve.prefix_hits"] - j0 == 1
        # the hit was admitted only after the cold stream's last token
        assert got[1][0][1]["emit_t"] > got[0][-1][1]["emit_t"]
        _assert_same_state(jfw._serve, tfw._serve, "after the hit")
        for i, p in enumerate((pc, pb)):
            assert len(got[i]) == 8
            _assert_same_greedy(p, _ids(got[i]), "", block_size=8, chunk=8)
    finally:
        jfw.close()
        tfw.close()


# -- contracts (tests/test_spec_decode.py) --------------------------------------------

def _port_fw(custom, model=REF_MODEL):
    fw = tllm.LLMFramework()
    fw.open({"model": model, "custom": custom, "accelerator": "true:cpu"})
    return fw


def _serve_second_at_first_token(fw, first, second, timeout=120.0):
    """Submit ``first``, and ``second`` from the serve thread when the
    first emits its first token (so that the second is admitted while the
    first decodes, however loaded the host); drain.  ``index -> [(token,
    meta)]``."""
    got = {0: [], 1: []}

    def emit_for(i):
        def emit(tensors, meta):
            got[i].append((int(np.asarray(tensors[0])[0]), meta))
            if i == 0 and len(got[0]) == 1:
                fw.submit([second], {}, emit_for(1))
        return emit

    fw.submit([first], {}, emit_for(0))
    assert fw.drain(timeout)
    return got


def test_shared_blocks_free_only_at_refcount_zero(monkeypatch):
    """Two streams share a 32-token prefix (count 2 on its 4 blocks): the
    first retiring leaves them mapped, count 1 and off the free list,
    while the second decodes; both retiring frees every block."""
    rng = np.random.default_rng(10)
    _, (pa, pb) = _shared(rng, 32, (2, 3))
    fw = _port_fw("max_new:24,stream_chunk:2,temperature:0.0,dtype:float32,"
                  "serve:continuous,slots:2,block_size:8,prefill_chunk:8")
    seen = {"after": []}
    real_emit = tllm._ContinuousLoop._emit_token

    def spy(self, emit, meta, token_id, index, last, extra=None):
        # the serve thread, between two steps: the loop's state is stable
        real_emit(self, emit, meta, token_id, index, last, extra)
        sid = meta["stream_id"]
        if last and "shared" not in seen:
            seen["shared"] = [b for b in range(self.n_blocks) if self._ref[b] > 1]
            seen["first"] = sid
        elif "shared" in seen and sid != seen["first"]:
            seen["after"].append(all(self._ref[b] == 1 and b not in self._free
                                     for b in seen["shared"]))

    monkeypatch.setattr(tllm._ContinuousLoop, "_emit_token", spy)
    try:
        got = _serve_second_at_first_token(fw, pa, pb)
        loop = fw._serve
        assert len(got[0]) == len(got[1]) == 24
        assert len(seen["shared"]) == 4, seen
        assert seen["after"] and all(seen["after"])
        assert sorted(loop._free) == list(range(loop.n_blocks))
        assert (loop._ref == 0).all()
    finally:
        fw.close()


def test_hit_admits_where_cold_defers():
    """A 64-token shared prefix in a 17-block pool: each stream's logical
    need is 12 blocks, so a cold second stream waits for the first to
    finish, and a sharing one reserves its ~4-block suffix and decodes
    beside it."""
    rng = np.random.default_rng(13)
    _, (pa, pb) = _shared(rng, 64, (2, 3))
    custom = ("max_new:24,stream_chunk:2,temperature:0.0,dtype:float32,"
              "serve:continuous,slots:2,block_size:8,kv_blocks:17,prefill_chunk:8")

    def concurrent(extra):
        fw = _port_fw(custom + extra)
        try:
            got = _serve_second_at_first_token(fw, pa, pb)
        finally:
            fw.close()
        assert len(got[0]) == 24 and len(got[1]) == 24
        return got[1][0][1]["emit_t"] < got[0][-1][1]["emit_t"]

    h0 = _counters(tmetrics)["llm.serve.prefix_hits"]
    assert concurrent(",prefix_cache:0") is False
    assert _counters(tmetrics)["llm.serve.prefix_hits"] == h0
    assert concurrent("") is True
    assert _counters(tmetrics)["llm.serve.prefix_hits"] == h0 + 1


def test_hit_tokens_equal_prefix_cache_off():
    """Hits, partial hits, a fork and a miss, staggered: the same tokens
    as the same prompts through ``prefix_cache:0`` (one device, the cold
    path's chunk grid), and the JAX paged model's greedy choices."""
    rng = np.random.default_rng(15)
    pre = rng.integers(3, 500, (16,)).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(3, 500, (5,)).astype(np.int32)]),
               np.concatenate([pre, rng.integers(3, 500, (9,)).astype(np.int32)]),
               pre.copy(),
               rng.integers(3, 500, (11,)).astype(np.int32)]
    runs = {}
    for extra in ("", ",prefix_cache:0"):
        fw = _port_fw(BASE + ",slots:2,block_size:8,prefill_chunk:4" + extra)
        f0 = _counters(tmetrics)["llm.serve.cow_forks"]
        try:
            runs[extra] = _serve(fw, prompts, stagger=True)
        finally:
            fw.close()
        forks = _counters(tmetrics)["llm.serve.cow_forks"] - f0
        assert forks == (1 if extra == "" else 0)
    for i, p in enumerate(prompts):
        assert _ids(runs[""][i]) == _ids(runs[",prefix_cache:0"][i]), i
        _assert_same_greedy(p, _ids(runs[""][i]), "", block_size=8, chunk=4)


@pytest.mark.parametrize("draft", ["", ",draft:llama_tiny,spec_k:2"])
def test_fork_copies_rows_in_place(draft):
    """A prompt wholly in the cache restarts its prefill at 20, inside
    block 2: the fork copies that block's rows into a fresh block of the
    same pool tensors (captured steps hold their addresses), so rows
    16..19 are the source's bitwise, and the source is untouched; with a
    draft, in the draft's pool too."""
    rng = np.random.default_rng(11)
    p = rng.integers(3, 500, (24,)).astype(np.int32)
    fw = _port_fw(BASE + ",slots:2,block_size:8,prefill_chunk:4" + draft)
    try:
        _serve(fw, [p])
        loop = fw._serve
        pools = [loop._pool] + ([loop._draft_pool] if draft else [])
        ptrs = [pool[k].data_ptr() for pool in pools for k in ("k", "v")]
        hashes = tllm.BlockAllocator(1, 8).chain_hashes(p, 3)
        src = [loop._prefix_index[h] for h in hashes]
        before = [{k: pool[k].clone() for k in ("k", "v")} for pool in pools]
        blocks = []

        def emit(tensors, meta):
            if not blocks:  # the serve thread, the slot's table is set
                blocks.extend(b for b in loop._slot_blocks if b)

        f0 = _counters(tmetrics)["llm.serve.cow_forks"]
        fw.submit([p], {}, emit)
        assert fw.drain(60)
        assert _counters(tmetrics)["llm.serve.cow_forks"] == f0 + 1
        (mine,) = blocks
        assert mine[:2] == src[:2] and mine[2] not in src
        assert [pool[k].data_ptr() for pool in pools for k in ("k", "v")] == ptrs
        for pool, was in zip(pools, before):
            for k in ("k", "v"):
                assert torch.equal(pool[k][:, mine[2], :4], pool[k][:, src[2], :4])
                assert torch.equal(pool[k][:, src[2]], was[k][:, src[2]])
    finally:
        fw.close()


def test_prefix_cache_is_on_by_default():
    fw = _port_fw(BASE)
    try:
        assert fw.prefix_cache is True
    finally:
        fw.close()
    fw = _port_fw(BASE + ",prefix_cache:0")
    try:
        assert fw.prefix_cache is False
    finally:
        fw.close()


# -- nan_guard --------------------------------------------------------------------

POISON = 7  # the token whose embedding row is NaN in the poisoned model


def _poisoned_model(opts, device):
    cfg = tl.resolve_config("llama_tiny", opts)
    params = tl.params_from_jax(_jax_tree(""), device=device)
    params["embed"][POISON] = float("nan")
    return tl.make_bundle(cfg, params, opts.get("dtype", "bfloat16"),
                          "llama_tiny_poisoned")


tzoo.register_model("llama_tiny_poisoned", _poisoned_model)


@pytest.mark.parametrize("guard", [True, False])
def test_nan_guard_quarantines_a_poisoned_prompt(tmp_path, guard):
    """A prompt holding the poisoned token prefills to NaN logits: with
    ``nan_guard:1`` it is quarantined to the pipeline's DLQ and answered
    with one ``abort_reason=poison`` terminator, its slot and blocks go
    back, and a clean prompt behind it is served whole.  Without the
    guard the poisoned prompt streams like any other."""
    dlq = tmp_path / "dlq"
    pipe = ntt.Pipeline(
        "appsrc name=src ! tensor_filter name=f framework=llm "
        f"model=llama_tiny_poisoned custom={BASE},slots:2,block_size:8,"
        f"prefill_chunk:8,nan_guard:{int(guard)} accelerator=true:cpu "
        "invoke-dynamic=true ! tensor_sink name=out", quarantine=str(dlq))
    p0 = tmetrics.snapshot().get("llm.serve.poisoned", 0.0)
    bad = np.array([5, POISON, 9, 11], np.int32)
    good = np.array([5, 6, 9, 11, 12], np.int32)
    with pipe:
        pipe.push("src", ntt.Buffer([bad], meta={"req": 0}))
        pipe.push("src", ntt.Buffer([good], meta={"req": 1}))
        want = (1 if guard else 5) + 5
        bufs = [pipe.pull("out", timeout=60) for _ in range(want)]
        pipe.eos("src")
        pipe.wait(timeout=60)
        loop = pipe.element("f").fw._serve
        assert sorted(loop._free) == list(range(loop.n_blocks))
    by = {0: [], 1: []}
    for b in bufs:
        by[b.meta["req"]].append(b)
    assert len(by[1]) == 5 and not any(b.meta.get("stream_aborted") for b in by[1])
    poisoned = tmetrics.snapshot().get("llm.serve.poisoned", 0.0) - p0
    if guard:
        (term,) = by[0]
        assert term.meta["stream_aborted"] is True and term.meta["stream_last"]
        assert term.meta["abort_reason"] == "poison"
        assert poisoned == 1
        assert len(DeadLetterQueue(str(dlq)).entries()) == 1
    else:
        assert len(by[0]) == 5
        assert not any(b.meta.get("stream_aborted") for b in by[0])
        assert poisoned == 0
        assert not dlq.exists() or not DeadLetterQueue(str(dlq)).entries()


def test_prefix_serving_example_runs_on_the_cpu():
    """``examples/torch_llm_prefix_serving.py --cpu``: the second stream
    hits the preamble's 8 blocks, and the loop holds its propose and
    verify steps."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, str(repo / "examples" / "torch_llm_prefix_serving.py"),
         "--cpu"], cwd=str(repo), env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefix hits: 1 (8 blocks shared)" in out.stdout
    assert "('propose', 2, 4, 'float32', False)" in out.stdout
    assert "2 captures" in out.stdout
