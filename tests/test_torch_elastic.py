"""Elastic serving in the port against the JAX package's
(``nnstreamer_tpu/filters/llm.py`` drain/adopt, ``utils/elastic.py``,
``pipeline/plan.py`` + ``runtime.py`` stage restarts), on the CPU.

Drain/adopt parity does not drive the JAX loop's streams, which depend
on timing on the CPU backend (ROADMAP Queue C): tokens are held against
the JAX paged model driven step by step, teacher-forced
(``tests/test_torch_continuous.py``), and a JAX-built snapshot is made
from JAX ``forward_paged`` in the JAX package's v2 layout.  Only the
allocator-state comparison runs the JAX loop, with in-order dispatch and
one stream at a time, as ``tests/test_torch_prefix.py`` does.
Tolerances: greedy tokens exact at f32, or one of the tied ones where
the reference's top-1/top-2 gap is under 1e-4 (``_assert_same_greedy``);
moved streams bitwise equal to their undrained runs.  Every snapshot
path is a ``tmp_path``; every thread started is stopped.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.filters.llm import LLMFramework as JaxLLM
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.trainer import checkpoint as jckpt
from nnstreamer_tpu.utils import elastic as jelastic
from nnstreamer_tpu_torch.core.log import Metrics, metrics
from nnstreamer_tpu_torch.core.types import TensorsSpec
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.filters.base import FrameworkError
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.pipeline.runtime import PipelineError
from nnstreamer_tpu_torch.trainer import checkpoint as ckpt
from nnstreamer_tpu_torch.utils import elastic, tracing
from tests.test_torch_continuous import (CFG, REF_MODEL, _assert_same_greedy,
                                         _jax_forward_paged, _jax_tree)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
BS = CHUNK = 8
SERVE = (f"max_new:10,serve:continuous,slots:2,stream_chunk:2,temperature:0.0,"
         f"dtype:float32,block_size:{BS},prefill_chunk:{CHUNK}")
SAMPLED = SERVE.replace("temperature:0.0", "temperature:0.9,top_k:40")
SPEC = SERVE + ",draft:llama_tiny,spec_k:2"


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """In-order dispatch for the JAX loop on the CPU backend (its host
    state is aliased by asynchronous dispatch; tests/test_torch_continuous.py)."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def make_fw(custom=SERVE, model=REF_MODEL):
    fw = tllm.LLMFramework()
    fw.open({"model": model, "custom": custom, "accelerator": "true:cpu"})
    return fw


class Collector:
    """emit() target: (token id, meta) per token; ``done`` at the last."""

    def __init__(self, after=None):
        self.toks = []
        self.done = threading.Event()
        self.seen = threading.Event()
        self.after = after

    def __call__(self, tensors, meta):
        self.toks.append((int(np.asarray(tensors[0])[0]), dict(meta)))
        if self.after is not None and len(self.toks) >= self.after:
            self.seen.set()
        if meta.get("stream_last"):
            self.done.set()

    @property
    def ids(self):
        return [t for t, _ in self.toks]

    @property
    def sid(self):
        return self.toks[0][1]["stream_id"]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, CFG.vocab, (n,)).astype(np.int32)


def _undrained(prompt, custom=SERVE, model=REF_MODEL):
    fw = make_fw(custom, model=model)
    try:
        c = Collector()
        fw.submit([prompt], {}, c)
        assert c.done.wait(120)
        return c.ids
    finally:
        fw.close()


def _drained(fw, prompt, after, meta=None):
    """Submit on ``fw``, drain after ``after`` tokens: (collector, snap)."""
    got = Collector(after=after)
    fw.submit([prompt], dict(meta or {}), got)
    assert got.seen.wait(120)
    return got, fw.drain_stream(got.sid, timeout=60)


def _pool_whole(loop):
    return (sorted(loop._free) == list(range(loop.n_blocks))
            and bool((loop._ref == 0).all())
            and bool((loop._tables == loop.sentinel).all()))


# -- greedy drain / adopt ---------------------------------------------------------

@pytest.mark.parametrize("via_file", [False, True])
def test_greedy_move_equals_undrained_and_jax(tmp_path, via_file):
    """A live greedy stream drained after 3 tokens and adopted on a second
    loop continues bitwise as the undrained port stream, every token the
    JAX paged model's greedy choice at f32; ``stream_index`` goes on
    without a gap; both pools whole; no capture on either loop after its
    warm-up (the census gains no signature)."""
    prompt = _prompt(0, 11)
    ref = _undrained(prompt)
    fa, fb = make_fw(), make_fw()
    try:
        fa.serve_loop()
        fb.serve_loop()
        warm = [(set(f.census.signatures), f.census.captures) for f in (fa, fb)]
        got, snap = _drained(fa, prompt, 3)
        assert snap["kind"] == "live" and snap["greedy"] is True
        assert snap["version"] == 2 and "gen_state" not in snap
        assert fa._serve.pool_stats()["blocks_free"] == fa._serve.n_blocks
        if via_file:
            snap = ckpt.load_stream_snapshot(ckpt.save_stream_snapshot(
                str(tmp_path / "snap.pkl"), snap))
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        ids = got.ids[:snap["sidx"]] + cont.ids
        assert ids == ref
        _assert_same_greedy(prompt, ids, "", block_size=BS, chunk=CHUNK)
        assert [m["stream_index"] for _, m in cont.toks] == \
            list(range(snap["sidx"], len(ref)))
        assert cont.toks[-1][1]["stream_last"] is True
        assert {m["stream_id"] for _, m in cont.toks} == {got.sid}
        for f, (sigs, caps) in zip((fa, fb), warm):
            assert set(f.census.signatures) == sigs and f.census.captures == caps
            assert _pool_whole(f._serve)
    finally:
        fa.close()
        fb.close()


def test_queued_drain_readmits():
    """A stream held in the queue (its tenant's quota is 0) drains as a
    queued snapshot (prompt and meta, no blocks) and is served whole after
    the adopt, as the undrained stream."""
    prompt = _prompt(1, 9)
    ref = _undrained(prompt)
    fa, fb = make_fw(), make_fw()
    try:
        fa.serve_loop().set_tenant_quota("held", 0)
        sid = fa.submit([prompt], {"_tenant": "held"}, Collector())
        snap = fa.drain_stream(sid, timeout=60)
        assert snap["kind"] == "queued" and "blocks_k" not in snap
        assert snap["meta"]["_tenant"] == "held"
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert cont.ids == ref
        assert [m["stream_index"] for _, m in cont.toks] == list(range(len(ref)))
        assert fa.serve_streams() == {} and fb.serve_streams() == {}
    finally:
        fa.close()
        fb.close()


def test_drain_in_prefill_waits_until_live():
    """A drain asked for while the stream is still in prefill runs once it
    is live (a live snapshot with its first token)."""
    custom = SERVE.replace("max_new:10", "max_new:30")
    prompt = _prompt(2, 60)  # 8 chunks
    ref = _undrained(prompt, custom)
    fa, fb = make_fw(custom), make_fw(custom)
    try:
        loop = fa.serve_loop()
        # a decoding stream keeps the prefill at one chunk per iteration
        busy = Collector(after=1)
        fa.submit([_prompt(3, 4)], {}, busy)
        assert busy.seen.wait(120)
        got = Collector()
        sid = fa.submit([prompt], {}, got)
        deadline = time.monotonic() + 60
        while fa.serve_streams().get(sid, {}).get("state") != "admitting":
            assert time.monotonic() < deadline
            time.sleep(0.001)
        snap = fa.drain_stream(sid, timeout=60)
        assert snap["kind"] == "live" and snap["sidx"] >= 1
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert got.ids[:snap["sidx"]] + cont.ids == ref
        assert busy.done.wait(120)
        assert _pool_whole(loop)
    finally:
        fa.close()
        fb.close()


def test_drain_right_after_submit_finds_the_stream():
    """A drain asked for right after the submit finds the stream, queued
    or already admitted, never unknown."""
    fa, fb = make_fw(), make_fw()
    try:
        fa.serve_loop()
        sid = fa.submit([_prompt(16, 5)], {}, Collector())
        snap = fa.drain_stream(sid, timeout=60)
        assert snap["kind"] in ("queued", "live")
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
    finally:
        fa.close()
        fb.close()


def test_drain_unknown_stream_is_refused():
    fw = make_fw()
    try:
        fw.serve_loop()
        with pytest.raises(FrameworkError, match="unknown or already-finished"):
            fw.drain_stream(123456789, timeout=10)
    finally:
        fw.close()


def test_sampled_move_is_bitwise():
    """A sampled stream's snapshot carries its slot's generator state (a
    CPU generator's here): the continuation on a second loop equals the
    undrained stream bitwise.  Each loop's first admission has the same
    seed."""
    prompt = _prompt(4, 6)
    ref = _undrained(prompt, SAMPLED)
    fa, fb = make_fw(SAMPLED), make_fw(SAMPLED)
    try:
        got, snap = _drained(fa, prompt, 4)
        assert snap["greedy"] is False and snap["generator"] == "cpu"
        assert snap["gen_state"].dtype == torch.uint8
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert got.ids[:snap["sidx"]] + cont.ids == ref
        assert len(set(ref)) > 1
    finally:
        fa.close()
        fb.close()


def test_pre_sampling_snapshot_gets_a_fresh_seed():
    """A snapshot without generator state adopted by a sampled loop draws
    from the loop's next admission seed, as the JAX package gives such a
    snapshot a fresh key; its tokens stay in the vocab and it completes."""
    prompt = _prompt(5, 6)
    fa, fb = make_fw(), make_fw(SAMPLED)
    try:
        got, snap = _drained(fa, prompt, 3)
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert len(got.ids[:snap["sidx"]] + cont.ids) == 10
        assert all(0 <= t < CFG.vocab for t in cont.ids)
    finally:
        fa.close()
        fb.close()


@pytest.mark.parametrize("custom", [SERVE, SPEC], ids=["plain", "spec"])
@pytest.mark.parametrize("after", [1, 2, 3, 6])
def test_token_mirrors_equal_the_card_side(custom, after):
    """The host mirrors of a slot's last token and the one before it (what
    a snapshot carries) equal the emitted stream and, where the loop keeps
    them as tensors, the loop's own: ``tok`` always, ``tok_prev`` with a
    draft (its propose step reads it)."""
    prompt = _prompt(6, 7)
    fw = make_fw(custom)
    try:
        loop = fw.serve_loop()
        got = Collector(after=after)
        fw.submit([prompt], {}, got)
        assert got.seen.wait(120)
        slot = fw.serve_streams()[got.sid]["slot"]
        snap = fw.drain_stream(got.sid, timeout=60)
        emitted = got.ids[:snap["sidx"]]
        assert snap["tok"] == emitted[-1]
        assert snap["tok_prev"] == (emitted[-2] if len(emitted) > 1 else prompt[-1])
        assert snap["tok"] == int(loop._tok[slot])
        if loop._tok_prev is not None:
            assert snap["tok_prev"] == int(loop._tok_prev[slot])
    finally:
        fw.close()


def test_drain_under_sharing_copies_shared_blocks():
    """A stream whose prefix blocks are shared with a live peer drains
    with private host copies of them (counted in ``shared_blocks``); the
    peer finishes bitwise, the moved stream continues bitwise, and both
    pools are whole after."""
    custom = SERVE.replace("max_new:10", "max_new:24")
    rng = np.random.default_rng(42)
    pre = rng.integers(3, 500, (32,)).astype(np.int32)
    pa = np.concatenate([pre, rng.integers(3, 500, (3,)).astype(np.int32)])
    pb = np.concatenate([pre, rng.integers(3, 500, (5,)).astype(np.int32)])
    refs = [_undrained(p, custom) for p in (pa, pb)]
    fa, fb = make_fw(custom), make_fw(custom)
    try:
        got_a = Collector(after=1)
        fa.submit([pa], {}, got_a)
        assert got_a.seen.wait(120)
        got_b, snap = _drained(fa, pb, 3)
        assert snap["shared_blocks"] >= 4
        pool = fa._serve._pool["k"]
        assert snap["blocks_k"].untyped_storage().data_ptr() != \
            pool.untyped_storage().data_ptr()
        assert got_a.done.wait(120) and got_a.ids == refs[0]
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert got_b.ids[:snap["sidx"]] + cont.ids == refs[1]
        for f in (fa, fb):
            assert f.drain(60)
            assert _pool_whole(f._serve)
    finally:
        fa.close()
        fb.close()


def test_allocator_state_after_drain_and_adopt_equals_jax():
    """One stream served whole, then one sharing its prefix drained from
    loop A and adopted on loop B, both packages, one stream at a time:
    reference counts, prefix index and free-list order equal the JAX
    loop's after the drain (A) and after the adopted stream ends (B)."""
    custom = SERVE.replace("max_new:10", "max_new:12")
    rng = np.random.default_rng(7)
    pre = rng.integers(3, 500, (32,)).astype(np.int32)
    p1 = np.concatenate([pre, rng.integers(3, 500, (3,)).astype(np.int32)])
    p2 = np.concatenate([pre, rng.integers(3, 500, (6,)).astype(np.int32)])
    states = {}
    for name in ("jax", "port"):
        if name == "jax":
            fa, fb = JaxLLM(), JaxLLM()
            for f in (fa, fb):
                f.open({"model": "llama_tiny", "custom": custom})
        else:
            fa, fb = make_fw(custom), make_fw(custom)
        try:
            first = Collector()
            fa.submit([p1], {}, first)
            assert first.done.wait(120) and fa.drain(60)
            _, snap = _drained(fa, p2, 3)
            a = dict(ref=[int(r) for r in fa._serve._ref], free=list(fa._serve._free),
                     index=sorted(fa._serve._prefix_index.values()))
            cont = Collector()
            fb.adopt_stream(snap, cont)
            assert cont.done.wait(120) and fb.drain(60)
            b = dict(ref=[int(r) for r in fb._serve._ref], free=list(fb._serve._free))
            states[name] = (a, b, snap["shared_blocks"])
        finally:
            fa.close()
            fb.close()
    assert states["port"] == states["jax"]


# -- snapshot_problems ----------------------------------------------------------

def _live_snapshot():
    fw = make_fw()
    try:
        return _drained(fw, _prompt(8, 5), 2)[1]
    finally:
        fw.close()


_SNAP = {}


def _snap():
    if "live" not in _SNAP:
        _SNAP["live"] = _live_snapshot()
    return _SNAP["live"]


@pytest.mark.parametrize("case", [
    "ok", "not_a_dict", "version", "geometry", "dtype", "block_size",
    "spec_without_tok_prev", "queued_other_dtype"])
def test_snapshot_problems_equal_jax(case):
    """The port's refusals are the JAX package's, message for message, on
    the same snapshots (the JAX framework's check is a pure function)."""
    snap = dict(_snap())
    custom = SERVE
    if case == "not_a_dict":
        snap = ["not", "a", "dict"]
    elif case == "version":
        snap["version"] = 99
    elif case == "geometry":
        snap["cfg"] = dict(snap["cfg"], n_layers=1)
    elif case == "dtype":
        snap["dtype"] = "bfloat16"
    elif case == "block_size":
        snap["block_size"] = 16
    elif case == "spec_without_tok_prev":
        snap = {k: v for k, v in snap.items() if k != "tok_prev"}
        custom = SPEC
    elif case == "queued_other_dtype":
        snap = dict(snap, kind="queued", dtype="bfloat16", block_size=16)
    jfw = JaxLLM()
    jfw.open({"model": "llama_tiny", "custom": custom})
    tfw = make_fw(custom)
    try:
        want = jfw.snapshot_problems(snap)
        assert tfw.snapshot_problems(snap) == want
        assert bool(want) == (case not in ("ok", "queued_other_dtype"))
        if want:
            with pytest.raises(FrameworkError, match="cannot adopt"):
                tfw.adopt_stream(snap, Collector(), timeout=10)
    finally:
        jfw.close()
        tfw.close()


def test_sampled_snapshot_from_the_other_generator_kind_is_refused():
    """A sampled snapshot's generator state is one kind of generator's: a
    CPU filter refuses a CUDA generator's state, never re-seeds it."""
    snap = dict(_snap(), greedy=False, gen_state=torch.zeros(16, dtype=torch.uint8),
                generator="cuda")
    fw = make_fw(SAMPLED)
    try:
        problems = fw.snapshot_problems(snap)
        assert problems == ["the snapshot's sampler state is a cuda generator's; "
                            "this filter draws with cpu generators"]
    finally:
        fw.close()


@pytest.mark.parametrize("case", ["no_slot", "table_span", "blocks", "gen_state"])
def test_adopt_refusals_are_typed(case):
    """The loop refuses an adopt it cannot hold, with the JAX loop's
    messages (and one of its own for a generator state of the wrong
    size), and keeps serving."""
    snap = dict(_snap())
    custom = SERVE
    if case == "no_slot":  # one slot, held by a long stream
        custom = SERVE.replace("slots:2", "slots:1").replace("max_new:10", "max_new:200")
    elif case == "table_span":
        snap["remaining"] = 10_000
    elif case == "blocks":
        custom = SERVE + ",kv_blocks:1"
    else:
        custom = SAMPLED
        snap.update(greedy=False, generator="cpu",
                    gen_state=torch.zeros(16, dtype=torch.uint8))
    msg = {"no_slot": "no free slot to adopt into",
           "table_span": "blocks > table span",
           "blocks": "insufficient free KV blocks",
           "gen_state": "is not a cpu generator's"}[case]
    fw = make_fw(custom)
    try:
        fw.serve_loop()
        busy = Collector(after=1)
        if case == "no_slot":
            fw.submit([_prompt(9, 4)], {}, busy)
            assert busy.seen.wait(120)
        with pytest.raises(FrameworkError, match=msg):
            fw.adopt_stream(snap, Collector(), timeout=30)
        if case == "no_slot":
            elastic.cancel_stream(busy.sid, force=True)
            assert busy.done.wait(120)
        assert fw.drain(60)
        assert _pool_whole(fw._serve)
    finally:
        fw.close()


def test_adopted_stream_id_is_reminted_on_collision():
    snap = _snap()
    fb = make_fw()
    try:
        elastic.register_stream(snap["stream_id"], lambda r, f: None)
        c1 = Collector()
        sid = fb.adopt_stream(dict(snap), c1)
        assert sid != snap["stream_id"]
        assert c1.done.wait(120)
        assert {m["stream_id"] for _, m in c1.toks} == {sid}
    finally:
        elastic.unregister_stream(snap["stream_id"])
        fb.close()


def test_spans_and_timeline():
    """``elastic.drain`` / ``elastic.adopt`` spans under the filter's
    recorder; an adopted stream (no local enqueue stamp) adds no TTFT."""
    rec = tracing.FlightRecorder("ring", 4096)
    fa, fb = make_fw(), make_fw()
    try:
        fa._trace_rec = fb._trace_rec = rec
        got, snap = _drained(fa, _prompt(10, 5), 2, meta={"_tenant": "mover"})
        n_ttft = len(metrics.reservoir("llm.serve.ttft_ms", "mover"))
        cont = Collector()
        fb.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        assert len(metrics.reservoir("llm.serve.ttft_ms", "mover")) == n_ttft == 1
        kinds = [(e.kind, e.args.get("state")) for e in rec.events()
                 if e.kind.startswith("elastic.")]
        assert kinds == [("elastic.drain", "live"), ("elastic.adopt", "live")]
    finally:
        fa.close()
        fb.close()


# -- snapshots across packages and files ------------------------------------------

def _jax_snapshot(prompt, n, k, dtype="float32"):
    """The JAX package's v2 live snapshot of a greedy stream after ``k`` of
    ``n`` tokens, built from JAX ``forward_paged`` driven as its loop
    drives a slot (chunked prefill, then one decode step per token), and
    the stream's ``n`` greedy tokens."""
    T = len(prompt)
    P = -(-T // CHUNK) * CHUNK
    n_blocks = -(-(P + n) // BS)
    pool = jl.init_paged_cache(CFG, n_blocks, BS, dtype=dtype)
    tables = jnp.arange(n_blocks, dtype=jnp.int32)[None]
    toks = np.zeros((1, P), np.int32)
    toks[0, :T] = prompt
    fwd, tree = _jax_forward_paged(), _jax_tree("")
    for p in range(0, P, CHUNK):
        logits, pool = fwd(tree, jnp.asarray(toks[:, p:p + CHUNK]), pool, tables,
                           jnp.asarray([p], jnp.int32),
                           logit_off=jnp.int32(T - 1 - p if p + CHUNK >= P else 0))
    ids = [int(np.argmax(np.asarray(logits)[0, -1]))]
    snap = None
    for i in range(1, n):
        pos = T + i - 1
        if i == k:
            used = np.arange(-(-pos // BS), dtype=np.int32)
            snap = {"version": 2, "kind": "live", "stream_id": 0,
                    "cfg": dataclasses.asdict(CFG), "dtype": dtype,
                    "block_size": BS, "pos": pos, "remaining": n - k, "sidx": k,
                    "tok": ids[-1], "tok_prev": ids[-2] if k > 1 else int(prompt[-1]),
                    "shared_blocks": 0, "greedy": True, "prng_key": [0, 7],
                    "meta": {"req": "jax"}, "prompt": prompt[None].copy(),
                    "blocks_k": np.asarray(pool["k"][:, used]),
                    "blocks_v": np.asarray(pool["v"][:, used])}
        logits, pool = fwd(tree, jnp.asarray([[ids[-1]]], jnp.int32), pool, tables,
                           jnp.asarray([pos], jnp.int32))
        ids.append(int(np.argmax(np.asarray(logits)[0, -1])))
    return snap, ids


@pytest.mark.parametrize("via_jax_file", [False, True])
def test_jax_built_snapshot_continues_as_the_jax_reference(tmp_path, via_jax_file):
    """A v2 snapshot built from JAX ``forward_paged`` (f32, llama_tiny) is
    accepted by the JAX package's own check and adopted by the port, whose
    continuation is the JAX greedy reference's, teacher-forced; through
    the JAX package's snapshot file too (version 1)."""
    prompt = _prompt(11, 13)
    snap, ids = _jax_snapshot(prompt, 10, 4)
    jfw = JaxLLM()
    jfw.open({"model": "llama_tiny", "custom": SERVE})
    try:
        assert jfw.snapshot_problems(snap) == []
    finally:
        jfw.close()
    if via_jax_file:
        snap = ckpt.load_stream_snapshot(jckpt.save_stream_snapshot(
            str(tmp_path / "jax_snap.pkl"), snap))
    fw = make_fw()
    try:
        assert fw.snapshot_problems(snap) == []
        cont = Collector()
        fw.adopt_stream(snap, cont)
        assert cont.done.wait(120)
        full = ids[:4] + cont.ids
        _assert_same_greedy(prompt, full, "", block_size=BS, chunk=CHUNK)
        assert [m["stream_index"] for _, m in cont.toks] == list(range(4, 10))
        assert {m["req"] for _, m in cont.toks} == {"jax"}
    finally:
        fw.close()


def test_jax_bf16_blocks_read_as_torch_bf16():
    """A JAX bf16 snapshot's ``ml_dtypes`` blocks come into the port as
    torch bf16 with the same bits."""
    blocks = np.asarray(jnp.asarray(
        np.random.default_rng(0).normal(size=(2, 3, 4)), jnp.bfloat16))
    got = ckpt.host_tensor(blocks)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), blocks.view(np.int16))


def test_snapshot_file_version_gate(tmp_path):
    """The port writes version 2 and reads 1 (the JAX package's) and 2;
    the JAX package's reader refuses the port's files by their version."""
    path = str(tmp_path / "snap.pkl")
    ckpt.save_stream_snapshot(path, {"kind": "queued", "version": 2})
    assert ckpt.load_stream_snapshot(path)["kind"] == "queued"
    with pytest.raises(ValueError, match="version"):
        jckpt.load_stream_snapshot(path)
    jpath = jckpt.save_stream_snapshot(str(tmp_path / "j.pkl"),
                                       {"kind": "queued", "version": 2})
    assert ckpt.load_stream_snapshot(jpath)["kind"] == "queued"
    with open(path, "wb") as f:
        pickle.dump({"snapshot_version": 42}, f)
    with pytest.raises(ValueError, match="version"):
        ckpt.load_stream_snapshot(path)


def test_bf16_snapshot_loads_and_continues_without_ml_dtypes(tmp_path):
    """A bf16 stream drained here and saved is loaded, adopted and
    continued by a fresh process in which ``ml_dtypes`` cannot be
    imported (a torch install without JAX): bitwise the undrained stream.  Both
    processes build llama_tiny from the zoo's seed."""
    custom = SERVE.replace("dtype:float32", "dtype:bfloat16")
    prompt = _prompt(12, 9)
    ref = _undrained(prompt, custom, model="llama_tiny")
    fa = make_fw(custom, model="llama_tiny")
    try:
        got, snap = _drained(fa, prompt, 3)
    finally:
        fa.close()
    assert snap["blocks_k"].dtype == torch.bfloat16
    path = ckpt.save_stream_snapshot(str(tmp_path / "bf16.pkl"), snap)
    code = (
        "import sys, threading\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from nnstreamer_tpu_torch.trainer import checkpoint as ckpt\n"
        "from nnstreamer_tpu_torch.filters.llm import LLMFramework\n"
        f"snap = ckpt.load_stream_snapshot({path!r})\n"
        "import torch\n"
        "assert snap['blocks_k'].dtype == torch.bfloat16\n"
        "fw = LLMFramework()\n"
        f"fw.open({{'model': 'llama_tiny', 'custom': {custom!r}, "
        "'accelerator': 'true:cpu'})\n"
        "ids, done = [], threading.Event()\n"
        "def emit(t, m):\n"
        "    ids.append(int(t[0][0]))\n"
        "    if m.get('stream_last'): done.set()\n"
        "fw.adopt_stream(snap, emit)\n"
        "assert done.wait(120)\n"
        "fw.close()\n"
        "assert 'jax' not in sys.modules\n"
        "print(' '.join(map(str, ids)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cont = [int(t) for t in out.stdout.split()]
    assert got.ids[:snap["sidx"]] + cont == ref


# -- the autoscaler ------------------------------------------------------------

class _StubCore:
    def __init__(self):
        self.tenant_admission = {}


class _StubEl:
    def __init__(self, core=None, fw=None):
        if core is not None:
            self._core = core
        if fw is not None:
            self.fw = fw


class _StubPipeline:
    def __init__(self, *els):
        self.elements = dict(enumerate(els))


def _scaler(rules, *els, spill_to=None):
    m = Metrics()
    rec = tracing.FlightRecorder("ring", 1024)
    return elastic.Autoscaler(_StubPipeline(*els), {"rules": rules}, metrics=m,
                              recorder=rec, spill_to=spill_to), m, rec


def test_autoscaler_hysteresis_and_spans():
    core = _StubCore()
    scaler, m, rec = _scaler(
        [{"tenant": "*", "burn_above": 1.5, "burn_below": 0.5,
          "action": "admission:shed", "cooldown_s": 0.0}], _StubEl(core=core))
    m.gauge("slo.burn_rate", 3.0, tenant="acme")
    assert scaler.evaluate() == 1
    assert core.tenant_admission == {"acme": "shed"}
    for burn in (2.5, 1.0):  # engaged, then inside the band: no edge
        m.gauge("slo.burn_rate", burn, tenant="acme")
        assert scaler.evaluate() == 0
    assert core.tenant_admission == {"acme": "shed"}
    m.gauge("slo.burn_rate", 0.2, tenant="acme")
    assert scaler.evaluate() == 1
    assert core.tenant_admission == {}
    edges = [e.args["edge"] for e in rec.events() if e.kind == "elastic.scale"]
    assert edges == ["engage", "relax"]
    assert [a["edge"] for a in scaler.actions] == ["engage", "relax"]


def test_autoscaler_cooldown_rate_limits():
    core = _StubCore()
    scaler, m, _ = _scaler(
        [{"tenant": "t", "burn_above": 1.0, "burn_below": 0.1,
          "action": "admission:shed", "cooldown_s": 60.0}], _StubEl(core=core))
    m.gauge("slo.burn_rate", 5.0, tenant="t")
    assert scaler.evaluate() == 1
    m.gauge("slo.burn_rate", 0.0, tenant="t")
    assert scaler.evaluate() == 0
    assert core.tenant_admission == {"t": "shed"}


def test_autoscaler_first_edge_on_a_young_host(monkeypatch):
    """A rule's first edge is not held back by its cooldown when the
    monotonic clock is younger than the cooldown (a freshly booted host):
    the JAX package's autoscaler starts each rule's clock at 0.0 and fires
    nothing there; the port starts it at minus infinity."""
    core = _StubCore()
    scaler, m, _ = _scaler(
        [{"tenant": "t", "burn_above": 1.0, "burn_below": 0.1,
          "action": "admission:shed", "cooldown_s": 60.0}], _StubEl(core=core))
    monkeypatch.setattr(elastic.time, "monotonic", lambda: 5.0)
    m.gauge("slo.burn_rate", 5.0, tenant="t")
    assert scaler.evaluate() == 1
    assert core.tenant_admission == {"t": "shed"}


def test_autoscaler_kv_quota_on_the_port_loop():
    """``kv_quota:N`` caps the tenant on the real continuous loop: its
    next stream waits while it would pass the cap, and is admitted once
    the quota relaxes."""
    fw = make_fw()
    try:
        loop = fw.serve_loop()
        scaler, m, _ = _scaler(
            [{"tenant": "big", "burn_above": 1.0, "burn_below": 0.2,
              "action": "kv_quota:1", "cooldown_s": 0.0}], _StubEl(fw=fw))
        m.gauge("slo.burn_rate", 2.0, tenant="big")
        assert scaler.evaluate() == 1
        assert loop._tenant_quota == {"big": 1}
        held = Collector()
        sid = fw.submit([_prompt(13, 9)], {"_tenant": "big"}, held)
        time.sleep(0.3)
        assert fw.serve_streams()[sid]["state"] == "queued" and not held.toks
        m.gauge("slo.burn_rate", 0.0, tenant="big")
        assert scaler.evaluate() == 1
        assert loop._tenant_quota == {}
        assert held.done.wait(120)
    finally:
        fw.close()


@pytest.mark.parametrize("policy", [
    {"rules": [{"tenant": "x", "action": "explode"}]},
    {"rules": [{"burn_above": 1.0, "burn_below": 2.0}]},
    {"rules": [{"action": "kv_quota:-3"}]},
    {"rules": [{"action": "admission:bogus"}]},
    {"rules": [{"cooldown_s": -1, "extra": 1}]},
    {"rules": []},
    {"rules": [{"action": "spill"}], "top": 1},
    ["not", "a", "dict"],
    {"rules": [{"tenant": "a", "action": "spill"}]},
])
def test_autoscale_policy_validation_equals_jax(policy):
    assert elastic.validate_autoscale_policy(policy) == \
        jelastic.validate_autoscale_policy(policy)
    if elastic.validate_autoscale_policy(policy) and isinstance(policy, dict):
        with pytest.raises(ValueError, match="invalid autoscale"):
            elastic.load_autoscale_policy(policy)
    assert elastic.load_autoscale_policy(None) == []


def test_autoscaler_spill_moves_a_live_stream():
    """The spill action drains the burning tenant's live stream off one
    port framework and adopts it on another, where it finishes as the
    undrained stream."""
    custom = SERVE.replace("max_new:10", "max_new:40")
    prompt = _prompt(14, 5)
    ref = _undrained(prompt, custom)
    fa, fb = make_fw(custom), make_fw(custom)

    class _Pipe:
        def __init__(self, fw, sink):
            self.fw, self.sink, self.elements = fw, sink, {}

        def serve_streams(self):
            return self.fw.serve_streams()

        def drain_stream(self, sid, timeout=10.0):
            return self.fw.drain_stream(sid, timeout)

        def adopt_stream(self, snap, timeout=10.0):
            return self.fw.adopt_stream(snap, self.sink, timeout)

    try:
        cont = Collector()
        got = Collector(after=1)
        fa.submit([prompt], {"_tenant": "noisy"}, got)
        assert got.seen.wait(120)
        m = Metrics()
        m.gauge("slo.burn_rate", 9.0, tenant="noisy")
        scaler = elastic.Autoscaler(
            _Pipe(fa, None), {"rules": [{"tenant": "noisy", "burn_above": 2.0,
                                         "burn_below": 0.5, "action": "spill",
                                         "cooldown_s": 60.0}]},
            spill_to=_Pipe(fb, cont), metrics=m)
        assert scaler.evaluate() == 1
        assert cont.done.wait(120)
        n_a = cont.toks[0][1]["stream_index"]
        assert got.ids[:n_a] + cont.ids == ref
        assert fa.serve_streams() == {} and fb.serve_streams() == {}
        # the rule re-fires only after its cooldown
        assert scaler.evaluate() == 0
    finally:
        fa.close()
        fb.close()


def test_autoscaler_thread_starts_and_stops():
    scaler, m, _ = _scaler([{"tenant": "*", "action": "admission:shed"}],
                           _StubEl(core=_StubCore()))
    scaler.start(period_s=0.01)
    t = scaler._thread
    assert t is not None and t.is_alive()
    scaler.stop()
    t.join(timeout=5)
    assert not t.is_alive() and scaler._thread is None


# -- the knob table ------------------------------------------------------------------

def test_knob_tables_equal_jax_and_the_port_defaults():
    assert elastic.SERVE_KNOB_SIGNATURE == jelastic.SERVE_KNOB_SIGNATURE
    assert elastic.SERVE_KNOB_DEFAULTS == jelastic.SERVE_KNOB_DEFAULTS
    fw = tllm.LLMFramework()
    fw.open({"model": "llama_tiny", "custom": "serve:continuous",
             "accelerator": "true:cpu"})
    try:
        got = dict(slots=fw.slots, block_size=fw.block_size, kv_blocks=fw.kv_blocks,
                   prefill_chunk=fw.prefill_chunk, stream_chunk=fw.chunk,
                   temperature=fw.temperature, top_k=fw.top_k, top_p=fw.top_p,
                   dtype=fw.dtype, max_new=fw.max_new, admit_timeout=fw.admit_timeout,
                   stream_idle_timeout=fw.stream_idle_timeout, seed=fw.seed,
                   draft="" if fw.draft_bundle is None else "?", spec_k=fw.spec_k,
                   draft_seed=0, prefix_cache=int(fw.prefix_cache))
    finally:
        fw.close()
    assert got == elastic.SERVE_KNOB_DEFAULTS


@pytest.mark.parametrize("current,reconfig", [
    ({"slots": "4"}, {"slots": 8, "max_new": 64, "kv_blocks": 128}),
    ({"slots": "4"}, {"slots": 4}),
    ({}, {"temperature": 0.0}),
    ({}, {"temperature": 0.7}),
    ({}, {"warp_factor": 9}),
    ({"draft": "llama_tiny"}, {"draft": "llama_small", "spec_k": 4}),
])
def test_signature_changes_equal_jax(current, reconfig):
    assert elastic.signature_changes(current, reconfig) == \
        jelastic.signature_changes(current, reconfig)


def test_chaos_hooks():
    elastic.chaos_slow_stage("s", 0.5)
    try:
        assert elastic.chaos_slow_delay("s") == 0.5
        elastic.chaos_slow_stage("s", 0)
        assert elastic.chaos_slow_delay("s") == 0.0
    finally:
        elastic.chaos_clear()


# -- pipeline-level drain / adopt ------------------------------------------------

def test_pipeline_drain_and_adopt():
    """``Pipeline.drain_stream`` / ``adopt_stream``: the remaining tokens
    reach the adopting pipeline's sink with the request's meta; unknown
    ids and pipelines without a continuous filter are refused."""
    desc = ("appsrc name=src ! tensor_filter name=llm framework=llm "
            f"model={REF_MODEL} custom={SERVE.replace('max_new:10', 'max_new:30')} "
            "accelerator=true:cpu invoke-dynamic=true ! tensor_sink name=out")
    prompt = _prompt(15, 6)
    pa, pb = ntt.Pipeline(desc), ntt.Pipeline(desc)
    with pa, pb:
        pa.push("src", ntt.Buffer([prompt], meta={"req": 7}))
        first = pa.pull("out", timeout=120)
        sid = first.meta["stream_id"]
        assert pa.serve_streams()[sid]["element"] == "llm"
        snap = pa.drain_stream(sid)
        with pytest.raises(PipelineError, match="no live serve stream"):
            pa.drain_stream(sid)
        assert pb.adopt_stream(snap) == sid
        tail = [pb.pull("out", timeout=120) for _ in range(30 - snap["sidx"])]
        assert all(b.meta["req"] == 7 for b in tail)
        assert [b.meta["stream_index"] for b in tail] == list(range(snap["sidx"], 30))
        assert tail[-1].meta["stream_last"]
        pa.eos("src")
        pb.eos("src")
        pa.wait(timeout=60)
        pb.wait(timeout=60)
    plain = ntt.Pipeline("appsrc name=src ! tensor_sink name=out")
    with pytest.raises(PipelineError, match="no continuous-serving filter"):
        plain.adopt_stream(snap)


# -- elastic stage restarts ---------------------------------------------------------

def _register(name, fail_at):
    spec = TensorsSpec.from_string("4", "float32")
    state = {"n": 0}

    def work(ins):
        state["n"] += 1
        if state["n"] in fail_at:
            raise RuntimeError("injected stage fault")
        return [np.asarray(ins[0]) * 2.0]

    register_custom_easy(name, work, in_spec=spec, out_spec=spec)


def _force_restartable(p):
    """The fault lives in a host custom-easy callable (the one way to
    raise deterministically per buffer), which the planner rightly does
    not call pure: flip the marker to drive the runner's restart itself,
    as the JAX package's test does."""
    for r in p._unique_runners():
        if r.element.kind == "tensor_filter":
            r.stage.restartable = True


def _pull_all(p, timeout=1.0):
    outs = []
    while True:
        try:
            outs.append(p.pull("out", timeout=timeout))
        except TimeoutError:
            return outs


@pytest.mark.parametrize("fuse", [True, False])
def test_planner_marks_pure_stages_restartable(fuse):
    desc = ("appsrc name=src caps=other/tensors,dimensions=4:4,types=float32 ! "
            "tensor_transform mode=arithmetic option=typecast:float32,div:2.0 ! "
            "tensor_filter framework=jax model=scaler custom=scale:4.0,dims:4:4 "
            "accelerator=true:cpu ! tensor_sink name=out")
    p = ntt.Pipeline(desc, fuse=fuse)
    jp = nt.Pipeline(desc.replace(" accelerator=true:cpu", ""), fuse=fuse)
    assert [(s.element.name, s.restartable) for s in p.stages] == \
        [(s.element.name, s.restartable) for s in jp.stages]


def test_restart_survives_bounded_faults():
    _register("elastic-flaky-port", {1})
    p = ntt.Pipeline("appsrc name=src ! tensor_filter name=flaky "
                     "framework=custom-easy model=elastic-flaky-port ! "
                     "tensor_sink name=out", fuse=False, max_stage_restarts=2)
    _force_restartable(p)
    before = metrics.snapshot()
    with p:
        for i in range(4):
            p.push("src", np.full((4,), float(i + 1), np.float32))
        outs = [float(np.asarray(o.tensors[0])[0]) for o in _pull_all(p)]
        p.eos("src")
        p.wait(timeout=20)
    after = metrics.snapshot()
    assert outs == [4.0, 6.0, 8.0]
    assert after.get("flaky.restarts", 0) - before.get("flaky.restarts", 0) == 1
    assert after.get("flaky.dropped", 0) - before.get("flaky.dropped", 0) == 1


def test_restart_budget_exhausts_to_failure():
    _register("elastic-dead-port", set(range(1, 100)))
    p = ntt.Pipeline("appsrc name=src ! tensor_filter name=dead "
                     "framework=custom-easy model=elastic-dead-port ! "
                     "tensor_sink name=out", fuse=False, max_stage_restarts=1)
    _force_restartable(p)
    before = metrics.snapshot().get("dead.restarts", 0)
    with p:
        p.push("src", np.ones((4,), np.float32))
        p.push("src", np.ones((4,), np.float32))
        p.eos("src")
        with pytest.raises(PipelineError, match="injected"):
            p.wait(timeout=20)
    assert metrics.snapshot().get("dead.restarts", 0) - before == 1


def test_default_is_fail_fast():
    _register("elastic-once-port", {1})
    p = ntt.Pipeline("appsrc name=src ! tensor_filter framework=custom-easy "
                     "model=elastic-once-port ! tensor_sink name=out", fuse=False)
    assert p.max_stage_restarts == 0
    with p:
        p.push("src", np.ones((4,), np.float32))
        p.eos("src")
        with pytest.raises(PipelineError):
            p.wait(timeout=20)


def test_restart_keeps_the_fused_stage_captured():
    """A restart in front of a fused stage: exactly the faulting buffer is
    lost, and the fused stage replays the step it captured on the first
    buffer (no capture after)."""
    name = "elastic-fused-port"
    _register(name, {3})
    p = ntt.Pipeline(
        "appsrc name=src caps=other/tensors,dimensions=4,types=float32 ! "
        f"tensor_filter name=flaky framework=custom-easy model={name} ! "
        "tensor_transform mode=arithmetic option=typecast:float32,add:1.0 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:4 "
        "accelerator=true:cpu ! tensor_sink name=out", max_stage_restarts=2)
    _force_restartable(p)
    (fused,) = [s.element for s in p.stages if s.element.kind == "fused"]
    with p:
        p.push("src", ntt.Buffer([np.full((4,), 0.0, np.float32)], pts=0))
        p.pull("out", timeout=30)
        captures = fused.census.captures
        for i in range(1, 6):
            p.push("src", ntt.Buffer([np.full((4,), float(i), np.float32)], pts=i))
        outs = _pull_all(p)
        p.eos("src")
        p.wait(timeout=30)
    assert [o.pts for o in outs] == [1, 3, 4, 5]
    assert all(float(np.asarray(o.tensors[0])[0]) == (o.pts * 2.0 + 1.0) * 2.0
               for o in outs)
    assert captures == 1 and fused.census.captures == 1
    assert fused.census.replays == 5


def test_fault_while_handling_eos_is_not_restarted():
    """Only faults raised inside process() restart: a stage whose
    finalize raises at EOS fails the pipeline even with a budget."""
    name = "elastic-eos-port"
    _register(name, set())
    p = ntt.Pipeline("appsrc name=src ! tensor_filter name=eosfail "
                     f"framework=custom-easy model={name} ! tensor_sink name=out",
                     fuse=False, max_stage_restarts=3)
    _force_restartable(p)
    el = p.element("eosfail")

    def boom():
        raise RuntimeError("finalize fault")

    el.finalize = boom
    with p:
        p.push("src", np.ones((4,), np.float32))
        p.eos("src")
        with pytest.raises(PipelineError, match="finalize fault"):
            p.wait(timeout=20)
    assert metrics.snapshot().get("eosfail.restarts", 0) == 0


def test_stage_restart_config_from_environment(monkeypatch):
    from nnstreamer_tpu_torch.core import config

    monkeypatch.setenv("NNS_TPU_MAX_STAGE_RESTARTS", "3")
    monkeypatch.setenv("NNS_TPU_FETCH_DEPTH", "5")
    config.reset_config()
    try:
        cfg = config.get_config()
        assert (cfg.max_stage_restarts, cfg.fetch_depth) == (3, 5)
        p = ntt.Pipeline("appsrc name=src ! tensor_sink name=out")
        assert p.max_stage_restarts == 3 and p.fetch_depth == 5
    finally:
        monkeypatch.delenv("NNS_TPU_MAX_STAGE_RESTARTS")
        monkeypatch.delenv("NNS_TPU_FETCH_DEPTH")
        config.reset_config()
