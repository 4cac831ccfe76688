"""The closed decode-program census of the port (``pipeline/graphs.py``):
decode at a position held on the card against the JAX package's
``forward_cached`` at a traced position, the census pins of both LLM
paths (the counterparts of the JAX package's compile-counter pins,
``tests/test_llm_continuous.py`` ``TestFixedDecodeSignature`` and
``tests/test_llm.py`` ``test_mixed_lengths_share_prefill_program``), the
graph-safe sampler and honest launch counts.  On the CPU a captured step
runs eagerly on the same static buffers, warm-up included: the path the
card takes, without the graph."""

import functools
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.ops import kernels
from nnstreamer_tpu_torch.pipeline.graphs import Census

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
TCFG = tl.PRESETS["llama_tiny"]
#: f32 logits and cache rows, port against the JAX package on the same
#: inputs and weights: the two sum in different orders
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _tree():
    return jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, seed=0))


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax.jit(lambda tree, tok, cache, pos: jl.forward_cached(
        tree, tok, cache, pos, CFG, compute_dtype="float32"))


def _cache(seed, B=2):
    """A cache whose every row holds values, from a numpy seed: rows past
    the position must be masked, not merely zero."""
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, B, CFG.max_seq, CFG.n_kv_heads, CFG.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


# -- decode at a position on the card ------------------------------------------

@pytest.mark.parametrize("pos", [1, 7, CFG.max_seq - 2])
def test_decode_at_card_position_matches_jax_traced_position(pos):
    """The port's ``forward_cached`` with the position as a tensor against
    the JAX package's, jitted with the position traced
    (``dynamic_update_slice`` at ``pos_offset``): logits and every cache
    row."""
    cache = _cache(pos)
    tok = np.random.default_rng(100 + pos).integers(3, CFG.vocab, (2, 1)).astype(np.int32)
    jlog, jcache = _jax_step()(_tree(), jnp.asarray(tok),
                               {k: jnp.asarray(v) for k, v in cache.items()},
                               jnp.int32(pos))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tlog, tcache = tl.forward_cached(
        tl.params_from_jax(_tree(), device="cpu"), torch.from_numpy(tok), tcache,
        torch.tensor(pos), TCFG, compute_dtype="float32")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)


@pytest.mark.parametrize("T", [1, 3])
def test_int_and_tensor_positions_agree_bitwise(T):
    params = tl.params_from_jax(_tree(), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(T).integers(
        3, CFG.vocab, (2, T)).astype(np.int32))
    out = []
    for pos in (9, torch.tensor(9)):
        cache = {k: torch.from_numpy(v) for k, v in _cache(3).items()}
        out.append(tl.forward_cached(params, toks, cache, pos, TCFG, "float32"))
    assert torch.equal(out[0][0], out[1][0])
    for k in ("k", "v"):
        assert torch.equal(out[0][1][k], out[1][1][k])


# -- the sampler a captured step runs ------------------------------------------

def test_draw_is_multinomials_draw():
    """One draw per row: the same tokens as ``torch.multinomial`` from the
    same generator state, without its host-side checks."""
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 64)).astype(np.float32)), dim=-1)
    for seed in range(5):
        want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(seed))
        got = tl._draw(probs, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want[:, 0].to(torch.int32))


def test_live_mask_keeps_live_draws_and_advances_every_generator():
    logits = torch.from_numpy(
        np.random.default_rng(15).standard_normal((3, 64)).astype(np.float32))

    def gens():
        return [torch.Generator().manual_seed(20 + i) for i in range(3)]

    all_rows = tl.sample_token_per_slot(logits, gens(), 0.9, top_k=8)
    g = gens()
    masked = tl.sample_token_per_slot(logits, g, 0.9, top_k=8,
                                      live=torch.tensor([True, False, True]))
    assert masked[0] == all_rows[0] and masked[2] == all_rows[2]
    assert int(masked[1]) == int(torch.argmax(logits[1]))
    # the idle row drew all the same: its generator moved on
    assert g[1].get_state().tolist() != gens()[1].get_state().tolist()


# -- launch counts ---------------------------------------------------------------

def test_replays_count_launches_and_capture_does_not():
    count = kernels.LaunchCount()
    census = Census("cpu")
    step = census.capture("stub", count.add)
    assert count.value == 0
    for _ in range(5):
        step.replay()
    assert count.value == 5
    assert (census.signatures, census.captures, census.replays) == ({"stub"}, 1, 5)


def test_held_launches_are_returned_not_counted():
    count = kernels.LaunchCount()
    with kernels.held_launches() as held:
        count.add(3)
        count.add()
    assert count.value == 0 and held == {count: 4}
    count.add(2)
    assert count.value == 2


# -- the continuous census pin ---------------------------------------------------

def _fw(custom):
    fw = tllm.LLMFramework()
    fw.open({"model": "llama_tiny", "custom": custom, "accelerator": "true:cpu"})
    return fw


def _serve(fw, prompts, timeout=120.0):
    got = {i: [] for i in range(len(prompts))}
    lock = threading.Lock()

    def emit_for(i):
        def emit(tensors, meta):
            with lock:
                got[i].append(int(tensors[0][0]))
        return emit

    for i, p in enumerate(prompts):
        fw.submit([p], {}, emit_for(i))
    assert fw.drain(timeout=timeout)
    return got


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_continuous_census_holds_one_decode_step_through_churn(temperature):
    """Once the loop is warm its census holds one decode signature; new
    prompt lengths, concurrent joins, a full drain and a rejoin capture
    nothing more (the JAX loop's zero-recompile pin)."""
    fw = _fw(f"max_new:5,stream_chunk:2,temperature:{temperature},top_k:40,"
             "dtype:float32,serve:continuous,slots:3,block_size:8,prefill_chunk:4")
    rng = np.random.default_rng(5)
    try:
        fw.serve_loop(timeout=60)
        census = fw.census
        warm = (set(census.signatures), census.captures)
        assert warm == ({("continuous", 3, "float32", temperature > 0)}, 1)
        _serve(fw, [rng.integers(3, 500, (3,)).astype(np.int32)])
        _serve(fw, [rng.integers(3, 500, (t,)).astype(np.int32) for t in (1, 7, 13)])
        got = _serve(fw, [rng.integers(3, 500, (9,)).astype(np.int32)])
        assert len(got[0]) == 5
        assert (set(census.signatures), census.captures) == warm
        assert census.replays == fw._serve.stats["decode_steps"] > 0
    finally:
        fw.close()


def test_slot_generator_is_reseeded_at_admission():
    """A sampled stream's tokens depend on the seed, its admission number
    and its positions, not on what its slot's generator drew before: the
    second admission gives the same tokens after the first one's stream
    used the slot (slots:1) as beside it in a slot that drew while idle
    (slots:2)."""
    prompts = [np.random.default_rng(10 + i).integers(3, 500, (t,)).astype(np.int32)
               for i, t in enumerate((6, 4))]
    second = []
    for slots in (1, 2):
        fw = _fw("max_new:7,stream_chunk:3,temperature:0.9,top_k:40,seed:5,"
                 f"dtype:float32,serve:continuous,slots:{slots},block_size:8")
        try:
            second.append(_serve(fw, prompts)[1])
        finally:
            fw.close()
    assert second[0] == second[1] and len(second[0]) == 7


# -- the static census pin -------------------------------------------------------

STATIC = "max_new:6,stream_chunk:4,dtype:float32"


def _ids(fw, prompt):
    return np.stack([o[0] for o in fw.invoke_stream([prompt])], axis=-1)


def test_static_census_one_decode_signature_per_batch_size():
    """Four prompt lengths and a tail chunk (6 tokens in chunks of 4: one
    of 4, one of 1) replay one decode step for B = 1; a B = 2 request
    adds exactly one."""
    fw = _fw(STATIC)
    try:
        for t in (3, 9, 17, 30):
            assert _ids(fw, np.arange(1, t + 1, dtype=np.int32)).shape == (1, 6)
        assert fw.census.signatures == {("static", 1, "float32", False)}
        assert fw.census.captures == 1 and fw.census.replays == 4 * 5
        _ids(fw, np.arange(1, 11, dtype=np.int32).reshape(2, 5))
        assert fw.census.signatures == {("static", 1, "float32", False),
                                        ("static", 2, "float32", False)}
        assert fw.census.captures == 2
    finally:
        fw.close()


def test_overlapping_requests_take_a_second_set():
    fw = _fw(STATIC)
    try:
        a = fw.invoke_stream([np.arange(1, 6, dtype=np.int32)])
        b = fw.invoke_stream([np.arange(1, 9, dtype=np.int32)])
        next(a)
        next(b)  # both hold a decode set now
        assert len(list(a)) == len(list(b)) == 5
        assert fw.census.signatures == {("static", 1, "float32", False)}
        assert fw.census.captures == 2
        _ids(fw, np.arange(1, 4, dtype=np.int32))  # a free set is reused
        assert fw.census.captures == 2
    finally:
        fw.close()


def test_idle_sets_stay_within_what_requests_in_flight_held():
    """At most one idle set per batch size, and a new set drops every idle
    one first: after overlapping requests one set stays; after a mix of
    batch sizes one after another, only the last one's; two sizes in
    flight together leave both, until a third size needs a set."""
    fw = _fw(STATIC)

    def held():
        return sorted((B, id(d)) for B, d in fw._free_sets.items())

    def request(B, t=5):
        return fw.invoke_stream([np.arange(1, B * t + 1, dtype=np.int32).reshape(B, t)])

    try:
        a, b = request(1), request(1, 8)
        next(a)
        next(b)
        list(a)
        list(b)
        assert [B for B, _ in held()] == [1] and fw.census.captures == 2
        for B in (2, 3, 1):
            list(request(B))
            assert [B_ for B_, _ in held()] == [B]
        assert fw.census.captures == 5
        a, b = request(1), request(2)
        next(a)
        next(b)
        list(a)
        list(b)
        assert [B for B, _ in held()] == [1, 2]
        kept = held()
        list(request(2))  # a free set of its size: nothing is dropped
        assert held() == kept and fw.census.captures == 6
        list(request(3))
        assert [B for B, _ in held()] == [3] and fw.census.captures == 7
        assert fw.census.signatures == {("static", B, "float32", False)
                                        for B in (1, 2, 3)}
    finally:
        fw.close()


@pytest.mark.parametrize("custom", [STATIC, STATIC + ",temperature:0.9,top_k:40,seed:3"])
def test_back_to_back_requests_give_the_tokens_each_gives_alone(custom):
    """A short request after a long one decodes over the cache rows the
    long one left, and from the generator it drew from: prefill and
    re-seeding make its tokens the ones it gives alone."""
    long_p = np.random.default_rng(8).integers(3, CFG.vocab, (60,)).astype(np.int32)
    short_p = np.random.default_rng(9).integers(3, CFG.vocab, (5,)).astype(np.int32)
    alone = {}
    for name, p in (("long", long_p), ("short", short_p)):
        fw = _fw(custom)
        try:
            alone[name] = _ids(fw, p)
        finally:
            fw.close()
    fw = _fw(custom)
    try:
        np.testing.assert_array_equal(_ids(fw, long_p), alone["long"])
        np.testing.assert_array_equal(_ids(fw, short_p), alone["short"])
        assert fw.census.captures == 1
    finally:
        fw.close()


def test_closing_the_filter_frees_its_decode_sets_and_weights():
    """No reference cycle holds a decode set: closing the filter frees the
    sets, their steps and the weights without the cyclic collector (the
    card's memory is not the collector's to count)."""
    fw = _fw(STATIC)
    gc.disable()
    try:
        _ids(fw, np.arange(1, 6, dtype=np.int32))
        sets = [weakref.ref(d) for d in fw._free_sets.values()]
        embed = weakref.ref(fw.bundle.params["embed"])
        assert len(sets) == 1 and sets[0]() is not None
        fw.close()
        assert sets[0]() is None and embed() is None
    finally:
        gc.enable()
