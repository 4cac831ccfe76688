"""The continuous serving loop (``custom=serve:continuous``) in the port
against the JAX package's, both on their paged path (``prefix_cache:0``)
with the same llama_tiny f32 weights: ``serving_plan``'s integers, greedy
streams emitted as the JAX pipeline emits them and token for token the
JAX paged model's choices, at occupancies 1..4, chunked prefill and int4,
the block allocator's contracts, typed rejects, the crash terminator,
and the sampled loop's reproducibility."""

import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.filters.llm import serving_plan as jax_plan
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
#: the port's zoo name for llama_tiny built from the JAX package's weights
REF_MODEL = "llama_tiny_jax_weights_serve"
#: logit gap under which a greedy step is a near tie (f32 logits: dense
#: 1e-4, int4 2e-3, the tolerances of test_torch_llama.py)
TIE = {"": 1e-4, "int4": 2e-3}
MAX_NEW = 5
BASE = f"max_new:{MAX_NEW},stream_chunk:2,temperature:0.0,dtype:float32"


@functools.lru_cache(maxsize=None)
def _jax_tree(quant):
    tree = (jl.init_params_int4(CFG, seed=0, gen_dtype="float32") if quant
            else jl.init_params(CFG, seed=0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_builder(opts, device):
    cfg = tl.resolve_config("llama_tiny", opts)
    params = tl.params_from_jax(_jax_tree(opts.get("quant", "")), device=device)
    return tl.make_bundle(cfg, params, opts.get("dtype", "bfloat16"), REF_MODEL)


tzoo.register_model(REF_MODEL, _ref_builder)


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """The JAX loop hands its numpy host state (positions, block tables)
    to jitted calls and mutates it right after (``pos[live] += chunk``).
    On the CPU backend ``jnp.asarray`` of a numpy array aliases its memory
    and dispatch is asynchronous, so a running decode can read positions
    already advanced: its streams then depend on timing.  Synchronous
    dispatch keeps it in order.  Tokens are therefore held against the
    JAX model driven step by step (:func:`_paged_reference_logits`); the
    JAX pipeline is the reference for each stream's emission (count,
    order, end marker)."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG.vocab, (t,)).astype(np.int32) for t in lens]


def _serve_pipeline(jax_side, custom, rounds):
    """Push each round's prompts (meta ``req`` = index), pull every token;
    per round, ``req -> [buffers in arrival order]``."""
    if jax_side:
        pipe = nt.Pipeline(
            "appsrc name=src ! tensor_filter framework=llm model=llama_tiny "
            f"custom={custom},prefix_cache:0 invoke-dynamic=true ! "
            "tensor_sink name=out")
        buf_cls = nt.Buffer
    else:
        pipe = ntt.Pipeline(
            f"appsrc name=src ! tensor_filter framework=llm model={REF_MODEL} "
            f"custom={custom} accelerator=true:cpu invoke-dynamic=true ! "
            "tensor_sink name=out")
        buf_cls = ntt.Buffer
    out = []
    with pipe:
        for prompts in rounds:
            for i, pr in enumerate(prompts):
                pipe.push("src", buf_cls([pr], meta={"req": i}))
            got = {i: [] for i in range(len(prompts))}
            for _ in range(len(prompts) * MAX_NEW):
                b = pipe.pull("out", timeout=120)
                got[b.meta["req"]].append(b)
            out.append(got)
        pipe.eos("src")
        pipe.wait(timeout=60)
    return out


def _ids(bufs):
    return [int(np.asarray(b.tensors[0])[0]) for b in bufs]


@functools.lru_cache(maxsize=None)
def _jax_forward_paged():
    return jax.jit(functools.partial(jl.forward_paged, cfg=CFG,
                                     compute_dtype="float32"))


def _paged_reference_logits(prompt, ids, quant, block_size, chunk):
    """The JAX package's ``forward_paged`` over one row, driven as its
    loop drives a slot: the prompt padded to ``chunk`` multiples and
    prefilled chunk by chunk (logits of the last real token), then one
    decode step per token of ``ids`` but the last, teacher-forced.  Row i
    of the result scores token i of the stream."""
    T = len(prompt)
    P = -(-T // chunk) * chunk
    n_blocks = -(-(P + len(ids)) // block_size)
    pool = jl.init_paged_cache(CFG, n_blocks, block_size, dtype="float32")
    tables = jnp.arange(n_blocks, dtype=jnp.int32)[None]
    toks = np.zeros((1, P), np.int32)
    toks[0, :T] = prompt
    fwd, tree = _jax_forward_paged(), _jax_tree(quant)
    for p in range(0, P, chunk):
        logits, pool = fwd(tree, jnp.asarray(toks[:, p:p + chunk]), pool, tables,
                           jnp.asarray([p], jnp.int32),
                           logit_off=jnp.int32(T - 1 - p if p + chunk >= P else 0))
    rows = [np.asarray(logits)[0, -1]]
    for i, tok in enumerate(ids[:-1]):
        logits, pool = fwd(tree, jnp.asarray([[tok]], jnp.int32), pool, tables,
                           jnp.asarray([T + i], jnp.int32))
        rows.append(np.asarray(logits)[0, -1])
    return np.stack(rows)


def _assert_same_greedy(prompt, port_ids, quant, block_size, chunk=32):
    """Every token of the port's stream is the JAX paged model's greedy
    choice on the same prefix (teacher-forced on the port's own tokens,
    so every step is compared).  At a near tie — the reference's
    top-1/top-2 logit gap inside the logits tolerance — the port's token
    must be one of the tied ones."""
    logits = _paged_reference_logits(prompt, port_ids, quant, block_size, chunk)
    for i, g in enumerate(port_ids):
        top2 = np.sort(logits[i])[-2:]
        if top2[1] - top2[0] < TIE[quant]:
            # the port's argmax is off the reference's by at most its
            # logits error on each side
            assert logits[i][g] >= top2[1] - 2 * TIE[quant], (i, g, port_ids)
        else:
            assert g == int(np.argmax(logits[i])), (i, port_ids)


def _assert_stream_markers(bufs):
    for i, b in enumerate(bufs):
        assert b.meta["stream_index"] == i
        assert bool(b.meta.get("stream_last", False)) == (i == len(bufs) - 1)
        assert not b.meta.get("stream_aborted", False)
    assert len({b.meta["stream_id"] for b in bufs}) == 1
    stamps = [b.meta["emit_t"] for b in bufs]
    assert stamps == sorted(stamps)


# -- serving_plan -------------------------------------------------------------

@pytest.mark.parametrize("preset,kw", [
    ("llama_tiny", dict(slots=4, block_size=16, prefill_chunk=32)),
    ("llama_tiny", dict(slots=2, block_size=16, kv_blocks=10_000)),
    ("llama_tiny", dict(slots=2, block_size=16, kv_blocks=5)),
    ("llama_small", dict(slots=3, block_size=8, prefill_chunk=24)),
    ("llama2_7b", dict(slots=8, block_size=16, prefill_chunk=32)),
])
def test_serving_plan_integers_equal_jax(preset, kw):
    want = jax_plan(jl.PRESETS[preset], **kw)
    got = tllm.serving_plan(tl.PRESETS[preset], **kw)
    assert got == {"max_blocks": want["max_blocks"], "n_blocks": want["n_blocks"]}


# -- the pipeline against the JAX pipeline -------------------------------------

def _assert_same_emission(ref_bufs, got_bufs):
    """The port's stream is emitted as the JAX pipeline's: as many
    buffers, the same ``stream_index`` order and ``stream_last`` marks."""
    assert [b.meta["stream_index"] for b in got_bufs] == \
        [b.meta["stream_index"] for b in ref_bufs]
    assert [bool(b.meta.get("stream_last")) for b in got_bufs] == \
        [bool(b.meta.get("stream_last")) for b in ref_bufs]


def test_greedy_streams_match_jax_at_every_occupancy():
    """Occupancy k = k prompts pushed together into a slots=4 loop; every
    stream is emitted as the JAX loop emits it, and every token is the
    JAX paged model's greedy choice."""
    prompts = _prompts(0, (3, 7, 5, 9))
    rounds = [prompts[:k] for k in range(1, 5)]
    custom = BASE + ",serve:continuous,slots:4,block_size:8"
    ref = _serve_pipeline(True, custom, rounds)
    got = _serve_pipeline(False, custom, rounds)
    for k in range(4):
        for i in range(k + 1):
            _assert_stream_markers(got[k][i])
            _assert_same_emission(ref[k][i], got[k][i])
            _assert_same_greedy(prompts[i], _ids(got[k][i]), "", block_size=8)


@pytest.mark.parametrize("quant,T,chunk", [("", 19, 4), ("int4", 6, 32),
                                           ("int4", 19, 4)])
def test_chunked_prefill_and_int4_match_jax(quant, T, chunk):
    """19 tokens in chunks of 4: 5 chunks, the last with 3 real rows."""
    prompt = _prompts(1, (T,))
    custom = (BASE + f",serve:continuous,slots:2,block_size:8,"
              f"prefill_chunk:{chunk}" + (",quant:int4" if quant else ""))
    ref = _serve_pipeline(True, custom, [prompt])[0][0]
    got = _serve_pipeline(False, custom, [prompt])[0][0]
    _assert_stream_markers(got)
    _assert_same_emission(ref, got)
    _assert_same_greedy(prompt[0], _ids(got), quant, block_size=8, chunk=chunk)


def test_eos_waits_for_every_admitted_stream():
    pipe = ntt.Pipeline(
        f"appsrc name=src ! tensor_filter framework=llm model={REF_MODEL} "
        f"custom={BASE},serve:continuous,slots:2,block_size:8 "
        "accelerator=true:cpu ! tensor_sink name=out")
    with pipe:
        for i, pr in enumerate(_prompts(2, (4, 11, 6))):
            pipe.push("src", ntt.Buffer([pr], meta={"req": i}))
        pipe.eos("src")
        pipe.wait(timeout=120)  # EOS passes only after the loop drained
        bufs = [pipe.pull("out", timeout=5) for _ in range(3 * MAX_NEW)]
    assert sum(1 for b in bufs if b.meta.get("stream_last")) == 3


# -- allocator contracts (tests/test_llm_continuous.py TestBlockAllocator) -------

def _port_fw(custom):
    fw = tllm.LLMFramework()
    fw.open({"model": REF_MODEL, "custom": custom, "accelerator": "true:cpu"})
    return fw


def _submit_all(fw, prompts, timeout=120.0):
    """Submit together; ``index -> [(tensors, meta)]`` in emission order."""
    got = {i: [] for i in range(len(prompts))}
    lock = threading.Lock()

    def emit_for(i):
        def emit(tensors, meta):
            with lock:
                got[i].append((tensors, meta))
        return emit

    for i, p in enumerate(prompts):
        fw.submit([p], {}, emit_for(i))
    assert fw.drain(timeout=timeout)
    return got


def _tokens(emitted):
    return [int(t[0][0]) for t, _ in emitted]


def test_churn_frees_every_block_and_slot():
    """kv_blocks sized so two streams fit and three defer: admission
    serializes the overflow, every stream finishes, and the pool drains
    back to fully free."""
    fw = _port_fw(BASE + ",serve:continuous,slots:2,block_size:4,kv_blocks:8")
    try:
        got = _submit_all(fw, _prompts(3, (3, 6, 4, 8, 5)))
        assert all(len(v) == MAX_NEW for v in got.values())
        loop = fw._serve
        assert sorted(loop._free) == list(range(loop.n_blocks))
        assert (loop._tables == loop.sentinel).all()
        assert all(not b for b in loop._slot_blocks)
        assert (loop._pos == loop.park).all()
    finally:
        fw.close()


def test_recycled_slot_emits_reference_tokens():
    """slots:1 sends every stream through the same slot, over blocks the
    previous stream just freed; the JAX paged model is the reference."""
    prompts = _prompts(4, (4, 9, 6))
    fw = _port_fw(BASE + ",serve:continuous,slots:1,block_size:4")
    try:
        got = _submit_all(fw, prompts)
    finally:
        fw.close()
    for i, p in enumerate(prompts):
        assert len(got[i]) == MAX_NEW
        _assert_same_greedy(p, _tokens(got[i]), "", block_size=4)


def test_impossible_reservation_rejected_not_wedged():
    """A pool of 8 positions (2 blocks of 4): a legal prompt whose
    T + max_new can never fit is rejected with a typed terminator, and
    the loop still serves a prompt that fits."""
    fw = _port_fw(BASE + ",serve:continuous,slots:1,block_size:4,kv_blocks:2")
    try:
        got = _submit_all(fw, [np.arange(1, 8, dtype=np.int32)])  # 7 + 5 > 8
        (tensors, meta), = got[0]
        assert meta["stream_aborted"] is True and meta["stream_last"] is True
        assert meta["abort_reason"] == "reservation-impossible"
        assert _tokens(_submit_all(fw, [np.array([1, 2, 3], np.int32)])[0]) \
            .__len__() == MAX_NEW
    finally:
        fw.close()


def test_oversize_prompt_rejected_with_abort():
    fw = _port_fw(BASE + ",serve:continuous,slots:1,max_seq:64")
    try:
        (_, meta), = _submit_all(fw, [np.ones((64,), np.int32)])[0]
    finally:
        fw.close()
    assert meta["stream_aborted"] is True and meta["stream_last"] is True
    assert meta["abort_reason"] == "prompt-oversize"


def test_head_of_queue_times_out():
    """One slot, a long first stream: the second prompt waits at the
    head past admit_timeout and is rejected; the first completes."""
    fw = _port_fw("max_new:150,stream_chunk:2,temperature:0.0,dtype:float32,"
                  "serve:continuous,slots:1,admit_timeout:0.05")
    try:
        got = _submit_all(fw, _prompts(5, (4, 4)))
    finally:
        fw.close()
    assert len(got[0]) == 150 and not got[0][-1][1].get("stream_aborted")
    (_, meta), = got[1]
    assert meta["stream_aborted"] is True
    assert meta["abort_reason"] == "admit-timeout"


def test_crash_aborts_every_stream_and_refuses_new_ones(monkeypatch):
    fw = _port_fw(BASE + ",serve:continuous,slots:2")
    try:
        fw.serve_loop(timeout=60)  # warm before the fault

        def broken(*a, **k):
            raise RuntimeError("injected fault")

        monkeypatch.setattr(tl, "forward_paged", broken)
        got = _submit_all(fw, _prompts(6, (3, 5, 4)))
        for v in got.values():
            (_, meta), = v
            assert meta["stream_aborted"] is True and meta["stream_last"]
        with pytest.raises(tllm.FrameworkError, match="injected fault"):
            fw.submit([np.array([1, 2], np.int32)], {}, lambda t, m: None)
    finally:
        fw.close()


# -- sampling --------------------------------------------------------------------

def test_sampled_stream_reproducible_and_independent_of_batch():
    """A sampled stream's tokens depend on the seed, its admission number
    and its positions: the same across two runs, and the same alone or
    with three other streams admitted after it."""
    custom = ("max_new:12,stream_chunk:3,temperature:0.9,top_k:40,seed:7,"
              "dtype:float32,serve:continuous,slots:4,block_size:8")
    prompts = _prompts(7, (6, 9, 3, 12))
    runs = []
    for batch in (prompts[:1], prompts[:1], prompts):
        fw = _port_fw(custom)
        try:
            runs.append(_tokens(_submit_all(fw, batch)[0]))
        finally:
            fw.close()
    assert runs[0] == runs[1] == runs[2]
    assert len(runs[0]) == 12


@pytest.mark.parametrize("opt", ["prefix_cache:1", "draft:llama_tiny",
                                 "nan_guard:1", "spec_k:4", "tp:2"])
def test_options_not_yet_ported_raise(opt):
    with pytest.raises(Exception, match="not yet ported"):
        ntt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                     f"model=llama_tiny custom=serve:continuous,{opt} "
                     "accelerator=true:cpu ! tensor_sink name=out")


def test_prefix_cache_off_is_accepted():
    fw = _port_fw(BASE + ",serve:continuous,prefix_cache:0,nan_guard:0")
    try:
        assert fw.continuous
    finally:
        fw.close()
