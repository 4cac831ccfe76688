"""Speculative decoding in the port's continuous loop (``draft:<preset>``,
``spec_k:N``, ``draft_seed:N``) against the JAX package: greedy streams
are the JAX paged model's greedy choices (teacher-forced, the rule of
``tests/test_torch_continuous.py``) at accept rates 1, partial and 0, at
the ``max_seq`` edge and with prefix sharing on; the rejection commit
equals the JAX package's ``spec_rejection_commit`` on the JAX package's
own draws, and its sampled marginal is the target's (chi-square, as
``tests/test_sampling.py``); the census holds one propose and one verify
signature through churn, hits and forks; a sampled loop repeats itself
bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.filters import llm as jllm
from nnstreamer_tpu_torch.core.log import metrics as tmetrics
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo
from tests.test_torch_continuous import _assert_same_greedy, _ref_builder
from tests.test_torch_prefix import _ids, _port_fw, _serve

torch.set_num_threads(2)

BASE = ("max_new:5,stream_chunk:2,temperature:0.0,dtype:float32,"
        "serve:continuous,slots:2,block_size:8")
SPEC = BASE + ",draft:llama_tiny,spec_k:3"
K = 3


@pytest.fixture
def same_weights_draft(monkeypatch):
    """``draft:llama_tiny`` built from the target's own (JAX) weights, so
    that every proposal is the target's argmax: accept rate 1."""
    monkeypatch.setitem(tzoo._builders, "llama_tiny", _ref_builder)


def _count(name):
    return tmetrics.snapshot().get(name, 0.0)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 500, (t,)).astype(np.int32) for t in lens]


def _spec_run(custom, prompts, **kw):
    """Serve through a fresh filter; returns the streams and the growth of
    the accept counters."""
    a0, r0 = _count("llm.serve.spec_accepted"), _count("llm.serve.spec_rejected")
    fw = _port_fw(custom)
    try:
        got = _serve(fw, prompts, **kw)
        loop = fw._serve
        assert sorted(loop._free) == list(range(loop.n_blocks))
        assert (loop._ref == 0).all()
    finally:
        fw.close()
    return got, (_count("llm.serve.spec_accepted") - a0,
                 _count("llm.serve.spec_rejected") - r0)


def _corrupt_proposals(monkeypatch, cols, dead):
    """Propose as the loop does, then overwrite the proposals of columns
    ``cols`` with ``dead`` (a token the target never chooses here)."""
    real = tllm.spec_propose_step

    def wrapped(*args, **kw):
        step, props = real(*args, **kw), args[8]

        def corrupted():
            step()
            props[:, cols] = dead
        return corrupted

    monkeypatch.setattr(tllm, "spec_propose_step", wrapped)


# -- greedy speculation against the JAX greedy reference -------------------------

def test_accept_rate_one(same_weights_draft):
    """A draft with the target's weights: every proposal is accepted, k
    accepted and one target token a round, and each stream is the JAX
    paged model's greedy stream.  Round tokens carry ``spec_draft`` (1:
    an accepted proposal, 0: the target's token); the prefill's first
    token carries none."""
    prompts = _prompts(16, (6, 11))
    got, (acc, rej) = _spec_run(SPEC, prompts)
    for i, p in enumerate(prompts):
        assert len(got[i]) == 5
        _assert_same_greedy(p, _ids(got[i]), "", block_size=8)
    assert acc > 0 and rej == 0
    flags = [m.get("spec_draft") for _, m in got[0]]
    assert flags[0] is None and set(flags[1:]) <= {0, 1} and 1 in flags
    assert _count("llm.serve.spec_rounds") > 0


def test_partial_accept(same_weights_draft, monkeypatch):
    """The last proposal of every round is spoiled: each round accepts a
    prefix shorter than k, and the streams stay the greedy ones."""
    prompts = _prompts(17, (7, 13))
    _corrupt_proposals(monkeypatch, [K - 1], 2)
    got, (acc, rej) = _spec_run(SPEC + ",max_new:12", prompts)
    for i, p in enumerate(prompts):
        assert len(got[i]) == 12
        _assert_same_greedy(p, _ids(got[i]), "", block_size=8)
    assert acc > 0 and rej > 0


def test_accept_rate_zero(monkeypatch):
    """Every proposal spoiled with a token that none of the streams
    emits: each round emits the target's token alone, no proposal is
    accepted, and the streams stay the greedy ones."""
    prompts = _prompts(18, (9, 4))
    plain = _serve_plain(prompts)
    dead = next(t for t in range(3, 512) if all(t not in s for s in plain))
    _corrupt_proposals(monkeypatch, list(range(K)), dead)
    got, (acc, rej) = _spec_run(SPEC + ",draft_seed:7", prompts)
    assert acc == 0 and rej > 0
    for i, p in enumerate(prompts):
        assert _ids(got[i]) == plain[i]
        _assert_same_greedy(p, _ids(got[i]), "", block_size=8)


def _serve_plain(prompts):
    fw = _port_fw(BASE)
    try:
        got = _serve(fw, prompts)
    finally:
        fw.close()
    return [_ids(got[i]) for i in range(len(prompts))]


def test_max_seq_edge():
    """T = 240 with 16 tokens to go fills llama_tiny's max_seq of 256: the
    last rounds' verify reaches positions past it, which the table spans
    (``serving_plan`` widens it by spec_k), so the last tokens are still
    the greedy ones."""
    (prompt,) = _prompts(25, (240,))
    custom = ("max_new:16,stream_chunk:2,temperature:0.0,dtype:float32,"
              "serve:continuous,slots:2,block_size:16,prefill_chunk:32,"
              "draft:llama_tiny,spec_k:4,draft_seed:7")
    got, _ = _spec_run(custom, [prompt])
    assert len(got[0]) == 16
    _assert_same_greedy(prompt, _ids(got[0]), "", block_size=16, chunk=32)


def test_speculation_with_prefix_sharing(same_weights_draft):
    """Sharing and speculation together: the draft pool's blocks are
    shared and forked with the target's, and the streams stay greedy."""
    rng = np.random.default_rng(19)
    pre = rng.integers(3, 500, (16,)).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(3, 500, (t,)).astype(np.int32)])
               for t in (3, 6)] + [pre.copy()]
    h0, f0 = _count("llm.serve.prefix_hits"), _count("llm.serve.cow_forks")
    got, (acc, _) = _spec_run(SPEC + ",prefill_chunk:4", prompts, stagger=True)
    assert _count("llm.serve.prefix_hits") - h0 == 2
    assert _count("llm.serve.cow_forks") - f0 == 1
    assert acc > 0
    for i, p in enumerate(prompts):
        _assert_same_greedy(p, _ids(got[i]), "", block_size=8, chunk=4)


# -- the rejection commit -----------------------------------------------------------

def _jax_case(B, k, V, seed, draft_like_target=False):
    rng = np.random.default_rng(seed)

    def dist(*shape):
        x = rng.standard_normal(shape).astype(np.float32) * 2.0
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    pt = dist(B, k + 1, V)
    dprobs = pt[:, :k].copy() if draft_like_target else dist(B, k, V)
    props = np.stack([[rng.choice(V, p=dprobs[b, i] / dprobs[b, i].sum())
                       for i in range(k)] for b in range(B)]).astype(np.int32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), B), np.uint32)
    pos = (np.arange(B) * 7 + 4).astype(np.int32)
    live = np.arange(B) % 5 != 3  # some parked rows
    return pt, dprobs, props, keys, pos, live


@pytest.mark.parametrize("B,k,V,seed,like", [
    (16, 3, 64, 0, False), (16, 4, 512, 1, False), (12, 3, 64, 2, True),
    (8, 1, 32, 3, False)])
def test_commit_equals_jax_on_jax_draws(B, k, V, seed, like):
    """The port's commit, handed the JAX package's draws (the accept
    uniforms under ``TAG_ACCEPT``, the Gumbel row of
    ``jax.random.categorical`` under ``TAG_FINAL``), gives exactly the
    JAX package's ``em`` and ``acc``, parked rows included."""
    pt, dprobs, props, keys, pos, live = _jax_case(B, k, V, seed, like)
    em, acc = jllm.spec_rejection_commit(jnp.asarray(pt), jnp.asarray(dprobs),
                                         jnp.asarray(props), jnp.asarray(keys),
                                         jnp.asarray(pos), jnp.asarray(live))
    ka = jllm._fold_slot_keys(jnp.asarray(keys), jnp.asarray(pos), jllm.TAG_ACCEPT)
    u = jax.vmap(lambda kd: jax.random.uniform(kd, (k,)))(ka)
    kf = jllm._fold_slot_keys(jnp.asarray(keys), jnp.asarray(pos), jllm.TAG_FINAL)
    g = jax.vmap(lambda kd: jax.random.gumbel(kd, (V,)))(kf)
    tem, tacc = tllm.spec_commit(torch.from_numpy(pt), torch.from_numpy(dprobs),
                                 torch.from_numpy(props),
                                 torch.from_numpy(np.array(u)),
                                 torch.from_numpy(np.array(g)),
                                 torch.from_numpy(live))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(acc))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(em))
    assert (tacc.numpy()[~live] == 0).all()
    if like:
        assert (tacc.numpy()[live] == k).all()


class TestCommitMarginal:
    """The commit's emitted token at position 0, with proposals drawn from
    the draft and the draws from a torch generator, chi-squared against
    the target distribution (``tests/test_sampling.py``)."""

    V, K, B = 8, 3, 20000
    CHI2_999 = 26.02  # chi-square df=7 critical value at p = 0.999
    PT = np.asarray([.30, .22, .16, .12, .08, .06, .04, .02], np.float32)

    def _run(self, q_row, seed=7):
        B, K, V = self.B, self.K, self.V
        gen = torch.Generator().manual_seed(seed)
        pt = torch.from_numpy(self.PT).expand(B, K + 1, V)
        q = torch.from_numpy(np.asarray(q_row, np.float32))
        props = torch.multinomial(q, B * K, replacement=True,
                                  generator=gen).reshape(B, K).to(torch.int32)
        u = torch.rand((B, K), generator=gen)
        gumbel = -torch.log(torch.empty((B, V)).exponential_(generator=gen))
        em, acc = tllm.spec_commit(pt, q.expand(B, K, V), props, u, gumbel,
                                   torch.ones(B, dtype=torch.bool))
        return em.numpy(), acc.numpy(), props.numpy()

    def _chi2(self, draws):
        counts = np.bincount(draws, minlength=self.V).astype(np.float64)
        expected = len(draws) * self.PT.astype(np.float64)
        return float(((counts - expected) ** 2 / expected).sum())

    def test_mismatched_draft_emits_target_marginal(self):
        em, acc, _ = self._run(self.PT[::-1].copy())
        assert self._chi2(em[:, 0]) < self.CHI2_999
        assert 0.05 < float((acc > 0).mean()) < 0.95

    def test_matched_draft_accepts_everything(self):
        em, acc, props = self._run(self.PT)
        assert (acc == self.K).all()
        assert np.array_equal(em[:, :self.K], props)
        assert self._chi2(em[:, self.K]) < self.CHI2_999


# -- census and sampling ----------------------------------------------------------------

def test_census_one_propose_and_one_verify_through_churn():
    """The loop captures its propose and verify steps once each, at its
    warm-up, and never the decode step; new lengths, hits, forks and
    every accept ratio replay them."""
    rng = np.random.default_rng(20)
    fw = _port_fw(SPEC + ",slots:3,prefill_chunk:4,draft_seed:7")
    try:
        _serve(fw, [rng.integers(3, 500, (3,)).astype(np.int32)])
        census = fw.census
        want = {("propose", 3, K, "float32", False), ("verify", 3, K, "float32", False)}
        assert census.signatures == want and census.captures == 2
        replays = census.replays
        p = rng.integers(3, 500, (24,)).astype(np.int32)
        f0 = _count("llm.serve.cow_forks")
        _serve(fw, [p])
        _serve(fw, [p, p])  # hits and forks
        _serve(fw, [rng.integers(3, 500, (t,)).astype(np.int32) for t in (1, 7, 13)])
        assert _count("llm.serve.cow_forks") - f0 >= 2
        assert census.signatures == want and census.captures == 2
        assert census.replays > replays
        assert fw._serve.stats["decode_steps"] == 0
        assert 2 * fw._serve.stats["spec_rounds"] == census.replays
    finally:
        fw.close()


def test_sampled_speculation_repeats_bitwise():
    """temperature 0.8: two runs from the same seed give the same tokens
    (each slot's generator re-seeded at admission; a round draws k
    proposals, k uniforms and a Gumbel row), alone or beside other
    streams, with one sampled propose and verify signature."""
    custom = ("max_new:10,stream_chunk:2,temperature:0.8,top_k:40,seed:1,"
              "dtype:float32,serve:continuous,slots:3,block_size:8,"
              "draft:llama_tiny,spec_k:3,draft_seed:7")
    prompts = _prompts(21, (6, 9, 4))
    runs = []
    for batch in (prompts[:1], prompts[:1], prompts):
        fw = _port_fw(custom)
        try:
            got = _serve(fw, batch)
            sigs = fw.census.signatures
        finally:
            fw.close()
        runs.append(_ids(got[0]))
        assert all(len(v) == 10 for v in got.values())
        assert sigs == {("propose", 3, K, "float32", True),
                        ("verify", 3, K, "float32", True)}
    assert runs[0] == runs[1] == runs[2]


def test_draft_shares_the_targets_token_space_and_device():
    """The draft is the named preset at the target's vocab and max_seq,
    with weights from ``draft_seed`` at ``param_dtype``, on the target's
    device; two drafts from one seed have the same weights."""
    fws = [_port_fw(SPEC + ",max_seq:128,draft_seed:5") for _ in range(2)]
    try:
        dcfg = fws[0].draft_cfg
        assert (dcfg.vocab, dcfg.max_seq) == (fws[0].cfg.vocab, 128)
        assert dcfg.dim == tl.PRESETS["llama_tiny"].dim
        a, b = (fw.draft_bundle.params["embed"] for fw in fws)
        assert a.device.type == "cpu" and a.dtype == torch.float32
        assert torch.equal(a, b)
    finally:
        for fw in fws:
            fw.close()
