"""Port of models/llama.py against the JAX package on llama_tiny at f32:
parameter trees moved over bit for bit, forward and cached prefill +
decode logits, the int4 tree, and the sampler chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.models import llama as tl

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
TCFG = tl.PRESETS["llama_tiny"]
#: f32 dense logits: XLA and torch sum in different orders
DENSE_TOL = dict(rtol=1e-4, atol=1e-4)
#: f32 int4 logits, the tolerance tests/test_int4.py holds int4 forward to
INT4_TOL = dict(rtol=2e-3, atol=2e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_tree_bit_equal(port_tree, np_tree):
    assert port_tree.keys() == np_tree.keys()
    for k, v in np_tree.items():
        if isinstance(v, dict):
            _assert_tree_bit_equal(port_tree[k], v)
            continue
        t = port_tree[k]
        assert tuple(t.shape) == v.shape, k
        if t.dtype == torch.bfloat16:
            got = t.view(torch.uint16).numpy()
        else:
            got = _bits(t.numpy())
        np.testing.assert_array_equal(got, _bits(v), err_msg=k)


@pytest.fixture(scope="module")
def dense():
    return _np_tree(jl.init_params(CFG, seed=0))


@pytest.fixture(scope="module")
def int4():
    return _np_tree(jl.init_params_int4(CFG, seed=0, gen_dtype="float32"))


@pytest.mark.parametrize("kind", ["dense_f32", "dense_bf16", "int4"])
def test_params_from_jax_bit_exact(kind, dense, int4):
    tree = {"dense_f32": dense, "int4": int4,
            "dense_bf16": _np_tree(jl.init_params(CFG, 0, dtype="bfloat16"))}[kind]
    _assert_tree_bit_equal(tl.params_from_jax(tree, device="cpu"), tree)


def test_quantize_int4_params_matches(dense):
    """Packed nibbles bit for bit.  Scales within 1 ulp: the JAX package's
    quantizer runs jitted, and XLA rewrites its ``amax / 7`` into
    ``amax * (1/7)``; the port divides, as the eager ``quantize_int4``
    does (test_torch_int4.py holds that one bit for bit)."""
    want = _np_tree(jl.quantize_int4_params(jl.init_params(CFG, seed=0)))
    got = tl.quantize_int4_params(tl.params_from_jax(dense, device="cpu"))
    scales = [("layers", k) for k in want["layers"] if k.endswith("_s")]
    scales.append((None, "lm_head_s"))
    for outer, k in scales:
        w = want[outer] if outer else want
        g = got[outer] if outer else got
        np.testing.assert_array_max_ulp(g.pop(k).numpy(), w.pop(k), maxulp=1)
    _assert_tree_bit_equal(got, want)


@pytest.mark.parametrize("quant", ["", "int4"])
def test_own_init_matches_jax_tree_layout(quant, dense, int4):
    want = int4 if quant else dense
    got = tl.init_params(TCFG, seed=0, quant=quant, device="cpu")
    again = tl.init_params(TCFG, seed=0, quant=quant, device="cpu")

    def walk(p, a, w):
        assert p.keys() == w.keys()
        for k in w:
            if isinstance(w[k], dict):
                walk(p[k], a[k], w[k])
                continue
            assert tuple(p[k].shape) == w[k].shape, k
            assert str(p[k].dtype).split(".")[-1] == str(w[k].dtype), k
            assert torch.equal(p[k], a[k]), k  # same seed, same tree

    walk(got, again, want)


def _tokens(T, seed=0):
    return np.random.default_rng(seed).integers(
        3, CFG.vocab, (1, T)).astype(np.int32)


@pytest.mark.parametrize("quant", ["", "int4"])
def test_forward_matches(quant, dense, int4):
    tree = int4 if quant else dense
    toks = _tokens(9)
    want = np.asarray(jl.forward(tree, jnp.asarray(toks), CFG,
                                 compute_dtype="float32"))
    got = tl.forward(tl.params_from_jax(tree, device="cpu"),
                     torch.from_numpy(toks).long(),
                     TCFG, compute_dtype="float32").numpy()
    np.testing.assert_allclose(got, want, **(INT4_TOL if quant else DENSE_TOL))


@pytest.mark.parametrize("quant", ["", "int4"])
def test_forward_cached_prefill_then_decode_matches(quant, dense, int4):
    """Prefill at pos 0, then decode steps teacher-forced with the JAX
    argmax token, so both sides see the same inputs every step."""
    tree = int4 if quant else dense
    tol = INT4_TOL if quant else DENSE_TOL
    prompt = _tokens(7, seed=1)
    jcache = jl.init_cache(CFG, 1, dtype="float32")
    jlog, jcache = jl.forward_cached(tree, jnp.asarray(prompt), jcache, 0, CFG,
                                     compute_dtype="float32")
    params = tl.params_from_jax(tree, device="cpu")
    tcache = tl.init_cache(TCFG, 1, dtype="float32", device="cpu")
    tlog, tcache = tl.forward_cached(params, torch.from_numpy(prompt), tcache,
                                     0, TCFG, compute_dtype="float32")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    pos = prompt.shape[1]
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        jlog, jcache = jl.forward_cached(tree, jnp.asarray(tok), jcache, pos,
                                         CFG, compute_dtype="float32")
        tlog, tcache = tl.forward_cached(params, torch.from_numpy(tok), tcache,
                                         pos, TCFG, compute_dtype="float32")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
        pos += 1
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **tol)


def test_filter_logits_matches():
    logits = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    for temp, k, p in [(0.7, 0, 1.0), (1.0, 10, 1.0), (0.8, 0, 0.9),
                       (1.3, 20, 0.5), (1.0, 0, 0.0)]:
        want = np.asarray(jl.filter_logits(jnp.asarray(logits), temp, k, p))
        got = tl.filter_logits(torch.from_numpy(logits), temp, k, p).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got[np.isfinite(got)],
                                   want[np.isfinite(want)], rtol=1e-6)


def test_greedy_sample_token_exact():
    logits = np.random.default_rng(6).standard_normal((4, 512)).astype(np.float32)
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1.0  # tie: first index
    want = np.asarray(jl.sample_token(jnp.asarray(logits), None, 0.0))
    got = tl.sample_token(torch.from_numpy(logits), None, 0.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[1] == 7


def test_sampled_token_respects_filters():
    logits = torch.from_numpy(
        np.random.default_rng(7).standard_normal((2, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    top = torch.topk(logits, 3, dim=-1).indices
    for _ in range(20):
        tok = tl.sample_token(logits, gen, 1.0, top_k=3)
        assert all(int(tok[i]) in top[i].tolist() for i in range(2))
