"""Port of paged attention and the block-paged forward against the JAX
package on the CPU: the plain version against the JAX reference (live
rows) and the interpreted Pallas kernel (every row, zeros at context 0),
a chunked-prefill suffix, and ``forward_paged`` (chunked prefill, then
decode with a parked row) on llama_tiny at f32, dense and int4, with the
pool compared block for block.  The CUDA kernel itself runs only on the
card (chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.ops.attention import paged_attention as jax_paged
from nnstreamer_tpu.ops.attention import paged_attention_reference as jax_ref
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.ops import attention as port

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
TCFG = tl.PRESETS["llama_tiny"]
#: f32 attention: XLA and torch sum in different orders
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
#: f32 logits, the tolerances of test_torch_llama.py
LOGIT_TOL = {"": dict(rtol=1e-4, atol=1e-4), "int4": dict(rtol=2e-3, atol=2e-3)}


def _case(seed, B=4, T=1, H=4, hkv=2, D=16, bs=8, n_blocks=16, max_blocks=4,
          lens=(1, 5, 8, 29)):
    """The shapes of tests/test_llm_continuous.py TestPagedAttentionKernel:
    blocks scattered through the pool, sentinel entries past each row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k_pool = rng.standard_normal((n_blocks, bs, hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, bs, hkv, D)).astype(np.float32)
    tables = np.full((B, max_blocks), n_blocks, np.int32)
    blocks = rng.permutation(n_blocks)
    i = 0
    for b, ln in enumerate(lens):
        need = -(-ln // bs)
        tables[b, :need] = blocks[i:i + need]
        i += need
    return q, k_pool, v_pool, tables, np.asarray(lens, np.int32)


def _port(q, k_pool, v_pool, tables, lens):
    return port.paged_attention(*(torch.from_numpy(a) for a in
                                  (q, k_pool, v_pool, tables, lens))).numpy()


@pytest.mark.parametrize("lens", [(1, 5, 8, 29), (0, 5, 0, 29), (32, 17, 3, 16)])
def test_plain_version_matches_jax_reference_on_live_rows(lens):
    case = _case(7, lens=lens)
    got = _port(*case)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in case)))
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], want[live], **ATTN_TOL)


@pytest.mark.parametrize("lens", [(1, 5, 8, 29), (0, 5, 0, 29)])
def test_plain_version_matches_interpreted_kernel_on_every_row(lens):
    case = _case(8, lens=lens)
    got = _port(*case)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in case), interpret=True))
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].any()  # exact zeros, as the kernel gives


@pytest.mark.parametrize("group", [1, 2, 4])
def test_grouped_heads_match_jax_reference(group):
    case = _case(9, H=4, hkv=4 // group, D=32, lens=(3, 9, 16, 30))
    np.testing.assert_allclose(
        _port(*case), np.asarray(jax_ref(*(jnp.asarray(a) for a in case))),
        **ATTN_TOL)


@pytest.mark.parametrize("T,ln", [(4, 13), (8, 8), (8, 31)])
def test_prefill_chunk_suffix_matches_jax_reference(T, ln):
    """T > 1: query t of the row sits at position len - T + t."""
    case = _case(10, B=1, T=T, lens=(ln,))
    np.testing.assert_allclose(
        _port(*case), np.asarray(jax_ref(*(jnp.asarray(a) for a in case))),
        **ATTN_TOL)


def test_plain_suffix_equals_flash_over_the_gathered_blocks():
    """The card routes a T > 1 step to flash attention over the row's
    gathered live blocks; on the same inputs its plain version must give
    the paged plain version's answer."""
    q, kp, vp, tables, lens = _case(11, B=1, T=8, lens=(21,))
    nb = -(-21 // 8)
    k = kp[tables[0, :nb]].reshape(1, nb * 8, 2, 16)[:, :21]
    v = vp[tables[0, :nb]].reshape(1, nb * 8, 2, 16)[:, :21]
    flash = port.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(_port(q, kp, vp, tables, lens), flash, **ATTN_TOL)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    case = [torch.from_numpy(a) for a in _case(12)]
    before = port.PAGED_LAUNCHES.value
    got = port.paged_attention(*case)
    torch.testing.assert_close(got, port.paged_attention_reference(*case),
                               rtol=0, atol=0)
    assert port.PAGED_LAUNCHES.value == before
    with pytest.raises(ValueError, match="no kernel for device"):
        port.paged_attention(*(t.to("meta") for t in case))


@pytest.mark.parametrize("what", ["pool", "tables", "lens"])
def test_wrapper_rejects_mismatched_shapes(what):
    q, kp, vp, tables, lens = [torch.from_numpy(a) for a in _case(13)]
    if what == "pool":
        kp = kp[..., :8]
    elif what == "tables":
        tables = tables[:2]
    else:
        lens = lens[:3]
    with pytest.raises(ValueError):
        port.paged_attention(q, kp, vp, tables, lens)


# -- forward_paged ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree(quant):
    tree = (jl.init_params_int4(CFG, seed=0, gen_dtype="float32") if quant
            else jl.init_params(CFG, seed=0))
    return jax.tree_util.tree_map(np.asarray, tree)


N_BLOCKS, BS, MAX_BLOCKS = 12, 4, 8


def _pools(seed):
    """The same random pool for both packages ([L, n_blocks, bs, Hkv, hd]),
    so that untouched blocks can be checked bit for bit."""
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, N_BLOCKS, BS, CFG.n_kv_heads, CFG.dim // CFG.n_heads)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tpool = tl.init_paged_cache(TCFG, N_BLOCKS, BS, "float32", device="cpu")
    tpool["k"][:, :N_BLOCKS] = torch.from_numpy(k)
    tpool["v"][:, :N_BLOCKS] = torch.from_numpy(v)
    return {"k": jnp.asarray(k), "v": jnp.asarray(v)}, tpool, (k, v)


def _both(tree, params, toks, jpool, tpool, tables, pos, logit_off=None):
    jlog, jpool = jl.forward_paged(
        tree, jnp.asarray(toks), jpool, jnp.asarray(tables),
        jnp.asarray(np.asarray(pos, np.int32)), CFG, compute_dtype="float32",
        logit_off=None if logit_off is None else jnp.int32(logit_off))
    tlog, tpool = tl.forward_paged(
        params, torch.from_numpy(toks), tpool, torch.from_numpy(tables),
        np.asarray(pos, np.int64), TCFG, compute_dtype="float32",
        logit_off=logit_off)
    return np.asarray(jlog), tlog.numpy(), jpool, tpool


@pytest.mark.parametrize("quant", ["", "int4"])
def test_forward_paged_matches_jax(quant):
    """Row 0 prefills 11 tokens in chunks of 8 (the last chunk's logits
    read at the last real token, ``logit_off``), then rows 0 and 1 decode
    5 steps, row 1 parked at ``max_blocks * block_size``; tokens are
    teacher-forced with the JAX argmax."""
    tree = _tree(quant)
    params = tl.params_from_jax(tree, device="cpu")
    tol = LOGIT_TOL[quant]
    jpool, tpool, (k0, v0) = _pools(1)
    tables = np.full((2, MAX_BLOCKS), N_BLOCKS, np.int32)
    tables[0, :5] = [9, 2, 7, 0, 11]  # non-contiguous, out of order
    prompt = np.random.default_rng(2).integers(3, CFG.vocab, (1, 16)).astype(np.int32)
    T = 11
    prompt[:, T:] = 0  # chunk padding
    for p in (0, 8):
        off = T - 1 - p if p + 8 >= 16 else None
        jlog, tlog, jpool, tpool = _both(tree, params, prompt[:, p:p + 8],
                                         jpool, tpool, tables[:1], [p], off)
        np.testing.assert_allclose(tlog, jlog, **tol)
    assert tlog.shape == (1, 1, CFG.vocab)  # one row through the lm_head
    tok = int(np.argmax(jlog[0, -1]))
    pos = [T, MAX_BLOCKS * BS]
    for _ in range(5):
        toks = np.asarray([[tok], [tok]], np.int32)
        jlog, tlog, jpool, tpool = _both(tree, params, toks, jpool, tpool,
                                         tables, pos)
        np.testing.assert_allclose(tlog[0], jlog[0], **tol)
        tok = int(np.argmax(jlog[0, -1]))
        pos[0] += 1
    # the live row's blocks agree; every other block is untouched
    live = np.zeros(N_BLOCKS, bool)
    live[tables[0, :4]] = True
    for name, init in (("k", k0), ("v", v0)):
        got = tpool[name][:, :N_BLOCKS].numpy()
        np.testing.assert_allclose(got[:, live], np.asarray(jpool[name])[:, live], **tol)
        np.testing.assert_array_equal(got[:, ~live], init[:, ~live])
        np.testing.assert_array_equal(np.asarray(jpool[name])[:, ~live], init[:, ~live])


def test_parked_row_never_writes_pool():
    """Port of test_llm_continuous.py::test_parked_row_never_writes_pool:
    the parked row's write lands in the sink block only."""
    params = tl.params_from_jax(_tree(""), device="cpu")
    _, tpool, (k0, _) = _pools(3)
    tables = np.full((2, MAX_BLOCKS), N_BLOCKS, np.int32)
    tables[0, 0] = 3  # row 0 live in block 3; row 1 parked
    tl.forward_paged(params, torch.tensor([[5], [5]], dtype=torch.int32), tpool,
                     torch.from_numpy(tables),
                     np.array([0, MAX_BLOCKS * BS]), TCFG, "float32")
    after = tpool["k"][:, :N_BLOCKS].numpy()
    assert not np.array_equal(after[:, 3], k0[:, 3])  # the live row wrote
    mask = np.ones(N_BLOCKS, bool)
    mask[3] = False
    np.testing.assert_array_equal(after[:, mask], k0[:, mask])


def test_paged_cache_sizes():
    pool = tl.init_paged_cache(TCFG, 6, 4, "bfloat16", device="cpu")
    assert tuple(pool["k"].shape) == (2, 7, 4, 2, 32)  # + the sink block
    assert tl.paged_cache_bytes(TCFG, 6, 4, "bfloat16") == \
        jl.paged_cache_bytes(CFG, 6, 4, dtype="bfloat16")
    with pytest.raises(TypeError):
        tl.init_paged_cache(TCFG, 6, 4)  # the device is never implied


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_sample_token_per_slot(temperature):
    logits = torch.from_numpy(
        np.random.default_rng(14).standard_normal((3, 64)).astype(np.float32))
    gens = [torch.Generator().manual_seed(5), None, torch.Generator().manual_seed(5)]
    got = tl.sample_token_per_slot(logits, gens, temperature, top_k=8)
    assert got.dtype == torch.int32 and got.shape == (3,)
    assert int(got[1]) == int(torch.argmax(logits[1]))  # no generator: argmax
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), torch.argmax(logits, -1).numpy())
    again = tl.sample_token_per_slot(
        logits, [torch.Generator().manual_seed(5), None,
                 torch.Generator().manual_seed(5)], temperature, top_k=8)
    torch.testing.assert_close(got, again)
