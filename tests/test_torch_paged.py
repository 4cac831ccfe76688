"""Port of paged attention and the block-paged forward against the JAX
package on the CPU: the plain version against the JAX reference (live
rows) and the interpreted Pallas kernel (every row, zeros at context 0),
a chunked-prefill suffix, several rows of T = 5 queries (the speculative
verify shape), and ``forward_paged`` (chunked prefill, then decode with a
parked row; a [3, 5] step) on llama_tiny at f32, dense and int4, with the
pool compared block for block.  The kernel's route and split plan are
checked as the pure functions they are, and its split/merge arithmetic
through a plain emulation in plan order.  The CUDA kernel itself runs
only on the card (chip_smoke.py)."""

import functools
import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

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
    # meta tensors (abstract execution): q's shape and dtype, no launch
    meta = port.paged_attention(*(t.to("meta") for t in case))
    assert meta.device.type == "meta" and port.PAGED_LAUNCHES.value == before
    assert (meta.shape, meta.dtype) == (got.shape, got.dtype)


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


@pytest.mark.parametrize("lens", [(5, 6, 17, 30), (5, 5, 9, 31)])
def test_several_rows_of_t5_match_jax_reference(lens):
    """B = 4 rows of T = 5 queries (a speculative-verify step), lengths
    >= T, one row holding only its suffix (L == T)."""
    case = _case(15, B=4, T=5, lens=lens)
    np.testing.assert_allclose(
        _port(*case), np.asarray(jax_ref(*(jnp.asarray(a) for a in case))),
        **ATTN_TOL)


def test_queries_with_no_position_give_zeros():
    """A query at position < 0 (context shorter than the suffix) attends
    nothing and gives zeros, as the kernel does; the other queries of the
    row match the JAX reference."""
    q, kp, vp, tables, lens = _case(16, B=2, T=5, lens=(3, 12))
    got = _port(q, kp, vp, tables, lens)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kp, vp, tables, lens))))
    assert not got[0, :2].any()  # positions -2, -1
    np.testing.assert_allclose(got[0, 2:], want[0, 2:], **ATTN_TOL)
    np.testing.assert_allclose(got[1], want[1], **ATTN_TOL)


@pytest.mark.parametrize("B,T,G,want", [
    (8, 1, 1, "kernel"),           # the 7B decode step
    (1, 1, 4, "kernel"),
    (8, 5, 1, "kernel"),           # the verify shape: no raise any more
    (8, 8, 8, "kernel"),           # G * T == 64, the kernel's widest
    (2, 16, 4, "kernel"),
    (1, 5, 1, "gather_flash"),     # one row's suffix: a prefill chunk
    (1, 32, 4, "gather_flash"),
    (8, 9, 8, "gather_flash"),     # G * T == 72: row by row
    (2, 17, 4, "gather_flash"),
])
def test_paged_route(B, T, G, want):
    assert port.paged_route(B, T, G) == want


@pytest.mark.parametrize("B,T,G", [(8, 1, 3), (4, 2, 16), (1, 1, 16)])
def test_paged_route_rejects_groups_the_kernel_lacks(B, T, G):
    with pytest.raises(ValueError, match="query heads per kv head"):
        port.paged_route(B, T, G)


@pytest.mark.parametrize("bs", [1, 4, 8, 12, 16, 32, 64, 100])
@pytest.mark.parametrize("T,G", [(1, 1), (1, 8), (5, 1), (5, 8), (8, 8)])
def test_paged_plan_takes_any_block_size(bs, T, G):
    plan = port.paged_plan(T, G, bs, 40)
    assert plan.part_len % bs == 0 and plan.part_len % port.PAGED_TILE == 0
    assert plan.n_parts * plan.part_len >= 40 * bs > (plan.n_parts - 1) * plan.part_len
    m_tiles = -(-G * T // 16)
    assert plan.splits * (1 << (m_tiles - 1).bit_length()) <= port.PAGED_WARPS
    assert port.paged_plan(T, G, bs, 40, bf16=False).splits == 1
    if bs == 16:
        assert plan.part_len == 256  # 16 pool blocks


def test_paged_plan_rejects_rows_the_kernel_does_not_take():
    for T, G in ((9, 8), (65, 1), (0, 1)):
        with pytest.raises(ValueError):
            port.paged_plan(T, G, 16, 64)


def _partitions(context_len, part_len):
    """The positions ``[start, stop)`` of each partition the kernel works
    on for one row of this context length, in the order the merge reads
    them (as :func:`port.paged_plan` states them)."""
    return [(s, min(s + part_len, context_len))
            for s in range(0, max(context_len, 0), part_len)]


@pytest.mark.parametrize("L,n", [(0, 0), (1, 1), (255, 1), (256, 1), (257, 2),
                                 (1000, 4), (1024, 4), (4096, 16)])
def test_partitions_of_a_row(L, n):
    part_len = port.paged_plan(1, 1, 16, 256).part_len
    assert part_len == 256
    parts = _partitions(L, part_len)
    assert len(parts) == n == -(-L // 256)
    assert all(0 < stop - start <= 256 for start, stop in parts)
    assert [p[0] for p in parts] == list(range(0, L, 256))  # in order, no gap
    assert (parts[-1][1] if parts else 0) == L


def _batch_sharing_row0(seed, q, k_pool, v_pool, tables, lens):
    """Another batch of the same shape that shares only row 0 with the
    given one (its query, table, blocks and their K/V): every other row's
    query, length, blocks (none of row 0's) and K/V differ."""
    rng = np.random.default_rng(seed)
    n_pool, bs = k_pool.shape[:2]
    q2 = rng.standard_normal(q.shape).astype(np.float32)
    k2 = rng.standard_normal(k_pool.shape).astype(np.float32)
    v2 = rng.standard_normal(v_pool.shape).astype(np.float32)
    mine = tables[0, :-(-int(lens[0]) // bs)]
    q2[0], k2[mine], v2[mine] = q[0], k_pool[mine], v_pool[mine]
    spare = rng.permutation(np.setdiff1d(np.arange(n_pool), mine))
    tables2 = np.full_like(tables, n_pool)
    tables2[0] = tables[0]
    used = 0
    for r, n in enumerate(lens[1:], start=1):
        need = -(-int(n) // bs)
        tables2[r, :need] = spare[used:used + need]
        used += need
    return q2, k2, v2, tables2


@pytest.mark.parametrize("T,G", [(1, 1), (5, 4)])
def test_a_rows_plan_depends_on_its_own_length_only(T, G):
    """The same row 0 in two batches that differ in every other row (the
    card's row-0 check, in plan order): the plan takes the shape alone,
    and row 0's output is bitwise the same in both."""
    bs, mb, nbk, hkv = 16, 64, 192, 2
    lens_a, lens_b = (700, 0, T, 1000), (700, 1024, 255, 5)
    q, kp, vp, tables, lens = _case(21, B=4, T=T, H=G * hkv, hkv=hkv, bs=bs,
                                    n_blocks=nbk, max_blocks=mb, lens=lens_a)
    q2, kp2, vp2, tables2 = _batch_sharing_row0(22, q, kp, vp, tables, lens_b)
    plan = port.paged_plan(T, G, bs, mb)
    assert _partitions(700, plan.part_len) == [(0, 256), (256, 512), (512, 700)]
    got_a = _emulate(q, kp, vp, tables, lens, plan)
    got_b = _emulate(q2, kp2, vp2, tables2, np.asarray(lens_b, np.int32), plan)
    np.testing.assert_allclose(got_a, _port(q, kp, vp, tables, lens), **ATTN_TOL)
    assert np.array_equal(got_a[0], got_b[0])
    assert not np.array_equal(got_a[1:], got_b[1:])


def _emulate(q, k_pool, v_pool, tables, lens, plan, fault=None):
    """The kernel's arithmetic, in plan order, in f64 numpy: each (row, kv
    head) cut into ``_partitions``, each partition's 16-position
    tiles taken in turn by ``plan.splits`` warps with an online softmax in
    the log2 domain (keys past a query's position masked), then the
    partials merged in order.  ``fault`` injects one mistake: drop the
    row's last partition, drop split 1, or skip the mask."""
    B, T, H, D = q.shape
    n_pool, bs, hkv, _ = k_pool.shape
    G, rows, max_blocks = H // hkv, H // hkv * T, tables.shape[1]
    c = D ** -0.5 * np.log2(np.e)
    out = np.zeros((B, T, H, D))
    for b in range(B):
        L_raw = max(int(lens[b]), 0)
        L = min(L_raw, max_blocks * bs)
        lim = np.minimum(L - 1, L_raw - T + np.arange(rows) // G)
        parts = _partitions(L, plan.part_len)
        if fault == "drop_partition":
            parts = parts[:-1]
        for kvh in range(hkv):
            qr = q[b].reshape(T, hkv, G, D)[:, kvh].reshape(rows, D).astype(np.float64)
            partials = []
            for p0, p1 in parts:
                n_tiles = -(-(p1 - p0) // port.PAGED_TILE)
                for sub in range(plan.splits):
                    m = np.full(rows, -np.inf)
                    l, acc = np.zeros(rows), np.zeros((rows, D))
                    for j in range(sub, n_tiles, plan.splits):
                        keys = p0 + j * port.PAGED_TILE + np.arange(port.PAGED_TILE)
                        e = keys // bs
                        blk = np.where(e < max_blocks,
                                       tables[b, np.minimum(e, max_blocks - 1)], n_pool - 1)
                        blk = np.clip(blk, 0, n_pool - 1)
                        kk, vv = k_pool[blk, keys % bs, kvh], v_pool[blk, keys % bs, kvh]
                        s = qr @ kk.T * c
                        if fault != "no_mask":
                            s = np.where(keys[None, :] > lim[:, None], -np.inf, s)
                        m_new = np.maximum(m, s.max(1))
                        sh = np.where(np.isinf(m_new), 0.0, m_new)
                        alpha = np.exp2(np.where(np.isinf(m), sh, m) - sh)
                        pr = np.exp2(s - sh[:, None])
                        l = l * alpha + pr.sum(1)
                        acc = acc * alpha[:, None] + pr @ vv
                        m = m_new
                    if not (fault == "drop_split" and sub == 1):
                        partials.append((m, l, acc))
            if not partials:
                continue
            ms = np.stack([p[0] for p in partials])
            mx = ms.max(0)
            w = np.where(np.isinf(ms), 0.0, np.exp2(ms - np.where(np.isinf(mx), 0.0, mx)))
            num = sum(wi[:, None] * p[2] for wi, p in zip(w, partials))
            den = sum(wi * p[1] for wi, p in zip(w, partials))
            o = np.where(den[:, None] > 0, num / np.where(den > 0, den, 1.0)[:, None], 0.0)
            out[b].reshape(T, hkv, G, D)[:, kvh] = o.reshape(T, G, D)
    return out.astype(np.float32)


#: (B, T, H, Hkv, D, bs, lens, table width, pool blocks): a decode step
#: over 1, 2 and 3 partitions; T = 5 rows (2 M tiles, 2 splits) with a
#: row of L == T; G = 8 at a block size that is no power of two, with a
#: second partition of one position
EMULATED = [
    (4, 1, 4, 4, 16, 16, (0, 1, 255, 600), 40, 64),
    (3, 5, 8, 2, 16, 8, (5, 40, 300), 40, 48),
    (2, 1, 8, 1, 16, 12, (250, 241), 24, 48),
]


@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_split_merge_matches_plain_version(shape):
    B, T, H, hkv, D, bs, lens, mb, nbk = shape
    q, kp, vp, tables, lens_a = _case(17, B=B, T=T, H=H, hkv=hkv, D=D, bs=bs,
                                      n_blocks=nbk, max_blocks=mb, lens=lens)
    plan = port.paged_plan(T, H // hkv, bs, mb)
    want = _port(q, kp, vp, tables, lens_a)
    np.testing.assert_allclose(_emulate(q, kp, vp, tables, lens_a, plan), want, **ATTN_TOL)
    f32 = port.paged_plan(T, H // hkv, bs, mb, bf16=False)
    np.testing.assert_allclose(_emulate(q, kp, vp, tables, lens_a, f32), want, **ATTN_TOL)


@pytest.mark.parametrize("fault", ["drop_partition", "drop_split", "no_mask"])
def test_each_fault_of_the_emulation_shows(fault):
    """What the card's per-row limit (2% of the row's scale) must catch:
    each injected mistake moves some live row by more than that."""
    B, T, H, hkv, D, bs, lens, mb, nbk = EMULATED[1]
    q, kp, vp, tables, lens_a = _case(18, B=B, T=T, H=H, hkv=hkv, D=D, bs=bs,
                                      n_blocks=nbk, max_blocks=mb, lens=lens)
    plan = port.paged_plan(T, H // hkv, bs, mb)
    want = _port(q, kp, vp, tables, lens_a)
    got = _emulate(q, kp, vp, tables, lens_a, plan, fault=fault)
    row_err = (np.abs(got - want).reshape(B, -1).max(1)
               / np.abs(want).reshape(B, -1).max(1))
    assert row_err.max() > 2e-2


@pytest.mark.parametrize("shape", chip_smoke.PAGED_SHAPES, ids=lambda s: s[0])
def test_card_shapes_are_shapes_the_port_takes(shape):
    """Each shape chip_smoke.py holds the kernel to on the card has a
    route, one length per row within its table, and, at T > 1, no live
    row shorter than its suffix (the reference's verify step)."""
    name, B, T, H, hkv, D, lens, max_blocks = shape
    route = port.paged_route(B, T, H // hkv)
    assert route == ("gather_flash" if name == "wide" else "kernel")
    assert len(lens) == B and max(lens) <= max_blocks * chip_smoke.PAGED_BS
    assert all(n == 0 or n >= T for n in lens)
    if route == "kernel":
        port.paged_plan(T, H // hkv, chip_smoke.PAGED_BS, max_blocks)


def test_rows_through_gathered_flash_match_plain_version():
    """The card's route for B > 1 rows of G * T > 64 queries: each row's
    live blocks gathered and put through flash attention (here its plain
    version), a context-0 row as zeros."""
    q, kp, vp, tables, lens = _case(19, B=3, T=6, lens=(0, 9, 29))
    rows = [port._gather_flash(torch.from_numpy(q[i:i + 1]), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(tables[i]),
                               int(lens[i]), 16 ** -0.5) for i in range(3)]
    np.testing.assert_allclose(torch.cat(rows).numpy(), _port(q, kp, vp, tables, lens),
                               **ATTN_TOL)
    with pytest.raises(ValueError, match="shorter than"):
        port._gather_flash(torch.from_numpy(q[:1]), torch.from_numpy(kp),
                           torch.from_numpy(vp), torch.from_numpy(tables[0]), 3, 0.25)


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


@pytest.mark.parametrize("quant", ["", "int4"])
def test_forward_paged_verify_step_matches_jax(quant):
    """A [B = 3, T = 5] step (the speculative-verify shape) over a random
    pool: row 0 holds only its suffix (L == T), rows 1 and 2 attend
    random context; every position's logits and the written blocks."""
    tree = _tree(quant)
    params = tl.params_from_jax(tree, device="cpu")
    tol = LOGIT_TOL[quant]
    jpool, tpool, _ = _pools(4)
    tables = np.full((3, MAX_BLOCKS), N_BLOCKS, np.int32)
    tables[0, :2] = [10, 4]
    tables[1, :3] = [1, 8, 6]
    tables[2, :5] = [0, 11, 3, 9, 2]
    toks = np.random.default_rng(5).integers(3, CFG.vocab, (3, 5)).astype(np.int32)
    jlog, tlog, jpool, tpool = _both(tree, params, toks, jpool, tpool, tables,
                                     [0, 7, 13])
    assert tlog.shape == (3, 5, CFG.vocab)
    np.testing.assert_allclose(tlog, jlog, **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name][:, :N_BLOCKS].numpy(),
                                   np.asarray(jpool[name]), **tol)


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
    live = torch.tensor([True, False, True])

    def gens():
        return [torch.Generator().manual_seed(5) for _ in range(3)]

    got = tl.sample_token_per_slot(logits, gens(), temperature, top_k=8, live=live)
    assert got.dtype == torch.int32 and got.shape == (3,)
    assert int(got[1]) == int(torch.argmax(logits[1]))  # idle row: argmax
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), torch.argmax(logits, -1).numpy())
    again = tl.sample_token_per_slot(logits, gens(), temperature, top_k=8, live=live)
    torch.testing.assert_close(got, again)
