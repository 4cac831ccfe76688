"""Port of flash attention against the JAX package: the plain version
against the interpreted Pallas kernel and the JAX reference (causal and
not, kv longer than q, grouped K/V), ragged lengths, and the wrapper's
routing on the CPU.  The CUDA kernel itself runs only on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops.attention import attention_reference as jax_ref
from nnstreamer_tpu.ops.attention import flash_attention as jax_flash
from nnstreamer_tpu_torch.ops import attention as port

torch.set_num_threads(2)


def _qkv(b, sq, skv, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal):
    return port.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,skv", [(128, 128), (64, 192)])
def test_matches_interpreted_kernel_and_reference(causal, group, sq, skv):
    q, k, v = _qkv(1, sq, skv, 4, 4 // group, 64, seed=sq + group)
    got = _port(q, k, v, causal)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True))
    np.testing.assert_allclose(got, kern, atol=3e-5)
    want = np.asarray(jax_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("sq,skv,d", [(100, 100, 32), (37, 70, 64), (5, 5, 128)])
def test_ragged_lengths_match_reference(sq, skv, d):
    q, k, v = _qkv(2, sq, skv, 4, 2, d, seed=sq)
    got = _port(q, k, v, True)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    q, k, v = _qkv(1, 16, 16, 2, 2, 32)
    before = port.LAUNCHES.value
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = port.flash_attention(tq, tk, tv, causal=True)
    torch.testing.assert_close(
        got, port.attention_reference(tq, tk, tv, causal=True), rtol=0, atol=0)
    assert port.LAUNCHES.value == before
    with pytest.raises(ValueError, match="no kernel for device"):
        port.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"))


def test_wrapper_rejects_mismatched_heads():
    q = torch.zeros(1, 8, 6, 32)
    k = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="do not match"):
        port.flash_attention(q, k, k)


# -- the cases the card's tiling must get right (128-row blocks of two
# 64-row warpgroups, 128-key tiles), held on the plain path ----------------

@pytest.mark.parametrize("sq,skv,hkv,block", [
    (40, 40, 2, 8),     # G = 2, Sq not a multiple of 64
    (100, 100, 1, 20),  # G = 4, 400 rows: the last 128-row block is ragged
    (100, 160, 1, 20),  # G = 4, kv longer than q
])
def test_grouped_ragged_rows_match_interpreted_kernel(sq, skv, hkv, block):
    q, k, v = _qkv(1, sq, skv, 4, hkv, 64, seed=sq + skv)
    got = _port(q, k, v, True)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=block,
                                block_k=block, interpret=True))
    np.testing.assert_allclose(got, kern, atol=3e-5)
    want = np.asarray(jax_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("skv", [256, 704])
def test_prefill_chunk_on_gathered_kv_matches_interpreted_kernel(skv):
    """The continuous loop's chunk: 32 queries at the back of ``skv``
    gathered positions, causal."""
    q, k, v = _qkv(1, 32, skv, 2, 2, 128, seed=skv)
    got = _port(q, k, v, True)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=32,
                                block_k=64, interpret=True))
    np.testing.assert_allclose(got, kern, atol=3e-5)
    want = np.asarray(jax_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_head_dims_match_interpreted_kernel(d):
    q, k, v = _qkv(2, 64, 128, 4, 2, d, seed=d)
    got = _port(q, k, v, True)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=32,
                                block_k=64, interpret=True))
    np.testing.assert_allclose(got, kern, atol=3e-5)
    want = np.asarray(jax_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16"),
                                         (torch.float32, "f32")])
def test_dtype_routes_to_its_kernel_and_cpu_takes_plain(dtype, route):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(1, 16, 24, 4, 2, 64))
    assert port.flash_route(q, k, v) == route
    before = port.LAUNCHES.value
    got = port.flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, port.attention_reference(q, k, v, causal=True), rtol=0, atol=0)
    assert port.LAUNCHES.value == before


def _bad_inputs(case):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 16, 4, 2, 64))
    if case == "f16":
        return q.half(), k.half(), v.half()
    if case == "mixed":
        return q, k.float(), v
    if case == "non-contiguous":
        return q.transpose(1, 2).contiguous().transpose(1, 2), k, v
    if case == "d96":
        return (torch.from_numpy(a).to(torch.bfloat16)
                for a in _qkv(1, 16, 16, 4, 2, 96))
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("f16", "f32/bf16"), ("mixed", "one dtype"),
    ("non-contiguous", "contiguous"), ("d96", "head dim 96")])
def test_route_rejects_what_no_kernel_takes(case, match):
    with pytest.raises(ValueError, match=match):
        port.flash_route(*_bad_inputs(case))


def test_wrapper_rejects_meta_device_for_every_dtype():
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(a).to(dtype).to("meta")
                   for a in _qkv(1, 16, 16, 4, 2, 64))
        with pytest.raises(ValueError, match="no kernel for device"):
            port.flash_attention(q, k, v, causal=True)
