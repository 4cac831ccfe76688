"""The port's ring attention (``nnstreamer_tpu_torch/parallel/ring.py``) and
sequence-parallel llama forward against the JAX package's
(``tests/test_parallel.py::test_ring_attention_matches_dense``,
``tests/test_llm.py::test_seq_parallel_matches_dense``), on the CPU.

The JAX ring runs on the conftest's eight virtual CPU devices, the port's
on eight slots of the CPU (``NNS_TPU_DEVICE_SLOTS=8``), on the same
seeded numpy inputs.  Tolerances: the ring within the JAX test's
``atol=2e-5`` of the JAX ring (measured: 3.3e-7); ``forward_seq_parallel``
at float32 on ``llama_tiny`` within 1e-4 of the JAX one (the JAX test
holds 2e-3; measured: 6.1e-6)."""

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.parallel import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel import ring_attention as jring
from nnstreamer_tpu_torch.models import llama
from nnstreamer_tpu_torch.ops.attention import flash_attention
from nnstreamer_tpu_torch.parallel import make_mesh, ring_attention
from nnstreamer_tpu_torch.parallel.mesh import local_devices
from nnstreamer_tpu_torch.parallel.ring import ring_attention_local

SEQ_TOL = 1e-4


@pytest.fixture(autouse=True)
def _slots(monkeypatch):
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")


def _qkv(seed=0, B=2, T=64, H=2, D=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D), dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(causal):
    q, k, v = _qkv()
    got = ring_attention(make_mesh({"data": 1, "seq": 8}), q, k, v, causal=causal)
    want = jring(jmake_mesh({"data": 1, "seq": 8}), q, k, v, causal=causal)
    assert got.shape == (2, 64, 2, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    dense = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_local_body_over_lists_equals_host_level(n):
    """The per-process body over ``n`` positions given as lists equals
    the host-level ring over a seq=n mesh, bitwise; one position is plain
    (blockwise) attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, T=32))
    tl = 32 // n
    cut = lambda t: [t[:, i * tl:(i + 1) * tl] for i in range(n)]  # noqa: E731
    outs = ring_attention_local(cut(q), cut(k), cut(v), index=0, size=n)
    mesh = make_mesh(seq=n, data=1, devices=local_devices("cpu")[:n])
    assert torch.equal(torch.cat(outs, dim=1), ring_attention(mesh, q, k, v))


def test_ring_bf16_inputs_keep_their_dtype():
    """bf16 shards: scores and the merge in float32, the output in bf16,
    within bf16 rounding of the float32 ring."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, T=32))
    mesh = make_mesh(seq=4, data=1, devices=local_devices("cpu")[:4])
    got = ring_attention(mesh, q.bfloat16(), k.bfloat16(), v.bfloat16())
    ref = ring_attention(mesh, q.bfloat16().float(), k.bfloat16().float(),
                         v.bfloat16().float())
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.PRESETS["llama_tiny"]
    params = jl.init_params(cfg, seed=0)
    return cfg, params, llama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def test_seq_parallel_matches_jax(tiny):
    """``forward_seq_parallel`` at seq=4 against the JAX one (and the
    dense forward) at float32."""
    cfg, jp, tp = tiny
    toks = np.arange(16, dtype=np.int32)[None, :] % cfg.vocab
    jmesh = jmake_mesh(seq=4, data=1, devices=jax.devices()[:4])
    want = np.asarray(jl.forward_seq_parallel(jmesh, jp, toks, cfg,
                                              compute_dtype="float32"))
    mesh = make_mesh(seq=4, data=1, devices=local_devices("cpu")[:4])
    got = llama.forward_seq_parallel(mesh, tp, torch.from_numpy(toks),
                                     llama.PRESETS["llama_tiny"], "float32")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SEQ_TOL)
    dense = llama.forward(tp, torch.from_numpy(toks), llama.PRESETS["llama_tiny"],
                          "float32")
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=SEQ_TOL)


def test_seq_parallel_without_seq_axis_is_forward(tiny):
    _, _, tp = tiny
    cfg = llama.PRESETS["llama_tiny"]
    toks = torch.arange(8)[None] % cfg.vocab
    mesh = make_mesh(data=1, devices=local_devices("cpu")[:1])
    assert torch.equal(llama.forward_seq_parallel(mesh, tp, toks, cfg, "float32"),
                       llama.forward(tp, toks, cfg, "float32"))


def test_block_attn_fn_overrides_attention(tiny):
    """``_block``'s ``attn_fn`` (the JAX ``_block``'s) gets K/V repeated to
    the query heads: plain causal attention through it equals the
    default flash path within float32 rounding, and a ring over one
    position is that same attention."""
    _, _, tp = tiny
    cfg = llama.PRESETS["llama_tiny"]
    torch.manual_seed(0)
    x = torch.randn(1, 8, cfg.dim)
    pos = torch.arange(8)
    lp = llama._layer(tp, 0)
    base = llama._block(cfg, lp, x, pos)
    seen = []

    def fn(q, k, v):
        seen.append((q.shape, k.shape))
        return ring_attention_local(q, k, v)

    got = llama._block(cfg, lp, x, pos, attn_fn=fn)
    assert seen[0][0] == seen[0][1]
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0, atol=1e-5)
