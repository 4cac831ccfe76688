"""Port of the int4 weight-only matmul against the JAX package: packing
and quantization bit for bit, the plain version against the JAX reference
and the interpreted Pallas kernel, and the wrapper's routing on the CPU.
The CUDA kernel itself runs only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import int4_matmul as ref
from nnstreamer_tpu_torch.ops import int4_matmul as port

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(0)
    wq = rng.integers(-8, 8, (64, 256)).astype(np.int8)
    want = np.asarray(ref.pack_int4(jnp.asarray(wq)))
    got = port.pack_int4(_t(wq)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.unpack_int4(_t(want)).numpy(),
                                  np.asarray(ref.unpack_int4(jnp.asarray(want))))
    np.testing.assert_array_equal(port.unpack_int4(_t(want)).numpy(), wq)


def test_quantize_bit_exact():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((128, 96)) * 0.3).astype(np.float32)
    w[:, 0] = 0.0  # all-zero column: the 1e-8 scale floor
    pj, sj = ref.quantize_int4(jnp.asarray(w))
    pt, st = port.quantize_int4(_t(w))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))


def _case(B, d=256, f=256, seed=3):
    rng = np.random.default_rng(seed + B)
    w = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    h = rng.standard_normal((B, d)).astype(np.float32)
    packed, s = ref.quantize_int4(jnp.asarray(w))
    return h, np.asarray(packed), np.asarray(s)


@pytest.mark.parametrize("B", [1, 7, 32])
def test_plain_matches_jax_reference_and_interpreted_kernel_f32(B):
    h, packed, s = _case(B)
    got = port.matmul_int4_reference(_t(h), _t(packed), _t(s)).numpy()
    want = np.asarray(ref.matmul_int4_reference(
        jnp.asarray(h), jnp.asarray(packed), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    kern = np.asarray(ref.matmul_int4(jnp.asarray(h), jnp.asarray(packed),
                                      jnp.asarray(s), block_d2=64,
                                      interpret=True))
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B", [1, 7, 32])
def test_plain_matches_interpreted_kernel_bf16(B):
    """bf16 inputs: the Pallas kernel mixes h_lo - h_hi/16 in bf16, which
    its docstring puts at ~0.6% output relative error (single elements
    reach ~1.1% of the output scale); the plain version unpacks directly.
    Held to 2% of the output scale, the bound tests/test_int4.py holds the
    kernel to."""
    h, packed, s = _case(B)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = port.matmul_int4_reference(hb, _t(packed), _t(s)).float().numpy()
    kern = np.asarray(ref.matmul_int4(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(packed), jnp.asarray(s),
        block_d2=64, interpret=True), np.float32)
    scale = np.abs(kern).max()
    assert np.abs(got - kern).max() / scale < 2e-2


def test_wrapper_takes_the_plain_version_on_cpu_only():
    h, packed, s = _case(4)
    before = port.LAUNCHES.value
    got = port.matmul_int4(_t(h), _t(packed), _t(s), out_dtype=torch.float32)
    want = port.matmul_int4_reference(_t(h), _t(packed), _t(s))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port.LAUNCHES.value == before
    meta = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        port.matmul_int4(meta, _t(packed).to("meta"), _t(s).to("meta"))


@pytest.mark.parametrize("shapes,match", [
    (((2, 100), (64, 16), (1, 16)), "2 \\* packed rows"),
    (((2, 128), (64, 16), (1, 8)), "scale shape"),
    (((128,), (64, 16), (1, 16)), "want h"),
])
def test_wrapper_rejects_bad_shapes(shapes, match):
    hs, ps, ss = shapes
    with pytest.raises(ValueError, match=match):
        port.matmul_int4(torch.zeros(hs), torch.zeros(ps, dtype=torch.int8),
                         torch.zeros(ss))
