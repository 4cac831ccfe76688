"""Port of the int4 weight-only matmul against the JAX package: packing
and quantization bit for bit, the plain version against the JAX reference
and the interpreted Pallas kernel, and the wrapper's routing on the CPU;
the tensor-core kernel's route, launch plan and arithmetic (emulated in
plan order), and the margin of chip_smoke.py's per-row limit against
faults such a kernel could have.  The CUDA kernels themselves run only on
the card (chip_smoke.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import int4_matmul as ref
from nnstreamer_tpu_torch.ops import int4_matmul as port

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

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
    # meta tensors (abstract execution): the CPU route's shape and dtype,
    # no data, no launch; the shape checks hold on meta too
    meta = port.matmul_int4(_t(h).to("meta"), _t(packed).to("meta"),
                            _t(s).to("meta"), out_dtype=torch.float32)
    assert meta.device.type == "meta" and port.LAUNCHES.value == before
    assert (meta.shape, meta.dtype) == (got.shape, got.dtype)
    with pytest.raises(ValueError, match="scale shape"):
        port.matmul_int4(_t(h).to("meta"), _t(packed).to("meta"),
                         _t(s)[:, :8].to("meta"))


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


# --- the tensor-core kernel's routing, launch plan and arithmetic ---------

#: (packed rows d2, out F): the five llama2_7b mats, llama_small's and the
#: ragged ones chip_smoke.py checks on the card
_PLAN_MATS = [(2048, 12288), (2048, 4096), (2048, 22016), (5504, 4096),
              (2048, 32000), (256, 1024), (256, 512), (256, 2048), (512, 512),
              (1000, 1040), (1000, 1000), (1001, 1001)]


@pytest.mark.parametrize("B,h_dtype,out_dtype,want", [
    (1, torch.bfloat16, torch.bfloat16, "tensor_cores"),
    (32, torch.bfloat16, torch.float32, "tensor_cores"),
    (8, torch.float32, torch.float32, "cuda_cores"),
    (17, torch.float32, torch.bfloat16, "cuda_cores"),
    (33, torch.bfloat16, torch.bfloat16, "reference"),
    (256, torch.float32, torch.float32, "reference"),
])
def test_route_by_rows_and_dtype(B, h_dtype, out_dtype, want):
    assert port.int4_route(B, h_dtype, out_dtype) == want


@pytest.mark.parametrize("h_dtype,out_dtype", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.float16),
    (torch.int8, torch.float32)])
def test_route_rejects_other_dtypes(h_dtype, out_dtype):
    with pytest.raises(ValueError, match="kernel takes f32/bf16"):
        port.int4_route(4, h_dtype, out_dtype)


@pytest.mark.parametrize("B", [1, 5, 8, 17, 32])
@pytest.mark.parametrize("d2,F", _PLAN_MATS)
def test_plan_covers_every_row_and_column_once(B, d2, F):
    plan = port.int4_plan(B, d2, F)
    assert plan.n in (8, 16, 32) and B <= plan.n and (plan.n == 8 or plan.n // 2 < B)
    assert plan.rows_per_split % port.TILE_ROWS == 0 and plan.splits <= 65535
    rows = np.zeros(d2, np.int64)
    for s in range(plan.splits):
        lo = s * plan.rows_per_split
        assert lo < d2, "an empty split"
        rows[lo:min(lo + plan.rows_per_split, d2)] += 1
    assert (rows == 1).all()
    cols = np.zeros(F, np.int64)
    for t in range(plan.col_tiles):
        cols[t * port.TILE_COLS:(t + 1) * port.TILE_COLS] += 1
    assert (cols == 1).all()


def test_plan_rejects_rows_the_kernel_does_not_take():
    for B in (0, 33):
        with pytest.raises(ValueError, match="no int4 kernel plan"):
            port.int4_plan(B, 64, 128)


class _Stream:
    """Stands in for a torch.cuda.Stream: the tickets key on its handle."""

    def __init__(self, handle):
        self.cuda_stream = handle


def test_ticket_counters_per_stream_and_never_freed(monkeypatch):
    """Split-K tickets: one zeroed set per (device, stream), so launches
    in flight on two streams never share a counter; a set outgrown by a
    wider F is replaced but kept alive (a launch in flight or a captured
    graph may hold its pointer)."""
    monkeypatch.setattr(port, "_tickets", {})
    monkeypatch.setattr(port, "_outgrown", [])
    dev = torch.device("cpu")
    one = port._ticket_counters(dev, _Stream(1), 10)
    two = port._ticket_counters(dev, _Stream(2), 10)
    assert one.data_ptr() != two.data_ptr()
    assert one.dtype == torch.int32 and not one.any()
    assert port._ticket_counters(dev, _Stream(1), 250) is one  # still wide enough
    wide = port._ticket_counters(dev, _Stream(1), 300)
    assert wide.numel() >= 300 and not wide.any()
    assert wide is not one and any(t is one for t in port._outgrown)
    assert port._ticket_counters(dev, _Stream(2), 10) is two


def _emulate(h, packed, scale, plan, fault=None):
    """The tensor-core kernel's arithmetic in plain PyTorch, in plan order:
    per split, per 64-row stage, per k16 slice of 8 packed rows (kernel K
    order: the 8 low nibbles' activations, then the 8 high nibbles'), an
    f32 partial; the partials summed in split order, the scale applied
    last.  ``fault`` injects one block's fault (column tile 0, split 1):
    a dropped k-slice, a dropped split, a dropped packed row, the two
    nibbles of one packed row swapped, or output columns 0 and 1
    exchanged."""
    B, F = h.shape[0], packed.shape[1]
    d2 = packed.shape[0]
    t32 = packed.to(torch.int32)
    lo = ((t32 & 15) - 8).float()              # [d2, F]
    hi = (t32 >> 4).float()
    hf = h.float()
    tile = slice(0, port.TILE_COLS)
    partials = []
    for s in range(plan.splits):
        acc = torch.zeros(F, B)
        r_end = min((s + 1) * plan.rows_per_split, d2)
        for r in range(s * plan.rows_per_split, r_end, 8):
            rs = slice(r, min(r + 8, r_end))
            a = torch.cat([lo[rs], hi[rs]], 0).T    # [F, 16]: kernel K order
            b = torch.cat([hf[:, rs], hf[:, d2 + r:d2 + rs.stop]], 1).T
            k = rs.stop - rs.start
            if s == 1 and r == plan.rows_per_split and fault in ("swap_nibble", "drop_row"):
                a = a.clone()
                if fault == "swap_nibble":
                    a[tile, 0], a[tile, k] = a[tile, k].clone(), a[tile, 0].clone()
                else:
                    a[tile, 0] = a[tile, k] = 0
            prod = a @ b
            if s == 1 and fault == "drop_slice" and r == plan.rows_per_split + 8:
                prod[tile] = 0
            acc += prod
        partials.append(acc)
    if fault == "drop_split":
        partials[1][tile] = 0
    y = partials[0].clone()
    for p in partials[1:]:
        y += p
    if fault == "wrong_column":
        y[[0, 1]] = y[[1, 0]]
    return (y.T * scale).to(h.dtype if h.dtype == torch.bfloat16 else torch.float32)


def _row_err(got, want):
    diff = (got.float() - want.float()).abs().amax(-1)
    return (diff / want.float().abs().amax(-1)).max().item()


@pytest.mark.parametrize("B,d2,F", [(1, 256, 512), (5, 1000, 1040), (8, 512, 384),
                                    (17, 1001, 200), (32, 256, 1024)])
def test_emulated_kernel_order_matches_reference_f32(B, d2, F):
    rng = np.random.default_rng(B + d2)
    packed = torch.from_numpy(rng.integers(-128, 128, (d2, F)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1.1e-2, (1, F)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, 2 * d2)).astype(np.float32))
    plan = port.int4_plan(B, d2, F)
    got = _emulate(h, packed, scale, plan)
    want = port.matmul_int4_reference(h, packed, scale)
    assert _row_err(got, want) <= 1e-5


@pytest.fixture(scope="module")
def fault_case():
    """llama2_7b's wo at a continuous decode step: d2 2048, F 4096, B 8,
    bf16 activations, the kernel's own plan (8 splits)."""
    rng = np.random.default_rng(11)
    d2, F, B = 2048, 4096, 8
    packed = torch.from_numpy(rng.integers(-128, 128, (d2, F)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1.1e-2, (1, F)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, 2 * d2)).astype(np.float32)).to(torch.bfloat16)
    plan = port.int4_plan(B, d2, F)
    assert plan.splits > 1
    f32 = port.matmul_int4_reference(h.float(), packed, scale)
    bf16 = port.matmul_int4_reference(h, packed, scale)
    return h, packed, scale, plan, f32, bf16


def _old_global_check(got, bf16_plain):
    """The check chip_smoke.py made before: max |kernel - bf16 plain| over
    the whole output within 2% of its max |bf16 plain|."""
    err = (got.float() - bf16_plain.float()).abs().max().item()
    return err <= 2e-2 * bf16_plain.float().abs().max().item()


def test_faultless_emulation_meets_the_row_limit(fault_case):
    h, packed, scale, plan, f32, bf16 = fault_case
    got = _emulate(h, packed, scale, plan)
    assert _row_err(got, f32) <= chip_smoke.INT4_ROW_TOL
    assert _old_global_check(got, bf16)


_FAULTS = ("drop_slice", "drop_split", "drop_row", "swap_nibble", "wrong_column")


@pytest.mark.parametrize("fault", _FAULTS)
def test_each_fault_breaks_the_row_limit(fault_case, fault):
    h, packed, scale, plan, f32, bf16 = fault_case
    got = _emulate(h, packed, scale, plan, fault=fault)
    assert _row_err(got, f32) > chip_smoke.INT4_ROW_TOL


def test_a_fault_passed_the_old_global_check(fault_case):
    h, packed, scale, plan, f32, bf16 = fault_case
    passed = [f for f in _FAULTS
              if _old_global_check(_emulate(h, packed, scale, plan, fault=f), bf16)]
    assert passed
