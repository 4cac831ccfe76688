"""Weight-only int4 (w4a16) matmul: ``h @ unpack(packed) * scale``.

Port of ``nnstreamer_tpu/ops/int4_matmul.py``.  The packing is the JAX
package's, bit for bit (split halves: logical rows ``0:Din/2`` in the LOW
nibble, stored biased +8; rows ``Din/2:Din`` in the HIGH nibble, signed),
so packed trees move between the two packages unchanged.

:func:`matmul_int4` launches the hand-written CUDA kernel
(``csrc/int4_matmul.cu``) for decode-shaped rows on a CUDA tensor;
:func:`matmul_int4_reference` is its plain PyTorch version, taken for CPU
tensors and, as in the JAX package, for more than ``_MAX_KERNEL_ROWS``
rows (prefill, where one unpack amortizes over many rows).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

#: Kernel rows bound: the JAX package routes B > 32 rows to its plain
#: path (int4_matmul.py:58); the port makes the same choice by row count.
_MAX_KERNEL_ROWS = 32

#: launches of the CUDA kernel (added where it launches, nowhere else)
LAUNCHES = kernels.LaunchCount()


def pack_int4(wq: torch.Tensor) -> torch.Tensor:
    """[Din, F] int8 values in [-8, 7] -> [Din/2, F] packed int8."""
    d = wq.shape[0]
    if d % 2:
        raise ValueError(f"contraction dim must be even, got {d}")
    lo = wq[: d // 2].to(torch.int32)
    hi = wq[d // 2:].to(torch.int32)
    byte = ((hi & 0xF) << 4) | ((lo + 8) & 0xF)  # 0..255
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> [Din, F] int8 in [-8, 7]."""
    t32 = packed.to(torch.int32)
    lo = (t32 & 15) - 8
    hi = t32 >> 4  # arithmetic shift on a signed tensor
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize_int4(w: torch.Tensor):
    """[Din, F] float -> (packed [Din/2, F] int8, scale [1, F] f32).

    Symmetric per-output-channel: q = round(w/s) clipped to [-7, 7]
    (round half to even, as jnp.round)."""
    w32 = w.to(torch.float32)
    s = torch.clamp_min(w32.abs().amax(dim=0, keepdim=True) / 7.0, 1e-8)
    q = torch.clamp(torch.round(w32 / s), -7, 7).to(torch.int8)
    return pack_int4(q), s


def matmul_int4_reference(h, packed, scale, out_dtype=None):
    """Plain PyTorch semantics of the kernel (mirrors the JAX package's
    ``matmul_int4_reference``): unpack both nibble planes in ``h.dtype``,
    two matmuls, scale applied in f32."""
    d2 = packed.shape[0]
    dt = h.dtype
    t32 = packed.to(torch.int32)
    lo = ((t32 & 15) - 8).to(dt)
    hi = (t32 >> 4).to(dt)
    y = h[..., :d2] @ lo + h[..., d2:] @ hi
    return (y.to(torch.float32) * scale).to(out_dtype or dt)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_int4_matmul.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.nns_int4_matmul.restype = i


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def matmul_int4(h, packed, scale, *, out_dtype=None):
    """``h @ unpack(packed) * scale`` -> [B, F] in ``out_dtype`` (default
    ``h.dtype``).

    h: [B, Din] f32/bf16; packed: [Din/2, F] int8 (:func:`pack_int4`
    layout); scale: [1, F] f32.  CPU tensors take
    :func:`matmul_int4_reference`; CUDA tensors launch the kernel for
    B <= 32 rows and take the reference above that; any other device, or
    a dtype, shape or layout the kernel does not take, raises.
    """
    if h.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"want h [B, Din] and packed [Din/2, F], got "
                         f"{tuple(h.shape)} and {tuple(packed.shape)}")
    B, din = h.shape
    d2, F = packed.shape
    if din != 2 * d2:
        raise ValueError(f"h dim {din} != 2 * packed rows {d2}")
    if tuple(scale.shape) != (1, F):
        raise ValueError(f"scale shape {tuple(scale.shape)} != (1, {F})")
    odt = out_dtype or h.dtype
    if h.device.type == "cpu":
        return matmul_int4_reference(h, packed, scale, out_dtype=odt)
    if h.device.type != "cuda":
        raise ValueError(f"matmul_int4: no kernel for device {h.device}")
    if B > _MAX_KERNEL_ROWS:
        return matmul_int4_reference(h, packed, scale, out_dtype=odt)
    if packed.device != h.device or scale.device != h.device:
        raise ValueError("matmul_int4: h, packed and scale must share a device")
    if h.device.index != torch.cuda.current_device():
        raise ValueError(f"matmul_int4: {h.device} is not the current device")
    if h.dtype not in _KERNEL_DTYPES or odt not in _KERNEL_DTYPES:
        raise ValueError(f"matmul_int4: kernel takes f32/bf16, got "
                         f"h {h.dtype} -> {odt}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"matmul_int4: want int8 packed and f32 scale, got "
                         f"{packed.dtype} and {scale.dtype}")
    if not (h.is_contiguous() and packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("matmul_int4: kernel takes contiguous tensors")
    if F % 4 == 0 and packed.data_ptr() % 4:
        raise ValueError("matmul_int4: packed rows must be 4-byte aligned")
    lib = kernels.library("int4_matmul", _declare)
    out = torch.empty((B, F), dtype=odt, device=h.device)
    rc = lib.nns_int4_matmul(
        h.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, d2, F, int(h.dtype == torch.bfloat16), int(odt == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, "int4_matmul")
    LAUNCHES.add()
    return out
