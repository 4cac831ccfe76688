"""Weight-only int4 (w4a16) matmul: ``h @ unpack(packed) * scale``.

Port of ``nnstreamer_tpu/ops/int4_matmul.py``.  The packing is the JAX
package's, bit for bit (split halves: logical rows ``0:Din/2`` in the LOW
nibble, stored biased +8; rows ``Din/2:Din`` in the HIGH nibble, signed),
so packed trees move between the two packages unchanged.

:func:`matmul_int4` launches a hand-written CUDA kernel
(``csrc/int4_matmul.cu``) for decode-shaped rows on a CUDA tensor,
chosen by :func:`int4_route`: bf16 activations take the tensor-core
kernel (wgmma, weights and activations by TMA, split-K under
:func:`int4_plan`), f32 ones the CUDA-core kernel.  :func:`matmul_int4_reference` is its plain PyTorch
version, taken for CPU tensors and, as in the JAX package, for more than
``_MAX_KERNEL_ROWS`` rows (prefill, where one unpack amortizes over many
rows).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Tuple

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


#: Launch-plan constants of the tensor-core kernel (csrc/int4_matmul.cu):
#: output columns per block, packed rows per ring stage, and the blocks a
#: mat's split aims at: two per SM of an H100's 132, one at N = 32, where
#: fewer splits measured faster (fewer partials to write and sum)
TILE_COLS = 128
TILE_ROWS = 64
SMS = 132

# flags of nns_int4_matmul_bf16
_FLAG_TMA_W, _FLAG_TMA_H, _FLAG_OUT_BF16 = 1, 2, 4


class Int4Plan(NamedTuple):
    """Launch plan of the tensor-core kernel for one (B, d2, F).

    ``n``: wgmma's N, B rounded up to 8, 16 or 32; ``splits``: blocks
    that share a column tile, each over ``rows_per_split`` packed rows (a
    multiple of ``TILE_ROWS``; the last split takes what is left);
    ``col_tiles``: blocks of ``TILE_COLS`` output columns."""

    n: int
    splits: int
    rows_per_split: int
    col_tiles: int


def int4_plan(B: int, d2: int, F: int) -> Int4Plan:
    """The launch plan of :func:`matmul_int4`'s tensor-core kernel: split
    the packed rows, in stages of ``TILE_ROWS`` rows, so that the grid
    comes nearest ``2 * SMS`` blocks (``SMS`` at N = 32)."""
    if not 0 < B <= _MAX_KERNEL_ROWS or d2 <= 0 or F <= 0:
        raise ValueError(f"no int4 kernel plan for B={B}, d2={d2}, F={F}")
    n = 8 if B <= 8 else 16 if B <= 16 else 32
    col_tiles = -(-F // TILE_COLS)
    row_tiles = -(-d2 // TILE_ROWS)
    target = SMS if n == 32 else 2 * SMS
    want = min(max(1, round(target / col_tiles)), row_tiles)
    per_split = -(-row_tiles // want)
    return Int4Plan(n, -(-row_tiles // per_split), per_split * TILE_ROWS, col_tiles)


def int4_route(B: int, h_dtype, out_dtype) -> str:
    """What a CUDA call of :func:`matmul_int4` runs, by row count and
    dtype alone: ``"reference"`` above ``_MAX_KERNEL_ROWS`` rows (as the
    JAX package), else ``"tensor_cores"`` for bf16 activations and
    ``"cuda_cores"`` for f32 ones (wgmma takes no f32 operands).  Raises on
    a dtype neither kernel takes."""
    if B > _MAX_KERNEL_ROWS:
        return "reference"
    if h_dtype not in _KERNEL_DTYPES or out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"matmul_int4: kernel takes f32/bf16, got "
                         f"h {h_dtype} -> {out_dtype}")
    return "tensor_cores" if h_dtype == torch.bfloat16 else "cuda_cores"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_int4_matmul_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.nns_int4_matmul_bf16.restype = i
    lib.nns_int4_matmul_f32.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.nns_int4_matmul_f32.restype = i


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: int32 tickets of the split-K reduction, one per column tile, zero
#: between launches (the last block of a tile resets its own).  One set
#: per (device, stream): launches in flight on two streams never share a
#: counter.  No set is ever freed: a launch in flight or a captured CUDA
#: graph may still hold its pointer, so a set outgrown by a wider F stays
#: in ``_outgrown``.  Sets are keyed by the stream's handle: PyTorch's own
#: streams come from a fixed pool per device and are never destroyed, so
#: the sets stay few; a caller's external stream must outlive its
#: launches, since a new stream given a destroyed one's handle would share
#: its set
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_outgrown: List[torch.Tensor] = []
_tickets_lock = threading.Lock()


def _ticket_counters(device: torch.device, stream: torch.cuda.Stream,
                     n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            if t is not None:
                _outgrown.append(t)
            t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
            _tickets[key] = t
        return t


def matmul_int4(h, packed, scale, *, out_dtype=None):
    """``h @ unpack(packed) * scale`` -> [B, F] in ``out_dtype`` (default
    ``h.dtype``).

    h: [B, Din] f32/bf16; packed: [Din/2, F] int8 (:func:`pack_int4`
    layout); scale: [1, F] f32.  CPU tensors take
    :func:`matmul_int4_reference`.  CUDA tensors go where
    :func:`int4_route` says: for B <= 32 rows, bf16 activations launch
    the tensor-core kernel (under :func:`int4_plan`) and f32 ones the
    CUDA-core kernel; above 32 rows the reference.  Any other device, or
    a dtype, shape or layout the kernels do not take, raises.
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
    route = int4_route(B, h.dtype, odt)
    if route == "reference":
        return matmul_int4_reference(h, packed, scale, out_dtype=odt)
    if packed.device != h.device or scale.device != h.device:
        raise ValueError("matmul_int4: h, packed and scale must share a device")
    if h.device.index != torch.cuda.current_device():
        raise ValueError(f"matmul_int4: {h.device} is not the current device")
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
    stream = torch.cuda.current_stream()
    if route == "cuda_cores":
        rc = lib.nns_int4_matmul_f32(
            h.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, d2, F, int(odt == torch.bfloat16), stream.cuda_stream)
    else:
        plan = int4_plan(B, d2, F)
        ws = (torch.empty((plan.splits, B, plan.col_tiles * TILE_COLS),
                          dtype=torch.float32, device=h.device)
              if plan.splits > 1 else None)
        tickets = _ticket_counters(h.device, stream, plan.col_tiles)
        flags = ((_FLAG_TMA_W if F % 16 == 0 and packed.data_ptr() % 16 == 0 else 0)
                 | (_FLAG_TMA_H if d2 % 8 == 0 and h.data_ptr() % 16 == 0 else 0)
                 | (_FLAG_OUT_BF16 if odt == torch.bfloat16 else 0))
        rc = lib.nns_int4_matmul_bf16(
            h.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, tickets.data_ptr(),
            B, d2, F, plan.n, plan.splits, plan.rows_per_split, flags,
            stream.cuda_stream)
    kernels.check(lib, rc, "int4_matmul")
    LAUNCHES.add()
    return out
