"""Flash (blockwise, online-softmax) attention and paged attention.

Port of ``nnstreamer_tpu/ops/attention.py``.  Layouts are the JAX
package's: q is ``[B, Sq, H, D]``, k/v are ``[B, Skv, Hkv, D]`` with
``H % Hkv == 0`` and arrive UNREPEATED (GQA/MQA): query head ``h`` reads
kv head ``h // (H // Hkv)``.  Causal queries align to the BACK of kv
(``q_offset = Skv - Sq``), the cached-prefix convention.  Paged attention
reads K/V from a shared block pool ``[n_blocks, block_size, Hkv, D]``
through per-row block tables (the continuous-serving layout).

:func:`flash_attention` and :func:`paged_attention` launch the
hand-written CUDA kernels (``csrc/flash_attention.cu``,
``csrc/paged_attention.cu``) on CUDA tensors; :func:`attention_reference`
and :func:`paged_attention_reference` are their plain PyTorch versions
(scores materialized), taken for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import kernels

#: launches of the flash CUDA kernel (added where it launches, nowhere else)
LAUNCHES = kernels.LaunchCount()
#: launches of the paged CUDA kernel (added where it launches, nowhere else)
PAGED_LAUNCHES = kernels.LaunchCount()

#: head dims the kernels are compiled for
_KERNEL_HEAD_DIMS = (32, 64, 128)
#: query heads per kv head the paged kernel is compiled for
_PAGED_GROUPS = (1, 2, 4, 8)
#: paged kernel (csrc/paged_attention.cu): query rows (G * T) it takes
#: per kv head (4 tiles of 16 rows), positions per tile of its K/V ring,
#: the positions a partition aims at, and its consumer warps per block.
#: The launch plan is made here alone (:func:`paged_plan`); the C entry
#: only refuses a plan its kernels cannot run
PAGED_MAX_ROWS = 64
PAGED_TILE = 16
PAGED_PART_TARGET = 256
PAGED_WARPS = 4


def repeat_kv_heads(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D]; query head i reads kv head
    i // n_rep."""
    if n_rep == 1:
        return x
    b, s, hkv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, hkv, n_rep, d).reshape(
        b, s, hkv * n_rep, d)


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain attention (the kernel's semantics, materialized): scores and
    softmax in f32, probabilities cast to v's dtype for the value sum."""
    d = q.shape[-1]
    h, hkv = q.shape[2], k.shape[2]
    if h != hkv:
        k = repeat_kv_heads(k, h // hkv)
        v = repeat_kv_heads(v, h // hkv)
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                        ctypes.c_float, i, p]
    lib.nns_flash_attention.restype = i


def flash_route(q, k, v) -> str:
    """The kernel a CUDA call of :func:`flash_attention` launches, by dtype
    alone: ``"bf16"`` (tensor cores) or ``"f32"`` (CUDA cores).  Raises on
    what neither kernel takes: another dtype or mixed dtypes, a head dim
    outside {32, 64, 128}, a tensor that is not contiguous or not 16-byte
    aligned."""
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: kernel takes f32/bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: kernel takes 16-byte aligned tensors")
    return "bf16" if q.dtype == torch.bfloat16 else "f32"


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Blockwise attention for [B, Sq, H, D] q and [B, Skv, Hkv, D] k/v.

    CPU tensors take :func:`attention_reference`.  CUDA tensors launch a
    kernel of ``csrc/flash_attention.cu``, chosen by dtype alone: bf16
    launches the tensor-core kernel (wgmma, K/V tiles by TMA), f32 the
    CUDA-core kernel (wgmma takes no f32 operands).  Both take any Sq and
    Skv and D in {32, 64, 128}, and both count in :data:`LAUNCHES`; any
    other device, dtype, head dim or layout raises.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,D] and k/v [B,Skv,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    scale_v = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale_v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {q.device} is not the current device")
    route = flash_route(q, k, v)
    lib = kernels.library("flash_attention", _declare)
    out = torch.empty_like(q)
    rc = lib.nns_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, hkv, d, int(causal), scale_v, int(route == "bf16"),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, "flash_attention")
    LAUNCHES.add()
    return out


# ---------------------------------------------------------------------------
# Paged (block-pool) attention: the continuous-serving decode path
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_pool, v_pool, block_tables, context_lens,
                              *, scale: Optional[float] = None):
    """Plain paged attention (the JAX package's reference formulation).

    ``q``: [B, T, H, D] query suffix; ``k_pool``/``v_pool``: [n_blocks,
    block_size, Hkv, D]; ``block_tables``: [B, max_blocks] int — row b's
    logical block j is pool block ``block_tables[b, j]`` (entries >=
    n_blocks are unallocated sentinels, clipped into the pool: their
    positions lie past the row's context and are masked);
    ``context_lens``: [B] int — positions attendable per row INCLUDING the
    suffix, whose K/V must already be in the pool.  Query t of row b sits
    at position ``context_lens[b] - T + t``.  Scores and softmax in f32,
    probabilities cast to q's dtype for the value sum, as the JAX
    reference does.  A query with no position to attend (position < 0;
    every query of a row with context length 0) gives zeros, as the
    kernel does (the JAX reference gives finite garbage there).
    """
    B, T, H, D = q.shape
    n_blocks, _, hkv, _ = k_pool.shape
    scale = (D ** -0.5) if scale is None else scale
    dt = q.dtype
    tbl = block_tables.to(q.device, torch.long).clamp(0, n_blocks - 1)
    k_all = k_pool[tbl].reshape(B, -1, hkv, D).to(dt)
    v_all = v_pool[tbl].reshape(B, -1, hkv, D).to(dt)
    if H != hkv:
        k_all = repeat_kv_heads(k_all, H // hkv)
        v_all = repeat_kv_heads(v_all, H // hkv)
    lens = context_lens.to(q.device, torch.long)
    q_pos = lens[:, None] - T + torch.arange(T, device=q.device)[None, :]
    k_pos = torch.arange(k_all.shape[1], device=q.device)
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_all.float()) * scale
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), v_all)
    return torch.where((q_pos >= 0)[:, :, None, None], out,
                       torch.zeros((), dtype=dt, device=q.device))


def paged_route(B: int, T: int, G: int) -> str:
    """What a CUDA call of :func:`paged_attention` runs for B rows of T
    queries, G query heads per kv head, by shape alone:

    * ``"kernel"``: the kernel of ``csrc/paged_attention.cu``, for a decode
      step (T == 1, any B) and for B > 1 rows of T > 1 queries with
      G * T <= ``PAGED_MAX_ROWS`` (a speculative-verify step);
    * ``"gather_flash"``: every other T > 1 shape, row by row: one row
      (a chunked-prefill step), or B > 1 rows with G * T above the
      kernel's rows; each gathers its live blocks and runs
      :func:`flash_attention`.

    Raises where the kernel route meets a group it is not compiled for."""
    if T == 1 or (B > 1 and G * T <= PAGED_MAX_ROWS):
        if G not in _PAGED_GROUPS:
            raise ValueError(f"paged_attention: {G} query heads per kv head "
                             f"not in {_PAGED_GROUPS}")
        return "kernel"
    return "gather_flash"


class PagedPlan(NamedTuple):
    """Launch plan of the paged kernel for one call.

    ``part_len``: positions per partition, a multiple of the block size
    and of ``PAGED_TILE``; ``n_parts``: partitions the grid gives each
    (row, kv head), enough for a full table; ``splits``: partials each
    partition writes, the consumer warps that share one 16-row query tile
    and take its K/V tiles in turn (bf16; 1 for f32, a warp per query)."""

    part_len: int
    n_parts: int
    splits: int

    def workspace_floats(self, B: int, Hkv: int, rows: int, D: int) -> int:
        """f32 partials of a call: ``(m, l)`` and ``D`` values for every
        (row, kv head, partition, split, query row)."""
        return B * Hkv * self.n_parts * self.splits * rows * (D + 2)


@functools.lru_cache(maxsize=None)
def paged_plan(T: int, G: int, block_size: int, max_blocks: int,
               bf16: bool = True) -> PagedPlan:
    """The split plan of :func:`paged_attention`'s kernel.  It depends on
    the call's shape alone (never on the context lengths), so every row
    is cut the same way: a row of context length L is worked on as the
    ``ceil(L / part_len)`` partitions ``[i * part_len, min((i + 1) *
    part_len, L))``, none at L == 0, and merged in that order."""
    rows = G * T
    if not 0 < rows <= PAGED_MAX_ROWS or block_size <= 0 or max_blocks <= 0:
        raise ValueError(f"no paged kernel plan for G={G}, T={T}, "
                         f"block_size={block_size}, max_blocks={max_blocks}")
    unit = block_size * PAGED_TILE // math.gcd(block_size, PAGED_TILE)
    part_len = unit * max(1, PAGED_PART_TARGET // unit)
    n_parts = -(-max_blocks * block_size // part_len)
    m_tiles = -(-rows // PAGED_TILE)
    splits = PAGED_WARPS // (1 << (m_tiles - 1).bit_length()) if bf16 else 1
    return PagedPlan(part_len, n_parts, splits)


def _declare_paged(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_paged_attention.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, i, i, i, ctypes.c_float, i, p]
    lib.nns_paged_attention.restype = i


def _gather_flash(q, k_pool, v_pool, table, n: int, scale: float):
    """One row's T > 1 suffix: its ``n`` live positions gathered into a
    contiguous ``[1, n, Hkv, D]``, then causal :func:`flash_attention`,
    whose back-aligned offset ``n - T`` is the reference's query position."""
    t = q.shape[1]
    if n == 0:
        return torch.zeros_like(q)
    if n < t:
        raise ValueError(f"paged_attention: context {n} is shorter than "
                         f"the {t}-row suffix")
    n_pool, bs, hkv, d = k_pool.shape
    nb = -(-n // bs)
    idx = table[:nb].to(torch.long).clamp(0, n_pool - 1)
    k = k_pool.index_select(0, idx).reshape(1, nb * bs, hkv, d)[:, :n]
    v = v_pool.index_select(0, idx).reshape(1, nb * bs, hkv, d)[:, :n]
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, scale=scale)


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    scale: Optional[float] = None):
    """Attention over a block-paged KV pool (continuous LLM serving).

    Shapes as in :func:`paged_attention_reference`.  CPU tensors take the
    plain version.  CUDA tensors go where :func:`paged_route` says:

    * ``"kernel"`` (T == 1, or B > 1 with G * T <= 64) launches
      ``csrc/paged_attention.cu`` under :func:`paged_plan`: each row reads
      only its ``ceil(context_len / block_size)`` live blocks, split into
      partitions across thread blocks and merged in order; tables stay on
      the card (int32), and so must ``context_lens`` at T == 1 (at T > 1
      they may also come from the CPU, and are copied over);
    * ``"gather_flash"`` (B == 1, T > 1, a chunked-prefill step; or B > 1,
      G * T > 64) gathers each row's live blocks and runs
      :func:`flash_attention` causally over them, row by row;
      ``context_lens`` must then lie on the CPU, since they size the
      gather.

    Anything else raises: another device, dtype or head dim, a pool that
    is not contiguous or 16-byte aligned (the kernel reads it through TMA
    tensor maps), and (as the launch's CUDA error) a table wider than 4096
    entries.
    """
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q [B,T,H,D] and pools [n_blocks,bs,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, t, h, d = q.shape
    n_pool, bs, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != d or h % hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            tuple(context_lens.shape) != (b,):
        raise ValueError(f"want block_tables [B, max_blocks] and context_lens "
                         f"[B] for B={b}, got {tuple(block_tables.shape)}, "
                         f"{tuple(context_lens.shape)}")
    scale_v = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, scale=scale_v)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    if k_pool.device != q.device or v_pool.device != q.device or \
            block_tables.device != q.device:
        raise ValueError("paged_attention: q, pools and block_tables must "
                         "share a device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention: kernel takes f32/bf16 q and pools "
                         f"of one dtype, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {_KERNEL_HEAD_DIMS}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention: kernel takes contiguous pools")
    route = paged_route(b, t, h // hkv)
    if route != "kernel":
        if context_lens.device.type != "cpu":
            raise ValueError("paged_attention: a T > 1 step of one row at a "
                             "time takes its context_lens on the CPU (they "
                             "size the gather)")
        rows = [_gather_flash(q[i:i + 1], k_pool, v_pool, block_tables[i],
                              int(context_lens[i]), scale_v) for i in range(b)]
        return rows[0] if b == 1 else torch.cat(rows)
    if t == 1 and context_lens.device != q.device:
        raise ValueError("paged_attention: a decode step takes its "
                         "context_lens on the card")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"paged_attention: {q.device} is not the current device")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and context_lens "
                         "must be int32")
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    context_lens = context_lens.to(q.device).contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: kernel takes 16-byte aligned tensors")
    bf16 = q.dtype == torch.bfloat16
    plan = paged_plan(t, h // hkv, bs, block_tables.shape[1], bf16)
    lib = kernels.library("paged_attention", _declare_paged)
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace_floats(b, hkv, (h // hkv) * t, d),
                     dtype=torch.float32, device=q.device)
    rc = lib.nns_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, t, h, hkv, d, bs, block_tables.shape[1], n_pool,
        plan.part_len, plan.n_parts, plan.splits, scale_v, int(bf16),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, "paged_attention")
    PAGED_LAUNCHES.add()
    return out
