"""Flash (blockwise, online-softmax) attention.

Port of the flash half of ``nnstreamer_tpu/ops/attention.py``.  Layouts
are the JAX package's: q is ``[B, Sq, H, D]``, k/v are ``[B, Skv, Hkv, D]``
with ``H % Hkv == 0`` and arrive UNREPEATED (GQA/MQA): query head ``h``
reads kv head ``h // (H // Hkv)``.  Causal queries align to the BACK of
kv (``q_offset = Skv - Sq``), the cached-prefix convention.

:func:`flash_attention` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) on CUDA tensors; :func:`attention_reference`
is its plain PyTorch version (the score matrix materialized), taken for
CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import kernels

#: launches of the CUDA kernel (added where it launches, nowhere else)
LAUNCHES = kernels.LaunchCount()

#: head dims the kernel is compiled for
_KERNEL_HEAD_DIMS = (32, 64, 128)


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


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Blockwise attention for [B, Sq, H, D] q and [B, Skv, Hkv, D] k/v.

    CPU tensors take :func:`attention_reference`.  CUDA tensors launch the
    kernel, which takes any Sq and Skv, D in {32, 64, 128}, f32 or bf16;
    any other device, dtype, head dim or layout raises.
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
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: kernel takes f32/bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{_KERNEL_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: kernel takes 16-byte aligned tensors")
    lib = kernels.library("flash_attention", _declare)
    out = torch.empty_like(q)
    rc = lib.nns_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, hkv, d, int(causal), scale_v,
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, "flash_attention")
    LAUNCHES.add()
    return out
