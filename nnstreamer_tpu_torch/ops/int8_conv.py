"""Integer convolution: int8 x int8 -> int32, NHWC, exact.

Serves every CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED of a
fully-quantized ``.tflite`` graph (``models/tflite.py``'s integer
execution).  It replaces no TPU kernel: the JAX package leaves these sums
to XLA (``lax.conv_general_dilated`` / ``lax.dot_general`` with
``preferred_element_type=int32``, ``nnstreamer_tpu/models/tflite.py:685``
and ``:742``).  PyTorch has no int8 convolution on the card, and a float32
one stops being exact once a sum passes 2^24, so :func:`int8_conv`
launches a hand-written CUDA kernel (``csrc/int8_conv.cu``) on a CUDA
tensor, by :func:`int8_conv_route`: an implicit GEMM over ``__dp4a`` for
``groups == 1`` with the channels a multiple of 4, else one thread an
output.  :func:`int8_conv_reference` is its plain PyTorch version: a
float64 convolution of the same integers, exact while every sum stays
under 2^53, taken for CPU tensors only.

The input comes padded (with the input's zero point, by the caller), so
every call is VALID: ``x`` [B, Hp, Wp, Cin] int8, ``w`` [O, kh, kw,
Cin/groups] int8 (TFLite's OHWI; a depthwise ``[1, kh, kw, cin*mult]``
kernel is passed as ``[cin*mult, kh, kw, 1]`` with ``groups=cin``), and
the output [B, OH, OW, O] int32.  A fully-connected layer is a 1x1 conv
over ``x.view(B, 1, 1, K)``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import kernels

#: launches of the CUDA kernel (added where it launches, nowhere else)
LAUNCHES = kernels.LaunchCount()

#: the C entry's route numbers
_ROUTES = {"direct": 0, "gemm": 1}


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _out_hw(hp: int, wp: int, kh: int, kw: int, stride, dilation) -> Tuple[int, int]:
    """The VALID output edge of a padded input."""
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    return (hp - (kh - 1) * dh - 1) // sh + 1, (wp - (kw - 1) * dw - 1) // sw + 1


def int8_conv_route(cin: int, groups: int) -> str:
    """Which kernel a CUDA call takes: ``"gemm"`` (the implicit GEMM over
    4-byte words of the channels) for ``groups == 1`` and ``cin % 4 ==
    0``, else ``"direct"``."""
    return "gemm" if groups == 1 and cin % 4 == 0 else "direct"


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, stride=1, dilation=1,
                        groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version: the same sums as a float64 convolution of
    the integers (exact: every partial sum of int8 products over a window
    stays far under 2^53), cast to int32."""
    xf = x.to(torch.float64).permute(0, 3, 1, 2)
    wf = w.to(torch.float64).permute(0, 3, 1, 2)
    y = F.conv2d(xf, wf, stride=_pair(stride), dilation=_pair(dilation),
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_int8_conv.argtypes = [p, p, p] + [i] * 15 + [p]
    lib.nns_int8_conv.restype = i


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride=1, dilation=1,
              groups: int = 1) -> torch.Tensor:
    """``x`` [B, Hp, Wp, Cin] int8 (padded) convolved VALID with ``w``
    [O, kh, kw, Cin/groups] int8 -> [B, OH, OW, O] int32, exact.

    CPU tensors take :func:`int8_conv_reference`; CUDA tensors launch the
    kernel of :func:`int8_conv_route`.  Any other device, or a dtype,
    shape or layout the kernel does not take, raises."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"int8_conv: want x [B, H, W, C] and w [O, kh, kw, C/g], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, hp, wp, cin = x.shape
    O, kh, kw, cg = w.shape
    if groups <= 0 or cin % groups or O % groups or cg * groups != cin:
        raise ValueError(f"int8_conv: {cin} input channels, weight {tuple(w.shape)} "
                         f"and groups={groups} do not agree")
    oh, ow = _out_hw(hp, wp, kh, kw, stride, dilation)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"int8_conv: window larger than the padded input "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int8_conv: want int8 x and w, got {x.dtype} and {w.dtype}")
    if x.device.type == "cpu":
        return int8_conv_reference(x, w, stride, dilation, groups)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    if w.device != x.device:
        raise ValueError("int8_conv: x and w must share a device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"int8_conv: {x.device} is not the current device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8_conv: kernel takes contiguous tensors")
    route = int8_conv_route(cin, groups)
    if route == "gemm" and (x.data_ptr() % 4 or w.data_ptr() % 4):
        raise ValueError("int8_conv: x and w must be 4-byte aligned")
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    lib = kernels.library("int8_conv", _declare)
    out = torch.empty((B, oh, ow, O), dtype=torch.int32, device=x.device)
    rc = lib.nns_int8_conv(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), B, hp, wp, cin, O, kh, kw,
        sh, sw, dh, dw, groups, oh, ow, _ROUTES[route],
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, "int8_conv")
    LAUNCHES.add()
    return out
