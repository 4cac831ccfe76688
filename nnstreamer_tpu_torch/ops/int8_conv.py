"""Integer convolution of a fully-quantized ``.tflite`` layer, NHWC, exact.

Serves every CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED of a
fully-quantized ``.tflite`` graph (``models/tflite.py``'s integer
execution).  It replaces no TPU kernel: the JAX package leaves these sums
to XLA (``lax.conv_general_dilated`` / ``lax.dot_general`` with
``preferred_element_type=int32``, ``nnstreamer_tpu/models/tflite.py:685``
and ``:742``) and requantizes them with ``_requant_acc`` (``:628``).
PyTorch has no int8 convolution on the card, and a float32 one stops being
exact once a sum passes 2^24, so on a CUDA tensor both entries below launch
the hand-written kernels of ``csrc/int8_conv.cu`` (:func:`int8_conv_kernel`
picks one: an implicit GEMM on the int8 tensor cores, a depthwise kernel
four channels a thread, a dense kernel for few input channels, or one
thread an output) and on a CPU tensor their plain PyTorch versions.

:func:`int8_conv_requant` is one whole layer in one launch: the layer's
unpadded uint8 or int8 activation in, SAME padding with the input's zero
point and the shift to int8 done in the kernel, the int32 sum plus ``cb``
(correction + bias, folded at open) requantized in the JAX package's f32
arithmetic, the next activation out.  A weight zero point (``wz``) adds a
second launch, the box sum over a ones weight.  Its plain version,
:func:`int8_conv_requant_reference`, is the same arithmetic step by step.

:func:`int8_conv` gives the plain int32 sums: an already padded int8 input
[B, Hp, Wp, Cin] convolved VALID to [B, OH, OW, O] int32, through the same
C entry with an int32 output (the mode the box sum uses);
:func:`int8_conv_reference` is its plain version, a float64 convolution of
the integers, exact while every sum stays under 2^53.

Weights are [O, kh, kw, Cin/groups] int8 (TFLite's OHWI; a depthwise
``[1, kh, kw, cin*mult]`` kernel is passed as ``[cin*mult, kh, kw, 1]``
with ``groups=cin``).  A fully-connected layer is a 1x1 conv over
``x.view(B, 1, 1, K)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cost, kernels

#: launches of the CUDA kernels (added where one launches, nowhere else)
LAUNCHES = kernels.LaunchCount()

#: the C entry's route numbers
_KERNELS = {"direct": 0, "gemm": 1, "depthwise": 2, "dense": 3}
#: the fused entry's output kinds
_OUT_KINDS = {torch.int32: 0, torch.int8: 1, torch.uint8: 2}


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _out_hw(hp: int, wp: int, kh: int, kw: int, stride, dilation) -> Tuple[int, int]:
    """The VALID output edge of a padded input."""
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    return (hp - (kh - 1) * dh - 1) // sh + 1, (wp - (kw - 1) * dw - 1) // sw + 1


def int8_conv_kernel(cin: int, out: int, groups: int, kh: int, kw: int, stride=1,
                     dilation=1) -> str:
    """Which kernel of ``csrc/int8_conv.cu`` a CUDA call launches:
    ``"dense"`` (one group, 3 rows of at most 12 bytes, at most 64
    outputs in eights: the first 3-channel conv), ``"gemm"`` (the implicit
    GEMM on the tensor cores: one group, channels in fours, copied 16
    bytes at a time where they come in sixteens and 4 else),
    ``"depthwise"`` (3x3, one channel a group, channels in fours, column
    stride 1 or 2) or ``"direct"`` (any other geometry); dense and
    depthwise want a column dilation of 1."""
    unit_cols = _pair(dilation)[1] == 1
    if (groups == 1 and kh == 3 and kw * cin <= 12 and unit_cols and out % 8 == 0
            and out <= 64):
        return "dense"
    if groups == 1 and cin % 4 == 0:
        return "gemm"
    if (groups == cin == out and kh == kw == 3 and cin % 4 == 0 and unit_cols
            and _pair(stride)[1] in (1, 2)):
        return "depthwise"
    return "direct"


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, stride=1, dilation=1,
                        groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv`: the same sums as a
    float64 convolution of the integers (exact: every partial sum of int8
    products over a window stays far under 2^53), cast to int32."""
    xf = x.to(torch.float64).permute(0, 3, 1, 2)
    wf = w.to(torch.float64).permute(0, 3, 1, 2)
    y = F.conv2d(xf, wf, stride=_pair(stride), dilation=_pair(dilation),
                 groups=groups)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def int8_conv_requant_reference(x: torch.Tensor, w: torch.Tensor, cb, mult,
                                stride=1, dilation=1, groups: int = 1,
                                pads=((0, 0), (0, 0)), pad8: int = 0, zp: int = 0,
                                lo: int = -128, hi: int = 127,
                                out_dtype=torch.int8, wz=None,
                                ones=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv_requant`, the JAX
    package's arithmetic step by step: the shift to int8, the zero-point
    pad, :func:`int8_conv_reference`'s sums (and the box sum over ``ones``
    where ``wz`` is given), ``+ cb`` and ``- wz * sum_x`` in int32, then
    ``clamp(round(f32(v) * mult) + zp, lo, hi)``."""
    x8 = (x ^ 128).view(torch.int8) if x.dtype == torch.uint8 else x
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        x8 = F.pad(x8, (0, 0, pl, pr, pt, pb), value=pad8)
    x8 = x8.contiguous()
    acc = int8_conv_reference(x8, w, stride, dilation, groups)
    if cb is not None:
        acc = acc + cb
    if wz is not None:
        sum_x = int8_conv_reference(x8, ones, stride, dilation, ones.shape[0])
        rep = acc.shape[-1] // sum_x.shape[-1]
        if rep > 1 and sum_x.shape[-1] > 1:
            sum_x = sum_x.repeat_interleave(rep, dim=-1)
        acc = acc - wz * sum_x
    y = torch.round(acc.to(torch.float32) * mult) + float(zp)
    return torch.clamp(y, lo, hi).to(out_dtype)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nns_int8_conv_requant.argtypes = [p] * 7 + [i] * 23 + [p]
    lib.nns_int8_conv_requant.restype = i


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_card(what: str, x: torch.Tensor, *tensors, aligned: bool) -> None:
    """The card kernel's preconditions on its operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: {x.device} is not the current device")
    for t in (x,) + tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: every operand must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernel takes contiguous tensors")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride=1, dilation=1,
              groups: int = 1) -> torch.Tensor:
    """``x`` [B, Hp, Wp, Cin] int8 (padded) convolved VALID with ``w``
    [O, kh, kw, Cin/groups] int8 -> [B, OH, OW, O] int32, exact.

    CPU tensors take :func:`int8_conv_reference`; CUDA tensors launch the
    kernel of :func:`int8_conv_kernel`.  Any other device, or a dtype,
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
    cost.report(2 * B * oh * ow * O * kh * kw * cg,
                x.numel() + w.numel() + 4 * B * oh * ow * O)
    with cost.paused():
        if x.device.type == "meta":  # shapes only: abstract execution
            return torch.empty((B, oh, ow, O), dtype=torch.int32, device="meta")
        if x.device.type == "cpu":
            return int8_conv_reference(x, w, stride, dilation, groups)
        _check_card("int8_conv", x, w, aligned=False)
        out = torch.empty((B, oh, ow, O), dtype=torch.int32, device=x.device)
        _launch("int8_conv", x, w, out, stride, dilation, groups)
    return out


def _launch(what: str, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, stride,
            dilation, groups: int, pads=((0, 0), (0, 0)), pad8: int = 0,
            cb: Optional[torch.Tensor] = None, mult: Optional[torch.Tensor] = None,
            wz: Optional[torch.Tensor] = None, sum_x: Optional[torch.Tensor] = None,
            zp: int = 0, lo: int = 0, hi: int = 0) -> None:
    """One launch of the C entry into ``out`` (its dtype picks int32 sums,
    int8 or uint8), on the kernel of :func:`int8_conv_kernel`; the
    operands were validated by the caller."""
    B, h, wd, cin = x.shape
    O, kh, kw, _ = w.shape
    _, oh, ow, _ = out.shape
    (sh, sw), (dh, dw) = _pair(stride), _pair(dilation)
    kernel = int8_conv_kernel(cin, O, groups, kh, kw, stride, dilation)
    _check_card(what, x, w, out, cb, mult, wz, sum_x, aligned=kernel != "direct")
    lib = kernels.library("int8_conv", _declare)
    rc = lib.nns_int8_conv_requant(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), _ptr(cb), _ptr(mult), _ptr(wz),
        _ptr(sum_x), B, h, wd, cin, O, kh, kw, sh, sw, dh, dw, groups, oh, ow, pads[0][0],
        pads[1][0], int(x.dtype == torch.uint8), int(pad8), _OUT_KINDS[out.dtype], int(zp),
        int(lo), int(hi), _KERNELS[kernel], torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, rc, what)
    LAUNCHES.add()


def int8_conv_requant(x: torch.Tensor, w: torch.Tensor, cb: Optional[torch.Tensor],
                      mult: torch.Tensor, stride=1, dilation=1, groups: int = 1,
                      pads=((0, 0), (0, 0)), pad8: int = 0, zp: int = 0,
                      lo: int = -128, hi: int = 127, out_dtype=torch.int8,
                      wz: Optional[torch.Tensor] = None,
                      ones: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One integer conv layer, requantized: ``x`` [B, H, W, Cin] uint8 or
    int8, unpadded; ``pads`` ((top, bottom), (left, right)) filled with
    ``pad8`` (the input zero point, int8 domain); ``cb`` [O] int32 (or
    None), ``mult`` [O] f32; ``wz`` [O] int32 with ``ones`` (the box sum's
    weight: [Cin, kh, kw, 1] for a depthwise layer, [1, kh, kw, Cin]
    else) where a weight zero point is not 0.  Returns [B, OH, OW, O] of
    ``out_dtype`` (int8 or uint8): ``clamp(round(f32(sum + cb - wz *
    sum_x) * mult) + zp, lo, hi)``.

    CPU tensors take :func:`int8_conv_requant_reference`; CUDA tensors
    launch the kernel of :func:`int8_conv_kernel` (twice with ``wz``)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"int8_conv_requant: want x [B, H, W, C] and w [O, kh, kw, C/g], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, h, wd, cin = x.shape
    O, kh, kw, cg = w.shape
    if groups <= 0 or cin % groups or O % groups or cg * groups != cin:
        raise ValueError(f"int8_conv_requant: {cin} input channels, weight "
                         f"{tuple(w.shape)} and groups={groups} do not agree")
    if x.dtype not in (torch.uint8, torch.int8) or w.dtype != torch.int8:
        raise ValueError(f"int8_conv_requant: want uint8 or int8 x and int8 w, got "
                         f"{x.dtype} and {w.dtype}")
    if out_dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"int8_conv_requant: no {out_dtype} output")
    if (cb is not None and (cb.dtype != torch.int32 or cb.shape != (O,))) or \
            mult.dtype != torch.float32 or mult.shape != (O,):
        raise ValueError("int8_conv_requant: want cb [O] int32 and mult [O] float32")
    if (wz is None) != (ones is None) or (wz is not None and (
            wz.dtype != torch.int32 or wz.shape != (O,) or ones.dtype != torch.int8)):
        raise ValueError("int8_conv_requant: wz [O] int32 comes with its int8 ones weight")
    if not -128 <= int(pad8) <= 127:
        raise ValueError(f"int8_conv_requant: pad value {pad8} is not int8")
    (pt, pb), (pl, pr) = pads
    oh, ow = _out_hw(h + pt + pb, wd + pl + pr, kh, kw, stride, dilation)
    if min(pt, pb, pl, pr) < 0 or oh <= 0 or ow <= 0:
        raise ValueError(f"int8_conv_requant: pads {pads} and the window do not fit "
                         f"{tuple(x.shape)}")
    cost.report(2 * B * oh * ow * O * kh * kw * cg,
                x.numel() + w.numel() + B * oh * ow * O + 8 * O)
    with cost.paused():
        if x.device.type == "meta":  # shapes only: abstract execution
            return torch.empty((B, oh, ow, O), dtype=out_dtype, device="meta")
        if x.device.type == "cpu":
            return int8_conv_requant_reference(x, w, cb, mult, stride, dilation, groups,
                                               pads, pad8, zp, lo, hi, out_dtype, wz, ones)
        _check_card("int8_conv_requant", x, w, cb, mult, wz, ones, aligned=False)
        sum_x = None
        if wz is not None:  # the box sum of the window, over the ones weight
            sum_x = torch.empty((B, oh, ow, ones.shape[0]), dtype=torch.int32,
                                device=x.device)
            _launch("int8_conv_requant", x, ones, sum_x, stride, dilation,
                    ones.shape[0], pads, pad8)
        out = torch.empty((B, oh, ow, O), dtype=out_dtype, device=x.device)
        _launch("int8_conv_requant", x, w, out, stride, dilation, groups, pads, pad8, cb,
                mult, wz, sum_x, zp, lo, hi)
    return out
