"""Shared MobileNet-style backbone building blocks.

Port of ``nnstreamer_tpu/models/backbone.py``: the depthwise-separable
recipe of ``mobilenet.py`` and ``ssd.py`` — channel rounding, feature-map
sizes, seeded weights, and the apply-time conv helpers.

The models are NHWC at their edges, as in the JAX package.  Inside, an
NHWC tensor is permuted to NCHW, which for a contiguous NHWC tensor is
the ``channels_last`` layout with no copy; conv weights are OIHW in
``channels_last`` too, so cuDNN takes its NHWC kernels.  The JAX
package's ``SAME`` padding is reproduced exactly: at stride 2 on an even
edge XLA pads 0 before and 1 after, which ``F.conv2d``'s symmetric
``padding`` cannot express, so such convs pad explicitly first.

Weights: :func:`he_conv` draws from a seeded ``torch.Generator`` on the
builder's device (torch cannot reproduce ``jax.random``), and
:func:`params_from_jax` converts the JAX package's numpy trees (HWIO ->
OIHW; a depthwise ``[kh, kw, 1, C]`` kernel becomes ``[C, 1, kh, kw]``,
applied with ``groups=C``).  The JAX package's ``PartitionSpec`` helpers
wait for the mesh slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def compute_dtype(name) -> torch.dtype:
    """The torch dtype of a ``custom=dtype:`` name."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _COMPUTE_DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"({sorted(_COMPUTE_DTYPES)})") from None


def rounded(ch: int, width: float) -> int:
    """Width-multiplied channel count, kept a multiple of 8."""
    return max(8, int(ch * width + 4) // 8 * 8)


def fm_size(size: int, stride: int) -> int:
    """SAME-padded feature-map edge after ``log2(stride)`` stride-2 convs
    (a ceil-division chain, not ``size // stride``)."""
    n = stride.bit_length() - 1
    if 1 << n != stride:
        raise ValueError(f"stride must be a power of 2, got {stride}")
    for _ in range(n):
        size = -(-size // 2)
    return size


def he_conv(gen: torch.Generator, kh: int, kw: int, cin: int,
            cout: int) -> torch.Tensor:
    """He-normal conv kernel, OIHW ``[cout, cin, kh, kw]``, on the
    generator's device."""
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=gen.device)
    return w * float(np.sqrt(2.0 / (kh * kw * cin)))


def stem_params(gen, cin: int, cout: int) -> Dict:
    return {
        "w": he_conv(gen, 3, 3, cin, cout),
        "scale": torch.ones(cout, device=gen.device),
        "bias": torch.zeros(cout, device=gen.device),
    }


def sep_block_params(gen, cin: int, cout: int) -> Dict:
    """Depthwise-separable block params: dw 3x3 (grouped) + pw 1x1."""
    dev = gen.device
    return {
        "dw": he_conv(gen, 3, 3, 1, cin),
        "dw_scale": torch.ones(cin, device=dev),
        "dw_bias": torch.zeros(cin, device=dev),
        "pw": he_conv(gen, 1, 1, cin, cout),
        "pw_scale": torch.ones(cout, device=dev),
        "pw_bias": torch.zeros(cout, device=dev),
    }


def params_from_jax(tree, device) -> Dict:
    """The JAX package's numpy parameter tree as the port's: 4-D kernels
    HWIO -> OIHW (a depthwise ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``),
    everything else as it is, on ``device``; dicts and lists keep their
    structure."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    a = np.asarray(tree, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def prepare(params, dtype: torch.dtype) -> Dict:
    """Params in the compute dtype, conv kernels ``channels_last``: what
    the JAX package casts at every apply, done once."""
    if isinstance(params, dict):
        return {k: prepare(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [prepare(v, dtype) for v in params]
    t = params.to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one edge: (before, after), the odd pixel
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def nhwc_to_internal(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC batch as the NCHW view the convs take (``channels_last``
    memory when ``x`` is contiguous)."""
    return x.to(dtype).permute(0, 3, 1, 2)


def make_ops(compute_dtype: torch.dtype):
    """Apply-time helpers closed over the compute dtype:
    (conv2d, scale_bias_relu6, sep_block), on NCHW-view tensors."""
    cdt = compute_dtype

    def conv2d(x, w, stride, groups=1):
        w = w.to(cdt)
        ph = same_pads(x.shape[2], w.shape[2], stride)
        pw = same_pads(x.shape[3], w.shape[3], stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]),
                            groups=groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=stride, groups=groups)

    def sbr(x, scale, bias):
        x = x * scale.to(cdt).view(1, -1, 1, 1) + bias.to(cdt).view(1, -1, 1, 1)
        return torch.clamp(x, 0.0, 6.0)

    def sep(x, p, stride):
        x = conv2d(x, p["dw"], stride, groups=x.shape[1])
        x = sbr(x, p["dw_scale"], p["dw_bias"])
        x = conv2d(x, p["pw"], 1)
        return sbr(x, p["pw_scale"], p["pw_bias"])

    return conv2d, sbr, sep
