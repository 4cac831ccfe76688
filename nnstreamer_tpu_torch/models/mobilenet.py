"""MobileNet-v1 image classifier (benchmark config #1).

Port of ``nnstreamer_tpu/models/mobilenet.py``: the same topology,
parameter tree (keys ``stem``, ``block0..12``, ``head``) and rounding.
The input is cast to the compute dtype (bfloat16 by default,
``custom=dtype:float32`` to override), every conv rounds to it, the
global mean accumulates in float32 and rounds back, and the logits come
out in float32.  BatchNorm is the inference form, a per-channel
scale/bias.

Weights are deterministic he-normal random from ``custom=seed:N``
(drawn by a ``torch.Generator`` on the build device: the values differ
from the JAX package's ``jax.random`` ones); ``params_from_jax`` (from
``backbone.py``) carries the JAX package's tree across for parity.  The ``param_pspecs``
of the JAX package wait for the mesh slice.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from ..core.types import TensorsSpec
from .backbone import (compute_dtype as torch_dtype, he_conv, make_ops,
                       nhwc_to_internal, prepare, rounded, sep_block_params,
                       stem_params)
from .backbone import params_from_jax  # noqa: F401 - the model's converter
from .zoo import ModelBundle, register_model

# (stride, out_channels) per depthwise-separable block, after the stem
# conv: the standard MobileNet-v1 1.0 topology.
_V1_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (1, 64),
    (2, 128),
    (1, 128),
    (2, 256),
    (1, 256),
    (2, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (2, 1024),
    (1, 1024),
)


def init_params(width: float = 1.0, classes: int = 1001, seed: int = 0,
                device="cpu") -> Dict:
    """He-normal random params (float32) in the canonical tree layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict = {"stem": stem_params(gen, 3, rounded(32, width))}
    cin = rounded(32, width)
    for i, (_stride, cout_base) in enumerate(_V1_BLOCKS):
        cout = rounded(cout_base, width)
        params[f"block{i}"] = sep_block_params(gen, cin, cout)
        cin = cout
    params["head"] = {
        "w": he_conv(gen, 1, 1, cin, classes),
        "bias": torch.zeros(classes, device=gen.device),
    }
    return params


def apply(params, x, *, compute_dtype="bfloat16"):
    """Forward pass.  ``x``: NHWC float [B, H, W, 3]; returns float32
    logits [B, classes]."""
    cdt = torch_dtype(compute_dtype)
    x = nhwc_to_internal(x, cdt)
    conv2d, sbr, sep = make_ops(cdt)

    p = params["stem"]
    x = sbr(conv2d(x, p["w"], 2), p["scale"], p["bias"])
    for i, (stride, _cout) in enumerate(_V1_BLOCKS):
        x = sep(x, params[f"block{i}"], stride)

    # global average pool: a float32 sum over H, W, rounded back
    x = torch.mean(x, dim=(2, 3), keepdim=True, dtype=torch.float32).to(cdt)
    h = params["head"]
    x = conv2d(x, h["w"], 1) + h["bias"].to(cdt).view(1, -1, 1, 1)
    return x[:, :, 0, 0].float()


def build_bundle(params, opts: Dict[str, str], name: str) -> ModelBundle:
    """A bundle over float32 ``params``, cast once to ``custom=dtype``."""
    classes = int(opts.get("classes", 1001))
    size = int(opts.get("size", 224))
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    return ModelBundle(
        apply_fn=functools.partial(apply, compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(f"{classes}:{batch}", "float32"),
        name=name,
    )


@register_model("mobilenet_v1")
def _mobilenet_v1(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(width=float(opts.get("width", 1.0)),
                         classes=int(opts.get("classes", 1001)),
                         seed=int(opts.get("seed", 0)), device=device)
    return build_bundle(params, opts, "mobilenet_v1")
