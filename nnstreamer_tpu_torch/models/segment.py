"""DeepLab-style semantic segmentation, the model of the image_segment
decoder.

Port of ``nnstreamer_tpu/models/segment.py``: the MobileNet backbone of
``backbone.py`` at output stride 16, an ASPP-lite context head (a 1x1
branch and a global-pooling branch, concatenated) and a bilinear
upsample back to the input resolution inside the model, the same
parameter tree and rounding.  ``custom=upsample:0`` emits the
native-stride ``[B, H/16, W/16, classes]`` score map instead: the class
decision at the model's true resolution, of which the full-resolution
map is only a bilinear blow-up.

When ``upsample`` is not pinned, the bundle offers that native-stride map
to the residency planner as its ``reduced_variant`` (sharing the
bundle's params), which ``pipeline/residency.py`` selects when every
consumer below the filter admits any geometry (``image_segment
option1=classmap``, ``tensor_sink``).

The resize is ``F.interpolate(mode="bilinear", align_corners=False)`` in
float32, ``jax.image.resize(..., "bilinear")``'s half-pixel sampling when
upsampling (no antialiasing applies).  Weights are deterministic random
from ``custom=seed:N`` (a ``torch.Generator`` on the build device);
:func:`params_from_jax` carries the JAX package's tree across.
:func:`param_pspecs`: the backbone's pointwise kernels cut over the
``model`` mesh axis, the ASPP and head convs replicated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.types import TensorsSpec
from .backbone import (compute_dtype as torch_dtype, fm_size, he_conv, make_ops,
                       nhwc_to_internal, prepare, rounded, sep_block_params,
                       sep_block_pspecs, stem_params, stem_pspecs)
from .backbone import params_from_jax  # noqa: F401 - the model's converter
from .zoo import ModelBundle, register_model

_BACKBONE: Tuple[Tuple[int, int], ...] = (
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512),
)
CLASSES = 21  # PASCAL-VOC, the reference example's label set


def init_params(width: float = 1.0, classes: int = CLASSES, seed: int = 0,
                device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    params: Dict = {"stem": stem_params(gen, 3, rounded(32, width))}
    cin = rounded(32, width)
    for i, (_s, ch) in enumerate(_BACKBONE):
        cout = rounded(ch, width)
        params[f"block{i}"] = sep_block_params(gen, cin, cout)
        cin = cout
    mid = rounded(256, width)
    params["aspp_conv"] = {"w": he_conv(gen, 1, 1, cin, mid),
                           "bias": torch.zeros(mid, device=dev)}
    params["aspp_pool"] = {"w": he_conv(gen, 1, 1, cin, mid),
                           "bias": torch.zeros(mid, device=dev)}
    params["head"] = {"w": he_conv(gen, 1, 1, 2 * mid, classes),
                      "bias": torch.zeros(classes, device=dev)}
    return params


def apply(params, x, *, compute_dtype="bfloat16", upsample: bool = True):
    """NHWC ``[B, H, W, 3]`` -> ``[B, H, W, classes]`` float32 scores (or
    the native-stride ``[B, H/16, W/16, classes]`` map with
    ``upsample=False``)."""
    cdt = torch_dtype(compute_dtype)
    H, W = x.shape[1], x.shape[2]
    x = nhwc_to_internal(x, cdt)
    conv2d, sbr, sep = make_ops(cdt)

    p = params["stem"]
    x = sbr(conv2d(x, p["w"], 2), p["scale"], p["bias"])
    for i, (stride, _ch) in enumerate(_BACKBONE):
        x = sep(x, params[f"block{i}"], stride)

    def bias(t):
        return t.to(cdt).view(1, -1, 1, 1)

    # ASPP-lite: a local 1x1 branch and an image-level pooling branch (the
    # mean accumulates in float32 and rounds back, as jnp.mean does)
    a = params["aspp_conv"]
    local = torch.relu(conv2d(x, a["w"], 1) + bias(a["bias"]))
    g = params["aspp_pool"]
    pooled = torch.mean(x, dim=(2, 3), keepdim=True, dtype=torch.float32).to(cdt)
    pooled = torch.relu(conv2d(pooled, g["w"], 1) + bias(g["bias"]))
    feat = torch.cat([local, pooled.expand_as(local)], dim=1)

    h = params["head"]
    logits = (conv2d(feat, h["w"], 1) + bias(h["bias"])).float()
    if upsample:
        logits = F.interpolate(logits, size=(H, W), mode="bilinear",
                               align_corners=False)
    return logits.permute(0, 2, 3, 1)  # NCHW view -> NHWC


def param_pspecs() -> Dict:
    from ..parallel.sharding import P

    specs: Dict = {"stem": stem_pspecs()}
    for i in range(len(_BACKBONE)):
        specs[f"block{i}"] = sep_block_pspecs()
    for head in ("aspp_conv", "aspp_pool", "head"):
        specs[head] = {"w": P(), "bias": P()}
    return specs


def build_bundle(params, opts: Dict[str, str], name: str) -> ModelBundle:
    """A bundle over float32 ``params``, cast once to ``custom=dtype``;
    with ``upsample`` unpinned it carries the native-stride variant."""
    classes = int(opts.get("classes", CLASSES))
    size = int(opts.get("size", 257))  # the reference example's 257x257
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    up = str(opts.get("upsample", "1")).lower() not in ("0", "false", "no")
    native = fm_size(size, 16)  # four SAME stride-2 stages

    def spec(n):
        return TensorsSpec.from_string(f"{classes}:{n}:{n}:{batch}", "float32")

    bundle = ModelBundle(
        apply_fn=functools.partial(apply, compute_dtype=dtype, upsample=up),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=spec(size if up else native),
        name=name,
        param_pspecs=param_pspecs(),
    )
    if up and "upsample" not in opts:
        # an explicit upsample:1 asks for full resolution: only an
        # unpinned bundle offers the planner its native-stride map.  The
        # thunk reads the bundle's params when called
        def reduced(b=bundle):
            return dataclasses.replace(
                b, apply_fn=functools.partial(apply, compute_dtype=dtype,
                                              upsample=False),
                out_spec=spec(native), reduced_variant=None, reduced_desc="")

        bundle.reduced_variant = reduced
        bundle.reduced_desc = (
            f"native-stride score map [{batch},{native},{native},{classes}] "
            f"({(size * size) // max(1, native * native)}x fewer bytes than "
            "full resolution)")
    return bundle


@register_model("deeplab_mobilenet")
def _deeplab(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(width=float(opts.get("width", 1.0)),
                         classes=int(opts.get("classes", CLASSES)),
                         seed=int(opts.get("seed", 0)), device=device)
    return build_bundle(params, opts, "deeplab_mobilenet")
