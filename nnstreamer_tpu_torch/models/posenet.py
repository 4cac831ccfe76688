"""PoseNet keypoint heatmap model (benchmark config #3).

Port of ``nnstreamer_tpu/models/posenet.py``: the MobileNet backbone of
``backbone.py`` at output stride 16 with two 1x1 heads, the same
parameter tree and rounding:

* heatmaps ``[B, H/16, W/16, K]`` — sigmoid keypoint confidence, float32;
* offsets ``[B, H/16, W/16, 2K]`` — short-range refinement, float32.

The layout is the ``pose_estimation`` decoder's contract.  Weights are
deterministic random from ``custom=seed:N`` (a ``torch.Generator`` on the
build device); :func:`params_from_jax` carries the JAX package's tree
across.  The JAX package's ``param_pspecs`` wait for the mesh slice.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from ..core.types import TensorsSpec
from .backbone import (compute_dtype as torch_dtype, fm_size, he_conv, make_ops,
                       nhwc_to_internal, prepare, rounded, sep_block_params,
                       stem_params)
from .backbone import params_from_jax  # noqa: F401 - the model's converter
from .zoo import ModelBundle, register_model

_BACKBONE: Tuple[Tuple[int, int], ...] = (
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512),
)
KEYPOINTS = 17  # COCO-17


def init_params(width: float = 1.0, keypoints: int = KEYPOINTS,
                seed: int = 0, device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    params: Dict = {"stem": stem_params(gen, 3, rounded(32, width))}
    cin = rounded(32, width)
    for i, (_s, ch) in enumerate(_BACKBONE):
        cout = rounded(ch, width)
        params[f"block{i}"] = sep_block_params(gen, cin, cout)
        cin = cout
    params["head_heat"] = {"w": he_conv(gen, 1, 1, cin, keypoints),
                           "bias": torch.zeros(keypoints, device=dev)}
    params["head_off"] = {"w": he_conv(gen, 1, 1, cin, 2 * keypoints),
                          "bias": torch.zeros(2 * keypoints, device=dev)}
    return params


def apply(params, x, *, compute_dtype="bfloat16"):
    """NHWC ``[B, H, W, 3]`` -> (heatmaps ``[B, H', W', K]``, offsets
    ``[B, H', W', 2K]``), both float32."""
    cdt = torch_dtype(compute_dtype)
    x = nhwc_to_internal(x, cdt)
    conv2d, sbr, sep = make_ops(cdt)

    p = params["stem"]
    x = sbr(conv2d(x, p["w"], 2), p["scale"], p["bias"])
    for i, (stride, _ch) in enumerate(_BACKBONE):
        x = sep(x, params[f"block{i}"], stride)
    hh, ho = params["head_heat"], params["head_off"]
    heat = conv2d(x, hh["w"], 1) + hh["bias"].to(cdt).view(1, -1, 1, 1)
    off = conv2d(x, ho["w"], 1) + ho["bias"].to(cdt).view(1, -1, 1, 1)
    # NCHW views -> NHWC (the channels_last memory itself)
    return (torch.sigmoid(heat).float().permute(0, 2, 3, 1),
            off.float().permute(0, 2, 3, 1))


def build_bundle(params, opts: Dict[str, str], name: str) -> ModelBundle:
    """A bundle over float32 ``params``, cast once to ``custom=dtype``."""
    keypoints = int(opts.get("keypoints", KEYPOINTS))
    size = int(opts.get("size", 256))
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    # the SAME-padded ceil-division chain, not size // 16: a 257x257 input
    # gives 17x17 heatmaps
    fm = fm_size(size, 16)
    return ModelBundle(
        apply_fn=functools.partial(apply, compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(
            f"{keypoints}:{fm}:{fm}:{batch},{2 * keypoints}:{fm}:{fm}:{batch}",
            "float32,float32"),
        name=name,
    )


@register_model("posenet")
def _posenet(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(width=float(opts.get("width", 1.0)),
                         keypoints=int(opts.get("keypoints", KEYPOINTS)),
                         seed=int(opts.get("seed", 0)), device=device)
    return build_bundle(params, opts, "posenet")
