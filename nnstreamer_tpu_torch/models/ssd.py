"""SSD-MobileNet object detector (benchmark config #2).

Port of ``nnstreamer_tpu/models/ssd.py``: a MobileNet-v1-style backbone
with two detection scales (strides 16 and 32), the same parameter tree
and anchors.  The anchor decode lives inside the model, as in the JAX
package (and as tflite SSD graphs embed their postprocess):
:func:`apply` emits corner-format normalized boxes ``[B, N, 4]`` and
per-class sigmoid scores ``[B, N, C]``, the ``bounding_boxes`` decoder's
``ssd`` contract, so model and decode fuse into one stage.

:func:`build_anchors` is a copy of the JAX package's numpy code and
gives the same bits.  Weights are deterministic random from
``custom=seed:N`` on the build device; ``params_from_jax`` (from
``backbone.py``) carries the JAX package's tree across for parity.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.types import TensorsSpec
from .backbone import (compute_dtype as torch_dtype, he_conv, make_ops,
                       nhwc_to_internal, prepare, rounded, sep_block_params,
                       sep_block_pspecs, stem_params, stem_pspecs)
from .backbone import params_from_jax  # noqa: F401 - the model's converter
from .zoo import ModelBundle, register_model

# Backbone: (stride, out_ch) separable blocks after the stem (stride-2 conv).
_BACKBONE: Tuple[Tuple[int, int], ...] = (
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512),          # feature map A: stride 16
)
_EXTRA: Tuple[Tuple[int, int], ...] = (
    (2, 512), (1, 512),          # feature map B: stride 32
)
_ASPECTS = (1.0, 2.0, 0.5)


def _anchors_for(fm: int, scale: float, next_scale: float) -> np.ndarray:
    """SSD anchor grid for one fm x fm feature map -> (fm*fm*A, 4) cxcywh.

    Layout is cell-major (y, x, a) to match the head's
    ``(B,H,W,A*4) -> (B, H*W*A, 4)`` reshape: anchor index = (y*fm + x)*A + a.
    """
    centers = (np.arange(fm, dtype=np.float32) + 0.5) / fm
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    per_aspect = []
    for a in _ASPECTS:
        w = scale * np.sqrt(a)
        h = scale / np.sqrt(a)
        per_aspect.append(np.stack(
            [cx, cy, np.full_like(cx, w), np.full_like(cy, h)], axis=-1))
    s_extra = float(np.sqrt(scale * next_scale))
    per_aspect.append(np.stack(
        [cx, cy, np.full_like(cx, s_extra), np.full_like(cy, s_extra)],
        axis=-1))
    grid = np.stack(per_aspect, axis=2)  # (fm, fm, A, 4)
    return grid.reshape(-1, 4)


def num_anchors_per_cell() -> int:
    return len(_ASPECTS) + 1


def build_anchors(size: int) -> np.ndarray:
    """All anchors (N,4) cxcywh normalized, for strides 16 and 32."""
    fm_a, fm_b = size // 16, size // 32
    return np.concatenate(
        [_anchors_for(fm_a, 0.35, 0.6), _anchors_for(fm_b, 0.6, 0.9)], axis=0
    ).astype(np.float32)


def init_params(classes: int = 91, width: float = 1.0, seed: int = 0,
                device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    params: Dict = {"stem": stem_params(gen, 3, rounded(32, width))}
    cin = rounded(32, width)
    for i, (_s, ch) in enumerate(_BACKBONE):
        params[f"block{i}"] = sep_block_params(gen, cin, rounded(ch, width))
        cin = rounded(ch, width)
    ca = cin
    for i, (_s, ch) in enumerate(_EXTRA):
        params[f"extra{i}"] = sep_block_params(gen, cin, rounded(ch, width))
        cin = rounded(ch, width)
    cb = cin
    A = num_anchors_per_cell()
    # class-head bias at the standard low prior (-log((1-pi)/pi), pi=0.01):
    # with random weights the scores sit near the prior and detections are
    # sparse, as a trained detector's
    prior_bias = float(-np.log((1 - 0.01) / 0.01))
    for tag, ch in (("a", ca), ("b", cb)):
        params[f"head_{tag}"] = {
            "box": he_conv(gen, 3, 3, ch, A * 4),
            "box_bias": torch.zeros(A * 4, device=dev),
            "cls": he_conv(gen, 3, 3, ch, A * classes),
            "cls_bias": torch.full((A * classes,), prior_bias, device=dev),
        }
    return params


def apply(params, x, *, anchors: torch.Tensor, classes: int,
          compute_dtype="bfloat16"):
    """NHWC image batch -> (boxes (B,N,4) corner [0,1], scores (B,N,C)),
    both float32.  ``anchors``: (N,4) cxcywh float32 on the input's
    device."""
    cdt = torch_dtype(compute_dtype)
    x = nhwc_to_internal(x, cdt)
    conv2d, sbr, sep = make_ops(cdt)

    p = params["stem"]
    x = sbr(conv2d(x, p["w"], 2), p["scale"], p["bias"])
    for i, (stride, _ch) in enumerate(_BACKBONE):
        x = sep(x, params[f"block{i}"], stride)
    fm_a = x
    for i, (stride, _ch) in enumerate(_EXTRA):
        x = sep(x, params[f"extra{i}"], stride)
    fm_b = x

    B = x.shape[0]

    def head(fm, hp):
        box = conv2d(fm, hp["box"], 1) + hp["box_bias"].to(cdt).view(1, -1, 1, 1)
        cls = conv2d(fm, hp["cls"], 1) + hp["cls_bias"].to(cdt).view(1, -1, 1, 1)
        # NCHW view -> NHWC (the channels_last memory itself) -> per anchor
        return (box.permute(0, 2, 3, 1).reshape(B, -1, 4).float(),
                cls.permute(0, 2, 3, 1).reshape(B, -1, classes).float())

    box_a, cls_a = head(fm_a, params["head_a"])
    box_b, cls_b = head(fm_b, params["head_b"])
    deltas = torch.cat([box_a, box_b], dim=1)  # (B,N,4)
    logits = torch.cat([cls_a, cls_b], dim=1)  # (B,N,C)

    # anchor decode (tflite SSD convention: deltas scaled by 10/5)
    anc = anchors
    cx = deltas[..., 0] / 10.0 * anc[:, 2] + anc[:, 0]
    cy = deltas[..., 1] / 10.0 * anc[:, 3] + anc[:, 1]
    w = torch.exp(torch.clamp(deltas[..., 2] / 5.0, -10.0, 10.0)) * anc[:, 2]
    h = torch.exp(torch.clamp(deltas[..., 3] / 5.0, -10.0, 10.0)) * anc[:, 3]
    boxes = torch.stack(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes, torch.sigmoid(logits)


def param_pspecs() -> Dict:
    """The backbone's and the extras' pointwise kernels cut over
    ``model``; the heads replicated."""
    from ..parallel.sharding import P

    specs: Dict = {"stem": stem_pspecs()}
    for i in range(len(_BACKBONE)):
        specs[f"block{i}"] = sep_block_pspecs()
    for i in range(len(_EXTRA)):
        specs[f"extra{i}"] = sep_block_pspecs()
    for tag in ("a", "b"):
        specs[f"head_{tag}"] = {"box": P(), "box_bias": P(),
                                "cls": P(), "cls_bias": P()}
    return specs


def build_bundle(params, opts: Dict[str, str], device, name: str) -> ModelBundle:
    """A bundle over float32 ``params``, cast once to ``custom=dtype``."""
    classes = int(opts.get("classes", 91))
    size = int(opts.get("size", 320))
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    if size % 32:
        raise ValueError(f"ssd size must be a multiple of 32, got {size}")
    anchors = torch.from_numpy(build_anchors(size)).to(device)
    n = anchors.shape[0]
    return ModelBundle(
        apply_fn=functools.partial(apply, anchors=anchors, classes=classes,
                                   compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(
            f"4:{n}:{batch},{classes}:{n}:{batch}", "float32,float32"),
        name=name,
        param_pspecs=param_pspecs(),
    )


@register_model("ssd_mobilenet")
def _ssd(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(classes=int(opts.get("classes", 91)),
                         width=float(opts.get("width", 1.0)),
                         seed=int(opts.get("seed", 0)), device=device)
    return build_bundle(params, opts, device, "ssd_mobilenet")
