"""YOLO-family single-shot detectors (the YOLOv5 half of benchmark config
#2).

Port of ``nnstreamer_tpu/models/yolo.py``: the same three zoo names,
parameter trees, anchors and rounding.

* ``yolov5`` — the compact stand-in on the shared depthwise-separable
  blocks (stem, a stride-2 max pool, three down/refine stages at strides
  8/16/32, one 1x1 head per scale): ``[B, N, 5+C]`` in the layout
  ``tensor_decoder mode=bounding_boxes option1=yolov5`` consumes (cx, cy,
  w, h normalized, objectness, class scores).
* ``yolov8`` — the same backbone, anchor-free (one predictor per cell, no
  objectness column), channels-first ``[B, 4+C, N]``.
* ``yolov5s`` — the real-geometry CSP detector: CSPDarknet backbone, SPPF
  and the PANet head at width 0.5 / depth 0.33, each conv followed by its
  folded-BN scale, bias and SiLU in the compute dtype.

Every head ends in the polynomial decode of the JAX package
(:func:`_poly_coeffs`, :func:`_poly_decode`): the per-scale raw outputs
are concatenated, cast to float32, and ``(A * s + B) * s + C`` with
``s = sigmoid(raw)`` is the whole box decode.  The ``A``/``B``/``C``
tables are numpy built once per bundle and put on the build device there,
so a captured stage never copies them from the host.

Weights are deterministic he-normal random from ``custom=seed:N`` (a
``torch.Generator`` on the build device: not the JAX package's values);
:func:`params_from_jax` carries the JAX package's trees across, lists
(the C3 blocks' ``m``) included.  The JAX package's ``param_pspecs`` wait
for the mesh slice.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import TensorsSpec
from .backbone import (compute_dtype as torch_dtype, fm_size, he_conv, make_ops,
                       nhwc_to_internal, prepare, rounded, same_pads,
                       sep_block_params, stem_params)
from .backbone import params_from_jax  # noqa: F401 - the models' converter
from .zoo import ModelBundle, register_model

#: scale widths (before the width multiplier) at strides 8, 16, 32
_BACKBONE = [64, 128, 256]
_ANCHORS_PER_CELL = 3
#: the toy yolov5's anchor sizes per scale, normalized to the input size
_ANCHOR_SIZES = {
    8: [(0.04, 0.06), (0.08, 0.12), (0.12, 0.09)],
    16: [(0.14, 0.22), (0.26, 0.17), (0.24, 0.38)],
    32: [(0.45, 0.35), (0.38, 0.64), (0.75, 0.70)],
}
#: YOLOv5 anchor priors, pixels of the nominal 640 input (P3/P4/P5)
_V5S_ANCHORS_PX = {
    8: [(10, 13), (16, 30), (33, 23)],
    16: [(30, 61), (62, 45), (59, 119)],
    32: [(116, 90), (156, 198), (373, 326)],
}


def init_params(classes: int, width: float = 1.0, seed: int = 0,
                anchors_per_cell: int = _ANCHORS_PER_CELL,
                head_values: int = 5, device="cpu") -> Dict:
    """The toy backbone's params; ``anchors_per_cell``/``head_values``
    let the anchor-free v8 head (1 predictor, 4+C values) share it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device
    params: Dict = {"stem": stem_params(gen, 3, rounded(32, width))}
    cin = rounded(32, width)
    for i, ch in enumerate(_BACKBONE):
        cout = rounded(ch, width)
        params[f"down{i}"] = sep_block_params(gen, cin, cout)   # stride 2
        params[f"block{i}"] = sep_block_params(gen, cout, cout)  # stride 1
        cin = cout
        nout = anchors_per_cell * (head_values + classes)
        params[f"head{i}"] = {
            "w": he_conv(gen, 1, 1, cout, nout),
            # objectness prior: random weights predict "no object"
            "b": torch.full((nout,), -4.0, device=dev),
        }
    return params


def num_predictions(size: int) -> int:
    return sum(fm_size(size, s) ** 2 * _ANCHORS_PER_CELL for s in (8, 16, 32))


def num_predictions_v8(size: int) -> int:
    return sum(fm_size(size, s) ** 2 for s in (8, 16, 32))


# The layout helpers below move data on the NHWC view of an NCHW-view
# tensor, the layout's contiguous view, so the result stays channels_last
# under torch.func.vmap too: there a pad, a channel concat or a repeat of
# the NCHW view returns NCHW memory, and cuDNN loses its NHWC kernels for
# every conv after it.  Unbatched they give the same values.


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _cat_channels(xs) -> torch.Tensor:
    """Concatenate NCHW views along C."""
    return _nchw(torch.cat([_nhwc(x) for x in xs], -1))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NCHW view."""
    return _nchw(_nhwc(x).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


def _maxpool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's ``reduce_window(max, SAME)``: pad with -inf (the odd pixel
    after), then pool."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if any(ph + pw):
        x = _nchw(F.pad(_nhwc(x), (0, 0, pw[0], pw[1], ph[0], ph[1]),
                        value=float("-inf")))
    return F.max_pool2d(x, k, stride)


def _backbone_feats(params, x, size: int, cdt):
    """Stem + three-scale backbone: NHWC ``[B, size, size, 3]`` -> NCHW
    views of the feature maps at strides 8/16/32, with their head params."""
    if x.shape[1] != size or x.shape[2] != size:
        raise ValueError(f"yolo input must be {size}x{size}, got {tuple(x.shape)}")
    conv2d, sbr, sep = make_ops(cdt)
    h = conv2d(nhwc_to_internal(x, cdt), params["stem"]["w"], 2)
    h = sbr(h, params["stem"]["scale"], params["stem"]["bias"])
    # a stride-2 max pool after the stem puts the three stages at 8/16/32
    h = _maxpool_same(h, 2, 2)
    feats = []
    for i, stride in enumerate((8, 16, 32)):
        h = sep(h, params[f"down{i}"], 2)
        h = sep(h, params[f"block{i}"], 1)
        feats.append((stride, h, params[f"head{i}"]))
    return feats


def _poly_coeffs(g: int, n_out: int, n_anchor: int, box_a):
    """Per-(position, channel) coefficients of a yolo-family decode head,
    ``out = A * sigmoid(raw)^2 + B * sigmoid(raw) + C`` over the flattened
    ``[N_s, n_out]`` block of one scale.  ``box_a``: ``[n_anchor, 2]``
    quadratic coefficients of the w/h channels (4 * anchor, in the head's
    output units).  Channels: 0/1 affine cell centres, 2/3 quadratic w/h,
    the rest identity (scores)."""
    gy, gx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    pos = np.stack([gx, gy], -1).reshape(-1, 2)
    pos = np.repeat(pos, n_anchor, axis=0)  # [N_s, 2], anchor-minor
    box_a = np.tile(np.asarray(box_a, np.float32), (g * g, 1))
    N_s = g * g * n_anchor
    A = np.zeros((N_s, n_out), np.float32)
    B = np.zeros((N_s, n_out), np.float32)
    C = np.zeros((N_s, n_out), np.float32)
    B[:, 4:] = 1.0
    B[:, 0] = B[:, 1] = 2.0 / g
    C[:, 0] = (pos[:, 0] - 0.5) / g
    C[:, 1] = (pos[:, 1] - 0.5) / g
    A[:, 2] = box_a[:, 0]
    A[:, 3] = box_a[:, 1]
    return A, B, C


def decode_tables(abc, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-scale ``(A, B, C)`` tables concatenated and put on
    ``device``: made once, at build."""
    return tuple(torch.from_numpy(np.concatenate([t[i] for t in abc])).to(device)
                 for i in range(3))


def _poly_decode(raws, tables):
    """Concatenate the per-scale raw heads and run the polynomial decode
    in float32 (see :func:`_poly_coeffs`)."""
    A, B, C = tables
    raw = torch.cat(raws, dim=1).float()
    s = torch.sigmoid(raw)
    return (A * s + B) * s + C


def _head_raw(conv2d, fm, hp, cdt, n_out):
    """A 1x1 detection head on an NCHW view: ``[B, g*g*A, n_out]``, the
    JAX package's NHWC reshape (cell-major, anchor-minor)."""
    raw = conv2d(fm, hp["w"], 1) + hp["b"].to(cdt).view(1, -1, 1, 1)
    return raw.permute(0, 2, 3, 1).reshape(fm.shape[0], -1, n_out)


def toy_tables(size: int, classes: int, v8: bool, device):
    abc = []
    for stride in (8, 16, 32):
        g = fm_size(size, stride)
        if v8:
            # anchor-free: w/h from a per-scale prior proportional to the
            # stride (v8's dist2bbox analog)
            prior = 4.0 * (4.0 * stride / size)
            abc.append(_poly_coeffs(g, 4 + classes, 1, [[prior, prior]]))
        else:
            anch = np.asarray(_ANCHOR_SIZES[stride], np.float32)
            abc.append(_poly_coeffs(g, 5 + classes, _ANCHORS_PER_CELL, 4.0 * anch))
    return decode_tables(abc, device)


def apply(params, x, *, classes: int, size: int, tables,
          compute_dtype="bfloat16"):
    """NHWC ``[B, size, size, 3]`` float32 in [0, 1] -> ``[B, N, 5+C]``
    float32 (yolov5 layout).  ``tables``: :func:`toy_tables`."""
    cdt = torch_dtype(compute_dtype)
    conv2d, _, _ = make_ops(cdt)
    raws = [_head_raw(conv2d, fm, hp, cdt, 5 + classes)
            for _stride, fm, hp in _backbone_feats(params, x, size, cdt)]
    return _poly_decode(raws, tables)


def apply_v8(params, x, *, classes: int, size: int, tables,
             compute_dtype="bfloat16"):
    """NHWC ``[B, size, size, 3]`` float32 in [0, 1] -> ``[B, 4+C, N]``
    float32, the YOLOv8 channels-first export layout: anchor-free,
    post-sigmoid class scores, normalized cx, cy, w, h."""
    cdt = torch_dtype(compute_dtype)
    conv2d, _, _ = make_ops(cdt)
    raws = [_head_raw(conv2d, fm, hp, cdt, 4 + classes)
            for _stride, fm, hp in _backbone_feats(params, x, size, cdt)]
    return _poly_decode(raws, tables).transpose(1, 2)


def build_bundle(params, opts: Dict[str, str], device, name: str,
                 v8: bool = False) -> ModelBundle:
    """A toy ``yolov5`` bundle (``v8``: a ``yolov8`` one) over float32
    ``params``, cast once to ``custom=dtype``."""
    classes = int(opts.get("classes", 80))
    size = int(opts.get("size", 224))
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    if size % 32:
        raise ValueError(f"{name} size must be a multiple of 32, got {size}")
    tables = toy_tables(size, classes, v8, device)
    if v8:
        n = num_predictions_v8(size)
        out = TensorsSpec.from_string(f"{n}:{4 + classes}:{batch}", "float32")
    else:
        n = num_predictions(size)
        out = TensorsSpec.from_string(f"{5 + classes}:{n}:{batch}", "float32")
    return ModelBundle(
        apply_fn=functools.partial(apply_v8 if v8 else apply, classes=classes,
                                   size=size, tables=tables, compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=out,
        name=name,
    )


@register_model("yolov5")
def _yolo(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(classes=int(opts.get("classes", 80)),
                         width=float(opts.get("width", 1.0)),
                         seed=int(opts.get("seed", 0)), device=device)
    return build_bundle(params, opts, device, "yolov5")


@register_model("yolov8")
def _yolov8(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params(classes=int(opts.get("classes", 80)),
                         width=float(opts.get("width", 1.0)),
                         seed=int(opts.get("seed", 0)), anchors_per_cell=1,
                         head_values=4, device=device)
    return build_bundle(params, opts, device, "yolov8", v8=True)


# -- CSP-YOLOv5s: the real-geometry detector ------------------------------


def _conv_p(gen, k: int, cin: int, cout: int) -> Dict:
    dev = gen.device
    return {"w": he_conv(gen, k, k, cin, cout),
            "scale": torch.ones(cout, device=dev),
            "bias": torch.zeros(cout, device=dev)}


def _c3_p(gen, cin: int, cout: int, n: int) -> Dict:
    ch = cout // 2
    return {
        "cv1": _conv_p(gen, 1, cin, ch),
        "cv2": _conv_p(gen, 1, cin, ch),
        "cv3": _conv_p(gen, 1, 2 * ch, cout),
        "m": [{"a": _conv_p(gen, 1, ch, ch), "b": _conv_p(gen, 3, ch, ch)}
              for _ in range(n)],
    }


def v5s_channels(width: float = 0.5):
    """Backbone channel plan after the width multiplier (c1..c5)."""
    return [rounded(c, width) for c in (64, 128, 256, 512, 1024)]


def v5s_depths(depth: float = 0.33):
    """C3 repeat counts after the depth multiplier (backbone stages)."""
    return [max(1, round(n * depth)) for n in (3, 6, 9, 3)]


def init_v5s_params(classes: int = 80, width: float = 0.5,
                    depth: float = 0.33, seed: int = 0, device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    c1, c2, c3, c4, c5 = v5s_channels(width)
    n1, n2, n3, n4 = v5s_depths(depth)
    nout = _ANCHORS_PER_CELL * (5 + classes)
    p: Dict = {
        "stem": _conv_p(gen, 6, 3, c1),
        "down1": _conv_p(gen, 3, c1, c2), "c3_1": _c3_p(gen, c2, c2, n1),
        "down2": _conv_p(gen, 3, c2, c3), "c3_2": _c3_p(gen, c3, c3, n2),
        "down3": _conv_p(gen, 3, c3, c4), "c3_3": _c3_p(gen, c4, c4, n3),
        "down4": _conv_p(gen, 3, c4, c5), "c3_4": _c3_p(gen, c5, c5, n4),
        "sppf_cv1": _conv_p(gen, 1, c5, c5 // 2),
        "sppf_cv2": _conv_p(gen, 1, c5 * 2, c5),
        # PANet head (top-down then bottom-up), shortcut-free C3s
        "h_lat5": _conv_p(gen, 1, c5, c4),
        "h_c3_4": _c3_p(gen, 2 * c4, c4, n4),
        "h_lat4": _conv_p(gen, 1, c4, c3),
        "h_c3_3": _c3_p(gen, 2 * c3, c3, n4),
        "h_down3": _conv_p(gen, 3, c3, c3),
        "h_c3_4b": _c3_p(gen, 2 * c3, c4, n4),
        "h_down4": _conv_p(gen, 3, c4, c4),
        "h_c3_5b": _c3_p(gen, 2 * c4, c5, n4),
    }
    for i, cin in enumerate((c3, c4, c5)):
        p[f"det{i}"] = {
            "w": he_conv(gen, 1, 1, cin, nout),
            "b": torch.full((nout,), -4.0, device=gen.device),  # no-object prior
        }
    return p


def num_predictions_v5s(size: int) -> int:
    return num_predictions(size)  # 3 anchors a cell at strides 8/16/32


def v5s_tables(params, size: int, device):
    """The v5s decode tables: anchors are pixels of the network input,
    normalized by the actual input size."""
    abc = []
    for i, stride in enumerate((8, 16, 32)):
        n_out = params[f"det{i}"]["b"].shape[0] // _ANCHORS_PER_CELL
        anch = np.asarray(_V5S_ANCHORS_PX[stride], np.float32) / size
        abc.append(_poly_coeffs(fm_size(size, stride), n_out, _ANCHORS_PER_CELL,
                                4.0 * anch))
    return decode_tables(abc, device)


def apply_v5s(params, x, *, classes: int, size: int, tables,
              compute_dtype="bfloat16"):
    """NHWC ``[B, size, size, 3]`` float32 in [0, 1] -> ``[B, N, 5+C]``
    float32, the yolov5 layout.  ``tables``: :func:`v5s_tables`."""
    if x.shape[1] != size or x.shape[2] != size:
        raise ValueError(f"yolov5s input must be {size}x{size}, got {tuple(x.shape)}")
    cdt = torch_dtype(compute_dtype)
    conv2d, _, _ = make_ops(cdt)

    def conv(x, p, stride=1):
        y = conv2d(x, p["w"], stride)
        y = y * p["scale"].to(cdt).view(1, -1, 1, 1) \
            + p["bias"].to(cdt).view(1, -1, 1, 1)
        return F.silu(y)

    def c3(x, p, shortcut=True):
        a = conv(x, p["cv1"])
        for bp in p["m"]:
            b = conv(conv(a, bp["a"]), bp["b"])
            a = a + b if shortcut else b
        return conv(_cat_channels([a, conv(x, p["cv2"])]), p["cv3"])

    def maxpool5(x):
        return _maxpool_same(x, 5, 1)

    h = conv(nhwc_to_internal(x, cdt), params["stem"], 2)  # stride 2
    h = conv(h, params["down1"], 2)                       # stride 4
    h = c3(h, params["c3_1"])
    h = conv(h, params["down2"], 2)                       # stride 8
    p3 = h = c3(h, params["c3_2"])
    h = conv(h, params["down3"], 2)                       # stride 16
    p4 = h = c3(h, params["c3_3"])
    h = conv(h, params["down4"], 2)                       # stride 32
    h = c3(h, params["c3_4"])
    a = conv(h, params["sppf_cv1"])                       # SPPF
    m1 = maxpool5(a)
    m2 = maxpool5(m1)
    p5 = conv(_cat_channels([a, m1, m2, maxpool5(m2)]), params["sppf_cv2"])

    # PANet: top-down
    lat5 = conv(p5, params["h_lat5"])
    f4 = c3(_cat_channels([_up2(lat5), p4]), params["h_c3_4"], shortcut=False)
    lat4 = conv(f4, params["h_lat4"])
    o3 = c3(_cat_channels([_up2(lat4), p3]), params["h_c3_3"], shortcut=False)
    # bottom-up
    o4 = c3(_cat_channels([conv(o3, params["h_down3"], 2), lat4]),
            params["h_c3_4b"], shortcut=False)
    o5 = c3(_cat_channels([conv(o4, params["h_down4"], 2), lat5]),
            params["h_c3_5b"], shortcut=False)

    raws = []
    for i, fm in enumerate((o3, o4, o5)):
        hp = params[f"det{i}"]
        raws.append(_head_raw(conv2d, fm, hp, cdt,
                              hp["b"].shape[0] // _ANCHORS_PER_CELL))
    return _poly_decode(raws, tables)


def build_bundle_v5s(params, opts: Dict[str, str], device, name: str) -> ModelBundle:
    """A ``yolov5s`` bundle over float32 ``params``."""
    classes = int(opts.get("classes", 80))
    size = int(opts.get("size", 640))
    batch = int(opts.get("batch", 1))
    dtype = opts.get("dtype", "bfloat16")
    if size % 32:
        raise ValueError(f"yolov5s size must be a multiple of 32, got {size}")
    n = num_predictions_v5s(size)
    return ModelBundle(
        apply_fn=functools.partial(apply_v5s, classes=classes, size=size,
                                   tables=v5s_tables(params, size, device),
                                   compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"3:{size}:{size}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(f"{5 + classes}:{n}:{batch}", "float32"),
        name=name,
    )


@register_model("yolov5s")
def _yolov5s(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_v5s_params(classes=int(opts.get("classes", 80)),
                             width=float(opts.get("width", 0.5)),
                             depth=float(opts.get("depth", 0.33)),
                             seed=int(opts.get("seed", 0)), device=device)
    return build_bundle_v5s(params, opts, device, "yolov5s")
