"""Audio models (benchmark config #4: speech commands / wav2vec2).

Port of ``nnstreamer_tpu/models/audio.py``: the same two models,
parameter trees and rounding.

* ``speech_commands`` — a conv keyword spotter whose feature front end is
  inside the model: frames of 640 samples every 320 (``Tensor.unfold``,
  the JAX package's static gather), a Hann-windowed real DFT and a mel
  filterbank as two matmuls in the compute dtype, the log in float32,
  then three stride-2 3x3 convs (XLA's ``SAME`` padding, the odd pixel
  after), a float32-accumulated mean and a dense head.
* ``wav2vec2`` — a strided ``VALID`` conv feature encoder with GELU (the
  tanh form, ``jax.nn.gelu``'s default), a projection, pre-LN
  bidirectional transformer layers and a CTC vocab head: ``[B, T,
  vocab]`` float32 logits.  The layer norm keeps the JAX package's order
  (float32 mean and population variance, normalize, round to the compute
  dtype, then scale and shift there); attention scores are float32, the
  softmax too, and the probabilities round to the compute dtype before
  the product with V.  The JAX package's ``lax.scan`` over the stacked
  ``[L, ...]`` layer weights is a loop here.

The DFT basis and the mel bank are numpy (copies of the JAX package's),
made once per bundle on the build device, so a captured stage never
copies them from the host.  T, the number of output frames, follows from
the conv strides (:func:`w2v_frames`), with no forward pass.

Inputs: float32 waveform ``(B, samples)`` in [-1, 1] at 16 kHz (also
``(S,)``, ``(S, 1)`` and ``(B, S, 1)``, the converter's layouts).
Weights are deterministic random from ``custom=seed:N`` (a
``torch.Generator`` on the build device); :func:`params_from_jax` carries
the JAX package's trees across.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import TensorsSpec
from .backbone import compute_dtype as torch_dtype, make_ops, prepare
from .backbone import params_from_jax as backbone_params_from_jax
from .zoo import ModelBundle, register_model

SAMPLE_RATE = 16000
_SPEECH_LABELS = ("silence", "unknown", "yes", "no", "up", "down", "left",
                  "right", "on", "off", "stop", "go")
#: speech_commands' front end: frame, hop, DFT bins
_KWS_FRAME, _KWS_HOP, _KWS_BINS = 640, 320, 256
#: wav2vec2's strided conv feature encoder: (kernel, stride, channels)
_W2V_CONVS: Tuple[Tuple[int, int, int], ...] = (
    (10, 5, 256), (3, 2, 256), (3, 2, 256), (3, 2, 256), (2, 2, 256),
)


def _dft_basis(frame: int, bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases (frame, bins) with a Hann window folded in."""
    n = np.arange(frame, dtype=np.float32)
    k = np.arange(bins, dtype=np.float32)
    ang = 2.0 * np.pi * np.outer(n, k) / frame
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / frame))[:, None]
    return (np.cos(ang) * win).astype(np.float32), \
        (np.sin(ang) * win).astype(np.float32)


def _mel_weights(bins: int, mels: int, sr: int, frame: int) -> np.ndarray:
    """Triangular mel filterbank (bins, mels)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    f_max = sr / 2.0
    pts = mel_to_hz(np.linspace(hz_to_mel(20.0), hz_to_mel(f_max), mels + 2))
    bin_hz = np.linspace(0.0, f_max, bins)
    w = np.zeros((bins, mels), np.float32)
    for m in range(mels):
        lo, ctr, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (bin_hz - lo) / max(ctr - lo, 1e-6)
        down = (hi - bin_hz) / max(hi - ctr, 1e-6)
        w[:, m] = np.maximum(0.0, np.minimum(up, down))
    return w


def _canon_wave(x: torch.Tensor, min_samples: int) -> torch.Tensor:
    """A waveform as (B, S).  A trailing dim of 1 is a mono channel axis
    (the converter's layout), not a batch of 1-sample clips."""
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"waveform must be (S,), (S,1), (B,S); got {tuple(x.shape)}")
    if x.shape[1] < min_samples:
        raise ValueError(f"waveform too short: {x.shape[1]} < {min_samples} samples")
    return x


def params_from_jax(tree, device) -> Dict:
    """The JAX package's numpy tree of either model as the port's, on
    ``device``: 4-D conv kernels HWIO -> OIHW, wav2vec2's 1-D conv kernels
    ``[k, cin, cout]`` -> ``[cout, cin, k]``, everything else (dense
    ``[cin, cout]``, stacked ``[L, ...]`` layers) as it is."""
    params = backbone_params_from_jax(tree, device)
    for c in params.get("convs", ()):
        c["w"] = c["w"].permute(2, 1, 0).contiguous()
    return params


# -- speech_commands ------------------------------------------------------

def init_params_kws(classes: int = len(_SPEECH_LABELS), mels: int = 64,
                    seed: int = 0, device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=gen, device=dev)
        return w * math.sqrt(2.0 / (kh * kw * cin))

    def dense(cin, cout):
        return torch.randn((cin, cout), generator=gen, device=dev) \
            * math.sqrt(2.0 / cin)

    return {
        "c1": {"w": conv(3, 3, 1, 64), "b": torch.zeros(64, device=dev)},
        "c2": {"w": conv(3, 3, 64, 64), "b": torch.zeros(64, device=dev)},
        "c3": {"w": conv(3, 3, 64, 128), "b": torch.zeros(128, device=dev)},
        "fc": {"w": dense(128, classes), "b": torch.zeros(classes, device=dev)},
    }


def kws_tables(mels: int, dtype, device):
    """The DFT bases and mel bank in the compute dtype on ``device``."""
    cos_b, sin_b = _dft_basis(_KWS_FRAME, _KWS_BINS)
    mel_w = _mel_weights(_KWS_BINS, mels, SAMPLE_RATE, _KWS_FRAME)
    return tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                 for t in (cos_b, sin_b, mel_w))


def apply_kws(params, x, *, tables, compute_dtype="bfloat16"):
    """waveform -> logits (B, classes) float32.  ``tables``:
    :func:`kws_tables`."""
    cdt = torch_dtype(compute_dtype)
    x = _canon_wave(x, _KWS_FRAME)
    cos_b, sin_b, mel_w = tables
    frames = x.unfold(1, _KWS_FRAME, _KWS_HOP).to(cdt)  # (B, T, frame)
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im  # (B, T, bins)
    mel = power @ mel_w
    feats = torch.log(mel.float() + 1e-6).to(cdt)
    h = feats[:, None]  # the NHWC (B, T, mels, 1) as an NCHW view
    conv2d, _, _ = make_ops(cdt)
    for name in ("c1", "c2", "c3"):
        p = params[name]
        h = torch.clamp_min(conv2d(h, p["w"], 2)
                            + p["b"].to(cdt).view(1, -1, 1, 1), 0.0)
    h = torch.mean(h, dim=(2, 3), dtype=torch.float32).to(cdt)  # (B, 128)
    logits = h @ params["fc"]["w"].to(cdt) + params["fc"]["b"].to(cdt)
    return logits.float()


def build_bundle_kws(params, opts: Dict[str, str], device, name: str) -> ModelBundle:
    """A ``speech_commands`` bundle over float32 ``params``."""
    classes = int(opts.get("classes", len(_SPEECH_LABELS)))
    samples = int(opts.get("samples", SAMPLE_RATE))  # a 1 s window
    batch = int(opts.get("batch", 1))
    mels = int(opts.get("mels", 64))
    dtype = opts.get("dtype", "bfloat16")
    cdt = torch_dtype(dtype)
    return ModelBundle(
        apply_fn=functools.partial(apply_kws, tables=kws_tables(mels, cdt, device),
                                   compute_dtype=dtype),
        params=prepare(params, cdt),
        in_spec=TensorsSpec.from_string(f"{samples}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(f"{classes}:{batch}", "float32"),
        name=name,
    )


@register_model("speech_commands")
def _speech_commands(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params_kws(classes=int(opts.get("classes", len(_SPEECH_LABELS))),
                             mels=int(opts.get("mels", 64)),
                             seed=int(opts.get("seed", 0)), device=device)
    return build_bundle_kws(params, opts, device, "speech_commands")


# -- wav2vec2-style encoder ------------------------------------------------

def init_params_w2v(dim: int = 256, n_layers: int = 4, n_heads: int = 4,
                    ffn: int = 512, vocab: int = 32, seed: int = 0,
                    device="cpu") -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dev = gen.device

    def randn(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)

    convs = []
    cin = 1
    for (k, _s, ch) in _W2V_CONVS:
        convs.append({"w": randn((ch, cin, k), k * cin),
                      "b": torch.zeros(ch, device=dev)})
        cin = ch
    L = n_layers
    layers = {
        "wq": randn((L, dim, dim), dim), "wk": randn((L, dim, dim), dim),
        "wv": randn((L, dim, dim), dim), "wo": randn((L, dim, dim), dim),
        "w1": randn((L, dim, ffn), dim), "w2": randn((L, ffn, dim), ffn),
        "ln1": torch.ones((L, dim), device=dev),
        "ln1b": torch.zeros((L, dim), device=dev),
        "ln2": torch.ones((L, dim), device=dev),
        "ln2b": torch.zeros((L, dim), device=dev),
    }
    return {
        "convs": convs,
        "proj": {"w": randn((cin, dim), cin), "b": torch.zeros(dim, device=dev)},
        "layers": layers,
        "head": {"w": randn((dim, vocab), dim), "b": torch.zeros(vocab, device=dev)},
    }


def w2v_frames(samples: int) -> int:
    """Frames out of the conv encoder for ``samples`` input samples."""
    t = samples
    for k, s, _ch in _W2V_CONVS:
        t = (t - k) // s + 1
    return t


def apply_w2v(params, x, *, n_heads: int, compute_dtype="bfloat16"):
    """waveform -> frame logits (B, T, vocab) float32 (CTC-style)."""
    cdt = torch_dtype(compute_dtype)
    x = _canon_wave(x, _W2V_CONVS[0][0])
    h = x.to(cdt)[:, None, :]  # (B, 1, S): NCW
    for cp, (_k, s, _ch) in zip(params["convs"], _W2V_CONVS):
        h = F.conv1d(h, cp["w"], stride=s)
        h = F.gelu(h + cp["b"].to(cdt).view(1, -1, 1), approximate="tanh")
    h = h.transpose(1, 2) @ params["proj"]["w"] + params["proj"]["b"]

    B, T, D = h.shape
    hd = D // n_heads
    scale = 1.0 / math.sqrt(hd)

    def layer_norm(v, g, b):
        v32 = v.float()
        mu = v32.mean(dim=-1, keepdim=True)
        var = v32.var(dim=-1, keepdim=True, unbiased=False)
        out = (v32 - mu) / torch.sqrt(var + 1e-5)
        return out.to(cdt) * g + b

    lp = params["layers"]
    for i in range(lp["wq"].shape[0]):
        v = layer_norm(h, lp["ln1"][i], lp["ln1b"][i])
        q = (v @ lp["wq"][i]).reshape(B, T, n_heads, hd)
        k = (v @ lp["wk"][i]).reshape(B, T, n_heads, hd)
        vv = (v @ lp["wv"][i]).reshape(B, T, n_heads, hd)
        # scores in float32 (preferred_element_type), softmax in float32,
        # the probabilities rounded to the compute dtype before P @ V
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.softmax(s * scale, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", p.to(cdt), vv)
        h = h + attn.reshape(B, T, D) @ lp["wo"][i]
        v = layer_norm(h, lp["ln2"][i], lp["ln2b"][i])
        h = h + F.gelu(v @ lp["w1"][i], approximate="tanh") @ lp["w2"][i]
    logits = h @ params["head"]["w"] + params["head"]["b"]
    return logits.float()


def build_bundle_w2v(params, opts: Dict[str, str], name: str) -> ModelBundle:
    """A ``wav2vec2`` bundle over float32 ``params``."""
    n_heads = int(opts.get("n_heads", 4))
    batch = int(opts.get("batch", 1))
    samples = int(opts.get("samples", SAMPLE_RATE))
    dtype = opts.get("dtype", "bfloat16")
    vocab = params["head"]["w"].shape[1]
    t = w2v_frames(samples)
    return ModelBundle(
        apply_fn=functools.partial(apply_w2v, n_heads=n_heads, compute_dtype=dtype),
        params=prepare(params, torch_dtype(dtype)),
        in_spec=TensorsSpec.from_string(f"{samples}:{batch}", "float32"),
        out_spec=TensorsSpec.from_string(f"{vocab}:{t}:{batch}", "float32"),
        name=name,
    )


@register_model("wav2vec2")
def _wav2vec2(opts: Dict[str, str], device: torch.device) -> ModelBundle:
    params = init_params_w2v(dim=int(opts.get("dim", 256)),
                             n_layers=int(opts.get("n_layers", 4)),
                             n_heads=int(opts.get("n_heads", 4)),
                             vocab=int(opts.get("vocab", 32)),
                             seed=int(opts.get("seed", 0)), device=device)
    return build_bundle_w2v(params, opts, "wav2vec2")
