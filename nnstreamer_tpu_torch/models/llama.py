"""Llama-family decoder-only LM (benchmark config #5: token streaming).

Port of ``nnstreamer_tpu/models/llama.py`` (the static-cache and the
block-paged paths).  The
parameter tree keeps the JAX package's layout — layer weights stacked on
a leading layer axis, int4 mats nibble-packed under ``<name>_p`` with
per-output-channel scales under ``<name>_s`` and q|k|v and gate|up fused
(``_INT4_GROUPS``) — so :func:`params_from_jax` moves a JAX tree over leaf
for leaf.  The block is the Llama-2 block: RMSNorm, rotate-half RoPE with
f32 angles, GQA, SwiGLU.

Where the JAX package threads the KV cache through a functional carry,
:func:`forward_cached` and :func:`forward_paged` write the new rows into
the cache or pool tensors in place.  Prefill into an empty cache runs
:func:`~..ops.attention.flash_attention`; the paged path runs
:func:`~..ops.attention.paged_attention`; int4 projections and the int4
lm_head run :func:`~..ops.int4_matmul.matmul_int4`.  Every builder takes
its ``device`` explicitly.

**Tensor parallelism** over a mesh's ``model`` axis (Megatron layout,
the JAX package's :func:`param_pspecs`): :func:`place_tp` cuts the tree
over the slots of one model group into a :class:`TPParams` — q/k/v and
gate/up by output columns (whole heads, GQA groups kept together), o and
down by input rows, the lm_head by vocabulary; embed and norms whole on
every device.  The int4 tree's fused mats are laid out per shard
(``[q_s | k_s | v_s]``, ``[gate_s | up_s]``, not a contiguous cut of the
fused axis) and its row-cut mats are unpacked, cut and packed again
(the nibble planes are the halves of the input axis).  Given a
:class:`TPParams`, :func:`forward`, :func:`forward_cached` and
:func:`forward_paged` run each slot's heads and FFN columns with the same
kernels at the shard's shapes, and after each row-cut product add the
partials in slot order on the root slot
(``parallel/sharding.fixed_order_sum``); the caches and pools
(:func:`init_cache`, :func:`init_paged_cache` with ``tp=``) are one
tensor per slot, cut by kv head.  :func:`params_from_jax` keeps working
on the unsharded tree: placement is a step after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.buffer import upload
from ..core.types import TensorFormat, TensorsSpec
from ..ops.attention import (flash_attention, paged_attention, paged_route,
                             repeat_kv_heads)
from ..ops.int4_matmul import matmul_int4, quantize_int4
from .zoo import ModelBundle, register_model


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_hidden: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


#: Named size presets.  ``llama2_7b`` is the benchmark config #5 shape;
#: the tiny presets serve tests.
PRESETS: Dict[str, LlamaConfig] = {
    "llama2_7b": LlamaConfig(),
    "llama_tiny": LlamaConfig(
        vocab=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_hidden=256, max_seq=256,
    ),
    "llama_small": LlamaConfig(
        vocab=2048, dim=512, n_layers=4, n_heads=8, n_kv_heads=4,
        ffn_hidden=1024, max_seq=1024,
    ),
}

_QUANT_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

#: int4 fused-mat grouping (the JAX package's): q/k/v and gate/up quantize
#: into ONE packed mat each; per-output-channel scales make the
#: concatenation exactly equal to quantizing separately.
_INT4_GROUPS = (("wqkv", ("wq", "wk", "wv")), ("wo", ("wo",)),
                ("wgu", ("w_gate", "w_up")), ("w_down", ("w_down",)))

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r} ({sorted(_DTYPES)})") from None


def _mat_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    D, H, Hkv, F_ = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden
    hd = cfg.head_dim
    return {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
            "wo": (H * hd, D), "w_gate": (D, F_), "w_up": (D, F_),
            "w_down": (F_, D)}


def _quant_mode(quant) -> str:
    q = str(quant or "").lower()
    if q not in ("", "int4", "int8"):
        raise ValueError(f"unsupported quant {quant!r} (int8, int4)")
    return q


def _assemble(cfg: LlamaConfig, mat, lm_head, quant: str, device) -> tuple:
    """The stacked layer dict and the lm_head leaves, filled one matrix at
    a time: ``mat(name, layer)`` gives one ``[in, out]`` weight on
    ``device``, ``lm_head()`` the ``[dim, vocab]`` one, each called once,
    in this order: every ``_QUANT_MATS`` name (the members of
    ``_INT4_GROUPS`` in turn) for layer 0, 1, ..., then the lm_head.
    ``quant="int4"`` / ``"int8"`` quantizes each matrix as it comes, so
    the peak is the finished tree plus one full-precision matrix.  The
    single place the draw order of :func:`init_params` lives, for every
    ``quant``, and the loaders' streaming path."""
    L, dev = cfg.n_layers, torch.device(device)
    shapes = _mat_shapes(cfg)
    layers: Dict = {}
    head: Dict = {}
    if quant == "int4":
        for gname, members in _INT4_GROUPS:
            din = shapes[members[0]][0]
            width = sum(shapes[m][1] for m in members)
            packed = torch.empty((L, din // 2, width), dtype=torch.int8, device=dev)
            scale = torch.empty((L, 1, width), dtype=torch.float32, device=dev)
            c = 0
            for m in members:
                w = shapes[m][1]
                for li in range(L):
                    packed[li, :, c:c + w], scale[li, :, c:c + w] = \
                        quantize_int4(mat(m, li))
                c += w
            layers[gname + "_p"] = packed
            layers[gname + "_s"] = scale
        head["lm_head_p"], head["lm_head_s"] = quantize_int4(lm_head())
    elif quant == "int8":
        for m in _QUANT_MATS:
            q = torch.empty((L,) + shapes[m], dtype=torch.int8, device=dev)
            s = torch.empty((L, 1, shapes[m][1]), dtype=torch.float32, device=dev)
            for li in range(L):
                q[li], s[li] = quantize_int8_mat(mat(m, li))
            layers[m + "_q"], layers[m + "_s"] = q, s
        head["lm_head_q"], head["lm_head_s"] = quantize_int8_mat(lm_head())
    else:
        for m in _QUANT_MATS:
            w = mat(m, 0)
            stack = torch.empty((L,) + tuple(w.shape), dtype=w.dtype, device=dev)
            stack[0] = w
            for li in range(1, L):
                stack[li] = mat(m, li)
            layers[m] = stack
        head["lm_head"] = lm_head()
    return layers, head


def init_params(cfg: LlamaConfig, seed: int = 0, dtype="float32", *,
                device, quant: str = "") -> Dict:
    """Deterministic-random params from a ``torch.Generator`` on ``device``
    (it cannot reproduce ``jax.random``; tests move JAX trees over with
    :func:`params_from_jax` instead).  Each weight is normal with std
    ``sqrt(2 / fan_in)``, drawn at ``dtype``, one matrix of one layer per
    draw in :func:`_assemble`'s order (the embedding first).

    ``quant="int4"`` / ``"int8"`` quantizes each matrix as it is drawn, so
    a full-width model never holds its full-precision tree: the peak is
    the quantized tree plus one ``dtype`` matrix.  The draws are the same
    as unquantized, so the result equals :func:`quantize_int4_params` /
    :func:`quantize_int8` of ``init_params(cfg, seed, dtype)`` bitwise.
    """
    quant = _quant_mode(quant)
    dev = torch.device(device)
    dt = torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return w * float(np.sqrt(2.0 / max(1, fan_in)))

    shapes = _mat_shapes(cfg)
    L, D = cfg.n_layers, cfg.dim
    params: Dict = {"embed": normal((cfg.vocab, D), D) * 0.5,
                    "ln_out": torch.ones(D, device=dev)}
    layers, head = _assemble(
        cfg, lambda m, li: normal(shapes[m], shapes[m][0]),
        lambda: normal((D, cfg.vocab), D), quant, dev)
    layers["ln_attn"] = torch.ones(L, D, device=dev)
    layers["ln_mlp"] = torch.ones(L, D, device=dev)
    params["layers"] = layers
    params.update(head)
    return params


def params_from_jax(tree, *, device):
    """The JAX package's parameter tree, given as numpy arrays (from its
    ``init_params``, ``init_params_int4`` or ``quantize_int4_params``),
    as the port's tree of torch tensors on ``device``.  Leaves come across
    bit for bit: packed int8 nibbles, f32 scales, and bf16 leaves (numpy's
    ``bfloat16`` extension dtype) by their raw 16-bit patterns."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def quantize_int4_params(params: Dict) -> Dict:
    """Weight-only int4 with per-output-channel scales (the JAX package's
    ``quantize_int4_params``): each member mat is quantized per layer and
    the packed nibbles + scales of a group concatenate on the out axis."""
    lay = params["layers"]
    qlay: Dict = {"ln_attn": lay["ln_attn"], "ln_mlp": lay["ln_mlp"]}
    for name, members in _INT4_GROUPS:
        ps, ss = [], []
        for m in members:
            q = [quantize_int4(w) for w in lay[m]]
            ps.append(torch.stack([p for p, _ in q]))
            ss.append(torch.stack([s for _, s in q]))
        qlay[name + "_p"] = torch.cat(ps, dim=-1)
        qlay[name + "_s"] = torch.cat(ss, dim=-1)  # [L, 1, out]
    p, s = quantize_int4(params["lm_head"])
    return {"embed": params["embed"], "layers": qlay,
            "ln_out": params["ln_out"], "lm_head_p": p, "lm_head_s": s}


#: 1 / 127 rounded to f32 (a Python float holding that f32 value)
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_int8_mat(w):
    """One ``[in, out]`` weight -> (int8 ``[in, out]``, f32 ``[1, out]``
    per-output-channel scales): ``s = max(|w| over in) / 127`` (at least
    1e-8), ``q = clip(round(w / s), -127, 127)``, as the JAX package's
    ``_qmat_2d``.  The division by the constant is a product with its f32
    reciprocal, as XLA compiles it there, so scales and ``q`` equal the
    JAX package's bitwise (a scale 1 ulp apart moves ``q`` at exact
    halves, which bf16 weights hit)."""
    w32 = w.to(torch.float32)
    s = torch.clamp(w32.abs().amax(dim=0, keepdim=True) * _INV127, min=1e-8)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, s


def quantize_int8(params: Dict) -> Dict:
    """Weight-only int8 with per-output-channel scales (the JAX package's
    ``quantize_int8``): each of the seven layer mats, layer by layer, and
    the lm_head under ``<name>_q`` / ``<name>_s``.  Norms and the
    embedding table stay full precision.  Consumed scale after the
    product (:func:`_mm`)."""
    lay = params["layers"]
    qlay: Dict = {"ln_attn": lay["ln_attn"], "ln_mlp": lay["ln_mlp"]}
    for m in _QUANT_MATS:
        q = [quantize_int8_mat(w) for w in lay[m]]
        qlay[m + "_q"] = torch.stack([a for a, _ in q])
        qlay[m + "_s"] = torch.stack([b for _, b in q])  # [L, 1, out]
    q, s = quantize_int8_mat(params["lm_head"])
    return {"embed": params["embed"], "layers": qlay,
            "ln_out": params["ln_out"], "lm_head_q": q, "lm_head_s": s}


def _apply_quant(params: Dict, opts: Dict) -> Dict:
    """The ``custom=quant:...`` handling of a full-precision tree."""
    quant = _quant_mode(opts.get("quant", ""))
    if quant == "int8":
        return quantize_int8(params)
    if quant == "int4":
        return quantize_int4_params(params)
    return params


def _mm(h, lp: Dict, key: str, dt, out_dtype=None):
    """``h @ W`` for a layer dict that stores ``key`` full-precision,
    nibble-packed (``key_p``/``key_s``) or int8 (``key_q``/``key_s``).

    int8 is applied scale after the product, ``(h @ q.to(dt)) * s``, as
    in the JAX package (exact algebra for per-output-channel scales; int8
    values are exact in bf16).  The product is ``torch.matmul`` on a
    ``dt`` copy of the int8 weights: XLA folds that convert into the
    product's operand read, torch writes the copy and reads it back.

    ``out_dtype`` (a tensor-parallel partial: float32): the int4 kernel
    writes its float32 sum unrounded; the other products are cast."""
    if key + "_p" in lp:
        B, T, D = h.shape
        y = matmul_int4(h.reshape(B * T, D).contiguous(), lp[key + "_p"],
                        lp[key + "_s"], out_dtype=out_dtype)
        return y.reshape(B, T, -1)
    if key + "_q" in lp:
        y = (h @ lp[key + "_q"].to(dt)) * lp[key + "_s"].to(dt)
    else:
        y = h @ lp[key].to(dt)
    return y if out_dtype is None else y.to(out_dtype)


def _lm_head(params: Dict, x, dt):
    if "lm_head_q" in params:
        # scale after the product; f32 scales promote the output to f32
        y = x @ params["lm_head_q"].to(dt)
        return y.to(torch.float32) * params["lm_head_s"]
    if "lm_head_p" in params:
        # f32 output: logits must not round through bf16 — near-tie greedy
        # argmax has to match the dense path's precision
        B, T, D = x.shape
        y = matmul_int4(x.reshape(B * T, D).contiguous(), params["lm_head_p"],
                        params["lm_head_s"], out_dtype=torch.float32)
        return y.reshape(B, T, -1)
    return (x @ params["lm_head"].to(dt)).to(torch.float32)


def _rmsnorm(x, w, eps):
    x32 = x.to(torch.float32)
    inv = torch.reciprocal(torch.sqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps))
    return (x32 * inv).to(x.dtype) * w.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding, rotate-half, f32 angles.  x: [B, T, H, D_head];
    positions: [B, T] or [T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * freqs  # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn(cfg: LlamaConfig, lp, x, positions, kv=None,
          pos_offset: Union[int, torch.Tensor, None] = None, paged=None,
          out_dtype=None):
    """The attention half of one transformer block (:func:`_block` says
    what ``kv``, ``pos_offset`` and ``paged`` are): its o-projection's
    output before the residual add, which under tensor parallelism is the
    slot's partial of it (``out_dtype`` float32: see :func:`_block_tp`)."""
    B, T, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    h = _rmsnorm(x, lp["ln_attn"], cfg.norm_eps)
    if "wqkv_p" in lp:  # int4 fused q|k|v (one kernel call per layer)
        qkv = _mm(h, lp, "wqkv", dt)
        q = qkv[..., :H * hd].reshape(B, T, H, hd)
        k = qkv[..., H * hd:(H + Hkv) * hd].reshape(B, T, Hkv, hd)
        v = qkv[..., (H + Hkv) * hd:].reshape(B, T, Hkv, hd)
    else:
        q = _mm(h, lp, "wq", dt).reshape(B, T, H, hd)
        k = _mm(h, lp, "wk", dt).reshape(B, T, Hkv, hd)
        v = _mm(h, lp, "wv", dt).reshape(B, T, Hkv, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    v = v.contiguous()

    if paged is not None:
        # suffix rows go to their (block, offset) first, then the row
        # attends its context through the tables
        k_pool, v_pool = kv
        tables, blk, off, lens = paged
        k_pool[blk, off] = k.to(k_pool.dtype)
        v_pool[blk, off] = v.to(v_pool.dtype)
        attn = paged_attention(q, k_pool, v_pool, tables, lens).to(dt)
    elif kv is None or isinstance(pos_offset, int):
        if kv is not None:
            kv[0][:, :T] = k.to(kv[0].dtype)
            kv[1][:, :T] = v.to(kv[1].dtype)
        # the int 0 means "prefill into an empty cache": the fresh
        # k/v ARE the filled cache rows, so attention reduces to causal
        # attention over the prompt — the flash kernel's case — instead of
        # a masked sweep over all S_max cache rows.  K/V go in UNREPEATED:
        # the kernel shares each K/V tile across the query-head group.
        attn = flash_attention(q, k, v, causal=True)
    else:
        # the position is a tensor on the card, read there (the JAX
        # package's dynamic_update_slice at a traced pos_offset): one
        # captured step serves every position
        k_cache, v_cache = kv
        q_pos = pos_offset + torch.arange(T, device=x.device)  # [T]
        k_cache.index_copy_(1, q_pos, k.to(k_cache.dtype))
        v_cache.index_copy_(1, q_pos, v.to(v_cache.dtype))
        kr = repeat_kv_heads(k_cache.to(dt), H // Hkv)
        vr = repeat_kv_heads(v_cache.to(dt), H // Hkv)
        S = kr.shape[1]
        k_pos = torch.arange(S, device=x.device)
        mask = (k_pos[None, None, :] <= q_pos[None, :, None])[:, None]
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                         kr.to(torch.float32))
        s = s * (1.0 / np.sqrt(hd))
        s = s.masked_fill(~mask, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        attn = torch.einsum("bhqk,bkhd->bqhd", p.to(dt), vr)

    return _mm(attn.reshape(B, T, H * hd), lp, "wo", dt, out_dtype)


def _mlp(cfg: LlamaConfig, lp, x, out_dtype=None):
    """The FFN half of one transformer block: its down-projection's
    output, before the residual add."""
    dt = x.dtype
    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    if "wgu_p" in lp:  # int4 fused gate|up
        F_ = lp["wgu_p"].shape[-1] // 2
        gu = _mm(h, lp, "wgu", dt)
        gate = F.silu(gu[..., :F_])
        up = gu[..., F_:]
    else:
        gate = F.silu(_mm(h, lp, "w_gate", dt))
        up = _mm(h, lp, "w_up", dt)
    return _mm(gate * up, lp, "w_down", dt, out_dtype)


def _block(cfg: LlamaConfig, lp, x, positions, kv=None,
           pos_offset: Union[int, torch.Tensor, None] = None, paged=None):
    """One transformer block.  ``kv=(k_cache, v_cache)`` ([B, S_max, Hkv,
    hd] each) enables cached decode: x is the new suffix, written into the
    caches in place at ``pos_offset`` (the Python int 0: prefill into an
    empty cache; else a 0-d int64 tensor on x's device, the position the
    suffix starts at).  ``paged=(tables, blk, off, lens)``
    switches ``kv`` to one layer of the block pool ([n_blocks + 1, bs,
    Hkv, hd]): the suffix row (b, t) is written at pool block
    ``blk[b, t]``, offset ``off[b, t]``, then attended through the tables
    (:func:`forward_paged` computes all four once per step)."""
    x = x + _attn(cfg, lp, x, positions, kv, pos_offset, paged)
    return x + _mlp(cfg, lp, x)


def _layer(params: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in params["layers"].items()}


# -- tensor parallelism over a mesh's model axis ----------------------------

def param_pspecs(quant="") -> Dict:
    """The tree's specs over the ``model`` mesh axis (the JAX package's
    Megatron layout): q/k/v and gate/up cut on their output axis, o and
    down on their input axis, the lm_head on the vocabulary; embed and
    norms whole.  ``quant="int8"`` / ``"int4"`` give the specs of those
    trees (a scale follows its mat's output axis; an input-cut mat's
    scales stay whole).  The int4 fused groups name ``model`` on the fused
    axis, as in the JAX package; :func:`place_tp` cuts them per member."""
    from ..parallel.sharding import P

    q = _quant_mode(quant if quant is not True else "int8")
    if not q:
        return {
            "embed": P(None, None),
            "layers": {
                "wq": P(None, None, "model"),
                "wk": P(None, None, "model"),
                "wv": P(None, None, "model"),
                "wo": P(None, "model", None),
                "w_gate": P(None, None, "model"),
                "w_up": P(None, None, "model"),
                "w_down": P(None, "model", None),
                "ln_attn": P(None, None),
                "ln_mlp": P(None, None),
            },
            "ln_out": P(None),
            "lm_head": P(None, "model"),
        }
    if q == "int4":
        out_sharded = {"wqkv": True, "wo": False, "wgu": True, "w_down": False}
        suffix = "_p"
    else:
        out_sharded = {"wq": True, "wk": True, "wv": True, "wo": False,
                       "w_gate": True, "w_up": True, "w_down": False}
        suffix = "_q"
    lay = {"ln_attn": P(None, None), "ln_mlp": P(None, None)}
    for k, on_out in out_sharded.items():
        lay[k + suffix] = (P(None, None, "model") if on_out
                           else P(None, "model", None))
        lay[k + "_s"] = (P(None, None, "model") if on_out
                         else P(None, None, None))
    return {
        "embed": P(None, None),
        "layers": lay,
        "ln_out": P(None),
        "lm_head" + suffix: P(None, "model"),
        "lm_head_s": P(None, "model"),
    }


def cache_pspecs() -> Dict:
    """The dense KV cache ``[L, B, S_max, Hkv, hd]`` cut by kv head."""
    from ..parallel.sharding import P

    return {"k": P(None, None, None, "model", None),
            "v": P(None, None, None, "model", None)}


def paged_cache_pspecs() -> Dict:
    """The block pool ``[L, n_blocks + 1, bs, Hkv, hd]`` cut by kv head:
    a ``model_parallel=M`` loop holds ``pool_bytes / M`` per slot.  Each
    slot's pool is a tensor of its own (:func:`init_paged_cache`), never
    a strided view: the paged kernel reads it through TMA maps."""
    from ..parallel.sharding import P

    return {"k": P(None, None, None, "model"), "v": P(None, None, None, "model")}


def tp_divisibility_problems(cfg: LlamaConfig, tp: int) -> List[str]:
    """Dims that ``tp``-way tensor parallelism cannot split evenly (empty
    when the geometry is clean): the one home of the arithmetic the
    filter's open error and the deep lint's ``model-divisibility`` share."""
    if tp <= 1:
        return []
    probs: List[str] = []
    if (cfg.n_heads * cfg.head_dim) % tp:
        probs.append(f"attention out dim n_heads*head_dim="
                     f"{cfg.n_heads * cfg.head_dim}")
    if (cfg.n_kv_heads * cfg.head_dim) % tp:
        probs.append(f"kv out dim n_kv_heads*head_dim="
                     f"{cfg.n_kv_heads * cfg.head_dim}")
    if cfg.ffn_hidden % tp:
        probs.append(f"ffn_hidden={cfg.ffn_hidden}")
    if cfg.vocab % tp:
        probs.append(f"vocab={cfg.vocab} (lm_head out)")
    if cfg.n_kv_heads % tp:
        probs.append(f"n_kv_heads={cfg.n_kv_heads} "
                     "(the KV cache/pool shards the head axis)")
    return probs


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """One shard's geometry: ``1/tp`` of the heads, kv heads and FFN
    columns at the same head dim (``dim`` is cut with the heads so that
    ``head_dim`` stays; the residual stream keeps the full width)."""
    return dataclasses.replace(cfg, dim=cfg.dim // tp, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               ffn_hidden=cfg.ffn_hidden // tp)


class TPParams:
    """A parameter tree cut over the slots of one model group
    (:func:`place_tp`): ``shards[s]`` is slot ``s``'s tree, on
    ``devices[s]``; ``local`` is the shard geometry.  Slot 0 is the root:
    the residual stream, the embedding lookup, the final norm and the
    gathered logits live on its device."""

    def __init__(self, shards: List[Dict], devices: Sequence[torch.device],
                 cfg: LlamaConfig):
        self.shards = shards
        self.devices = [torch.device(d) for d in devices]
        self.cfg = cfg
        self.ways = len(shards)
        self.local = shard_config(cfg, self.ways)
        #: every slot on one device: a step over all of them is one stream
        self.one_device = len({str(d) for d in self.devices}) == 1

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    def on(self, s: int):
        """Slot ``s``'s device as the current CUDA device (kernel wrappers
        launch on the current device) where the slots span cards."""
        if self.one_device or self.devices[s].type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.devices[s])

    def to(self, x: torch.Tensor, s: int) -> torch.Tensor:
        d = self.devices[s]
        return x if x.device == d else x.to(d)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        from ..parallel.sharding import fixed_order_sum

        return fixed_order_sum(parts, self.root)

    def leaves(self):
        """``(path, [tensor per slot])`` for every leaf."""
        def walk(trees, path):
            if isinstance(trees[0], dict):
                for k in trees[0]:
                    yield from walk([t[k] for t in trees],
                                    f"{path}.{k}" if path else k)
            else:
                yield path, trees

        yield from walk(self.shards, "")


def _cut(t: torch.Tensor, axis: int, s: int, ways: int) -> torch.Tensor:
    n = t.shape[axis] // ways
    return t.narrow(axis, s * n, n)


def _cut_groups(t: torch.Tensor, sizes: Sequence[int], s: int, ways: int) -> torch.Tensor:
    """Shard ``s`` of a mat fused on its last axis from members of
    ``sizes``: each member cut by itself, the pieces side by side."""
    out, start = [], 0
    for n in sizes:
        out.append(_cut(t.narrow(-1, start, n), -1, s, ways))
        start += n
    return torch.cat(out, dim=-1)


def _cut_packed_rows(p: torch.Tensor, s: int, ways: int) -> torch.Tensor:
    """Shard ``s`` of an int4 mat cut on its input axis: the packed rows
    hold rows ``r`` and ``r + Din/2`` in one byte, so the mat is unpacked,
    its logical rows ``[s*Din/ways, (s+1)*Din/ways)`` cut and packed
    again (``ops/int4_matmul.pack_int4``'s layout) on the last two axes."""
    t32 = p.to(torch.int32)
    full = torch.cat([(t32 & 15) - 8, t32 >> 4], dim=-2)  # [..., Din, F]
    rows = _cut(full, -2, s, ways)
    h = rows.shape[-2] // 2
    lo, hi = rows.narrow(-2, 0, h), rows.narrow(-2, h, h)
    return (((hi & 0xF) << 4) | ((lo + 8) & 0xF)).to(torch.uint8).view(torch.int8)


def place_tp(params: Dict, cfg: LlamaConfig,
             devices: Sequence[torch.device]) -> TPParams:
    """``params`` (the bf16 / float, ``quant:int8`` or ``quant:int4``
    tree) cut over ``devices``, one slot each, by :func:`param_pspecs`:
    output-cut mats by whole heads or FFN columns, the int4 fused groups
    member by member (``[q_s | k_s | v_s]``, ``[gate_s | up_s]``), int4
    input-cut mats repacked, input-cut mats' scales and every replicated
    leaf whole (the same tensor on the tree's device).  Raises
    ``ValueError`` naming the dims that do not divide."""
    ways = len(devices)
    probs = tp_divisibility_problems(cfg, ways)
    if probs:
        raise ValueError(f"model geometry does not divide model_parallel="
                         f"{ways}: " + "; ".join(probs))
    H, Hkv, hd, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_hidden
    groups = {"wqkv": (H * hd, Hkv * hd, Hkv * hd), "wgu": (F_, F_)}
    lay = params["layers"]
    shards = []
    for s, dev in enumerate(devices):
        dev = torch.device(dev)

        def put(t):  # a cut: a contiguous tensor of its own on dev
            if t.device != dev:
                return t.to(dev).contiguous()
            return t.clone(memory_format=torch.contiguous_format)

        def fresh(t):  # already a tensor of its own
            return t if t.device == dev else t.to(dev)

        whole = fresh

        out_lay: Dict = {}
        for key, t in lay.items():
            name, _, kind = key.rpartition("_")
            if kind not in ("p", "q", "s"):
                name, kind = key, ""
            if key in ("ln_attn", "ln_mlp"):
                out_lay[key] = whole(t)
            elif name in groups:  # int4 fused q|k|v, gate|up (and scales)
                out_lay[key] = fresh(_cut_groups(t, groups[name], s, ways))
            elif name in ("wo", "w_down"):
                if kind == "p":
                    out_lay[key] = fresh(_cut_packed_rows(t, s, ways))
                elif kind == "s":
                    out_lay[key] = whole(t)
                else:
                    out_lay[key] = put(_cut(t, 1, s, ways))
            else:  # wq wk wv w_gate w_up (full, _q or _s): output columns
                out_lay[key] = put(_cut(t, -1, s, ways))
        tree = {"embed": whole(params["embed"]), "layers": out_lay,
                "ln_out": whole(params["ln_out"])}
        for key in ("lm_head", "lm_head_q", "lm_head_p", "lm_head_s"):
            if key in params:
                tree[key] = put(_cut(params[key], -1, s, ways))
        shards.append(tree)
    return TPParams(shards, devices, cfg)


def _lm_head_tp(tp: TPParams, x: torch.Tensor, dt) -> torch.Tensor:
    """Each slot's vocabulary columns, gathered on the root in slot order."""
    parts = []
    for s in range(tp.ways):
        with tp.on(s):
            parts.append(_lm_head(tp.shards[s], tp.to(x, s), dt))
    return torch.cat([tp.to(p, 0) for p in parts], dim=-1)


def _block_tp(tp: TPParams, i: int, x, slot_args) -> torch.Tensor:
    """One block over the model group: each slot's heads, the partials
    of the o-projection summed in slot order, then each slot's FFN
    columns, the down-projection's partials summed likewise.  The
    partials are float32 (the int4 kernel's sums unrounded) and their
    sum rounds once to the compute dtype, as the unsharded product's
    float32 accumulation does.  ``slot_args(s)`` gives slot ``s``'s
    ``(positions, kv, pos_offset, paged)``."""
    f32 = torch.float32
    parts = []
    for s in range(tp.ways):
        with tp.on(s):
            pos_s, kv, po, paged = slot_args(s)
            parts.append(_attn(tp.local, _layer(tp.shards[s], i), tp.to(x, s),
                               pos_s, kv, po, paged, out_dtype=f32))
    x = x + tp.sum(parts).to(x.dtype)
    parts = []
    for s in range(tp.ways):
        with tp.on(s):
            parts.append(_mlp(tp.local, _layer(tp.shards[s], i), tp.to(x, s),
                              out_dtype=f32))
    return x + tp.sum(parts).to(x.dtype)


def _to_slot(tp: TPParams, v, s: int):
    return tp.to(v, s) if isinstance(v, torch.Tensor) else v


def forward(params, tokens, cfg: LlamaConfig, compute_dtype="bfloat16"):
    """Full-sequence forward -> logits [B, T, vocab] f32 (a
    :class:`TPParams` runs tensor-parallel)."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    tp = params if isinstance(params, TPParams) else None
    root = tp.shards[0] if tp is not None else params
    x = root["embed"][tokens].to(dt)
    positions = torch.arange(T, device=x.device)
    for i in range(cfg.n_layers):
        if tp is not None:
            x = _block_tp(tp, i, x, lambda s: (_to_slot(tp, positions, s),
                                               None, None, None))
        else:
            x = _block(cfg, _layer(params, i), x, positions)
    x = _rmsnorm(x, root["ln_out"], cfg.norm_eps)
    return _lm_head_tp(tp, x, dt) if tp is not None else _lm_head(params, x, dt)


def init_cache(cfg: LlamaConfig, batch: int, dtype="bfloat16", *, device,
               tp: Optional[TPParams] = None):
    """KV cache: k/v of [L, B, S_max, H_kv, head_dim].  With ``tp``: one
    such dict per slot at the shard's kv heads, on the slot's device."""
    if tp is not None:
        return [init_cache(tp.local, batch, dtype, device=d) for d in tp.devices]
    shape = (cfg.n_layers, batch, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def forward_cached(params, tokens, cache, pos_offset: Union[int, torch.Tensor],
                   cfg: LlamaConfig, compute_dtype="bfloat16"):
    """Forward a suffix with the KV cache -> (logits [B, T, vocab] f32,
    cache).  The suffix's K/V rows are written into ``cache`` in place,
    and the same dict is returned.

    ``pos_offset``: the Python int 0 is prefill into an empty cache
    (causal flash attention over the suffix alone, the JAX package's
    ``type(pos_offset) is int and pos_offset == 0``); a 0-d int64 tensor
    on the tokens' device is the position of the suffix's first row,
    written with ``index_copy_`` and attended through a masked sweep of
    the cache, all on the card (a captured decode step advances it in
    place).  Any other int is taken as that tensor.  A :class:`TPParams`
    runs tensor-parallel over its per-slot ``cache`` list
    (:func:`init_cache` with ``tp=``)."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    tp = params if isinstance(params, TPParams) else None
    root = tp.shards[0] if tp is not None else params
    x = root["embed"][tokens].to(dt)
    if isinstance(pos_offset, int) and pos_offset != 0:
        pos_offset = torch.full((), pos_offset, dtype=torch.long, device=x.device)
    positions = pos_offset + torch.arange(T, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        if tp is not None:
            x = _block_tp(tp, i, x, lambda s: (
                _to_slot(tp, positions, s), (cache[s]["k"][i], cache[s]["v"][i]),
                _to_slot(tp, pos_offset, s), None))
        else:
            x = _block(cfg, _layer(params, i), x, positions,
                       kv=(cache["k"][i], cache["v"][i]), pos_offset=pos_offset)
    x = _rmsnorm(x, root["ln_out"], cfg.norm_eps)
    logits = _lm_head_tp(tp, x, dt) if tp is not None else _lm_head(params, x, dt)
    return logits, cache


# -- block-paged KV pool (continuous serving) -------------------------------

def init_paged_cache(cfg: LlamaConfig, n_blocks: int, block_size: int,
                     dtype="bfloat16", *, device, tp: Optional[TPParams] = None):
    """Block-pool KV cache: k/v of [L, n_blocks + 1, block_size, H_kv,
    head_dim] on ``device``.

    Blocks ``0 .. n_blocks - 1`` are the pool of the JAX package's
    ``init_paged_cache``.  The one extra block, index ``n_blocks`` (the
    block tables' sentinel), takes the writes the JAX package DROPS (a
    parked row, a position past the row's reservation): torch has no
    dropping scatter, and a masked write would cost a host sync per layer.
    No table entry of a live position ever points at it.

    With ``tp``: one such dict per slot at the shard's kv heads, each a
    tensor of its own on the slot's device (:func:`paged_cache_pspecs`)."""
    if tp is not None:
        return [init_paged_cache(tp.local, n_blocks, block_size, dtype, device=d)
                for d in tp.devices]
    shape = (cfg.n_layers, n_blocks + 1, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_cache_bytes(cfg: LlamaConfig, n_blocks: int, block_size: int,
                      dtype="bfloat16") -> int:
    """Footprint of the ``n_blocks`` pool blocks of
    :func:`init_paged_cache` (k + v), by arithmetic — the JAX package's
    figure; the write-sink block adds one block more."""
    itemsize = 2 if str(dtype) in ("bfloat16", "float16") else 4
    return (2 * cfg.n_layers * n_blocks * block_size * cfg.n_kv_heads
            * cfg.head_dim * itemsize)


def _context_lens(p: torch.Tensor, T: int, span: int) -> torch.Tensor:
    """Positions attendable per row including the T-row suffix; 0 for a
    parked row (the kernel then reads none of its blocks)."""
    return torch.where(p + T <= span, p + T, torch.zeros_like(p)).to(torch.int32)


def forward_paged(params, tokens, pool, block_tables, pos, cfg: LlamaConfig,
                  compute_dtype="bfloat16", logit_off: Optional[int] = None):
    """Forward a suffix against the block-paged KV pool -> (logits
    [B, T, vocab] f32, pool).

    ``tokens``: [B, T] (T == 1 for a decode step of every slot; B == 1
    with T == prefill_chunk for a chunked-prefill step); ``pool``: the
    :func:`init_paged_cache` dict, written IN PLACE (the same dict is
    returned); ``block_tables``: [B, max_blocks] int32 on the pool's
    device (entry ``n_blocks`` = unallocated sentinel); ``pos``: [B] —
    the position token 0 of each row writes at, a tensor on the card or
    values on the host.  A parked row (``pos >= max_blocks *
    block_size``) writes only the sink block and attends nothing.  A
    T > 1 step that :func:`~..ops.attention.paged_route` sends through
    gathered flash (a prefill chunk) needs its positions on the host:
    they size the row's gather (a card tensor is read back once); one
    that takes the paged kernel (B > 1 rows of a verify step) reads them
    on the card.

    ``logit_off``: return logits for ONLY that suffix position — [B, 1,
    vocab]; a chunked-prefill step needs the last real token's logits,
    and slicing before the lm_head keeps it at one row.

    A :class:`TPParams` runs tensor-parallel over its per-slot ``pool``
    list (:func:`init_paged_cache` with ``tp=``): the tables, positions
    and lengths are computed once on the root slot, each slot attends its
    own kv heads."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    dev = tokens.device
    tp = params if isinstance(params, TPParams) else None
    root = tp.shards[0] if tp is not None else params
    pool0 = pool[0] if tp is not None else pool
    x = root["embed"][tokens].to(dt)
    sink = pool0["k"].shape[1] - 1  # == n_blocks, the tables' sentinel
    bs = pool0["k"].shape[2]
    span = block_tables.shape[1] * bs
    p = torch.as_tensor(pos, dtype=torch.long).reshape(-1)
    pd = p if p.device == dev else upload(p, dev)
    idx = pd[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    valid = (idx >= 0) & (idx < span)
    slot_blk = torch.clamp(idx // bs, 0, block_tables.shape[1] - 1)
    blk = torch.where(valid, block_tables.to(torch.long).gather(1, slot_blk),
                      torch.full_like(idx, sink)).clamp_(0, sink)
    off = idx % bs
    # the lengths stay on the card where the paged kernel reads them (a
    # decode or verify step, which a captured step needs); a step that
    # gathers row by row (a prefill chunk) sizes its gathers on the host
    on_card = T == 1 or (dev.type == "cuda" and paged_route(
        B, T, cfg.n_heads // cfg.n_kv_heads) == "kernel")
    lens = _context_lens(pd if on_card else p.cpu(), T, span)
    if tp is not None:
        # each slot's copy of the step's indices (the same tensors where
        # the slots share a device)
        per = [tuple(_to_slot(tp, v, s) if v.device.type != "cpu" else v
                     for v in (idx, block_tables, blk, off, lens))
               for s in range(tp.ways)]
    for i in range(cfg.n_layers):
        if tp is not None:
            x = _block_tp(tp, i, x, lambda s: (
                per[s][0], (pool[s]["k"][i], pool[s]["v"][i]), None,
                per[s][1:]))
        else:
            x = _block(cfg, _layer(params, i), x, idx,
                       kv=(pool["k"][i], pool["v"][i]),
                       paged=(block_tables, blk, off, lens))
    x = _rmsnorm(x, root["ln_out"], cfg.norm_eps)
    if logit_off is not None:
        x = x[:, int(logit_off):int(logit_off) + 1]
    logits = _lm_head_tp(tp, x, dt) if tp is not None else _lm_head(params, x, dt)
    return logits, pool


def filter_logits(logits, temperature: float, top_k: int = 0,
                  top_p: float = 1.0):
    """The sampler chain's logit filters: [.., vocab] -> [.., vocab].

    ``temperature`` scales, ``top_k`` (0 = off) keeps the k highest
    logits, ``top_p`` (1.0 = off) keeps the smallest set whose probability
    mass reaches p (nucleus; the top token always survives); masked
    positions go to -inf.  Caller must have temperature > 0.
    """
    logits = logits / temperature
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sort = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sort, dim=-1)
        cut = ((torch.cumsum(probs, dim=-1) - probs) >= top_p) \
            & (torch.arange(sort.shape[-1], device=logits.device) > 0)
        kept = torch.where(cut, torch.full_like(sort, float("inf")), sort)
        thresh = kept.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    return logits


def _draw(probs, generator: Optional[torch.Generator]):
    """One draw per row of ``probs`` [.., vocab] -> ids [..] int32: the
    argmax of ``probs / q``, q ~ Exp(1), which is what ``torch.multinomial``
    computes for one sample (the same draws from the same generator
    state), without its host-side checks of the probabilities: those read
    the card, which a captured step cannot."""
    q = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def draw_per_slot(probs, generators: Sequence[torch.Generator]):
    """probs [B, vocab] -> ids [B] int32: row i drawn with ``generators[i]``
    (:func:`_draw`), so that a row's draw depends only on its own
    generator and probabilities."""
    return torch.stack([_draw(probs[i], gen) for i, gen in enumerate(generators)])


def sample_token(logits, generator: Optional[torch.Generator],
                 temperature: float, top_k: int = 0, top_p: float = 1.0):
    """logits [B, vocab] -> token ids [B] int32.  Greedy (argmax, first
    index on ties) at ``temperature <= 0``; else one draw per row from
    ``softmax(filter_logits(...))`` with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(
        filter_logits(logits, temperature, top_k, top_p).to(torch.float32), dim=-1)
    return _draw(probs, generator)


def sample_token_per_slot(logits, generators: Sequence[torch.Generator],
                          temperature: float, top_k: int = 0,
                          top_p: float = 1.0, live: Optional[torch.Tensor] = None):
    """logits [B, vocab] + one generator per row -> token ids [B] int32.

    The continuous-serving sampler: greedy (argmax) at ``temperature <=
    0``; else each row draws once from its own ``softmax(filter_logits(
    ...))`` with its own generator, so a stream's tokens depend only on
    its own generator and logits, whoever shares the batch.  ``live``
    ([B] bool on the logits' device) keeps the draws of its True rows;
    the others draw all the same (a captured step draws the same way
    every time) and take the argmax."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature <= 0.0:
        return tok
    probs = torch.softmax(
        filter_logits(logits, temperature, top_k, top_p).to(torch.float32), dim=-1)
    drawn = draw_per_slot(probs, generators)
    return drawn if live is None else torch.where(live, drawn, tok)


# -- model files -------------------------------------------------------------

#: HF linear names of the seven layer mats (``model.layers.N.<name>.weight``)
_HF_MATS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
            "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
            "w_down": "mlp.down_proj"}
#: llama.cpp names of the same mats (``blk.N.<name>.weight``)
_GGUF_MATS = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
              "wo": "attn_output", "w_gate": "ffn_gate", "w_up": "ffn_up",
              "w_down": "ffn_down"}


def _resolve_param_dtype(dtype) -> torch.dtype:
    """ONE home for the checkpoint param-dtype rule: load_checkpoint and
    the gguf path must never drift apart here."""
    return torch_dtype(dtype)


def _rope_permute(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """ggml/Meta interleaved-pair RoPE layout -> rotate-half layout (the
    permutation HF applies converting Meta checkpoints; :func:`_rope` is
    rotate-half).  ``w``: [n_heads*head_dim, in_features]."""
    out, dim2 = w.shape
    hd = out // n_heads
    return w.reshape(n_heads, hd // 2, 2, dim2).transpose(1, 2).reshape(out, dim2)


def _on_device(t: torch.Tensor, device, dt, *, transpose=False,
               heads: Optional[int] = None) -> torch.Tensor:
    """One file tensor (a CPU view of the memmap) on ``device`` at ``dt``:
    copied over at its file dtype, then un-permuted (``heads``) and
    transposed there — both exact — and cast."""
    x = t.to(device)
    if heads is not None:
        x = _rope_permute(x, heads)
    if transpose:
        x = x.t()
    return x.to(dt).contiguous()


def _want_shapes(cfg: LlamaConfig) -> Dict:
    shapes = _mat_shapes(cfg)
    want = {"embed": (cfg.vocab, cfg.dim), "lm_head": (cfg.dim, cfg.vocab)}
    want.update({"layers." + m: (cfg.n_layers,) + shapes[m] for m in _QUANT_MATS})
    return want


def _checked(t: torch.Tensor, name: str, want: tuple, path: str) -> torch.Tensor:
    """``t`` if its shape is ``want`` (a layer mat: one layer of it)."""
    shape = tuple(t.shape)
    if len(want) == 3:
        shape, want = (want[0],) + shape, want
    if shape != want:
        raise ValueError(
            f"{path}: {name} has shape {shape}, config wants {want} — wrong "
            "config for this checkpoint?")
    return t


def _fill(cfg: LlamaConfig, path: str, layer_mat, embed, lm_head, norm,
          quant: str, device) -> Dict:
    """The tree from a file's tensors, one matrix at a time
    (:func:`_assemble`): ``layer_mat(name, layer)`` and ``lm_head()`` give
    ``[in, out]`` weights on the device at the param dtype, ``embed`` the
    table there, ``norm(key, layer)`` an f32 norm weight."""
    want = _want_shapes(cfg)
    dev = torch.device(device)
    _checked(embed, "embed", want["embed"], path)
    layers, head = _assemble(
        cfg, lambda m, li: _checked(layer_mat(m, li), "layers." + m,
                                    want["layers." + m], path),
        lambda: _checked(lm_head(), "lm_head", want["lm_head"], path),
        quant, dev)
    for key in ("ln_attn", "ln_mlp"):
        layers[key] = torch.stack([norm(key, li) for li in range(cfg.n_layers)])
    return {"embed": embed, "layers": layers, "ln_out": norm("ln_out", None),
            **head}


def load_checkpoint(path: str, cfg: Optional[LlamaConfig] = None,
                    dtype="bfloat16", *, device, quant: str = ""):
    """Fill the tree layout from a REAL checkpoint file, on ``device``.

    ``path``: a ``.safetensors`` file, a HF sharded checkpoint directory /
    ``*.safetensors.index.json``, an ``.npz`` (models/checkpoint.py), or a
    llama.cpp ``.gguf`` (models/gguf.py — F32/F16/BF16, config from the
    ``llama.*`` metadata keys, RoPE layout converted).  Accepts HF
    ``model.layers.N.self_attn.q_proj.weight`` naming (weights transposed
    from [out, in] linear layout to this module's [in, out] layout) or
    this module's own stacked naming (``layers.wq`` etc., the npz
    round-trip).  Per-layer tensors are stacked on the leading layer axis.

    The file is streamed: each matrix goes from its memmap to ``device``
    at its file dtype, is transposed or un-permuted there, cast to
    ``dtype`` and, with ``quant`` ("int4", "int8"), quantized before the
    next is read, so the peak is the finished tree plus one matrix.  The
    result equals the JAX package's ``load_checkpoint`` (then
    ``_apply_quant``) leaf for leaf.

    ``cfg=None`` reads a HF ``config.json`` next to the checkpoint;
    without one, dims are inferred from tensor shapes with head_dim
    assumed 128 (the Llama convention).  Returns ``(params, cfg)``;
    norms stay f32.
    """
    from . import checkpoint as ckpt

    dt = _resolve_param_dtype(dtype)
    quant = _quant_mode(quant)
    if path.endswith(".gguf"):
        params, cfg, _tok = _load_gguf(path, cfg, dt, device=device, quant=quant)
        return params, cfg
    tensors = ckpt.load_tensors(path)
    dev = torch.device(device)

    if "embed" in tensors and "layers.wq" in tensors:  # native stacked npz
        if cfg is None:
            cfg = _read_config_json(path) or _infer_config_native(tensors)
        params = _fill(
            cfg, path,
            lambda m, li: _on_device(tensors["layers." + m][li], dev, dt),
            _on_device(tensors["embed"], dev, dt),
            lambda: _on_device(tensors["lm_head"], dev, dt),
            lambda k, li: _on_device(
                tensors["layers." + k][li] if li is not None else tensors[k],
                dev, torch.float32),
            quant, dev)
        return params, cfg

    if cfg is None:
        cfg = _infer_config_hf(path, tensors)

    def get(name):
        if name not in tensors:
            raise ckpt.CheckpointError(
                f"{path}: missing tensor {name!r} "
                f"(have {len(tensors)} tensors, e.g. "
                f"{sorted(tensors)[:3]})")
        return tensors[name]

    norms = {"ln_attn": "model.layers.{}.input_layernorm.weight",
             "ln_mlp": "model.layers.{}.post_attention_layernorm.weight",
             "ln_out": "model.norm.weight"}
    embed = _on_device(get("model.embed_tokens.weight"), dev, dt)
    if "lm_head.weight" in tensors:
        def lm_head():
            return _on_device(get("lm_head.weight"), dev, dt, transpose=True)
    else:  # tied embeddings
        def lm_head():
            return embed.t().contiguous()
    params = _fill(
        cfg, path,
        lambda m, li: _on_device(get(f"model.layers.{li}.{_HF_MATS[m]}.weight"),
                                 dev, dt, transpose=True),
        embed, lm_head,
        lambda k, li: _on_device(get(norms[k].format(li)), dev, torch.float32),
        quant, dev)
    return params, cfg


def _load_gguf(path: str, cfg: Optional[LlamaConfig], dt, *, device,
               quant: str = ""):
    """llama.cpp GGUF -> (the stacked tree on ``device``, its config, the
    file's tokenizer or None), streamed as :func:`load_checkpoint`."""
    from . import gguf

    meta, tensors = gguf.read(path)
    dev = torch.device(device)

    def get(name):
        if name not in tensors:
            raise gguf.GGUFError(
                f"{path}: missing tensor {name!r} (have e.g. "
                f"{sorted(tensors)[:3]})")
        return tensors[name]

    if cfg is None:
        arch = str(meta.get("general.architecture", "llama"))

        def m(key, default=None):
            v = meta.get(f"{arch}.{key}", default)
            if v is None:
                raise gguf.GGUFError(
                    f"{path}: metadata {arch}.{key} missing and no cfg "
                    "given")
            return v

        vocab = get("token_embd.weight").shape[0]
        n_heads = int(m("attention.head_count"))
        ctx = int(m("context_length", 4096))
        if ctx > 8192:
            from ..core.log import logger

            logger(__name__).warning(
                "%s: clamping context_length %d to 8192 (KV-cache memory "
                "budget); pass custom=max_seq:%d to tensor_filter to "
                "raise it", path, ctx, ctx)
        cfg = LlamaConfig(
            vocab=vocab,
            dim=int(m("embedding_length")),
            n_layers=int(m("block_count")),
            n_heads=n_heads,
            n_kv_heads=int(m("attention.head_count_kv", n_heads)),
            ffn_hidden=int(m("feed_forward_length")),
            max_seq=min(ctx, 8192),
            rope_theta=float(m("rope.freq_base", 10000.0)),
            norm_eps=float(m("attention.layer_norm_rms_epsilon", 1e-5)),
        )

    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads}
    norms = {"ln_attn": "blk.{}.attn_norm.weight",
             "ln_mlp": "blk.{}.ffn_norm.weight", "ln_out": "output_norm.weight"}
    embed = _on_device(get("token_embd.weight"), dev, dt)
    if "output.weight" in tensors:
        def lm_head():
            return _on_device(get("output.weight"), dev, dt, transpose=True)
    else:  # tied embeddings
        def lm_head():
            return embed.t().contiguous()
    params = _fill(
        cfg, path,
        lambda mname, li: _on_device(get(f"blk.{li}.{_GGUF_MATS[mname]}.weight"),
                                     dev, dt, transpose=True,
                                     heads=heads.get(mname)),
        embed, lm_head,
        lambda k, li: _on_device(get(norms[k].format(li)), dev, torch.float32),
        quant, dev)
    # the vocab rode along in the SAME metadata parse
    tok = None
    if "tokenizer.ggml.tokens" in meta:
        from .tokenizer import SentencePieceTokenizer

        tok = SentencePieceTokenizer.from_gguf_meta(meta)
    return params, cfg, tok


def _read_config_json(path: str) -> Optional[LlamaConfig]:
    """HF-style config.json next to (or inside) ``path``, if present."""
    import json
    import os

    base = path if os.path.isdir(path) else os.path.dirname(path)
    cfg_path = os.path.join(base, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        c = json.load(f)
    return LlamaConfig(
        vocab=c["vocab_size"], dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c.get("num_key_value_heads",
                         c["num_attention_heads"]),
        ffn_hidden=c["intermediate_size"],
        max_seq=min(c.get("max_position_embeddings", 4096), 8192),
        rope_theta=float(c.get("rope_theta", 10000.0)),
        norm_eps=float(c.get("rms_norm_eps", 1e-5)),
    )


def _infer_config_hf(path: str, tensors: Dict) -> LlamaConfig:
    cfg = _read_config_json(path)
    if cfg is not None:
        return cfg
    # shape inference: head_dim is 128 by Llama convention
    from . import checkpoint as ckpt

    try:
        vocab, dim = tensors["model.embed_tokens.weight"].shape
        layer_ids = [int(k.split(".")[2]) for k in tensors
                     if k.startswith("model.layers.")]
        n_layers = 1 + max(layer_ids)
        ffn = tensors["model.layers.0.mlp.gate_proj.weight"].shape[0]
        kv_out = tensors["model.layers.0.self_attn.k_proj.weight"].shape[0]
    except (KeyError, ValueError) as e:
        raise ckpt.CheckpointError(
            f"{path}: not a Llama-family checkpoint (no config.json and "
            f"HF tensor names absent: {e}; have e.g. "
            f"{sorted(tensors)[:3]})") from e
    hd = 128 if dim % 128 == 0 and dim >= 128 else 64
    return LlamaConfig(vocab=vocab, dim=dim, n_layers=n_layers,
                       n_heads=dim // hd, n_kv_heads=kv_out // hd,
                       ffn_hidden=ffn)


def _infer_config_native(tensors: Dict) -> LlamaConfig:
    L, D, qout = tensors["layers.wq"].shape
    vocab = tensors["embed"].shape[0]
    F_ = tensors["layers.w_gate"].shape[2]
    kvout = tensors["layers.wk"].shape[2]
    hd = 128 if D % 128 == 0 and D >= 128 else 64
    if qout % hd:
        hd = qout  # degenerate tiny models: one head
    return LlamaConfig(vocab=vocab, dim=D, n_layers=L, n_heads=qout // hd,
                       n_kv_heads=kvout // hd, ffn_hidden=F_)


def hf_tensors(params: Dict, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_checkpoint`'s HF mapping: an unquantized
    stacked tree -> HF tensor names, mats as [out, in] views on the tree's
    device (made contiguous by the writer)."""
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["ln_out"],
           "lm_head.weight": params["lm_head"].t()}
    for i in range(cfg.n_layers):
        for k, name in _HF_MATS.items():
            out[f"model.layers.{i}.{name}.weight"] = lay[k][i].t()
        out[f"model.layers.{i}.input_layernorm.weight"] = lay["ln_attn"][i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = lay["ln_mlp"][i]
    return out


def export_hf(dirpath: str, params: Dict, cfg: LlamaConfig, shards: int = 2) -> None:
    """Write an unquantized tree as a HF checkpoint directory: ``shards``
    ``model-0000i-of-0000n.safetensors`` files (layers split evenly, the
    embedding in the first, the head and final norm in the last), their
    ``model.safetensors.index.json`` and a ``config.json``."""
    import json
    import os

    from . import checkpoint as ckpt

    tensors = hf_tensors(params, cfg)
    per = -(-cfg.n_layers // shards)

    def shard_of(name: str) -> int:
        if name.startswith("model.layers."):
            return int(name.split(".")[2]) // per
        return 0 if name.startswith("model.embed") else shards - 1

    names = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors" for i in range(shards)]
    weight_map = {k: names[shard_of(k)] for k in tensors}
    os.makedirs(dirpath, exist_ok=True)
    for i, fname in enumerate(names):
        ckpt.write_safetensors(os.path.join(dirpath, fname),
                               {k: v for k, v in tensors.items() if shard_of(k) == i})
    with open(os.path.join(dirpath, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump({
            "vocab_size": cfg.vocab, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.ffn_hidden,
            "max_position_embeddings": cfg.max_seq,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}, f)


# -- zoo builders ---------------------------------------------------------

def make_bundle(cfg: LlamaConfig, params: Dict, compute_dtype="bfloat16",
                name: str = "llama") -> ModelBundle:
    """A zoo bundle around a built parameter tree."""

    def apply_fn(params, tokens):
        return forward(params, tokens, cfg, compute_dtype=compute_dtype)

    # Token streams are variable-length: FLEXIBLE format, spec per buffer.
    in_spec = TensorsSpec.from_string("1:1", "int32").replace(
        format=TensorFormat.FLEXIBLE)
    out_spec = TensorsSpec.from_string(f"{cfg.vocab}:1:1", "float32").replace(
        format=TensorFormat.FLEXIBLE)
    return ModelBundle(apply_fn=apply_fn, params=params, in_spec=in_spec,
                       out_spec=out_spec, name=name, config=cfg)


def resolve_config(preset: str, opts: Dict[str, str]) -> Optional[LlamaConfig]:
    """Preset + ``custom=`` geometry overrides, without building weights (the
    deep lint prices a serving pool through it); None for a model that is
    not a preset (a file's config lives in the file, which a static pass
    does not open)."""
    if preset not in PRESETS:
        return None
    overrides = {f: int(opts[f]) for f in
                 ("vocab", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_hidden", "max_seq") if f in opts}
    cfg = PRESETS[preset]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def param_bytes_estimate(cfg: LlamaConfig, quant: str = "",
                         param_dtype: str = "float32") -> int:
    """The parameter tree's bytes by arithmetic, no weights built (the JAX
    package's figure): the seven layer matrices and the lm_head at the
    quant width (int8: 1 byte and f32 scales, int4: half a byte and f32
    scales, else the param dtype's), embed at the param dtype, norms at
    the param dtype's float32 (the JAX package keeps them f32)."""
    L, D, H, Hkv, F = (cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                       cfg.ffn_hidden)
    hd = cfg.head_dim
    big = L * (D * H * hd + 2 * D * Hkv * hd + H * hd * D + 2 * D * F + F * D)
    head = D * cfg.vocab
    out_channels = L * (H * hd + 2 * Hkv * hd + D + 2 * F + D)
    itemsize = 2 if str(param_dtype) in ("bfloat16", "float16") else 4
    q = str(quant).lower()
    if q == "int8":
        mats, scales = big + head, 4 * (out_channels + cfg.vocab)
    elif q == "int4":
        mats, scales = (big + head) // 2, 4 * (out_channels + cfg.vocab)
    else:
        mats, scales = (big + head) * itemsize, 0
    return mats + scales + cfg.vocab * D * itemsize + 4 * (2 * L * D + D)


def param_bytes_split(cfg: LlamaConfig, quant: str = "",
                      param_dtype: str = "float32") -> Tuple[int, int]:
    """``(cut, replicated)`` bytes of :func:`param_bytes_estimate` under
    :func:`param_pspecs` (the JAX package's split): the layer mats and the
    lm_head with their scales divide by the ``model`` width per slot,
    embed and norms are whole on each.  The deep lint prices a
    ``model_parallel=M`` pipeline's params per slot as ``cut / M +
    replicated``."""
    total = param_bytes_estimate(cfg, quant=quant, param_dtype=param_dtype)
    itemsize = 2 if str(param_dtype) in ("bfloat16", "float16") else 4
    replicated = cfg.vocab * cfg.dim * itemsize \
        + 4 * (2 * cfg.n_layers * cfg.dim + cfg.dim)
    return total - replicated, replicated


def _build(preset: str, opts: Dict[str, str], device: torch.device) -> ModelBundle:
    cfg = resolve_config(preset, opts)
    # param_dtype=bfloat16 draws weights at 2 bytes/param (the full-width
    # setting); the default float32 keeps the test presets' numerics.
    params = init_params(cfg, seed=int(opts.get("seed", 0)),
                         dtype=opts.get("param_dtype", "float32"),
                         device=device, quant=opts.get("quant", ""))
    return make_bundle(cfg, params, opts.get("dtype", "bfloat16"), preset)


def build_from_checkpoint(path: str, opts: Dict[str, str], *, device) -> ModelBundle:
    """Zoo entry for REAL weights: ``model=/path/llama.gguf`` (or
    ``.safetensors``, a HF directory, an ``.npz``).  Same bundle contract
    as the presets' builder, params from :func:`load_checkpoint` on
    ``device`` (quantized while streaming with ``quant:``);
    ``custom=param_dtype:...`` (default bfloat16) and ``max_seq:N`` apply.
    A GGUF's embedded vocab rides along as the bundle's tokenizer."""
    pdt = opts.get("param_dtype", "bfloat16")
    quant = opts.get("quant", "")
    tok = None
    if path.endswith(".gguf"):
        params, cfg, tok = _load_gguf(path, None, _resolve_param_dtype(pdt),
                                      device=device, quant=_quant_mode(quant))
    else:
        params, cfg = load_checkpoint(path, dtype=pdt, device=device, quant=quant)
    if "max_seq" in opts:
        cfg = dataclasses.replace(cfg, max_seq=int(opts["max_seq"]))
    bundle = make_bundle(cfg, params, opts.get("dtype", "bfloat16"), path)
    bundle.tokenizer = tok
    return bundle


for _name in PRESETS:
    register_model(_name, lambda opts, device, _p=_name: _build(_p, opts, device))
