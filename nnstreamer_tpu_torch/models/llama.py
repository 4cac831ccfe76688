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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

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


def init_params(cfg: LlamaConfig, seed: int = 0, dtype="float32", *,
                device, quant: str = "") -> Dict:
    """Deterministic-random params from a ``torch.Generator`` on ``device``
    (it cannot reproduce ``jax.random``; tests move JAX trees over with
    :func:`params_from_jax` instead).  Each weight is normal with std
    ``sqrt(2 / fan_in)``, drawn at ``dtype``.

    ``quant="int4"`` draws and quantizes one matrix of one layer at a
    time, so a full-width model never holds its full-precision tree:
    the peak is the packed tree plus one ``dtype`` matrix.
    """
    quant = str(quant or "").lower()
    if quant not in ("", "int4"):
        raise ValueError(f"quant {quant!r} is not yet ported (int4 only)")
    dev = torch.device(device)
    dt = torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return w * float(np.sqrt(2.0 / max(1, fan_in)))

    L, D = cfg.n_layers, cfg.dim
    shapes = _mat_shapes(cfg)
    params: Dict = {"embed": normal((cfg.vocab, D), D) * 0.5,
                    "ln_out": torch.ones(D, device=dev)}
    layers: Dict = {"ln_attn": torch.ones(L, D, device=dev),
                    "ln_mlp": torch.ones(L, D, device=dev)}
    if quant == "int4":
        for gname, members in _INT4_GROUPS:
            din = shapes[members[0]][0]
            width = sum(shapes[m][1] for m in members)
            packed = torch.empty((L, din // 2, width), dtype=torch.int8, device=dev)
            scale = torch.empty((L, 1, width), dtype=torch.float32, device=dev)
            for li in range(L):
                c = 0
                for m in members:
                    w = shapes[m][1]
                    packed[li, :, c:c + w], scale[li, :, c:c + w] = \
                        quantize_int4(normal(shapes[m], shapes[m][0]))
                    c += w
            layers[gname + "_p"] = packed
            layers[gname + "_s"] = scale
        params["lm_head_p"], params["lm_head_s"] = quantize_int4(
            normal((D, cfg.vocab), D))
    else:
        for m in _QUANT_MATS:
            layers[m] = normal((L,) + shapes[m], shapes[m][0])
        params["lm_head"] = normal((D, cfg.vocab), D)
    params["layers"] = layers
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


def _mm(h, lp: Dict, key: str, dt):
    """``h @ W`` for a layer dict that stores ``key`` full-precision or
    nibble-packed (``key_p``/``key_s``)."""
    if key + "_p" in lp:
        B, T, D = h.shape
        y = matmul_int4(h.reshape(B * T, D).contiguous(), lp[key + "_p"],
                        lp[key + "_s"])
        return y.reshape(B, T, -1)
    if key + "_q" in lp:
        raise ValueError("int8 weights are not yet ported (quant:int4 only)")
    return h @ lp[key].to(dt)


def _lm_head(params: Dict, x, dt):
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

    x = x + _mm(attn.reshape(B, T, H * hd), lp, "wo", dt)

    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    if "wgu_p" in lp:  # int4 fused gate|up
        F_ = lp["wgu_p"].shape[-1] // 2
        gu = _mm(h, lp, "wgu", dt)
        gate = F.silu(gu[..., :F_])
        up = gu[..., F_:]
    else:
        gate = F.silu(_mm(h, lp, "w_gate", dt))
        up = _mm(h, lp, "w_up", dt)
    return x + _mm(gate * up, lp, "w_down", dt)


def _layer(params: Dict, i: int) -> Dict:
    return {k: v[i] for k, v in params["layers"].items()}


def forward(params, tokens, cfg: LlamaConfig, compute_dtype="bfloat16"):
    """Full-sequence forward -> logits [B, T, vocab] f32."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(T, device=x.device)
    for i in range(cfg.n_layers):
        x = _block(cfg, _layer(params, i), x, positions)
    x = _rmsnorm(x, params["ln_out"], cfg.norm_eps)
    return _lm_head(params, x, dt)


def init_cache(cfg: LlamaConfig, batch: int, dtype="bfloat16", *, device):
    """KV cache: k/v of [L, B, S_max, H_kv, head_dim]."""
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
    place).  Any other int is taken as that tensor."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    x = params["embed"][tokens].to(dt)
    if isinstance(pos_offset, int) and pos_offset != 0:
        pos_offset = torch.full((), pos_offset, dtype=torch.long, device=x.device)
    positions = pos_offset + torch.arange(T, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x = _block(cfg, _layer(params, i), x, positions,
                   kv=(cache["k"][i], cache["v"][i]), pos_offset=pos_offset)
    x = _rmsnorm(x, params["ln_out"], cfg.norm_eps)
    return _lm_head(params, x, dt), cache


# -- block-paged KV pool (continuous serving) -------------------------------

def init_paged_cache(cfg: LlamaConfig, n_blocks: int, block_size: int,
                     dtype="bfloat16", *, device):
    """Block-pool KV cache: k/v of [L, n_blocks + 1, block_size, H_kv,
    head_dim] on ``device``.

    Blocks ``0 .. n_blocks - 1`` are the pool of the JAX package's
    ``init_paged_cache``.  The one extra block, index ``n_blocks`` (the
    block tables' sentinel), takes the writes the JAX package DROPS (a
    parked row, a position past the row's reservation): torch has no
    dropping scatter, and a masked write would cost a host sync per layer.
    No table entry of a live position ever points at it."""
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
    and slicing before the lm_head keeps it at one row."""
    dt = torch_dtype(compute_dtype)
    B, T = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens].to(dt)
    sink = pool["k"].shape[1] - 1  # == n_blocks, the tables' sentinel
    bs = pool["k"].shape[2]
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
    for i in range(cfg.n_layers):
        x = _block(cfg, _layer(params, i), x, idx,
                   kv=(pool["k"][i], pool["v"][i]),
                   paged=(block_tables, blk, off, lens))
    x = _rmsnorm(x, params["ln_out"], cfg.norm_eps)
    if logit_off is not None:
        x = x[:, int(logit_off):int(logit_off) + 1]
    return _lm_head(params, x, dt), pool


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


def resolve_config(preset: str, opts: Dict[str, str]) -> LlamaConfig:
    """Preset + ``custom=`` geometry overrides."""
    overrides = {f: int(opts[f]) for f in
                 ("vocab", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_hidden", "max_seq") if f in opts}
    cfg = PRESETS[preset]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _build(preset: str, opts: Dict[str, str], device: torch.device) -> ModelBundle:
    cfg = resolve_config(preset, opts)
    # param_dtype=bfloat16 draws weights at 2 bytes/param (the full-width
    # setting); the default float32 keeps the test presets' numerics.
    params = init_params(cfg, seed=int(opts.get("seed", 0)),
                         dtype=opts.get("param_dtype", "float32"),
                         device=device, quant=opts.get("quant", ""))
    return make_bundle(cfg, params, opts.get("dtype", "bfloat16"), preset)


for _name in PRESETS:
    register_model(_name, lambda opts, device, _p=_name: _build(_p, opts, device))
