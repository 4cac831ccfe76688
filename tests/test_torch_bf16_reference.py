"""The tolerance of chip_smoke.py's bf16 reference phase, on the CPU.

``chip_smoke.BF16_REF_TOL`` holds the card's bf16 llama_small logits to
the CPU's.  It must sit above what two bf16 evaluations that round in
different places disagree by, and below what an attention fault does at
every step.
Here both sides run on the CPU: the plain path against (a) the card's
rounding emulated (the int4 product accumulated in f32 and rounded once;
flash probabilities left unnormalised in bf16 before P·V, divided at the
end), (b) a dropped key tile and (c) a wrong kv head for half a group,
each injected into the prefill's flash attention.  The phase's steps are
reproduced: 40-token cached prefill, then 4 greedy decode steps fed the
plain path's tokens."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from nnstreamer_tpu_torch.models import llama  # noqa: E402
from nnstreamer_tpu_torch.ops import attention, int4_matmul  # noqa: E402

torch.set_num_threads(2)

CFG = llama.PRESETS["llama_small"]


def _int4_f32_accumulate(h, packed, scale, out_dtype=None):
    w = int4_matmul.unpack_int4(packed).float()
    return ((h.float() @ w) * scale).to(out_dtype or h.dtype)


def _flash_unnormalised(q, k, v, *, causal=False, scale=None):
    g = q.shape[2] // k.shape[2]
    k, v = attention.repeat_kv_heads(k, g), attention.repeat_kv_heads(v, g)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    s = s.masked_fill(torch.arange(sk)[None, :] > qpos, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


def _flash_dropped_tile(q, k, v, *, causal=False, scale=None):
    k, v = k.clone(), v.clone()
    k[:, 32:], v[:, 32:] = 0, 0
    return attention.attention_reference(q, k, v, causal=causal, scale=scale)


def _flash_wrong_kv_head(q, k, v, *, causal=False, scale=None):
    k, v = k.clone(), v.clone()
    k[:, :, 0], v[:, :, 0] = k[:, :, 1], v[:, :, 1]
    return attention.attention_reference(q, k, v, causal=causal, scale=scale)


def _steps(params, prompt, forced=None):
    """Last-position logits of the prefill and 4 decode steps; decode
    feeds ``forced`` (or this run's own greedy tokens)."""
    cache = llama.init_cache(CFG, 1, "bfloat16", device="cpu")
    out, tok = [], None
    for step in range(5):
        pos = 0 if step == 0 else prompt.shape[1] + step - 1
        x = prompt if step == 0 else torch.tensor([[tok]], dtype=torch.int32)
        logits, _ = llama.forward_cached(params, x, cache, pos, CFG, "bfloat16")
        out.append(logits[0, -1].float())
        tok = forced[step] if forced else int(out[-1].argmax())
    return out


@pytest.fixture(scope="module")
def plain():
    params = llama.init_params(CFG, seed=3, dtype="bfloat16", quant="int4",
                               device="cpu")
    prompt = torch.randint(3, CFG.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        logits = _steps(params, prompt)
    return params, prompt, logits


VARIANTS = {
    "card_rounding": (_int4_f32_accumulate, _flash_unnormalised),
    "dropped_key_tile": (None, _flash_dropped_tile),
    "wrong_kv_head": (None, _flash_wrong_kv_head),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_tolerance_separates_rounding_from_faults(plain, variant, monkeypatch):
    params, prompt, want = plain
    mm, flash = VARIANTS[variant]
    if mm is not None:
        monkeypatch.setattr(llama, "matmul_int4", mm)
    monkeypatch.setattr(llama, "flash_attention", flash)
    with torch.inference_mode():
        got = _steps(params, prompt, forced=[int(w.argmax()) for w in want])
    rel = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
    tol = chip_smoke.BF16_REF_TOL
    if variant == "card_rounding":
        assert max(rel) < 0.6 * tol, rel
    else:
        # every step fails the phase; the prefill, where the fault acts,
        # by a wide margin
        assert min(rel) > tol and rel[0] > 5 * tol, rel
