"""The slice end to end: ``appsrc ! tensor_filter framework=llm !
tensor_sink`` in the port against the same pipeline in the JAX package,
on llama_tiny at f32 with the same weights, dense and int4."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.core import config as tconfig
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
#: the port's zoo name for llama_tiny built from the JAX package's weights
REF_MODEL = "llama_tiny_jax_weights"
#: logit gap under which a greedy step is a near tie (f32 tolerances of
#: test_torch_llama.py: dense 1e-4, int4 2e-3)
TIE = {"": 1e-4, "int4": 2e-3}


@functools.lru_cache(maxsize=None)
def _jax_tree(quant):
    """The weights the JAX package's llm filter builds for llama_tiny
    (seed 0, f32), as numpy."""
    tree = (jl.init_params_int4(CFG, seed=0, gen_dtype="float32") if quant
            else jl.init_params(CFG, seed=0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_builder(opts, device):
    params = tl.params_from_jax(_jax_tree(opts.get("quant", "")), device=device)
    return tl.make_bundle(tl.PRESETS["llama_tiny"], params,
                          opts.get("dtype", "bfloat16"), REF_MODEL)


tzoo.register_model(REF_MODEL, _ref_builder)


def _custom(max_new, quant):
    c = f"max_new:{max_new},dtype:float32"
    return c + (",quant:int4" if quant else "")


def _run_port(prompt, max_new=8, quant="", model=REF_MODEL):
    p = ntt.Pipeline(
        f"appsrc name=src ! tensor_filter framework=llm model={model} "
        f"custom={_custom(max_new, quant)} accelerator=true:cpu ! "
        "tensor_sink name=out")
    with p:
        p.push("src", prompt)
        outs = [p.pull("out", timeout=120) for _ in range(max_new)]
        p.eos("src")
        p.wait(timeout=60)
    return outs


def _run_jax(prompt, max_new=8, quant=""):
    p = nt.Pipeline(
        "appsrc name=src ! tensor_filter framework=llm model=llama_tiny "
        f"custom={_custom(max_new, quant)} ! tensor_sink name=out")
    with p:
        p.push("src", prompt)
        outs = [p.pull("out", timeout=120) for _ in range(max_new)]
        p.eos("src")
        p.wait(timeout=60)
    return [int(np.asarray(b.tensors[0])[0]) for b in outs]


def _ids(outs):
    return [int(b.tensors[0][0]) for b in outs]


def _assert_same_greedy(prompt, ref_ids, port_ids, quant):
    """Token-exact, except that a step where the reference's top-1/top-2
    logit gap is inside the tolerance may flip, and the streams may part
    from there (the near-tie rule)."""
    seq = np.concatenate([prompt, np.asarray(ref_ids, np.int32)])[None, :]
    logits = np.asarray(jl.forward(_jax_tree(quant), jnp.asarray(seq), CFG,
                                   compute_dtype="float32"))[0]
    T = len(prompt)
    for i, (r, g) in enumerate(zip(ref_ids, port_ids)):
        top2 = np.sort(logits[T - 1 + i])[-2:]
        if top2[1] - top2[0] < TIE[quant]:
            return
        assert g == r, (i, ref_ids, port_ids)


@pytest.mark.parametrize("quant", ["", "int4"])
def test_greedy_stream_matches_jax_pipeline(quant):
    prompt = np.array([1, 17, 42, 9, 300], np.int32)
    ref_ids = _run_jax(prompt, quant=quant)
    outs = _run_port(prompt, quant=quant)
    _assert_same_greedy(prompt, ref_ids, _ids(outs), quant)


def test_text_prompt_and_stream_markers():
    outs = _run_port("hi", max_new=5)
    for i, buf in enumerate(outs):
        assert buf.meta["stream_index"] == i
        assert buf.meta.get("stream_last", False) == (i == 4)
        ids = buf.tensors[0]
        assert ids.dtype == np.int32 and ids.shape == (1,)
        assert 0 <= int(ids[0]) < CFG.vocab
        assert buf.tensors[1].dtype == np.uint8  # the token's piece bytes


@pytest.mark.parametrize("T", [5, 32, 33])
def test_bucket_padding_keeps_the_last_real_logit(T):
    """Right-padding the prompt to its bucket (32, 32, 64) must leave the
    logit sampled at T-1 — and so the first token — unchanged."""
    params = tl.params_from_jax(_jax_tree(""), device="cpu")
    cfg = tl.PRESETS["llama_tiny"]
    prompt = np.random.default_rng(T).integers(3, CFG.vocab, (1, T)).astype(np.int32)
    padded = np.pad(prompt, ((0, 0), (0, 64 - T)))
    plain, _ = tl.forward_cached(params, torch.from_numpy(prompt),
                                 tl.init_cache(cfg, 1, "float32", device="cpu"), 0, cfg, "float32")
    pad, _ = tl.forward_cached(params, torch.from_numpy(padded),
                               tl.init_cache(cfg, 1, "float32", device="cpu"), 0, cfg, "float32")
    torch.testing.assert_close(pad[:, T - 1], plain[:, T - 1], rtol=1e-5, atol=1e-5)

    first = {}
    try:
        for bucketing in (False, True):
            tconfig.set_config(dataclasses.replace(
                tconfig.Config(), shape_bucketing=bucketing))
            first[bucketing] = _ids(_run_port(prompt[0], max_new=3))
    finally:
        tconfig.reset_config()
    assert first[True][0] == first[False][0]
    assert first[True] == first[False]


def test_opening_without_cpu_on_a_machine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="no CUDA device"):
        ntt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                     "model=llama_tiny ! tensor_sink name=out")


@pytest.mark.parametrize("prop,match", [
    ("accelerator=true:gpu,cpu", "preference list"),
    ("accelerator=true:tpu", "unknown device"),
    # the continuous loop is ported; its prefix cache is not
    pytest.param("custom=serve:continuous,prefix_cache:1 accelerator=true:cpu",
                 "not yet ported",
                 id="custom=serve:continuous accelerator=true:cpu-not yet ported"),
    ("custom=draft:llama_tiny accelerator=true:cpu", "not yet ported"),
    ("custom=tp:2 accelerator=true:cpu", "not yet ported"),
    ("custom=quant:int8 accelerator=true:cpu", "not yet ported"),
])
def test_unported_or_ambiguous_requests_raise(prop, match):
    with pytest.raises(Exception, match=match):
        ntt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                     f"model=llama_tiny {prop} ! tensor_sink name=out")


def test_unknown_property_is_rejected_at_start():
    p = ntt.Pipeline("appsrc name=src ! tensor_filter framework=llm "
                     "model=llama_tiny custom=max_new:2,dtype:float32 "
                     "accelerator=true:cpu typo_prop=1 ! tensor_sink name=out")
    with pytest.raises(ntt.PipelineError, match="typo_prop"):
        p.start()
