"""Model files end to end: a llama_tiny-sized ``.gguf`` (with an
embedded SentencePiece vocab), ``.safetensors`` (with config.json) and HF
checkpoint directory, served by the JAX package's llm filter and by the
port's, on the static and the continuous paths.  Greedy tokens are held
exactly at f32; so are ``quant:int8`` streams, whose logits are held
within stated tolerances.  Also: the draw order of ``init_params`` for
every ``quant`` (quantize-after-init bitwise), the tokenizer choice, the
vocab guard, ``stop_eos`` defaults and an EOS that lands inside a
decode chunk."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.filters.llm import LLMFramework as JaxLLM
from nnstreamer_tpu.models import checkpoint as jckpt
from nnstreamer_tpu.models import gguf as jgguf
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.models import tokenizer as jtok
from nnstreamer_tpu_torch.filters import llm as tllm
from nnstreamer_tpu_torch.filters.base import FrameworkError
from nnstreamer_tpu_torch.models import llama as tl
from nnstreamer_tpu_torch.models import zoo as tzoo
from tests.test_torch_checkpoint import (_flat, _to_hf, _torch_tree_np, _write_config,
                                         assert_trees_bitwise)

torch.set_num_threads(2)

CFG = jl.PRESETS["llama_tiny"]
TCFG = tl.PRESETS["llama_tiny"]
MAX_NEW = 6
STATIC = f"max_new:{MAX_NEW},stream_chunk:4,param_dtype:float32,dtype:float32,stop_eos:0"
CONT = STATIC + ",serve:continuous,slots:2,block_size:8,prefill_chunk:8"
#: f32 logits, XLA against torch: the sums run in other orders
F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: bf16 logits: max |port - JAX| over a step within this share of the
#: step's max |JAX logit| (the bf16 tolerance of test_torch_models.py)
BF16_SHARE = 3e-2
MERGES = {"▁h": 2.0, "▁he": 3.0, "ll": 2.5, "llo": 3.5, "▁hello": 5.0, "or": 1.5}


def _vocab(n=None, eos=2):
    """toy_vocab padded to ``n`` pieces (default: the model's vocab)."""
    base = jtok.toy_vocab(MERGES)
    pad = (n or CFG.vocab) - base.n_vocab
    tok = jtok.toy_vocab(MERGES, n_normal_pad=pad)
    tok.eos = eos
    return tok


@pytest.fixture(scope="module", autouse=True)
def _jax_dispatch_in_order():
    """In-order dispatch on the CPU backend (tests/test_torch_continuous.py)."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, seed=0))


@pytest.fixture(scope="module")
def files(tmp_path_factory, params):
    d = tmp_path_factory.mktemp("model_files")
    gg = str(d / "llama_tiny.gguf")
    jgguf.export_llama(gg, params, CFG, tokenizer=_vocab())
    st_dir = d / "st"
    st_dir.mkdir()
    jckpt.write_safetensors(str(st_dir / "model.safetensors"), _to_hf(params, CFG))
    _write_config(st_dir, CFG)
    hf = d / "hf"
    tl.export_hf(str(hf), tl.params_from_jax(params, device="cpu"), TCFG, shards=2)
    return {"gguf": gg, "safetensors": str(st_dir / "model.safetensors"),
            "directory": str(hf), "dir": d}


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(3, CFG.vocab, (t,)).astype(np.int32) for t in (5, 11)]


def _jax_static(path, custom, prompt):
    fw = JaxLLM()
    fw.open({"model": path, "custom": custom})
    try:
        return [int(o[0][0]) for o in fw.invoke_stream([prompt])]
    finally:
        fw.close()


def _open_port(path, custom):
    fw = tllm.LLMFramework()
    fw.open({"model": path, "custom": custom, "accelerator": "true:cpu"})
    return fw


def _port_static(path, custom, prompts):
    fw = _open_port(path, custom)
    try:
        return [[int(o[0][0]) for o in fw.invoke_stream([p])] for p in prompts]
    finally:
        fw.close()


def _port_continuous(path, custom, prompts, timeout=120.0):
    """Submit every prompt, drain; per prompt the (token, meta) pairs."""
    fw = _open_port(path, custom)
    got = {i: [] for i in range(len(prompts))}
    lock = threading.Lock()

    def emit_for(i):
        def emit(tensors, meta):
            with lock:
                got[i].append((int(np.asarray(tensors[0])[0]), meta))
        return emit

    try:
        for i, p in enumerate(prompts):
            fw.submit([p], {}, emit_for(i))
        assert fw.drain(timeout)
        loop = fw._serve
        assert sorted(loop._free) == list(range(loop.n_blocks))
        assert (loop._ref == 0).all()
        return [got[i] for i in range(len(prompts))]
    finally:
        fw.close()


@pytest.fixture(scope="module")
def reference(files):
    """The JAX filter's greedy tokens on the GGUF, per prompt."""
    return [_jax_static(files["gguf"], STATIC, p) for p in _prompts()]


# -- end to end -------------------------------------------------------------------

@pytest.mark.parametrize("path", ["static", "continuous"])
@pytest.mark.parametrize("kind", ["gguf", "safetensors", "directory"])
def test_file_greedy_tokens_exact(files, reference, kind, path):
    if path == "static":
        got = _port_static(files[kind], STATIC, _prompts())
    else:
        got = [[t for t, _ in s] for s in _port_continuous(files[kind], CONT, _prompts())]
    assert got == reference


def test_jax_filter_agrees_across_files(files, reference):
    """The three files hold one model: the JAX filter's tokens agree too."""
    for kind in ("safetensors", "directory"):
        assert _jax_static(files[kind], STATIC, _prompts()[0]) == reference[0]


@pytest.mark.parametrize("path", ["static", "continuous"])
def test_int8_greedy_tokens_exact(files, path):
    custom = (STATIC if path == "static" else CONT) + ",quant:int8"
    want = [_jax_static(files["gguf"], STATIC + ",quant:int8", p) for p in _prompts()]
    if path == "static":
        got = _port_static(files["gguf"], custom, _prompts())
    else:
        got = [[t for t, _ in s] for s in _port_continuous(files["gguf"], custom, _prompts())]
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_match(files, dtype):
    """The int8 tree loaded from the GGUF (bitwise equal to the JAX
    package's ``quantize_int8`` of its loaded tree) and its forward
    logits: f32 within ``F32_TOL``; bf16 within ``BF16_SHARE`` of the
    largest |logit|."""
    jparams = jl.quantize_int8(jl.load_checkpoint(files["gguf"], dtype=dtype)[0])
    tparams, _ = tl.load_checkpoint(files["gguf"], dtype=dtype, device="cpu",
                                    quant="int8")
    assert_trees_bitwise(tparams, jparams)
    toks = _prompts()[1][None, :]
    want = np.asarray(jl.forward(jparams, jnp.asarray(toks), CFG, compute_dtype=dtype))
    got = tl.forward(tparams, torch.from_numpy(toks).long(), TCFG,
                     compute_dtype=dtype).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_SHARE * np.abs(want).max()


# -- repair: one draw order for every quant ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int4", "int8"])
def test_init_quant_equals_quantize_after_init(quant, dtype):
    got = tl.init_params(TCFG, seed=3, dtype=dtype, device="cpu", quant=quant)
    plain = tl.init_params(TCFG, seed=3, dtype=dtype, device="cpu")
    q = tl.quantize_int4_params if quant == "int4" else tl.quantize_int8
    assert_trees_bitwise(got, _torch_tree_np(q(plain)))
    # the unquantized leaves are the plain tree's too
    assert torch.equal(got["embed"], plain["embed"])


# -- tokenizer, vocab guard, stop_eos -----------------------------------------------

def test_stop_eos_follows_the_tokenizer(files):
    base = "max_new:2,param_dtype:float32,dtype:float32"
    fw = _open_port(files["gguf"], base)
    assert isinstance(fw.tokenizer, type(tl.build_from_checkpoint(
        files["gguf"], {}, device="cpu").tokenizer)) and fw.stop_eos
    fw.close()
    fw = _open_port(files["safetensors"], base)
    assert isinstance(fw.tokenizer, tllm.ByteTokenizer) and not fw.stop_eos
    fw.close()
    fw = _open_port(files["gguf"], base + ",stop_eos:0")
    assert not fw.stop_eos
    fw.close()
    # an explicit tokenizer: file wins over the byte fallback
    fw = _open_port(files["safetensors"], base + f",tokenizer:{files['gguf']}")
    assert fw.tokenizer.n_vocab == CFG.vocab and fw.stop_eos
    fw.close()


def test_vocab_guard(files):
    """A vocab larger than the model's is refused at open: on the card an
    out-of-range id in the embedding gather is a device assert."""
    d = files["dir"]
    big = str(d / "big_vocab.gguf")
    jgguf.export_llama(big, jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, 0)),
                       CFG, tokenizer=_vocab(CFG.vocab + 88))
    with pytest.raises(FrameworkError, match="exceeds model vocab"):
        _open_port(big, "param_dtype:float32,dtype:float32")
    with pytest.raises(FrameworkError, match="exceeds model vocab"):
        _open_port(files["safetensors"], f"param_dtype:float32,tokenizer:{big}")
    weights_only = str(d / "weights_only.gguf")
    jgguf.export_llama(weights_only,
                       jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, 0)), CFG)
    with pytest.raises(FrameworkError, match="carries no"):
        _open_port(files["safetensors"], f"param_dtype:float32,tokenizer:{weights_only}")


def test_text_prompt_through_the_embedded_vocab(files):
    """Prompt bytes in, the file's own vocab encodes them (as the JAX
    filter does) and the pieces come out."""
    text = np.frombuffer("hello world".encode(), np.uint8)
    custom = "max_new:4,param_dtype:float32,dtype:float32,stop_eos:0"
    jfw = JaxLLM()
    jfw.open({"model": files["gguf"], "custom": custom})
    want = [(int(o[0][0]), bytes(o[1])) for o in jfw.invoke_stream([text])]
    assert jfw._to_tokens(text).tolist()[0] == _vocab().encode(b"hello world")
    jfw.close()
    fw = _open_port(files["gguf"], custom)
    assert fw._to_tokens(text).tolist()[0] == _vocab().encode(b"hello world")
    got = [(int(o[0][0]), bytes(o[1])) for o in fw.invoke_stream([text])]
    fw.close()
    assert got == want


def test_eos_inside_a_decode_chunk(files, reference):
    """With the EOS id among a stream's tokens, generation stops there on
    both paths as in the JAX filter: the continuous loop drops the rest of
    the chunk (``stream_chunk:4``), flags the EOS token last and frees the
    stream's blocks."""
    ref = reference[1]
    j = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    eos_file = str(files["dir"] / f"eos_{j}.gguf")
    jgguf.export_llama(eos_file, jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, 0)),
                       CFG, tokenizer=_vocab(eos=ref[j]))
    custom = STATIC.replace(",stop_eos:0", "")
    want = ref[:j + 1]
    assert _jax_static(eos_file, custom, _prompts()[1]) == want
    assert _port_static(eos_file, custom, [_prompts()[1]]) == [want]
    got = _port_continuous(eos_file, CONT.replace(",stop_eos:0", ""), _prompts())
    assert [t for t, _ in got[1]] == want
    assert [bool(m.get("stream_last")) for _, m in got[1]] == [False] * j + [True]


# -- zoo names --------------------------------------------------------------------

def test_tflite_and_onnx_not_yet_ported(files):
    """Named for when the zoo refused both suffixes; since the graph files
    were ported it hands them to their own parsers, which refuse a file
    that is not one of theirs (``tests/test_torch_tflite.py`` and
    ``test_torch_onnx.py`` run real ones)."""
    from nnstreamer_tpu_torch.models import onnx as tonnx
    from nnstreamer_tpu_torch.models import tflite as ttflite

    for suffix, err, match in ((".tflite", ttflite.TFLiteError, "flatbuffer"),
                               (".onnx", tonnx.ONNXError, "varint")):
        p = files["dir"] / f"m{suffix}"
        p.write_bytes(b"\x00")
        with pytest.raises(err, match=match):
            tzoo.build(str(p), {}, device="cpu")
    with pytest.raises(KeyError, match="model file not found"):
        tzoo.build(str(files["dir"] / "absent.gguf"), {}, device="cpu")


def gguf_bundle(opts, device):
    """A ``pkg.mod:attr`` builder for the zoo test below."""
    return tl.build_from_checkpoint(opts["path"], dict(opts), device=device)


def test_import_string(files):
    b = tzoo.build("tests.test_torch_llm_files:gguf_bundle",
                   {"path": files["gguf"], "param_dtype": "float32"}, device="cpu")
    assert b.config.vocab == CFG.vocab and b.tokenizer is not None
    keys = {k for k, _ in _flat(b.params)}
    assert "layers.wq" in keys and "lm_head" in keys
