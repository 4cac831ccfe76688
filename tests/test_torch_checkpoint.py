"""The port's ``models/checkpoint.py`` and ``llama.load_checkpoint``
against the JAX package's: the same safetensors / sharded-index / HF
directory / npz file read by both packages gives bitwise-equal tensors
and parameter trees, in F32, F16 and BF16; the writers emit the same
bytes; the quantized trees follow the quantizers' rules (int8 bitwise,
int4 nibbles bitwise with scales within 1 ulp at f32); and the port's
readers and writers work with ``ml_dtypes`` unimportable, as on a card
machine without JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.core.types import bfloat16 as np_bf16
from nnstreamer_tpu.models import checkpoint as jckpt
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.models import checkpoint as tckpt
from nnstreamer_tpu_torch.models import llama as tl

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CFG = jl.LlamaConfig(vocab=96, dim=32, n_layers=2, n_heads=2,
                     n_kv_heads=1, ffn_hidden=48, max_seq=64)
TCFG = tl.LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _bits(x):
    """A numpy array or a tensor as its raw bits (bf16 by its 16-bit
    pattern), for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x.view(np.uint8)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + ".")
        else:
            yield pre + k, v


def assert_trees_bitwise(port, ref, ulp_keys=()):
    """Every leaf bitwise equal (shape and bits); leaves named in
    ``ulp_keys`` (f32 scales) within 1 ulp instead."""
    p, r = dict(_flat(port)), dict(_flat(jax.tree_util.tree_map(np.asarray, ref)))
    assert p.keys() == r.keys(), p.keys() ^ r.keys()
    for k, want in r.items():
        got = p[k]
        assert tuple(got.shape) == want.shape, k
        if k in ulp_keys:
            np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


def _jax_tree(seed, dtype="float32"):
    return jax.tree_util.tree_map(np.asarray, jl.init_params(CFG, seed=seed, dtype=dtype))


def _to_hf(params, cfg):
    """The JAX package's HF export mapping (tests/test_checkpoint.py)."""
    out = {"model.embed_tokens.weight": np.asarray(params["embed"]),
           "model.norm.weight": np.asarray(params["ln_out"]),
           "lm_head.weight": np.ascontiguousarray(np.asarray(params["lm_head"]).T)}
    lay = params["layers"]
    for i in range(cfg.n_layers):
        for k, name in tl._HF_MATS.items():
            out[f"model.layers.{i}.{name}.weight"] = np.ascontiguousarray(
                np.asarray(lay[k])[i].T)
        out[f"model.layers.{i}.input_layernorm.weight"] = np.asarray(lay["ln_attn"])[i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            np.asarray(lay["ln_mlp"])[i]
    return out


def _write_config(dirpath, cfg):
    (dirpath / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab, "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.ffn_hidden,
        "max_position_embeddings": cfg.max_seq,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}))


def _mixed():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float16),
            "c": rng.standard_normal((2, 5)).astype(np.float32).astype(np_bf16),
            "d": rng.integers(-100, 100, (7,)).astype(np.int8),
            "e": np.asarray([True, False, True])}


# -- the container ---------------------------------------------------------------

def test_safetensors_read_by_both_bitwise(tmp_path):
    tensors = _mixed()
    p = str(tmp_path / "t.safetensors")
    jckpt.write_safetensors(p, tensors)
    got = tckpt.read_safetensors(p)
    want = jckpt.read_safetensors(p)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    assert got["c"].dtype == torch.bfloat16 and got["b"].dtype == torch.float16


def test_safetensors_writer_bytes_equal_the_jax_writer(tmp_path):
    tensors = _mixed()
    a, b = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jckpt.write_safetensors(a, tensors)
    # the port takes numpy arrays and torch tensors alike
    port = {k: (tckpt.as_tensor(v) if k in ("a", "c") else v) for k, v in tensors.items()}
    tckpt.write_safetensors(b, port)
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_rejects_garbage(tmp_path):
    p = tmp_path / "bad.safetensors"
    p.write_bytes(b"\xff" * 64)
    with pytest.raises(tckpt.CheckpointError):
        tckpt.read_safetensors(str(p))
    with pytest.raises(tckpt.CheckpointError, match="unsupported checkpoint"):
        tckpt.load_tensors(str(tmp_path / "x.bin"))


def test_sharded_index_read_by_both(tmp_path):
    rng = np.random.default_rng(1)
    t1 = {"x": rng.standard_normal((4,)).astype(np.float32)}
    t2 = {"y": rng.standard_normal((2, 2)).astype(np.float32).astype(np_bf16)}
    jckpt.write_safetensors(str(tmp_path / "s1.safetensors"), t1)
    jckpt.write_safetensors(str(tmp_path / "s2.safetensors"), t2)
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"x": "s1.safetensors", "y": "s2.safetensors"}}))
    for where in (str(tmp_path), str(tmp_path / "model.safetensors.index.json")):
        got, want = tckpt.load_tensors(where), jckpt.load_tensors(where)
        assert got.keys() == want.keys() == {"x", "y"}
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


# -- llama trees -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["safetensors", "directory", "npz"])
def test_load_checkpoint_trees_bitwise(tmp_path, layout, dtype):
    """HF names (one file with config.json, or a sharded directory) and
    the native stacked npz: the port's streamed load equals the JAX
    loader's tree leaf for leaf."""
    params = _jax_tree(3)
    if layout == "npz":
        path = str(tmp_path / "m.npz")
        flat = {"embed": params["embed"], "ln_out": params["ln_out"],
                "lm_head": params["lm_head"]}
        flat.update({f"layers.{k}": v for k, v in params["layers"].items()})
        np.savez(path, **flat)
        _write_config(tmp_path, CFG)  # 32 wide: head_dim is not inferable
    elif layout == "safetensors":
        path = str(tmp_path / "model.safetensors")
        jckpt.write_safetensors(path, _to_hf(params, CFG))
        _write_config(tmp_path, CFG)
    else:
        tl.export_hf(str(tmp_path), tl.params_from_jax(params, device="cpu"), TCFG,
                     shards=2)
        path = str(tmp_path)
    want, wcfg = jl.load_checkpoint(path, dtype=dtype)
    got, gcfg = tl.load_checkpoint(path, dtype=dtype, device="cpu")
    assert_trees_bitwise(got, want)
    assert {f: getattr(gcfg, f) for f in CFG.__dataclass_fields__} == \
        {f: getattr(wcfg, f) for f in CFG.__dataclass_fields__}


def test_export_hf_index_and_shards(tmp_path):
    """export_hf writes what the JAX loader reads: two shards, their
    index and a config.json; the tree comes back bitwise."""
    params = _jax_tree(4)
    tl.export_hf(str(tmp_path), tl.params_from_jax(params, device="cpu"), TCFG, shards=2)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert sorted(set(index["weight_map"].values())) == [
        "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    want, _ = jl.load_checkpoint(str(tmp_path), dtype="float32")
    assert_trees_bitwise(tl.params_from_jax(params, device="cpu"), want)


def test_f16_file_to_bf16_params_bitwise(tmp_path):
    """An F16 file loaded at bf16: the cast rounds alike in both."""
    params = _jax_tree(5)
    hf = {k: v.astype(np.float16) for k, v in _to_hf(params, CFG).items()}
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, hf)
    _write_config(tmp_path, CFG)
    want, _ = jl.load_checkpoint(path, dtype="bfloat16")
    got, _ = tl.load_checkpoint(path, dtype="bfloat16", device="cpu")
    assert_trees_bitwise(got, want)


def test_tied_embeddings_fallback(tmp_path):
    params = _jax_tree(6)
    hf = _to_hf(params, CFG)
    del hf["lm_head.weight"]
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, hf)
    _write_config(tmp_path, CFG)
    want, _ = jl.load_checkpoint(path, dtype="float32")
    got, _ = tl.load_checkpoint(path, dtype="float32", device="cpu")
    assert_trees_bitwise(got, want)
    assert torch.equal(got["lm_head"], got["embed"].t())


def test_config_inferred_without_config_json(tmp_path):
    params = jax.tree_util.tree_map(np.asarray, jl.init_params(
        jl.LlamaConfig(vocab=96, dim=128, n_layers=2, n_heads=1, n_kv_heads=1,
                       ffn_hidden=64, max_seq=64), seed=0))
    cfg = jl.LlamaConfig(vocab=96, dim=128, n_layers=2, n_heads=1, n_kv_heads=1,
                         ffn_hidden=64, max_seq=64)
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, _to_hf(params, cfg))
    _, wcfg = jl.load_checkpoint(path, dtype="float32")
    _, gcfg = tl.load_checkpoint(path, dtype="float32", device="cpu")
    assert (gcfg.n_heads, gcfg.n_kv_heads, gcfg.n_layers, gcfg.ffn_hidden) == \
        (wcfg.n_heads, wcfg.n_kv_heads, wcfg.n_layers, wcfg.ffn_hidden)


def test_missing_tensor_and_wrong_config_errors(tmp_path):
    params = _jax_tree(7)
    hf = _to_hf(params, CFG)
    del hf["model.layers.1.mlp.up_proj.weight"]
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, hf)
    _write_config(tmp_path, CFG)
    with pytest.raises(tckpt.CheckpointError, match="up_proj"):
        tl.load_checkpoint(path, dtype="float32", device="cpu")
    wrong = tl.LlamaConfig(vocab=96, dim=32, n_layers=2, n_heads=2, n_kv_heads=2,
                           ffn_hidden=48, max_seq=64)
    jckpt.write_safetensors(path, _to_hf(params, CFG))
    with pytest.raises(ValueError, match="wrong config"):
        tl.load_checkpoint(path, cfg=wrong, dtype="float32", device="cpu")
    other = tmp_path / "other"  # no config.json beside it
    other.mkdir()
    jckpt.write_safetensors(str(other / "model.safetensors"),
                            {"conv.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(tckpt.CheckpointError, match="not a Llama-family"):
        tl.load_checkpoint(str(other / "model.safetensors"), dtype="float32",
                           device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_loaded_tree_bitwise(tmp_path, dtype):
    """quant:int8 while streaming equals the JAX package's
    ``quantize_int8`` of its loaded tree, every leaf bitwise (the port
    multiplies by the f32 reciprocal of 127, as XLA compiles the JAX
    quantizer's division)."""
    params = _jax_tree(8)
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, _to_hf(params, CFG))
    _write_config(tmp_path, CFG)
    want = jl.quantize_int8(jl.load_checkpoint(path, dtype=dtype)[0])
    got, _ = tl.load_checkpoint(path, dtype=dtype, device="cpu", quant="int8")
    assert_trees_bitwise(got, want)
    # and the port's own quantize-after-load, bitwise
    plain, _ = tl.load_checkpoint(path, dtype=dtype, device="cpu")
    assert_trees_bitwise(got, _torch_tree_np(tl.quantize_int8(plain)))


def _torch_tree_np(tree):
    """A port tree as numpy (bf16 leaves as ml_dtypes bfloat16)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch_tree_np(v)
        elif v.dtype == torch.bfloat16:
            out[k] = v.view(torch.uint16).numpy().view(np_bf16)
        else:
            out[k] = v.numpy()
    return out


def test_int4_loaded_tree_follows_the_int4_rule(tmp_path):
    """quant:int4 while streaming: nibbles bitwise, scales within 1 ulp
    of the JAX package's jitted quantizer (XLA's ``amax * (1/7)``)."""
    params = _jax_tree(9)
    path = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(path, _to_hf(params, CFG))
    _write_config(tmp_path, CFG)
    want = jl.quantize_int4_params(jl.load_checkpoint(path, dtype="float32")[0])
    got, _ = tl.load_checkpoint(path, dtype="float32", device="cpu", quant="int4")
    scales = {k for k, _ in _flat(got) if k.endswith("_s")}
    assert_trees_bitwise(got, want, ulp_keys=scales)
    plain, _ = tl.load_checkpoint(path, dtype="float32", device="cpu")
    assert_trees_bitwise(got, _torch_tree_np(tl.quantize_int4_params(plain)))


def test_readers_and_writers_without_ml_dtypes(tmp_path):
    """With ``ml_dtypes`` unimportable (no JAX, as on the card machine):
    the port reads a BF16 safetensors and a BF16 GGUF bitwise, writes
    torch bf16 tensors to the same bytes as here, and loads a llama
    tree from both files."""
    params = _jax_tree(10, dtype="bfloat16")
    st = str(tmp_path / "model.safetensors")
    jckpt.write_safetensors(st, _to_hf(params, CFG))
    _write_config(tmp_path, CFG)
    from nnstreamer_tpu.models import gguf as jgguf

    gg = str(tmp_path / "m.gguf")
    jgguf.export_llama(gg, params, CFG)
    ref_st = {k: _bits(v) for k, v in jckpt.read_safetensors(st).items()}
    np.savez(str(tmp_path / "ref.npz"), **ref_st)
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from nnstreamer_tpu_torch.core import types
assert types.bfloat16.name != "bfloat16", types.bfloat16
from nnstreamer_tpu_torch.models import checkpoint, gguf, llama
got = checkpoint.read_safetensors({st!r})
ref = np.load({str(tmp_path / "ref.npz")!r})
for k in ref.files:
    g = got[k]
    bits = g.view(torch.uint16).numpy() if g.dtype == torch.bfloat16 else g.numpy().view(ref[k].dtype)
    assert np.array_equal(bits, ref[k]), k
assert got["model.embed_tokens.weight"].dtype == torch.bfloat16
checkpoint.write_safetensors({str(tmp_path / "again.safetensors")!r}, got)
meta, tens = gguf.read({gg!r})
assert tens["token_embd.weight"].dtype == torch.bfloat16
params, cfg = llama.load_checkpoint({gg!r}, dtype="bfloat16", device="cpu")
params2, _ = llama.load_checkpoint({st!r}, dtype="bfloat16", device="cpu")
for a, b in ((params["embed"], params2["embed"]), (params["lm_head"], params2["lm_head"]),
             (params["layers"]["wq"], params2["layers"]["wq"])):
    assert torch.equal(a.view(torch.uint16), b.view(torch.uint16))
gguf.export_llama({str(tmp_path / "again.gguf")!r}, params, cfg)
assert "jax" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert (tmp_path / "again.safetensors").read_bytes() == Path(st).read_bytes()
    assert (tmp_path / "again.gguf").read_bytes() == Path(gg).read_bytes()
