"""The port's ``models/gguf.py`` against the JAX package's: the same GGUF
read by both gives bitwise-equal tensors and metadata; the port's writer
and ``export_llama`` (from a torch tree) emit the JAX writer's bytes; a
llama GGUF loads into the same tree in both (RoPE un-permuted, tied
embeddings, config from the ``llama.*`` keys); malformed files raise the
same errors."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.core.types import bfloat16 as np_bf16
from nnstreamer_tpu.models import gguf as jgguf
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu_torch.models import gguf as tgguf
from nnstreamer_tpu_torch.models import llama as tl
from tests.test_torch_checkpoint import _bits, _torch_tree_np, assert_trees_bitwise

torch.set_num_threads(2)

CFG = jl.LlamaConfig(vocab=96, dim=32, n_layers=2, n_heads=2,
                     n_kv_heads=1, ffn_hidden=48, max_seq=64)
TCFG = tl.LlamaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _tree(seed, dtype="float32", cfg=CFG):
    return jax.tree_util.tree_map(np.asarray, jl.init_params(cfg, seed=seed, dtype=dtype))


def test_container_read_by_both(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal((8,)).astype(np.float16),
               "c": rng.standard_normal((2, 5)).astype(np.float32).astype(np_bf16),
               "d": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32)}
    meta = {"general.architecture": "llama", "x.count": 7, "x.flag": True,
            "x.rate": 0.5, "x.names": ["a", "b"], "x.ids": [1, 2, 3]}
    p = str(tmp_path / "t.gguf")
    jgguf.write(p, meta, tensors)
    jm, jt = jgguf.read(p)
    tm, tt = tgguf.read(p)
    assert tm == jm
    assert tgguf.read_metadata(p) == jgguf.read_metadata(p)
    assert tt.keys() == jt.keys()
    for k in jt:
        assert tuple(tt[k].shape) == jt[k].shape, k
        np.testing.assert_array_equal(_bits(tt[k]), _bits(jt[k]), err_msg=k)
    assert tt["c"].dtype == torch.bfloat16
    # the port's writer, fed torch tensors and numpy arrays, emits the
    # JAX writer's bytes
    q = str(tmp_path / "port.gguf")
    tgguf.write(q, meta, {k: (tt[k] if k in ("a", "c") else v) for k, v in tensors.items()})
    assert open(q, "rb").read() == open(p, "rb").read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_llama_bytes_equal_the_jax_export(tmp_path, dtype):
    params = _tree(1, dtype)
    a, b = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    jgguf.export_llama(a, params, CFG)
    tgguf.export_llama(b, tl.params_from_jax(params, device="cpu"), TCFG)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_gguf_loads_the_same_tree(tmp_path, dtype):
    """RoPE-interleaved q/k (ggml's layout) come back rotate-half: the
    port's tree equals the JAX loader's, and both equal the tree that was
    exported; the config comes from the metadata alike."""
    params = _tree(2, dtype)
    p = str(tmp_path / "m.gguf")
    jgguf.export_llama(p, params, CFG)
    want, wcfg = jl.load_checkpoint(p, dtype=dtype)
    got, gcfg = tl.load_checkpoint(p, dtype=dtype, device="cpu")
    assert_trees_bitwise(got, want)
    assert_trees_bitwise(got, params)
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)


def test_tied_embeddings(tmp_path):
    params = _tree(3)
    tensors = jgguf.llama_to_tensors(params, CFG)
    del tensors["output.weight"]
    p = str(tmp_path / "tied.gguf")
    jgguf.write(p, jgguf.llama_metadata(CFG), tensors)
    want, _ = jl.load_checkpoint(p, dtype="float32")
    got, _ = tl.load_checkpoint(p, dtype="float32", device="cpu")
    assert_trees_bitwise(got, want)
    assert torch.equal(got["lm_head"], got["embed"].t())


@pytest.mark.parametrize("quant", ["int4", "int8"])
def test_quantized_while_streaming_equals_quantize_after_load(tmp_path, quant):
    params = _tree(4, "bfloat16")
    p = str(tmp_path / "m.gguf")
    jgguf.export_llama(p, params, CFG)
    got, _ = tl.load_checkpoint(p, dtype="bfloat16", device="cpu", quant=quant)
    plain, _ = tl.load_checkpoint(p, dtype="bfloat16", device="cpu")
    q = tl.quantize_int4_params if quant == "int4" else tl.quantize_int8
    assert_trees_bitwise(got, _torch_tree_np(q(plain)))


def test_bad_magic_and_quantized_type(tmp_path):
    p = tmp_path / "bad.gguf"
    p.write_bytes(b"NOPE" + b"\x00" * 32)
    with pytest.raises(tgguf.GGUFError, match="magic"):
        tgguf.read(str(p))
    name = b"blk.0.ffn_up.weight"
    blob = struct.pack("<IIQQ", 0x46554747, 3, 1, 0)
    blob += struct.pack("<Q", len(name)) + name
    blob += struct.pack("<I", 2) + struct.pack("<QQ", 4, 4)
    blob += struct.pack("<IQ", 12, 0) + b"\x00" * 64
    q = tmp_path / "q.gguf"
    q.write_bytes(blob)
    with pytest.raises(tgguf.GGUFError, match="Q4_K"):
        tgguf.read(str(q))


def test_truncated_file(tmp_path):
    params = _tree(5)
    p = tmp_path / "m.gguf"
    jgguf.export_llama(str(p), params, CFG)
    data = p.read_bytes()
    p.write_bytes(data[:len(data) - 100])
    with pytest.raises(tgguf.GGUFError, match="truncated"):
        tgguf.read(str(p))
