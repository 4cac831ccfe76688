"""Checkpoint converter CLI: move Llama-family weights between formats.

Port of ``nnstreamer_tpu/tools/convert.py``: the same command, output and
files, byte for byte, over the port's readers and writers:

    python -m nnstreamer_tpu_torch.tools.convert model.safetensors model.gguf
    python -m nnstreamer_tpu_torch.tools.convert model.gguf model.npz
    python -m nnstreamer_tpu_torch.tools.convert hf_dir/ model.safetensors

Input: anything ``llama.load_checkpoint`` reads (.safetensors / HF
sharded dir / .npz / .gguf).  Output format from the extension:
``.gguf`` (llama.cpp layout, f32/f16/bf16), ``.safetensors`` (HF
naming), ``.npz`` (this framework's stacked naming).  ``--dtype``
selects the stored weight dtype (norms stay f32).

Conversion is host work: the tree is loaded on the CPU (no card is
needed), and bf16 is carried as its raw ``uint16`` bits throughout, so
no ``ml_dtypes`` is needed either.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

#: the order of the stacked layer leaves in an ``.npz``: the JAX
#: package's tree order, which its ``np.savez`` writes
_NPZ_LAYERS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "ln_attn", "ln_mlp")


def _head_column_major(src: str) -> bool:
    """Whether the JAX package's loader leaves ``src``'s output head
    column-major, so that its ``np.savez`` stores it in Fortran order: a
    head stored as ``[vocab, dim]`` (a HF ``lm_head.weight``, a GGUF
    ``output.weight``), which the loader transposes as a view, or an
    ``.npz`` head stored in Fortran order.  A tied head (the embedding's
    transpose, copied) is row-major."""
    from ..models import checkpoint as ckpt
    from ..models import gguf

    if src.endswith(".npz"):
        import zipfile

        with zipfile.ZipFile(src) as z, z.open("lm_head.npy") as f:
            major, _minor = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
            return bool(read(f)[1])
    if src.endswith(".gguf"):
        return "output.weight" in gguf.read(src)[1]
    return "lm_head.weight" in ckpt.load_tensors(src)


def _to_npz(params: Dict, head_column_major: bool) -> Dict[str, np.ndarray]:
    from ..models.checkpoint import host_bytes

    flat = {"embed": params["embed"], "ln_out": params["ln_out"],
            "lm_head": params["lm_head"]}
    for k in _NPZ_LAYERS:
        flat[f"layers.{k}"] = params["layers"][k]
    out = {k: host_bytes(v) for k, v in flat.items()}
    if head_column_major:
        out["lm_head"] = np.asfortranarray(out["lm_head"])
    return out


def _write_config_json(dst: str, cfg) -> None:
    """HF-style config.json next to the output, so reimport reconstructs
    the EXACT config (rope_theta/norm_eps/head counts) instead of
    shape-inference guesses — the .gguf path carries this in metadata."""
    path = os.path.join(os.path.dirname(os.path.abspath(dst)),
                        "config.json")
    with open(path, "w") as f:
        json.dump({
            "vocab_size": cfg.vocab, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.ffn_hidden,
            "max_position_embeddings": cfg.max_seq,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps,
        }, f, indent=1)


def convert(src: str, dst: str, dtype: str = "float32") -> None:
    from ..models import checkpoint as ckpt
    from ..models import gguf, llama

    if not dst.endswith((".gguf", ".safetensors", ".npz")):
        # validate BEFORE the (potentially minutes-long, 13 GB) load
        raise ValueError(
            f"unsupported output format {dst!r} "
            "(want .gguf / .safetensors / .npz)")
    if dst.endswith(".npz") and dtype == "bfloat16":
        # numpy has no bfloat16: an npz would hold raw void bytes no
        # reader can load — npz is float32/float16 only
        raise ValueError(
            "npz cannot represent bfloat16; use --dtype float32/float16 "
            "or a .gguf/.safetensors output")
    params, cfg = llama.load_checkpoint(src, dtype=dtype, device="cpu")
    if dst.endswith(".gguf"):
        gguf.export_llama(dst, params, cfg)
    elif dst.endswith(".safetensors"):
        ckpt.write_safetensors(dst, llama.hf_tensors(params, cfg))
        _write_config_json(dst, cfg)
    else:
        np.savez(dst, **_to_npz(params, _head_column_major(src)))
        _write_config_json(dst, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert Llama-family checkpoints between the formats "
                    "the llm filter ingests")
    ap.add_argument("src", help="input: .safetensors / HF dir / .npz / .gguf")
    ap.add_argument("dst", help="output: .gguf / .safetensors / .npz")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"],
                    help="stored weight dtype (norms stay float32)")
    args = ap.parse_args(argv)
    try:
        convert(args.src, args.dst, args.dtype)
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"convert: {e}", file=sys.stderr)
        return 1
    print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
