"""Model FILES on the PyTorch/CUDA port: a llama.cpp ``.gguf`` through
``tensor_filter framework=llm model=<file>``.  The port-side copy of the
``.gguf`` half of ``examples/model_files.py``.

The example writes a small Llama-family model in llama.cpp's own layout
(tensor names, fastest-first dims, interleaved RoPE) with a SentencePiece
vocab embedded as ``tokenizer.ggml.*`` metadata — what a real ``.gguf``
looks like — then streams from it twice: token ids in, ids out; and a
text prompt in, which the file's own vocab encodes, with each token's
text piece out (``stop_eos`` is on by default with a real vocab).  The
same file serves with ``custom=quant:int4`` or ``quant:int8``, quantized
on the card while it loads.

    python examples/torch_model_files.py
    python examples/torch_model_files.py --cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import nnstreamer_tpu_torch as ntt  # noqa: E402
from nnstreamer_tpu_torch.models import gguf, llama, tokenizer  # noqa: E402

MERGES = {"▁h": 2.0, "▁he": 3.0, "ll": 2.5, "llo": 3.5, "▁hello": 5.0,
          "▁w": 1.0, "or": 1.5, "ld": 1.2, "▁world": 4.0}


def stream(path, prompt, custom, acc):
    """Push one prompt, pull until ``stream_last``: (ids, text pieces)."""
    with ntt.Pipeline(
        "appsrc name=src ! "
        f"tensor_filter framework=llm model={path} custom={custom} "
        f"{acc}! tensor_sink name=out"
    ) as p:
        p.push("src", prompt)
        bufs = [p.pull("out", timeout=300)]
        while not bufs[-1].meta.get("stream_last"):
            bufs.append(p.pull("out", timeout=300))
        p.eos("src")
        p.wait(timeout=60)
    return ([int(np.asarray(b.tensors[0]).ravel()[0]) for b in bufs],
            [bytes(np.asarray(b.tensors[1])) for b in bufs])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    acc = "accelerator=true:cpu " if args.cpu else ""
    device = "cpu" if args.cpu else "cuda"

    cfg = llama.LlamaConfig(vocab=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_hidden=256, max_seq=128)
    params = llama.init_params(cfg, seed=1, device=device)
    # pad the toy vocab to the model's with text pieces that merge last,
    # so that random weights' tokens decode to visible text
    pad = cfg.vocab - tokenizer.toy_vocab(MERGES).n_vocab
    vocab = tokenizer.toy_vocab({**MERGES, **{f"▁p{i}": -2e4 for i in range(pad)}})
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "model.gguf")
        gguf.export_llama(path, params, cfg, tokenizer=vocab)
        print(f"wrote {path}: {os.path.getsize(path)} bytes, "
              f"{vocab.n_vocab}-piece vocab embedded")

        custom = "max_new:8,param_dtype:float32,dtype:float32,stop_eos:0"
        ids, _ = stream(path, np.array([1, 17, 9], np.int32), custom, acc)
        print(f".gguf, ids in     -> streamed tokens {ids}")

        for quant in ("", ",quant:int8", ",quant:int4"):
            ids, pieces = stream(path, np.frombuffer(b"hello world", np.uint8),
                                 "max_new:8,param_dtype:float32" + quant, acc)
            text = b"".join(pieces).decode("utf-8", "replace")
            print(f".gguf{quant or ' (f32 weights)'}, text in -> ids {ids} text {text!r}")


if __name__ == "__main__":
    main()
