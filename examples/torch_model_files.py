"""Model FILES on the PyTorch/CUDA port: a ``.tflite``, a fully-quantized
``.tflite``, an ``.onnx`` and a llama.cpp ``.gguf``, each through
``tensor_filter model=<file>``.  The port-side copy of
``examples/model_files.py``.

The ``.tflite`` files are written with the port's ``tflite_build`` (the
flatbuffer writer the tests use): a small float CNN, then its
fully-quantized twin (uint8 activations, int8 per-axis weights), which
runs by integer execution, every conv's sums on the int8 conv kernel on
the card.  The ``.onnx`` file is exported by torch's own exporter from an
``nn.Module`` and held against it.

The ``.gguf`` half writes a small Llama-family model in llama.cpp's own layout
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
from nnstreamer_tpu_torch.models import gguf, llama, tflite_build, tokenizer  # noqa: E402

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


def run_once(desc, x):
    """Push one buffer through ``appsrc ! <desc> ! tensor_sink``, pull it."""
    with ntt.Pipeline(f"appsrc name=src ! {desc} ! tensor_sink name=out") as p:
        p.push("src", x)
        out = np.asarray(p.pull("out", timeout=120).tensors[0])
        p.eos("src")
        p.wait(timeout=60)
    return out


def tflite_demo(td, acc):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.2
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    mw = tflite_build.ModelWriter()
    inp = mw.add_input([1, 16, 16, 3])
    y = mw.add_op("CONV_2D", [inp, mw.add_const(w), mw.add_const(np.zeros(8, np.float32))],
                  [1, 8, 8, 8], options={"padding": "SAME", "stride": (2, 2), "act": "relu6"})
    y = mw.add_op("MEAN", [y, mw.add_const(np.array([1, 2], np.int32))], [1, 8])
    y = mw.add_op("SOFTMAX", [y], [1, 8])
    path = os.path.join(td, "tiny.tflite")
    with open(path, "wb") as f:
        f.write(mw.finish(outputs=[y]))
    probs = run_once(f"tensor_filter framework=jax model={path} {acc}", x)
    print(f".tflite            -> probs sum={probs.sum():.3f} argmax={probs.argmax()}")

    # the quantized twin: uint8 in [0, 1] at 1/255, int8 weights per
    # output channel, the conv's output uint8 in [0, 6] at 6/255
    sw = np.abs(w).max(axis=(1, 2, 3)) / 127.0
    mq = tflite_build.ModelWriter()
    inp = mq.add_input([1, 16, 16, 3], dtype=np.uint8, quant_scale=[1 / 255],
                       quant_zero_point=[0])
    wq = mq.add_const(np.round(w / sw[:, None, None, None]).astype(np.int8), "wq",
                      quant_scale=list(sw), quant_zero_point=[0] * 8, quant_axis=0)
    bq = mq.add_const(np.zeros(8, np.int32), "bq", quant_scale=list(sw / 255),
                      quant_zero_point=[0] * 8, quant_axis=0)
    y = mq.add_op("CONV_2D", [inp, wq, bq], [1, 8, 8, 8], out_dtype=np.uint8,
                  options={"padding": "SAME", "stride": (2, 2), "act": "relu6"},
                  quant_scale=[6 / 255], quant_zero_point=[0])
    qpath = os.path.join(td, "tiny_quant.tflite")
    with open(qpath, "wb") as f:
        f.write(mq.finish(outputs=[y]))
    xu = np.round(x * 255).astype(np.uint8)
    yq = run_once(f"tensor_filter framework=jax model={qpath} {acc}", xu)
    print(f".tflite, quantized -> {yq.dtype} {yq.shape}, mean {yq.astype(float).mean() * 6 / 255:.3f}"
          " (integer execution)")


def onnx_demo(td, acc):
    import importlib
    import pkgutil
    import warnings

    import torch
    import torch.nn as nn
    import torch.onnx

    torch.manual_seed(0)
    m = nn.Sequential(nn.Conv2d(3, 4, 3, stride=2, padding=1), nn.ReLU(),
                      nn.Flatten(), nn.Linear(4 * 8 * 8, 10), nn.Softmax(dim=1)).eval()
    xt = torch.randn(1, 3, 16, 16)
    path = os.path.join(td, "torch.onnx")
    # torch's exporter works without the `onnx` package once its optional
    # onnxscript post-step is skipped (found wherever this torch keeps it)
    utils = [importlib.import_module(info.name) for info in
             pkgutil.walk_packages(torch.onnx.__path__, "torch.onnx.")
             if info.name.endswith("onnx_proto_utils")]
    saved = [u._add_onnxscript_fn for u in utils]
    for u in utils:
        u._add_onnxscript_fn = lambda b, c: b
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.onnx.export(m, xt, path, opset_version=13, dynamo=False)
    finally:
        for u, fn in zip(utils, saved):
            u._add_onnxscript_fn = fn
    probs = run_once(f"tensor_filter framework=jax model={path} {acc}", xt.numpy())
    with torch.no_grad():
        want = m(xt).numpy()
    print(f".onnx              -> max |port - torch| = {np.abs(probs - want).max():.2e}")


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
        tflite_demo(td, acc)
        onnx_demo(td, acc)
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
