"""Config #5 on the PyTorch/CUDA port: LLM token streaming through the llm
filter framework, a prompt in and the generated tokens streamed out one
buffer each.  The port-side copy of ``examples/llm_stream.py``: decode
is a captured CUDA graph replayed a token at a time, prefill runs the
flash-attention kernel.

    python examples/torch_llm_stream.py          # on the card
    python examples/torch_llm_stream.py --cpu    # on the CPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402

NEW = 12


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    custom = f"max_new:{NEW}" + (",dtype:float32" if args.cpu else "")
    acc = " accelerator=true:cpu" if args.cpu else ""
    pipe = ntt.Pipeline(
        "appsrc name=src ! "
        f"tensor_filter framework=llm model=llama_tiny custom={custom}{acc} ! "
        "tensor_sink name=out")
    with pipe:
        pipe.push("src", np.array([[1, 17, 42, 9]], np.int32))
        toks = []
        for _ in range(NEW):
            b = pipe.pull("out", timeout=600)
            toks.append(int(np.asarray(b.tensors[0]).ravel()[0]))
        pipe.eos()
        pipe.wait(timeout=60)
    print("generated tokens:", toks)


if __name__ == "__main__":
    main()
