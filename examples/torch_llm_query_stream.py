"""Config #5, "Llama-2 token streaming (tensor_filter + tensor_query)", on
the PyTorch/CUDA port: a query SERVER owns the model on the card, a
client sends a prompt over TCP and receives the generated tokens
streamed back one buffer each, tagged ``stream_index`` with
``stream_last`` on the final one.  The port-side copy of
``examples/llm_query_stream.py``.

    python examples/torch_llm_query_stream.py             # tiny preset
    python examples/torch_llm_query_stream.py llama2_7b   # 7B, int4 weights
    python examples/torch_llm_query_stream.py --cpu       # on the CPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="llama_tiny")
    ap.add_argument("--cpu", action="store_true",
                    help="run the filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    custom = "max_new:16,stream_chunk:4"
    if args.model == "llama2_7b":
        custom += ",quant:int4,param_dtype:bfloat16,max_seq:1024"
    if args.cpu:
        custom += ",dtype:float32"
    acc = "accelerator=true:cpu " if args.cpu else ""
    server = ntt.Pipeline(
        "tensor_query_serversrc name=ssrc port=0 id=5 ! "
        f"tensor_filter framework=llm model={args.model} custom={custom} "
        f"{acc}invoke-dynamic=true ! "
        "tensor_query_serversink id=5"
    )
    with server:
        port = server.element("ssrc").bound_port
        print(f"query server up on :{port} (model={args.model})")
        client = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} "
            "timeout=600 ! tensor_sink name=out"
        )
        with client:
            client.push("src", "stream me some tokens")
            text = bytearray()
            while True:
                buf = client.pull("out", timeout=600)
                ids = np.asarray(buf.tensors[0])
                piece = (bytes(np.asarray(buf.tensors[1]))
                         if len(buf.tensors) > 1 else b"")
                text += piece
                print(f"  token[{buf.meta['stream_index']:2d}] id={int(ids[0])}"
                      f" piece={piece!r}")
                if buf.meta.get("stream_last"):
                    break
            client.eos()
            client.wait(timeout=60)
    print(f"decoded bytes: {bytes(text)!r}")


if __name__ == "__main__":
    main()
