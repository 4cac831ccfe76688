"""Remote inference offload on the PyTorch/CUDA port: a ``tensor_query``
client and server on localhost.  The client serializes its tensors to
the server pipeline, which runs the model and returns the result by
message id.  The port-side copy of ``examples/query_offload.py``.

    python examples/torch_query_offload.py          # the server's filter on the card
    python examples/torch_query_offload.py --cpu    # on the CPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the server's filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    acc = " accelerator=true:cpu" if args.cpu else ""
    server = ntt.Pipeline(
        "tensor_query_serversrc port=0 name=ssrc ! "
        f"tensor_filter framework=jax model=scaler custom=scale:10.0,dims:4{acc} ! "
        "tensor_query_serversink")
    with server:
        port = server.element("ssrc").bound_port
        client = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} ! tensor_sink name=out")
        with client:
            client.push("src", np.arange(4, dtype=np.float32))
            out = client.pull("out", timeout=120)
            client.eos()
            client.wait(timeout=60)
    print("offloaded result:", np.asarray(out.tensors[0]))


if __name__ == "__main__":
    main()
