"""Dynamic batching on the query server of the PyTorch/CUDA port.

``tensor_query_serversrc max-batch=N batch-window-ms=W`` stacks up to N
concurrent client requests into ONE batch-leading buffer, so the filter
runs once per group instead of once per request.  Partial groups pad to
N (one static shape); the serversink routes each output row back to its
own client and drops pad rows.  The port-side copy of
``examples/query_dynamic_batching.py``.

    python examples/torch_query_dynamic_batching.py
    python examples/torch_query_dynamic_batching.py --cpu
"""

import argparse
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402
from nnstreamer_tpu_torch.core.types import TensorsSpec  # noqa: E402
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy  # noqa: E402

MAX_BATCH = 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="keep every tensor on the CPU (the model is a host "
                         "function either way)")
    ap.parse_args()
    invokes = []
    spec = TensorsSpec.from_string(f"4:{MAX_BATCH}", "float32")

    def model(ins):
        invokes.append(tuple(ins[0].shape))
        return [ins[0] * 2.0]

    register_custom_easy("batched-double", model, in_spec=spec, out_spec=spec)
    srv = ntt.Pipeline(
        f"tensor_query_serversrc name=ssrc port=0 id=7 "
        f"max-batch={MAX_BATCH} batch-window-ms=50 ! "
        "tensor_filter framework=custom-easy model=batched-double "
        "invoke-dynamic=true ! "
        "tensor_query_serversink id=7")
    with srv:
        port = srv.element("ssrc").bound_port
        results = {}

        def client(i):
            cli = ntt.Pipeline(
                f"appsrc name=src ! tensor_query_client port={port} "
                "timeout=20 ! tensor_sink name=out")
            with cli:
                cli.push("src", np.full((4,), float(i), np.float32))
                results[i] = np.asarray(cli.pull("out", timeout=20).tensors[0])
                cli.eos("src")
                cli.wait(timeout=10)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(MAX_BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

    for i, r in sorted(results.items()):
        assert np.allclose(r, 2.0 * i), (i, r)
    assert len(results) == MAX_BATCH, sorted(results)
    print(f"{len(results)} concurrent clients answered correctly via "
          f"{len(invokes)} batched invoke(s) (each a static [{MAX_BATCH}, 4] input)")


if __name__ == "__main__":
    main()
