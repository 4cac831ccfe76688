"""Cross-pipeline hand-off through a shared-memory ring on the PyTorch/CUDA
port: ``shmsink`` in one pipeline, ``shmsrc`` in another on the same
host, no TCP stack in the path.  The port-side copy of
``examples/shm_handoff.py`` (the JAX package's ring is native C++; the
port's is ``elements/shm.py``, over POSIX shared memory).

    python examples/torch_shm_handoff.py
    python examples/torch_shm_handoff.py --cpu
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
                    help="keep every tensor on the CPU (the elements are host "
                         "elements either way)")
    ap.parse_args()
    name = f"/nns_example_{os.getpid()}"
    producer = ntt.Pipeline(f"appsrc name=src ! shmsink socket-path={name}")
    with producer:
        consumer = ntt.Pipeline(
            f"shmsrc socket-path={name} ! "
            "tensor_transform mode=arithmetic option=typecast:float32,mul:0.5 ! "
            "tensor_sink name=out")
        with consumer:
            for i in range(3):
                producer.push("src", np.full((4,), 2 * i, np.uint8))
            results = [np.asarray(consumer.pull("out", timeout=60).tensors[0])
                       for _ in range(3)]
            producer.eos()
            producer.wait(timeout=60)
            consumer.wait(timeout=60)
    print("halved:", [r.tolist() for r in results])


if __name__ == "__main__":
    main()
