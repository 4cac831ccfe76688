"""Micro-batching on the PyTorch/CUDA port: one frame a buffer, many a step.

The README quick-start fed one frame per buffer (a camera, an app's
``appsrc``, query clients) pays the runner's host work and a graph
launch for every frame.  ``Pipeline(batch_max=N)`` lets the fused stage
drain up to N queued frames into one bucketed step (``torch.func.vmap``
of the stage's callable, one captured CUDA graph per bucket).  This
script runs the quick-start per frame at ``batch_max`` 1 and 8 and
prints frames/s, the occupancy histogram and the stage's census; then
the query examples' server pipelines through the port:
``examples/query_dynamic_batching.py``'s (``max-batch=8``, custom-easy)
and ``examples/query_offload.py``'s (``scaler``, here behind
``batch_max=8`` with eight concurrent clients).

    python examples/torch_micro_batching.py          # on the card
    python examples/torch_micro_batching.py --cpu    # on the CPU (small frames)
"""
import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import nnstreamer_tpu_torch as ntt  # noqa: E402
from nnstreamer_tpu_torch.core.log import metrics  # noqa: E402
from nnstreamer_tpu_torch.core.types import TensorsSpec  # noqa: E402
from nnstreamer_tpu_torch.filters.custom_easy import register_custom_easy  # noqa: E402

CLIENTS = 8


def quickstart(size, frames, batch_max, acc):
    """The quick-start, one frame a buffer: frames/s, occupancy, census."""
    pipe = ntt.Pipeline(
        f"appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,types=uint8 ! "
        "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter framework=jax model=mobilenet_v1 custom=size:{size},batch:1{acc} ! "
        "tensor_decoder mode=image_labeling ! tensor_sink name=out",
        batch_max=batch_max, queue_capacity=64)
    [stage] = [s for s in pipe.stages if s.element.kind == "fused"]
    rng = np.random.default_rng(0)
    data = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8) for _ in range(frames)]
    metrics.reset()
    with pipe:
        pipe.push("src", data[0])  # the first frame captures the stage
        pipe.pull("out", timeout=600)

        def pusher():
            for f in data[1:]:
                pipe.push("src", f)

        t = threading.Thread(target=pusher, daemon=True)
        t0 = time.perf_counter()
        t.start()
        labels = [pipe.pull("out", timeout=600).meta["label_index"] for _ in data[1:]]
        wall = time.perf_counter() - t0
        t.join()
        pipe.eos("src")
        pipe.wait(timeout=60)
    hist = metrics.value_histograms().get(f"{stage.element.name}.batch_occupancy")
    census = stage.element.census
    print(f"quick-start per frame, batch_max={batch_max}: "
          f"{(frames - 1) / wall:.1f} frames/s, stage batchable {stage.batchable}")
    if hist is not None:
        bounds, counts, total, n = hist
        print(f"  occupancy: {n} drains, mean {total / n:.2f}; cumulative "
              f"{dict(zip([int(b) for b in bounds], np.cumsum(counts[:-1]).tolist()))}")
    print(f"  census: {census.captures} captures, {census.replays} replays, "
          f"buckets {sorted(s[0] for s in census.signatures if isinstance(s[0], int))}")
    return labels


def query_dynamic_batching(acc):
    """examples/query_dynamic_batching.py's server through the port."""
    spec = TensorsSpec.from_string(f"4:{CLIENTS}", "float32")
    invokes = []

    def model(ins):
        invokes.append(tuple(ins[0].shape))
        return [ins[0] * 2.0]

    register_custom_easy("batched-double", model, in_spec=spec, out_spec=spec)
    srv = ntt.Pipeline(
        f"tensor_query_serversrc name=ssrc port=0 id=7 max-batch={CLIENTS} "
        "batch-window-ms=50 ! tensor_filter framework=custom-easy "
        "model=batched-double invoke-dynamic=true ! tensor_query_serversink id=7")
    results = clients(srv)
    for i, r in results.items():
        assert np.allclose(r, 2.0 * (np.arange(4) + i)), (i, r)
    print(f"query max-batch={CLIENTS}: {len(results)} clients answered via "
          f"{len(invokes)} batched invoke(s)")


def query_offload(acc):
    """examples/query_offload.py's server through the port, its scaler
    stage drained by micro-batching."""
    srv = ntt.Pipeline(
        "tensor_query_serversrc name=ssrc port=0 id=8 ! "
        f"tensor_filter framework=jax model=scaler custom=scale:10.0,dims:4{acc} "
        "name=f ! tensor_query_serversink id=8", batch_max=CLIENTS)
    metrics.reset()
    results = clients(srv)
    for i, r in results.items():
        assert np.allclose(r, 10.0 * np.arange(4) + 10.0 * i), (i, r)
    snap = metrics.snapshot()
    print(f"query offload (scaler, batch_max={CLIENTS}): {len(results)} clients "
          f"answered, {snap.get('f.batch_occupancy.n', 0):.0f} dispatches, "
          f"occupancy p99 {snap.get('f.batch_occupancy.p99', 1.0):.0f}")


def clients(srv):
    results = {}
    with srv:
        port = srv.element("ssrc").bound_port

        def client(i):
            cli = ntt.Pipeline(f"appsrc name=src ! tensor_query_client port={port} "
                               "timeout=20 ! tensor_sink name=out")
            with cli:
                cli.push("src", np.arange(4, dtype=np.float32) + float(i))
                results[i] = np.asarray(cli.pull("out", timeout=20).tensors[0])
                cli.eos("src")
                cli.wait(timeout=10)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the filters on the CPU (accelerator=true:cpu), "
                         "at 64 px and 65 frames")
    args = ap.parse_args()
    acc = " accelerator=true:cpu" if args.cpu else ""
    size, frames = (64, 65) if args.cpu else (224, 2049)
    one = quickstart(size, frames, 1, acc)
    many = quickstart(size, frames, 8, acc)
    print(f"  labels equal at batch_max 1 and 8: {sum(np.array_equal(a, b) for a, b in zip(one, many))} "
          f"of {len(one)}")
    query_dynamic_batching(acc)
    query_offload(acc)


if __name__ == "__main__":
    main()
