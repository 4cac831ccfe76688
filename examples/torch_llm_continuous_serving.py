"""Continuous serving on the PyTorch/CUDA port: clients join a RUNNING
paged-KV decode loop over the query wire.  The port-side copy of
``examples/llm_continuous_serving.py``.

``custom=serve:continuous,slots:N`` keeps one decode loop alive on the
card over a block-paged KV pool: each queued prompt is admitted into a
free slot by reserving pool blocks, prefilled in ``prefill_chunk``-sized
steps interleaved with the running decode, and decoded at its own depth
through its own block table, so a late client starts receiving tokens
while earlier streams are still decoding.  The decode step is one
captured CUDA graph; a stream's join, leave or completion changes only
the values it reads.

    python examples/torch_llm_continuous_serving.py
    python examples/torch_llm_continuous_serving.py --cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402

MAX_NEW = 16
SLOTS = 2
BLOCK_SIZE = 8
PREFILL_CHUNK = 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    acc = "accelerator=true:cpu " if args.cpu else ""
    dtype = ",dtype:float32" if args.cpu else ""
    srv = ntt.Pipeline(
        "tensor_query_serversrc name=ssrc port=0 id=11 ! "
        f"tensor_filter framework=llm model=llama_tiny "
        f"custom=max_new:{MAX_NEW},serve:continuous,slots:{SLOTS},"
        f"stream_chunk:2,block_size:{BLOCK_SIZE},"
        f"prefill_chunk:{PREFILL_CHUNK}{dtype} "
        f"{acc}invoke-dynamic=true ! "
        "tensor_query_serversink id=11")
    with srv:
        port = srv.element("ssrc").bound_port
        first = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} timeout=60 "
            "! tensor_sink name=out")
        late = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} timeout=60 "
            "! tensor_sink name=out")
        with first, late:
            first.push("src", "stream one, long-running")
            first.pull("out", timeout=60)  # stream 1 is demonstrably live
            t_join = time.perf_counter()
            late.push("src", "late joiner")
            late.pull("out", timeout=60)   # first token of the LATE stream
            join_ms = (time.perf_counter() - t_join) * 1e3
            # drain both streams
            for p, n in ((first, MAX_NEW - 1), (late, MAX_NEW - 1)):
                toks = [p.pull("out", timeout=60) for _ in range(n)]
                assert toks[-1].meta.get("stream_last") is True
            for p in (first, late):
                p.eos("src")
                p.wait(timeout=15)
    print(f"late client's first token arrived {join_ms:.0f} ms after it "
          f"joined — while stream one was still decoding its {MAX_NEW} "
          "tokens (continuous admission, no group barrier)")


if __name__ == "__main__":
    main()
