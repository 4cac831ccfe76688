"""Prefix sharing and speculative decoding on the PyTorch/CUDA port.  The
port-side copy of ``examples/llm_prefix_serving.py``.

Every prompt here shares one 64-token "system preamble": the first
stream prefills it into the paged KV pool, and every later stream's
admission finds its blocks through the prefix index, maps them into its
own table (one more reference each, nothing reserved for them) and
prefills only its suffix.  ``draft:llama_tiny,spec_k:4`` adds
speculative decoding: the draft proposes 4 tokens a round and the target
verifies them in one ``[slots, 5]`` step, so greedy output is the
target's own at every accept rate.  The loop's census holds two captured
steps, propose and verify.

    python examples/torch_llm_prefix_serving.py
    python examples/torch_llm_prefix_serving.py --cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import nnstreamer_tpu_torch as ntt  # noqa: E402
from nnstreamer_tpu_torch.core.log import metrics  # noqa: E402

MAX_NEW = 16
SLOTS = 2
BLOCK_SIZE = 8
PREFILL_CHUNK = 8
SPEC_K = 4


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the filter on the CPU (accelerator=true:cpu)")
    args = ap.parse_args()
    acc = "accelerator=true:cpu " if args.cpu else ""
    dtype = ",dtype:float32" if args.cpu else ""
    rng = np.random.default_rng(0)
    preamble = rng.integers(1, 400, (64,), dtype=np.int32)

    def prompt():
        return np.concatenate([preamble, rng.integers(1, 400, (8,), np.int32)])

    with ntt.Pipeline(
        "appsrc name=src ! "
        "tensor_filter name=llm framework=llm model=llama_small "
        f"custom=max_new:{MAX_NEW},serve:continuous,slots:{SLOTS},"
        f"stream_chunk:2,temperature:0.0,block_size:{BLOCK_SIZE},"
        f"prefill_chunk:{PREFILL_CHUNK},kv_blocks:64,"
        f"draft:llama_tiny,spec_k:{SPEC_K}{dtype} "
        f"{acc}invoke-dynamic=true ! tensor_sink name=out"
    ) as p:
        # stream 0 prefills the preamble cold (after the loop's warm-up)
        p.element("llm").fw.serve_loop()
        p.push("src", prompt())
        for _ in range(MAX_NEW):
            p.pull("out", timeout=600)
        # stream 1 finds the preamble's blocks and prefills its suffix
        t0 = time.monotonic()
        p.push("src", prompt())
        first = p.pull("out", timeout=600)
        hit_ms = (first.meta["emit_t"] - t0) * 1e3
        for _ in range(MAX_NEW - 1):
            p.pull("out", timeout=600)
        census = p.element("llm").fw.census
        p.eos("src")
        p.wait(timeout=60)
    snap = metrics.snapshot()
    print(f"prefix hits: {int(snap.get('llm.serve.prefix_hits', 0))} "
          f"({int(snap.get('llm.serve.prefix_hit_blocks', 0))} blocks shared), "
          f"cache-hit first token in {hit_ms:.0f} ms")
    accepted = snap.get("llm.serve.spec_accepted", 0.0)
    rejected = snap.get("llm.serve.spec_rejected", 0.0)
    rate = accepted / (accepted + rejected) if accepted + rejected else 0.0
    print(f"speculation: {int(accepted)} draft tokens accepted, {int(rejected)} "
          f"rejected (accept rate {rate:.2f}); the output is the target's "
          "greedy stream either way")
    print(f"census: {sorted(census.signatures)}, {census.captures} captures")


if __name__ == "__main__":
    main()
