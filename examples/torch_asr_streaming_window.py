"""Windowed streaming ASR on the PyTorch/CUDA port, with the window carry
resident on the card.

The port-side counterpart of ``examples/asr_streaming_window.py``: the
classic nnstreamer audio shape, ``tensor_aggregator`` windows feeding a
speech model.  Each 4,000-sample chunk is copied into the aggregator's
device ring (``device=true``), every complete 16,000-sample window (75%
overlap) is copied out as a card tensor of its own straight into the
speech filter, and nothing crosses to the host between windows.  The
ring is allocated once, on the filter's device.

    python examples/torch_asr_streaming_window.py          # on the card
    python examples/torch_asr_streaming_window.py --cpu    # on the CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import nnstreamer_tpu_torch as ntt  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the filter and the ring on the CPU (accelerator=true:cpu)")
ap.add_argument("--chunks", type=int, default=24, help="4,000-sample chunks to stream")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""

CHUNK, WINDOW, RATE = 4000, 16000, 16000

pipe = ntt.Pipeline(
    f"audiotestsrc device=true num-buffers={args.chunks} "
    f"samplesperbuffer={CHUNK} rate={RATE} freq=880 name=src ! "
    f"tensor_aggregator frames_in={CHUNK} frames_out={WINDOW} "
    f"frames_flush={CHUNK} frames_dim=0 device=true name=agg ! "
    f"tensor_filter framework=jax model=speech_commands custom=dtype:float32{acc} name=f ! "
    "tensor_sink name=out",
)
print(pipe.residency.render())
n_windows = (args.chunks * CHUNK - WINDOW) // CHUNK + 1
with pipe:
    scores = [np.asarray(pipe.pull("out", timeout=300).tensors[0])
              for _ in range(n_windows)]
    pipe.wait(timeout=120)
agg = pipe.element("agg")
print(f"ring on {agg.ring_device or 'the card'}, {agg.ring_allocations} allocation(s)")
print(f"{len(scores)} overlapping windows decoded; "
      f"argmax per window: {[int(s.ravel().argmax()) for s in scores[:8]]}")
