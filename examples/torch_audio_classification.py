"""Config #4: speech-command classification of a 1 s audio window on the
PyTorch/CUDA port.

The port-side counterpart of ``examples/audio_classification.py``.  That
example gathers sixteen 1,000-sample buffers into a 16,000-sample window
with ``tensor_aggregator``, which the port does not have yet; here the
source emits the 1 s window itself (``samplesperbuffer=16000``), and
``tensor_converter`` hands it to the model as ``(samples, channels)``.

    python examples/torch_audio_classification.py          # on the card
    python examples/torch_audio_classification.py --cpu    # on the CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import nnstreamer_tpu_torch as ntt  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the filter on the CPU (accelerator=true:cpu)")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""

pipe = ntt.Pipeline(
    "audiotestsrc num-buffers=1 samplesperbuffer=16000 rate=16000 freq=880 format=F32LE ! "
    "tensor_converter ! "
    f"tensor_filter framework=jax model=speech_commands custom=dtype:float32{acc} ! "
    "tensor_sink name=out",
)
with pipe:
    buf = pipe.pull("out", timeout=300)
    pipe.wait(timeout=60)
scores = np.asarray(buf.tensors[0]).ravel()
print("command scores shape:", scores.shape, "argmax:", int(scores.argmax()))
