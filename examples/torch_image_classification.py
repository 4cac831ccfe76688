"""Config #1: MobileNet-v1 image classification on the PyTorch/CUDA port.

The port-side copy of ``examples/image_classification.py``: the
transform, the model and the decoder's argmax fuse into one stage, which
runs on the card as one captured CUDA graph; only the labels' ids and
scores cross to the host.

    python examples/torch_image_classification.py          # on the card
    python examples/torch_image_classification.py --cpu    # on the CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import nnstreamer_tpu_torch as ntt  # noqa: E402

BATCH, SIZE = 8, 224

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the filter on the CPU (accelerator=true:cpu)")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""

pipe = ntt.Pipeline(
    f"appsrc name=src caps=other/tensors,dimensions=3:{SIZE}:{SIZE}:{BATCH},types=uint8 ! "
    "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
    f"tensor_filter framework=jax model=mobilenet_v1 custom=size:{SIZE},batch:{BATCH}{acc} ! "
    "tensor_decoder mode=image_labeling ! tensor_sink name=out",
)
print("plan:", [s.element.name for s in pipe.stages])
rng = np.random.default_rng(0)
with pipe:
    pipe.push("src", rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8))
    buf = pipe.pull("out", timeout=300)
    pipe.eos(); pipe.wait(timeout=60)
print("labels:", buf.meta["label"][:4], "scores:", np.round(buf.meta["score"][:4], 3))
