"""DeepLab segmentation on the PyTorch/CUDA port, and the residency
planner's choice of what crosses to the host.

The port-side counterpart of ``examples/fetch_bound.py``'s deeplab
pipeline.  With ``tensor_decoder mode=image_segment option1=classmap``
every consumer below the filter admits any geometry, so the residency
planner switches deeplab to its native-stride score map (16 x 16 fewer
pixels than the full-resolution blow-up of it) and the fused stage's
device argmax sends one byte a pixel of that map to the host.  The
overlay form (``--overlay``) pins full resolution, as in the JAX
package's example.

    python examples/torch_segmentation.py                # on the card
    python examples/torch_segmentation.py --cpu          # on the CPU
    python examples/torch_segmentation.py --overlay      # full resolution
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
ap.add_argument("--overlay", action="store_true",
                help="decode to the RGBA overlay (pins full resolution)")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""
form = "" if args.overlay else " option1=classmap"
# the JAX package's example runs 8 frames of 224 x 224; the CPU run is
# cut to 2 frames of 64 x 64 at width 0.25 to take seconds
BATCH, SIZE, NUM, WIDTH = (2, 64, 4, ",width:0.25") if args.cpu else (8, 224, 32, "")

pipe = ntt.Pipeline(
    f"videotestsrc device=true batch={BATCH} num-buffers={NUM} "
    f"width={SIZE} height={SIZE} pattern=smpte name=src ! "
    "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
    f"tensor_filter framework=jax model=deeplab_mobilenet "
    f"custom=size:{SIZE},batch:{BATCH}{WIDTH} name=f{acc} ! "
    f"tensor_decoder mode=image_segment{form} ! tensor_sink name=out",
)
print(pipe.residency.render())
with pipe:
    buf = pipe.pull("out", timeout=300)
    pipe.wait(timeout=120)
print("class map" if form else "overlay", np.asarray(buf.tensors[0]).shape)
