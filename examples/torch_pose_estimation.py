"""Config #3: PoseNet keypoints (heatmap -> skeleton decode) on the
PyTorch/CUDA port.

The port-side copy of ``examples/pose_estimation.py``: host video frames
are converted to tensors, and the transform, the model and the decoder's
heatmap argmax fuse into one stage (one captured CUDA graph on the card);
the keypoints and the skeleton overlay resolve at the sink.

    python examples/torch_pose_estimation.py          # on the card
    python examples/torch_pose_estimation.py --cpu    # on the CPU
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the filter on the CPU (accelerator=true:cpu)")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""

pipe = ntt.Pipeline(
    "videotestsrc num-buffers=1 width=96 height=96 pattern=ball ! "
    "tensor_converter ! "
    "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
    f"tensor_filter framework=jax model=posenet custom=size:96,width:0.5{acc} ! "
    "tensor_decoder mode=pose_estimation option2=96:96 option3=0.0 ! "
    "tensor_sink name=out",
)
with pipe:
    buf = pipe.pull("out", timeout=300)
    pipe.wait(timeout=60)
kps = buf.meta.get("keypoints")
print("first keypoints:", [
    {k: round(float(v), 1) for k, v in kp.items()} if isinstance(kp, dict) else kp
    for kp in (kps or [])[:3]
])
