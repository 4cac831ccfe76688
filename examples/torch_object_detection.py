"""Config #2: SSD-MobileNet detection with bounding-box decode on the
PyTorch/CUDA port.

The port-side copy of ``examples/object_detection.py``: host video frames
are converted to tensors, and the transform, the model and the decoder's
top-k fuse into one stage (one captured CUDA graph on the card); NMS and
the overlay run at the sink.

    python examples/torch_object_detection.py          # on the card
    python examples/torch_object_detection.py --cpu    # on the CPU
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
    "videotestsrc num-buffers=2 width=96 height=96 pattern=ball ! "
    "tensor_converter ! "
    "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
    f"tensor_filter framework=jax model=ssd_mobilenet custom=size:96,classes:7{acc} ! "
    "tensor_decoder mode=bounding_boxes option3=0.0 option4=96:96 ! "
    "tensor_sink name=out",
)
with pipe:
    for i in range(2):
        buf = pipe.pull("out", timeout=300)
        dets = buf.meta.get("detections", [])
        print(f"frame {i}: overlay {buf.tensors[0].shape}, {len(dets)} detections;"
              f" first: {dets[0] if dets else None}")
    pipe.wait(timeout=60)
