"""Camera ingest -> detection -> overlay on the PyTorch/CUDA port: the
north-star pipeline string (``v4l2src ! ... ! tensor_filter !
tensor_decoder``) in its stock form, the detector's boxes composited back
onto the camera frame.

The port-side counterpart of ``examples/camera_detection.py``.  The port
reads a camera's raw frames from a file or a FIFO (``v4l2src``'s raw
backend; its V4L2 character-device backend is not ported), so a writer
thread plays the camera, as the JAX example does without
``/dev/video0``: it pushes synthetic 640x480 RGB frames with a moving box
into a named pipe, and the pipeline consumes them.  ``videoscale`` shrinks each frame to the detector's 320
px, and ``compositor`` blends the decoder's RGBA overlay onto the frame.

    python examples/torch_camera_detection.py          # on the card
    python examples/torch_camera_detection.py --cpu    # on the CPU
"""
import argparse
import os
import shutil
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import nnstreamer_tpu_torch as ntt  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the detector on the CPU (accelerator=true:cpu)")
ap.add_argument("--frames", type=int, default=3, help="frames to capture")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""

W, H, SIZE = 640, 480, 320

if os.path.exists("/dev/video0"):
    print("/dev/video0 needs v4l2src's character-device backend, which the port "
          "does not have yet: playing the camera from a FIFO instead")
tmp = tempfile.mkdtemp(prefix="nnstpu_cam_")
device = os.path.join(tmp, "cam")
os.mkfifo(device)


def feed():
    with open(device, "wb") as f:
        for i in range(args.frames):
            frame = np.zeros((H, W, 3), np.uint8)
            frame[100 + 20 * i:200 + 20 * i, 150:300] = (255, 64, 0)  # a moving box
            f.write(frame.tobytes())


writer = threading.Thread(target=feed, daemon=True)
writer.start()
print(f"fake camera on FIFO {device}")

pipe = ntt.Pipeline(
    f"v4l2src device={device} width={W} height={H} format=RGB "
    f"num-buffers={args.frames} ! tee name=cam "
    f"cam. ! videoscale width={SIZE} height={SIZE} method=bilinear ! tensor_converter ! "
    "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
    f"tensor_filter framework=jax model=ssd_mobilenet custom=size:{SIZE},classes:91{acc} ! "
    f"tensor_decoder mode=bounding_boxes option3=0.0 option4={W}:{H} ! comp.sink_1 "
    "cam. ! queue ! comp.sink_0 "
    "compositor name=comp ! tensor_sink name=out",
)
try:
    with pipe:
        for i in range(args.frames):
            buf = pipe.pull("out", timeout=300)
            dets = buf.meta.get("detections", [])
            print(f"frame {i}: composited {buf.tensors[0].shape}, {len(dets)} detections")
        pipe.wait(timeout=60)
finally:
    writer.join(timeout=10)
    shutil.rmtree(tmp, ignore_errors=True)
print("camera pipeline done")
