"""Raw camera bytes to detection and crops on the PyTorch/CUDA port.

A camera hands the pipeline raw RGB bytes, one 1-D uint8 array a frame
(here synthetic: noise with a box moving across it).  ``tensor_converter``
unpacks them and a ``tee`` fans the frame out: one branch is normalised
into ssd_mobilenet, whose tensors a second ``tee`` sends to
``tensor_decoder mode=tensor_region`` (the top regions, in pixels) and
through the flexbuf wire format and back; ``tensor_crop`` pairs each
frame with its regions and emits one crop per region.

    python examples/torch_camera_crop.py          # on the card
    python examples/torch_camera_crop.py --cpu    # on the CPU
"""
import argparse
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="run the filter on the CPU (accelerator=true:cpu)")
ap.add_argument("--size", type=int, default=64, help="frame and model size (x32)")
ap.add_argument("--frames", type=int, default=6)
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""
size = args.size

pipe = ntt.Pipeline(
    f"appsrc name=cam caps=video/x-raw,format=RGB,width={size},height={size},"
    "framerate=30/1 max-inflight=4 ! tensor_converter ! tee name=t "
    "t. ! tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
    f"tensor_filter framework=jax model=ssd_mobilenet custom=size:{size},classes:91,batch:1"
    f"{acc} ! tee name=d "
    f"d. ! tensor_decoder mode=tensor_region option1={size}:{size} option2=3 ! crop.sink_1 "
    "d. ! tensor_decoder mode=flexbuf ! tensor_converter mode=flexbuf ! tensor_sink name=wire "
    "t. ! crop.sink_0 "
    "tensor_crop name=crop ! tensor_sink name=crops")

rng = np.random.default_rng(0)
frames = []
for i in range(args.frames):
    f = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    box = size // 4
    x, y = (i * 7) % (size - box), (i * 3) % (size - box)
    f[y:y + box, x:x + box] = (255, 64, 0)
    frames.append(f.reshape(-1))  # raw bytes, as a camera delivers them

with pipe:
    # the pushes block past max-inflight until the pulls below free credits
    pusher = threading.Thread(target=lambda: [pipe.push("cam", f) for f in frames])
    pusher.start()
    for i in range(len(frames)):
        crops = pipe.pull("crops", timeout=300)
        wire = pipe.pull("wire", timeout=300)
        shapes = [tuple(np.asarray(c).shape) for c in crops.tensors]
        print(f"frame {i}: crops {shapes}; wire round trip "
              f"{[tuple(np.asarray(t).shape) for t in wire.tensors]} "
              f"{[str(np.asarray(t).dtype) for t in wire.tensors]}")
    pusher.join()
    pipe.eos("cam")
    pipe.wait(timeout=60)
print(f"{len(frames)} frames: tee, tensor_region, tensor_crop and the flexbuf round trip")
