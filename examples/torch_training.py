"""Streaming training on the PyTorch/CUDA port.

The port-side copy of ``examples/training.py``.  Two pipelines, capture
then replay:

1. **Capture**: an appsrc-fed stream of (input, label) samples is recorded
   by ``datareposink manifest=true`` into a binary shard and a JSON
   manifest.
2. **Train**: ``datareposrc`` replays the manifest with a seeded shuffle per
   epoch into ``tensor_trainer``, whose samples go into a window on the
   card and whose update step is one captured CUDA graph; per-epoch stats
   flow to the sink, and ``checkpoint-every=1`` writes an fsync'd,
   step-versioned checkpoint after every epoch (``model-load-path``
   resumes from it bitwise).

    python examples/torch_training.py          # on the card
    python examples/torch_training.py --cpu    # on the CPU

Files go to a temporary directory, or to ``--dir``.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import nnstreamer_tpu_torch as ntt  # noqa: E402

SAMPLES = 32
EPOCHS = 3

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--cpu", action="store_true",
                help="train on the CPU (accelerator=true:cpu)")
ap.add_argument("--dir", help="where the dataset and checkpoints go "
                "(default: a temporary directory)")
args = ap.parse_args()
acc = " accelerator=true:cpu" if args.cpu else ""
tmp = None if args.dir else tempfile.TemporaryDirectory()
out_dir = args.dir or tmp.name
data, meta = os.path.join(out_dir, "xor.bin"), os.path.join(out_dir, "xor.json")
ckpt = os.path.join(out_dir, "model.ckpt")

# 1. capture a live (input, label) stream into a replayable manifest
x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]] * (SAMPLES // 4), np.float32)
y = (x[:, 0].astype(np.int32) ^ x[:, 1].astype(np.int32))[:, None]
cap = ntt.Pipeline(f"appsrc name=src ! datareposink location={data} json={meta} "
                   "manifest=true")
with cap:
    for xi, yi in zip(x, y):
        cap.push("src", [xi, yi])
    cap.eos()
    cap.wait(timeout=60)

# 2. train on the replay
pipe = ntt.Pipeline(
    f"datareposrc json={meta} epochs={EPOCHS} is-shuffle=true shuffle-seed=7 ! "
    f"tensor_trainer framework=jax model=mlp:2:16:2 num-training-samples={SAMPLES} "
    f"epochs={EPOCHS} batch-size=8 learning-rate=0.1 checkpoint-every=1 "
    f"model-save-path={ckpt}{acc} ! tensor_sink name=stats")
with pipe:
    for epoch in range(EPOCHS):
        s = np.asarray(pipe.pull("stats", timeout=300).tensors[0])
        print(f"epoch {epoch}: loss={s[0]:.4f} acc={s[1]:.3f}")
    pipe.wait(timeout=120)
print("checkpoint written:", os.path.exists(ckpt))
if tmp is not None:
    tmp.cleanup()
