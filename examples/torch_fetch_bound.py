"""A deliberately FETCH-BOUND pipeline on the PyTorch/CUDA port: the
full-resolution segmentation overlay.

The overlay decode pins the full output geometry (RGBA media), so the
residency planner cannot select deeplab's native-stride reduced output:
every frame ships its full-resolution class map over the device-to-host
link.  ``lint --deep`` flags it statically when a calibrated link is
configured::

    NNS_TPU_LINK_D2H_MBPS=38.2 NNS_TPU_LINK_RTT_MS=88 \\
        python -m nnstreamer_tpu_torch.tools.lint --deep -v \\
        --files examples/torch_fetch_bound.py

emitting the ``fetch-bound`` diagnostic: the planned copy per buffer
exceeds the device stages' compute floor, so no dispatch overlap can
hide the link.  The fix is in the warning's text: ``option1=classmap``
lets the planner pick the native-stride map.  The port-side copy of
``examples/fetch_bound.py``.

    python examples/torch_fetch_bound.py          # on the card, 224 px, batch 8
    python examples/torch_fetch_bound.py --cpu    # on the CPU, 64 px, batch 2
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nnstreamer_tpu_torch as ntt  # noqa: E402

#: the card's cell; ``--cpu`` shrinks it (the lint reads these values)
BATCH, SIZE, NUM = 8, 224, 32
CUSTOM = ""
ACC = ""


def main():
    global BATCH, SIZE, NUM, CUSTOM, ACC
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at 64 px, batch 2, 4 buffers")
    if ap.parse_args().cpu:
        BATCH, SIZE, NUM = 2, 64, 4
        CUSTOM, ACC = ",dtype:float32", " accelerator=true:cpu"
    pipe = ntt.Pipeline(
        f"videotestsrc device=true batch={BATCH} num-buffers={NUM} "
        f"width={SIZE} height={SIZE} pattern=smpte name=src ! "
        "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
        f"tensor_filter framework=jax model=deeplab_mobilenet "
        f"custom=size:{SIZE},batch:{BATCH}{CUSTOM} name=f{ACC} ! "
        "tensor_decoder mode=image_segment ! tensor_sink name=out")
    print("residency:", pipe.residency.render())
    with pipe:
        buf = pipe.pull("out", timeout=300)
        pipe.wait(timeout=120)
    print("overlay:", np.asarray(buf.tensors[0]).shape)


if __name__ == "__main__":
    main()
