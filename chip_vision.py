#!/usr/bin/env python3
"""Run a checkout's vision phase on one CUDA card, with a digest of its
host-fed quick-start's outputs, so that two versions are compared the same
way, in one call on one card.

    python3 chip_vision.py [TREE] [TAG]

``TREE`` is the root of a checkout of the port (default: the directory of
this script), for example a parent commit unpacked with ``git archive``.
The script runs TREE's own ``chip_smoke.phase_vision`` unchanged, then
TREE's ``vision_host_fed`` once more over the quick-start's frames (batch
64, drawn from seed 0 as the phase draws them) and prints a SHA-1 of every
batch's labels and scores: equal digests mean bitwise equal outputs.
Prints the card's name and power limit, then one JSON line.  Exits
non-zero without a CUDA card.
"""

import hashlib
import json
import os
import sys
import time


def main(argv):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_vision: no CUDA device available", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(os.path.abspath(__file__)))
    tag = argv[1] if len(argv) > 1 else os.path.basename(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    if not os.path.abspath(cs.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    v = cs.phase_vision(dev)
    phase_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (cs.VISION_BATCH, 224, 224, 3), dtype=np.uint8)
              for _ in range(cs.VISION_WARM + cs.VISION_TIMED)]
    outs, st = cs.vision_host_fed(cs.QUICKSTART.format(
        size=224, batch=cs.VISION_BATCH, model="mobilenet_v1", custom="", acc=""), frames)
    digest = hashlib.sha1()
    for labels, scores in outs:
        digest.update(np.ascontiguousarray(labels).tobytes())
        digest.update(np.ascontiguousarray(scores).tobytes())
    qs, src, det = v["quickstart"], v["quickstart_device_source"], v["detection"]
    print(card)
    print(json.dumps(dict(
        tag=tag, quickstart_frames_per_s=qs["frames_per_s"], quickstart_p50_ms=qs["p50_ms"],
        quickstart_p99_ms=qs["p99_ms"], quickstart_card_ms=qs["card_ms_per_batch"],
        device_source_frames_per_s=src["frames_per_s"],
        detection_device_frames_per_s=det["device"]["frames_per_s"],
        detection_host_frames_per_s=det["host"]["frames_per_s"],
        rerun_frames_per_s=st["frames_per_s"], outputs_sha1=digest.hexdigest(),
        phase_s=phase_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
