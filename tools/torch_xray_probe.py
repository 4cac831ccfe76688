"""Drive ``chip_smoke.py``'s ``xray`` phase alone on a CUDA card.

Builds the kernels, then runs ``chip_smoke.phase_xray`` (the deep lint of
the continuous llama2_7b int4 cell, that cell under xray, the quick-start's
bucket census, ``doctor --gate``, a scrape, the pinned link) with a stand-in
for the continuous phase's xray-off tok/s, prints its lines and writes its
detail to ``chiprun_out/xray_probe.json``.  Run from the root of a checkout:

    python tools/torch_xray_probe.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from nnstreamer_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("torch_xray_probe: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    x = cs.phase_xray(dev, dict(aggregate_tok_s=1.0, window_s=1.0))
    print(f"xray phase {time.perf_counter() - t0:.1f} s", flush=True)
    cs.print_xray(x, card)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "xray_probe.json"), "w") as fh:
        json.dump(x, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
