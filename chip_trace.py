#!/usr/bin/env python3
"""Trace the continuous cell of a checkout's ``chip_smoke.py`` on one CUDA
card: the card's busy time and idle share over the cell's counted run.

    python3 chip_trace.py [TREE]

``TREE`` is the root of a checkout of the port (default: the directory of
this script), for example a parent commit unpacked with ``git archive``,
so that two versions are traced the same way in one session on one card.
The script builds TREE's kernels and runs TREE's own
``chip_smoke.phase_continuous`` unchanged, with ``torch.profiler`` (card
activity only) on across its counted run.  The window opens at the
phase's reset of the peak-memory statistics, just before its first push,
and closes at its read of the peak, after the loop has drained and the
pipeline has ended; the card is synchronized before the window closes,
and the profiler's own start and stop lie outside it.  Busy time is the
sum of the card's kernel, copy and fill times in the trace.

The trace slows the host (CUPTI records every launch), so the window is
longer than an untraced run's; the untraced cell is ``chip_smoke.py``'s.
Prints the card's name and power limit, then one JSON line.  Exits
non-zero without a CUDA card.
"""

import json
import os
import sys
import time


def main(argv):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_trace: no CUDA device available", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    import chip_smoke
    from nnstreamer_tpu_torch.ops import kernels

    for mod in (chip_smoke, kernels):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from {mod.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    kernels.build()

    window = {}
    reset_peak, read_peak = torch.cuda.reset_peak_memory_stats, torch.cuda.max_memory_allocated

    def opened(*args, **kwargs):
        if "prof" not in window:
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        return reset_peak(*args, **kwargs)

    def closed(*args, **kwargs):
        if "prof" in window and "t1" not in window:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            window["prof"].stop()
        return read_peak(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats, torch.cuda.max_memory_allocated = opened, closed
    try:
        cont = chip_smoke.phase_continuous(dev)
    finally:
        torch.cuda.reset_peak_memory_stats, torch.cuda.max_memory_allocated = \
            reset_peak, read_peak
    window_ms = (window["t1"] - window["t0"]) * 1e3
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in window["prof"].key_averages()) / 1e3
    steps, chunks = cont["decode_steps"], cont["prefill_chunks"]
    print(card)
    print(json.dumps(dict(
        tree=tree, window_ms=window_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / window_ms, decode_steps=steps,
        prefill_chunks=chunks,
        traced_aggregate_tok_s=cont["aggregate_tok_s"], traced_window_s=cont["window_s"])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
