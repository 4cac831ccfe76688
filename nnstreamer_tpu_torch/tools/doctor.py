"""pipeline doctor: one predicted-vs-actual report for a live pipeline.

Port of ``nnstreamer_tpu/tools/doctor.py``.  The lint PREDICTS (the
census of captured steps, the memory high-water mark by category, fetch
verdicts); the doctor runs a pipeline with xray on and VERIFIES, joining
plan, residency, census, the memory ledger, device time / MFU from CUDA
events, and the SLO verdict into one report with a JSON twin.

    # the built-in bench pipeline (appsrc -> scaler filter -> sink,
    # burst-pushed so the bucket ladder captures), on the card
    python -m nnstreamer_tpu_torch.tools.doctor --json report.json
    python -m nnstreamer_tpu_torch.tools.doctor --cpu      # on the CPU

    # any self-driving pipeline string
    python -m nnstreamer_tpu_torch.tools.doctor \\
        "videotestsrc num-buffers=64 ! tensor_converter ! fakesink"

    # gate mode: deterministic verdict lines
    python -m nnstreamer_tpu_torch.tools.doctor --gate

    # bench mode: xray-off vs xray-on wall-time A/B
    python -m nnstreamer_tpu_torch.tools.doctor --bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the built-in bench pipeline: the adaptive-batching bench's shape
#: (bench.py --config batching) at doctor scale — a backlogged device
#: filter whose bucket ladder, single-buffer program, and activation
#: window all exercise the census + ledger
BENCH_DIMS = 64
BENCH_DESC = (
    f"appsrc name=src caps=other/tensors,dimensions={BENCH_DIMS},"
    "types=float32 ! "
    f"tensor_filter framework=jax model=scaler "
    f"custom=scale:1.5,dims:{BENCH_DIMS} name=f{{acc}} ! "
    "tensor_sink name=out"
)


def _drive_bench(batch_max: int, frames_n: int, *, xray: bool,
                 trace_mode: str, cpu: bool = False):
    """Run the built-in bench pipeline to completion; returns
    ``(report_or_None, drive_seconds)`` — explain() runs BEFORE stop()
    so the ledger still sees live frameworks/pools."""
    import numpy as np

    from ..pipeline.runtime import Pipeline

    frames = [np.full((BENCH_DIMS,), float(i % 7), np.float32)
              for i in range(8)]
    desc = BENCH_DESC.format(acc=" accelerator=true:cpu" if cpu else "")
    p = Pipeline(desc, queue_capacity=64, batch_max=batch_max,
                 xray=xray, trace_mode=trace_mode)
    try:
        p.start()
        t0 = time.perf_counter()
        # burst pushes so the runner actually drains micro-batches (the
        # bucket ladder compiles); pulls drain the sink
        for i in range(frames_n):
            p.push("src", frames[i % len(frames)])
        for _ in range(frames_n):
            p.pull("out", timeout=120)
        dt = time.perf_counter() - t0
        p.eos()
        p.wait(timeout=120)
        rep = p.explain() if xray else None
        return rep, dt
    finally:
        p.stop()


def _run_pipeline(desc: str, timeout: float):
    """Run a self-driving pipeline string with xray + the ring recorder
    on; explain() before stop()."""
    from ..pipeline.runtime import Pipeline

    p = Pipeline(desc, xray=True, trace_mode="ring")
    try:
        p.start()
        p.wait(timeout=timeout)
        return p.explain()
    finally:
        p.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.tools.doctor",
        description=__doc__.splitlines()[0])
    ap.add_argument("pipeline", nargs="?", default=None,
                    help="self-driving pipeline string (default: the "
                         "built-in bench pipeline)")
    ap.add_argument("--batch-max", type=int, default=4,
                    help="bench pipeline batch_max (default 4)")
    ap.add_argument("--frames", type=int, default=192,
                    help="bench pipeline frames to push (default 192)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the bench pipeline's filter on the CPU "
                         "(accelerator=true:cpu); default: the card")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--gate", action="store_true",
                    help="print only the deterministic verdict lines "
                         "(the CI baseline contract) and exit non-zero "
                         "on drift")
    ap.add_argument("--bench", action="store_true",
                    help="xray-off vs xray-on wall A/B; prints one "
                         "{\"metric\": ...} JSON line")
    args = ap.parse_args(argv)

    from ..core.log import metrics
    from ..utils import tracing, xray

    if args.bench:
        # interleaved off/on pairs; medians keep one scheduler hiccup
        # from defining the result
        offs, ons = [], []
        drift = 0
        for _ in range(3):
            metrics.reset()
            xray.registry.reset()
            _, dt_off = _drive_bench(args.batch_max, args.frames,
                                     xray=False, trace_mode="off",
                                     cpu=args.cpu)
            metrics.reset()
            xray.registry.reset()
            rep, dt_on = _drive_bench(args.batch_max, args.frames,
                                      xray=True, trace_mode="off",
                                      cpu=args.cpu)
            offs.append(dt_off)
            ons.append(dt_on)
            # EVERY measured round pins drift 0, not just the last one
            # (the reset between rounds must not launder an early drift)
            drift += rep["census"]["drift_total"]
        off_m = sorted(offs)[1]
        on_m = sorted(ons)[1]
        overhead = (on_m / off_m - 1.0) * 100.0 if off_m > 0 else 0.0
        print(json.dumps({
            "metric": "doctor_overhead_pct", "value": round(overhead, 2),
            "unit": "%",
            "off_s": offs, "on_s": ons,
            "census_drift": drift,
            "note": "xray-on vs xray-off wall time on the bench "
                    "pipeline (3 interleaved rounds, median); drift "
                    "must be 0",
        }))
        # a run with live census drift is a regression, not a measurement
        return 0 if drift == 0 else 1

    metrics.reset()
    xray.registry.reset()
    tracing.recorder.clear()
    if args.pipeline:
        rep = _run_pipeline(args.pipeline, args.timeout)
    else:
        rep, _dt = _drive_bench(args.batch_max, args.frames, xray=True,
                                trace_mode="ring", cpu=args.cpu)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=1)
    if args.gate:
        for line in xray.verdict_lines(rep):
            print(line)
    else:
        print(xray.render_report(rep))
        if args.json_out:
            print(f"json twin: {args.json_out}")
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
