"""Time the port's ``int8_conv`` card kernels at a few layer shapes, for one tree.

    python3 tools/torch_int8_conv_shapes.py [--tree DIR]

imports ``nnstreamer_tpu_torch`` from ``DIR`` (default: this checkout) and
builds its ``csrc/int8_conv.cu`` into ``DIR/build/torch_kernels/``, so that
two trees (a parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, and this one) are compared in one call on the
same card: run parent, change, change, parent.  At each shape, batch 64,
seeded operands: ``int8_conv``'s int32 sums (a padded int8 input) and,
where the tree has it, ``int8_conv_requant``'s fused uint8 layer (the
unpadded uint8 activation, SAME pads), each held bitwise against its plain
version first, then timed as ``chip_smoke.py`` times its rows (median of
20 device-only timings, L2 flushed).  Prints the card line, then one JSON
object.  Needs a CUDA card; imports torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (label, input edge, Cin, O, kernel, stride) at batch 64: MobileNet-v2's
#: 24-channel shapes (channels in fours, not sixteens), and two of
#: MobileNet-v1's 1x1 layers for scale
SHAPES = (("pw 24->144 @56", 56, 24, 144, 1, 1),
          ("conv 24->48 k3 s1 @56", 56, 24, 48, 3, 1),
          ("pw 32->64 @112", 112, 32, 64, 1, 1),
          ("pw 512->512 @14", 14, 512, 512, 1, 1))
BATCH = 64


def timed_ms(fn, flush, reps=20):
    """Median device ms of one call: L2 flushed before each, a spin kernel
    queued ahead of the start event so the events see device time only."""
    import torch

    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def kernel_name(i8, cin, cout, k, stride):
    if hasattr(i8, "int8_conv_kernel"):
        return i8.int8_conv_kernel(cin, cout, 1, k, k, stride)
    return i8.int8_conv_route(cin, 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_int8_conv_shapes: no CUDA device available", file=sys.stderr)
        return 2
    from nnstreamer_tpu_torch.ops import int8_conv as i8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, hw, cin, cout, k, s in SHAPES:
        x = torch.randint(0, 256, (BATCH, hw, hw, cin), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, device=dev,
                          dtype=torch.int8)
        pad8 = 95 - 128
        total = max((-(-hw // s) - 1) * s + k - hw, 0)
        pads = ((total // 2, total - total // 2),) * 2
        (pt, pb), (pl, pr) = pads
        x8p = F.pad((x ^ 128).view(torch.int8), (0, 0, pl, pr, pt, pb), value=pad8)
        x8p = x8p.contiguous()
        acc = i8.int8_conv(x8p, w, s)
        check = torch.equal(acc, i8.int8_conv_reference(x8p, w, s))
        row = dict(label=label, kernel=kernel_name(i8, cin, cout, k, s),
                   int32_bitwise=check,
                   int32_ms=timed_ms(lambda: i8.int8_conv(x8p, w, s), flush_buf.zero_))
        if hasattr(i8, "int8_conv_requant"):
            cb = torch.randint(-3000, 3000, (cout,), generator=gen, device=dev,
                               dtype=torch.int32)
            std = float(acc.to(torch.float64).std()) + 1.0
            mult = torch.full((cout,), 90.0 / std, device=dev)
            fargs = (x, w, cb, mult, s, 1, 1, pads, pad8, 100, 0, 255, torch.uint8)
            got = i8.int8_conv_requant(*fargs)
            row.update(fused_bitwise=torch.equal(got, i8.int8_conv_requant_reference(*fargs)),
                       fused_ms=timed_ms(lambda: i8.int8_conv_requant(*fargs),
                                         flush_buf.zero_))
        rows.append(row)
        print(f"int8_conv_shapes: {json.dumps(row)}", flush=True)
    ok = all(r["int32_bitwise"] and r.get("fused_bitwise", True) for r in rows)
    print(json.dumps(dict(tree=tree, card=card, torch=torch.__version__, ok=ok, rows=rows)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
