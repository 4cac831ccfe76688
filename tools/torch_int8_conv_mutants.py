"""Plant faults in the port's fused ``int8_conv`` epilogue and show that
``chip_smoke.py``'s checks report each one.

    python3 tools/torch_int8_conv_mutants.py [--out DIR]

For each fault below, copies ``nnstreamer_tpu_torch/`` and
``chip_smoke.py`` into ``DIR/<fault>/`` (default ``build/mutants/``,
listed in ``.gitignore``), edits that copy's ``csrc/int8_conv.cu`` (the
edit must apply exactly once), builds it there and runs the ``modelfiles``
phase's two kernel checks, ``int8_conv_rows`` (every MobileNet-v1 layer
shape) and ``int8_edge_cases``, each on its own.  A copy with no fault
runs too, as the control: it must pass both, and every fault must fail
both with a message that outputs differ.  The copies run one after
another.  Prints the card line, then one JSON object; exits 0 only if
every check came out so.  Needs a CUDA card; imports torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REQUANT = ("  float y = __fadd_rn(rintf(__fmul_rn(__int2float_rn(v), mult)), zpf);\n")
_GEMM_SUM = ("          const int v = wrap_sub(wrap_add(acc[mi][ni][2 * h + e], cbv[ni][e]),\n"
             "                                 wrap_mul(wzv[ni][e], sx));\n"
             "          q[e] = requant(v, mv[ni][e], zpf, lo, hi);\n")

#: fault name -> (what it models, text of csrc/int8_conv.cu, its replacement)
FAULTS = {
    "none": ("the control: the source as it is", None, None),
    "round_half_away": (
        "rounding half away from zero (roundf) where the JAX package rounds half to even",
        _REQUANT,
        "  float y = __fadd_rn(roundf(__fmul_rn(__int2float_rn(v), mult)), zpf);\n"),
    "fma_contracted": (
        "the multiply and the zero point's add contracted into one FMA, rounded once",
        _REQUANT,
        "  float y = rintf(__fmaf_rn(__int2float_rn(v), mult, zpf));\n"),
    "cb_after_requant": (
        "the GEMM epilogue adds cb to the requantized value instead of to the sum",
        _GEMM_SUM,
        "          const int v = wrap_sub(acc[mi][ni][2 * h + e], wrap_mul(wzv[ni][e], sx));\n"
        "          q[e] = requant(v, mv[ni][e], zpf, lo, hi) + cbv[ni][e];\n"),
}

_CHILD = """
import json, sys, torch
import chip_smoke
from nnstreamer_tpu_torch.ops import kernels
kernels.build(("int8_conv",))
dev = torch.device("cuda", 0)
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
out = {}
for name, fn in (
        ("int8_conv_rows", lambda: chip_smoke.int8_conv_rows(dev, flush.zero_, 3.35e12, 1979e12)),
        ("int8_edge_cases", lambda: chip_smoke.int8_edge_cases(dev))):
    try:
        fn()
        out[name] = "passed"
    except RuntimeError as e:
        out[name] = "failed: " + str(e)
print("RESULT " + json.dumps(out))
"""


def plant(out_dir: str, name: str) -> str:
    tree = os.path.join(out_dir, name)
    shutil.rmtree(tree, ignore_errors=True)
    os.makedirs(tree)
    shutil.copytree(os.path.join(ROOT, "nnstreamer_tpu_torch"),
                    os.path.join(tree, "nnstreamer_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
    _, old, new = FAULTS[name]
    if old is not None:
        src = os.path.join(tree, "nnstreamer_tpu_torch", "csrc", "int8_conv.cu")
        text = open(src).read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace occurs {text.count(old)} times")
        with open(src, "w") as fh:
            fh.write(text.replace(old, new))
    return tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mutants"))
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if card.returncode != 0:
        print("torch_int8_conv_mutants: no card", file=sys.stderr)
        return 2
    print(card.stdout.strip().splitlines()[0], flush=True)
    results = {}
    for name, (what, _, _) in FAULTS.items():
        tree = plant(args.out, name)
        run = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree, capture_output=True,
                             text=True, timeout=300)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
        res = json.loads(lines[-1][len("RESULT "):]) if lines else dict(
            error=f"rc {run.returncode}: {run.stderr[-2000:]}")
        want = "passed" if name == "none" else "failed"
        res["as_expected"] = all(
            res.get(k, "").startswith(want) and (name == "none" or "differ" in res[k])
            for k in ("int8_conv_rows", "int8_edge_cases"))
        results[name] = dict(what=what, **res)
        print(f"mutant {name}: {json.dumps(results[name])}", flush=True)
    ok = all(r["as_expected"] for r in results.values())
    print(json.dumps(dict(ok=ok, faults=results)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
