"""nns-slo CLI: validate SLO policies and evaluate them against a
Prometheus scrape (docs/SERVING.md "Front door").

Port of ``nnstreamer_tpu/tools/slo.py``: the same output and exit codes,
over the port's ``utils/slo.py`` policy schema and ``utils/profiler.py``
exposition names (``metrics_text`` is byte-identical to the JAX
package's for the same metrics).

    # schema-check a policy file (the shape the CI soak gate asserts)
    python -m nnstreamer_tpu_torch.tools.slo validate slo.json

    # evaluate objectives against a live /metrics endpoint or a saved
    # exposition dump — per-tenant verdict table, exit 1 on breach
    python -m nnstreamer_tpu_torch.tools.slo report slo.json --url \\
        http://127.0.0.1:9090/metrics
    python -m nnstreamer_tpu_torch.tools.slo report slo.json --text scrape.txt

``report`` reads the tenant-labeled ``<sink>.e2e_latency`` histogram
families and the shed counter family out of the exposition and estimates
p50/p99 at bucket resolution (the upper bound of the bucket the target
rank falls into — conservative: a true quantile is never ABOVE the
estimate's bucket).  Throughput objectives need a rate, which one scrape
cannot provide; with ``--url`` the endpoint is scraped twice
``--interval`` seconds apart and fps derives from the count delta
(``--text`` reports latency/shed objectives only).

In-process, prefer ``Pipeline(slo=...)`` + ``Pipeline.slo_report()`` —
that path reads exact reservoir quantiles and attributes the dominant
span kind from the flight-recorder ring.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict, Optional, Tuple

#: one labeled histogram bucket sample:
#: nnstpu_<family>_bucket{tenant="t",le="0.005"} 3
_BUCKET_RE = re.compile(
    r'^nnstpu_(\w+)_bucket\{tenant="([^"]*)",le="([^"}]+)"\}\s+(\d+)\s*$')
_COUNTER_RE = re.compile(r'^nnstpu_(\w+)\{tenant="([^"]*)"\}\s+([\d.eE+-]+)\s*$')


def _prom(name: str) -> str:
    from ..utils.profiler import _prom_name

    return _prom_name(name)


def parse_exposition(text: str) -> Tuple[dict, dict]:
    """(histograms, counters) keyed ``(family, tenant)`` from exposition
    text: histograms as {le_str: cumulative_count}, counters as float."""
    hists: Dict[Tuple[str, str], Dict[str, int]] = {}
    counters: Dict[Tuple[str, str], float] = {}
    for line in text.splitlines():
        m = _BUCKET_RE.match(line)
        if m:
            fam, tenant, le, cum = m.groups()
            hists.setdefault((fam, tenant), {})[le] = int(cum)
            continue
        m = _COUNTER_RE.match(line)
        if m:
            fam, tenant, val = m.groups()
            counters[(fam, tenant)] = float(val)
    return hists, counters


def quantile_from_buckets(buckets: Dict[str, int], q: float
                          ) -> Optional[float]:
    """q-th percentile (ms) at bucket resolution: the upper bound of the
    bucket the target rank lands in (+Inf clamps to the last finite
    bound)."""
    if not buckets:
        return None
    bounds = sorted((float("inf") if le == "+Inf" else float(le), cum)
                    for le, cum in buckets.items())
    total = bounds[-1][1]
    if total <= 0:
        return None
    rank = max(1, int(q / 100.0 * total + 0.999999))
    last_finite = max((b for b, _ in bounds if b != float("inf")),
                      default=0.0)
    for bound, cum in bounds:
        if cum >= rank:
            return (bound if bound != float("inf") else last_finite) * 1e3
    return last_finite * 1e3


def _scrape(url: str) -> str:
    import urllib.request

    return urllib.request.urlopen(url, timeout=10).read().decode()


def _cmd_validate(args) -> int:
    from ..utils.slo import validate_policy

    try:
        with open(args.policy) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{args.policy}: unreadable: {e}", file=sys.stderr)
        return 1
    problems = validate_policy(doc)
    for p in problems:
        print(f"{args.policy}: {p}", file=sys.stderr)
    if not problems:
        print(f"{args.policy}: OK "
              f"({len(doc.get('tenants', []))} tenant objectives)")
    return 1 if problems else 0


def _cmd_report(args) -> int:
    from ..utils.slo import load_policy

    policy = load_policy(args.policy)
    sinks = policy.sinks or [args.sink]
    if args.text:
        with open(args.text) as f:
            text = text2 = f.read()
        dt = 0.0
    else:
        text = _scrape(args.url)
        dt = max(0.1, args.interval)
        time.sleep(dt)
        text2 = _scrape(args.url)
    h1, c1 = parse_exposition(text)
    h2, c2 = parse_exposition(text2)
    shed_fam = _prom(policy.shed_series)
    fams = [_prom(f"{s}.e2e_latency") for s in sinks]
    tenants = sorted({t for (fam, t) in h2 if fam in fams}
                     | {t.tenant for t in policy.tenants})
    breaches = []
    rows = []
    for tenant in tenants:
        slo = policy.for_tenant(tenant)
        merged: Dict[str, int] = {}
        n2 = n1 = 0
        for fam in fams:
            for le, cum in h2.get((fam, tenant), {}).items():
                merged[le] = merged.get(le, 0) + cum
            n2 += h2.get((fam, tenant), {}).get("+Inf", 0)
            n1 += h1.get((fam, tenant), {}).get("+Inf", 0)
        p50 = quantile_from_buckets(merged, 50.0)
        p99 = quantile_from_buckets(merged, 99.0)
        sheds = c2.get((shed_fam, tenant), 0.0)
        fps = (n2 - n1) / dt if dt > 0 else None
        violations = []
        if slo is not None:
            if slo.p50_ms > 0 and p50 is not None and p50 > slo.p50_ms:
                violations.append(f"p50 {p50:.1f}ms > {slo.p50_ms:g}ms")
            if slo.p99_ms > 0 and p99 is not None and p99 > slo.p99_ms:
                violations.append(f"p99 {p99:.1f}ms > {slo.p99_ms:g}ms")
            if slo.min_fps > 0 and fps is not None and fps < slo.min_fps:
                violations.append(
                    f"throughput {fps:.1f}fps < {slo.min_fps:g}fps")
        if violations:
            breaches.append(tenant)
        rows.append((tenant, n2, p50, p99, fps, sheds, violations))
    if args.json:
        print(json.dumps({
            "ok": not breaches, "breaches": breaches,
            "tenants": {t: {"requests": n, "p50_ms": p50, "p99_ms": p99,
                            "fps": fps, "sheds": sheds,
                            "violations": v}
                        for t, n, p50, p99, fps, sheds, v in rows}},
            indent=1))
    else:
        fmt = "{:<16} {:>8} {:>10} {:>10} {:>8} {:>6}  {}"
        print(fmt.format("tenant", "reqs", "p50(ms)", "p99(ms)", "fps",
                         "sheds", "verdict"))
        for t, n, p50, p99, fps, sheds, v in rows:
            print(fmt.format(
                t, n,
                "-" if p50 is None else f"{p50:.1f}",
                "-" if p99 is None else f"{p99:.1f}",
                "-" if fps is None else f"{fps:.1f}",
                int(sheds),
                "BREACH: " + "; ".join(v) if v else "ok"))
    return 1 if breaches else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.tools.slo",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-check a policy file")
    v.add_argument("policy")
    v.set_defaults(fn=_cmd_validate)
    r = sub.add_parser("report",
                       help="evaluate a policy against a scrape")
    r.add_argument("policy")
    src = r.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", help="/metrics endpoint (scraped twice)")
    src.add_argument("--text", help="saved exposition text file")
    r.add_argument("--sink", default="out",
                   help="sink element name when the policy lists none")
    r.add_argument("--interval", type=float, default=2.0,
                   help="seconds between the two --url scrapes (fps)")
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
