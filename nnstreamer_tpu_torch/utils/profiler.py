"""Profiling hooks: device traces + pipeline metrics export.

Port of ``nnstreamer_tpu/utils/profiler.py``:

* :func:`trace` — context manager around :mod:`torch.profiler` that
  writes a Chrome trace of the block (CPU ops, and the card's kernels
  through CUPTI on a CUDA machine); the per-buffer flight recorder
  (``utils/tracing.py``) covers the pipeline layer;
* :func:`metrics_text` — the process metrics in Prometheus text format:
  counters, sampler-fed gauges (queue depth, staleness watermark), real
  cumulative histograms with explicit buckets for every
  ``observe_latency`` series (stage latency, queue wait, end-to-end
  latency) and for ``<stage>.batch_occupancy`` (the batching runner's
  occupancy stream, ``Metrics.value_histograms``), and xray's series;
  the same registry always renders the same bytes as the JAX package's
  for the same state;
* :func:`start_metrics_server` / :func:`stop_metrics_server` /
  :func:`metrics_server` — a ``/metrics`` HTTP endpoint with clean
  shutdown.
"""

from __future__ import annotations

import contextlib
import http.server
import re
import threading
from typing import Optional

from ..core.log import LATENCY_BUCKETS, logger, metrics

log = logger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with :mod:`torch.profiler` (the card's
    activity too when CUDA is available) and write its Chrome trace to
    ``<logdir>/trace.json``; the profile object is yielded."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


#: HELP/TYPE metadata keyed by the raw series suffix the runtime emits per
#: stage, so Prometheus scrapes are well-formed self-describing exposition
#: (docs/BATCHING.md, docs/OBSERVABILITY.md).
_SERIES_META = {
    "batch_occupancy": ("buffers drained per micro-batch dispatch "
                        "(distribution)", "gauge"),
    "batch_pad_waste": ("pad rows appended to reach the bucket size",
                        "counter"),
    "shard_rows": ("rows placed on each mesh device by sharded dispatches",
                   "counter"),
    "shard_dispatch": ("sharded micro-batch dispatches", "counter"),
    "param_replications": ("one-time stage parameter placements onto "
                           "the mesh", "counter"),
    "param_shards": ("param leaves SHARDED over the mesh's `model` axis "
                     "at placement (2-D placement, docs/BATCHING.md)",
                     "counter"),
    "param_replicas": ("param leaves replicated (no `model`-axis pspec) "
                       "at placement", "counter"),
    "queue_depth": ("stage input queue depth (sampler gauge)", "gauge"),
    "inflight_window": ("dispatched-but-unemitted micro-batches held in "
                        "the dispatch window (sampler gauge)", "gauge"),
    "staleness_s": ("seconds since this sink last delivered a buffer "
                    "(pipeline staleness watermark, sampler gauge)",
                    "gauge"),
    "watermark_pts": ("highest presentation timestamp delivered at this "
                      "sink (ns)", "gauge"),
    # front-door series (docs/SERVING.md "Front door")
    "shed": ("requests shed at query-server admission under backlog "
             "(per-tenant labels when the request carried a tenant)",
             "counter"),
    "downgraded": ("requests moved to the low-priority lane under backlog "
                   "(admission=downgrade)", "counter"),
    "sheds": ("shed notices received by this query client", "counter"),
    "backlog": ("query-server inbound backlog depth (gauge)", "gauge"),
    "burn_rate": ("SLO error-budget burn rate: 1.0 = consuming exactly "
                  "the budget (utils/slo.py)", "gauge"),
    "breach": ("SLO breach flag: 1 = tenant currently out of SLO",
               "gauge"),
    # nns-xray predicted-vs-actual series (utils/xray.py,
    # docs/OBSERVABILITY.md "Predicted vs actual")
    "compiles": ("XLA programs compiled by this stage's tracked jit "
                 "entry points (nns-xray program registry)", "counter"),
    "census_drifts": ("compiled programs that escaped the deep lint's "
                      "predicted census (counter; fired at register "
                      "time)", "counter"),
    "census_drift": ("census-drift total, republished every reconciler "
                     "tick (gauge twin of the xray.census_drifts "
                     "counter — distinct names so neither family ever "
                     "changes type between scrapes)", "gauge"),
    "mfu": ("model FLOPs utilization: tracked-program FLOPs per second "
            "of measured dispatch time over the device's peak "
            "(Config.peak_tflops / device-kind table)", "gauge"),
    "roofline_fraction": ("fraction of the compute/HBM roofline this "
                          "stage's dispatches achieve (ideal time from "
                          "cost analysis vs measured)", "gauge"),
    "pad_waste_flops": ("FLOPs spent computing bucket-ladder pad rows "
                        "(the adaptive ladder's pad waste priced in "
                        "FLOPs, not rows)", "counter"),
    "hbm": ("nns-xray HBM ledger: live measured bytes per category "
            "(params / kv_pool / agg_rings / activations)", "gauge"),
    "hbm_predicted": ("nns-xray HBM ledger: the deep-lint estimate per "
                      "category", "gauge"),
    "hbm_drift": ("nns-xray HBM ledger: measured / predicted ratio per "
                  "category (warns past Config.xray_hbm_tolerance)",
                  "gauge"),
}

#: HELP text for histogram series, by raw-name suffix (fallback generic)
_HIST_HELP = {
    "batch_occupancy": "buffers drained per micro-batch dispatch "
                       "(cumulative histogram; bucket bounds mirror the "
                       "static ladder — the adaptive ladder refines from "
                       "this same occupancy stream, docs/BATCHING.md)",
    "proc": "per-buffer stage process latency, seconds (histogram)",
    "invoke": "model invocation latency, seconds (histogram)",
    "push": "source push latency, seconds (histogram)",
    "queue_wait": "seconds a buffer waited in the stage input queue "
                  "(histogram; trace_mode != off)",
    "e2e_latency": "source-ingress-to-sink-delivery pipeline latency, "
                   "seconds (histogram; trace_mode != off)",
}


def _series_meta(raw: str):
    """(help, type) when ``raw`` belongs to a documented series (including
    derived ``.p50``/``.mean`` quantile samples and per-device ``.dN``
    placement counters), else None."""
    for key, (help_, typ) in _SERIES_META.items():
        if raw.endswith("." + key) or f".{key}." in raw or raw == key \
                or raw.startswith(key + "."):
            if raw.endswith((".p50", ".p99", ".mean", ".n")):
                return help_, "gauge"  # derived summary samples
            return help_, typ
    return None


def _hist_help(raw: str) -> str:
    for key, help_ in _HIST_HELP.items():
        if raw.endswith("." + key) or raw == key:
            return help_
    return "latency seconds (histogram)"


def _dedup_prom_names(raws) -> dict:
    """raw -> exposition name: sanitized, with colliding sanitizations
    (``a.b:c`` and ``a.b/c`` both -> ``a_b_c``) disambiguated by a short
    deterministic hash of the raw name — the SAME rule for every sample
    family, so no series silently shadows another and the same registry
    always renders the same text."""
    import hashlib

    by_prom: dict = {}
    for raw in raws:
        by_prom.setdefault(_prom_name(raw), []).append(raw)
    out = {}
    for prom, group in by_prom.items():
        for raw in group:
            out[raw] = prom if len(group) == 1 else \
                f"{prom}_{hashlib.sha1(raw.encode()).hexdigest()[:6]}"
    return out


def _tenant_label_values(raws) -> dict:
    """raw tenant value -> exposition label value.  Tenant label values go
    through the SAME sanitization + deterministic sha1 collision
    disambiguation as series names (``a:b`` and ``a/b`` must not merge
    into one ``a_b`` tenant), so the same registry always renders the
    same labels — scraping twice yields identical series."""
    return _dedup_prom_names(raws)


def _hist_series(lines: list, name: str, counts, total, n,
                 label: str = "", bounds=LATENCY_BUCKETS) -> None:
    """One histogram's sample lines; ``label`` is a pre-rendered
    ``tenant="x",`` prefix for labeled twins (empty for the base).
    ``bounds`` defaults to the latency family's; bucketed value series
    (occupancy) carry their own."""
    cum = 0
    for bound, c in zip(bounds, counts):
        cum += c
        lines.append(f'{name}_bucket{{{label}le="{bound:g}"}} {cum}')
    cum += counts[-1]
    lines.append(f'{name}_bucket{{{label}le="+Inf"}} {cum}')
    suffix = f"{{{label[:-1]}}}" if label else ""
    lines.append(f"{name}_sum{suffix} {total:.9g}")
    lines.append(f"{name}_count{suffix} {n}")


def _render_histograms(lines: list) -> None:
    """Cumulative ``_bucket``/``_sum``/``_count`` exposition for every
    observe_latency series (real Prometheus histograms — aggregatable
    across scrapes, unlike the point-in-time quantile gauges).  Labeled
    (per-tenant) twins render under the SAME family — one
    ``# HELP``/``# TYPE`` header, base sample first, then one sample set
    per tenant."""
    hists = metrics.histograms()
    vhists = metrics.value_histograms()
    labeled = metrics.labeled_histograms()
    by_name: dict = {}
    for (raw, ten), h in labeled.items():
        by_name.setdefault(raw, {})[ten] = h
    names = _dedup_prom_names(set(hists) | set(by_name) | set(vhists))
    tlabels = _tenant_label_values({t for (_, t) in labeled})
    for raw in sorted(names):
        name = f"nnstpu_{names[raw]}"
        lines.append(f"# HELP {name} {_hist_help(raw)}")
        lines.append(f"# TYPE {name} histogram")
        if raw in hists:
            counts, total, n = hists[raw]
            _hist_series(lines, name, counts, total, n)
        if raw in vhists:
            # bucketed value series (occupancy): own bounds, same
            # cumulative _bucket/_sum/_count exposition family
            bounds, counts, total, n = vhists[raw]
            _hist_series(lines, name, counts, total, n, bounds=bounds)
        for ten in sorted(by_name.get(raw, ()),
                          key=lambda t: tlabels[t]):
            counts, total, n = by_name[raw][ten]
            _hist_series(lines, name, counts, total, n,
                         label=f'tenant="{tlabels[ten]}",')


def metrics_text(openmetrics: bool = False) -> str:
    """Render the global metrics registry in Prometheus text format.

    Histograms first (``observe_latency`` series), then gauges, then
    counters + derived quantile samples.  Sanitized names that COLLIDE
    (``a.b:c`` and ``a.b/c`` both sanitize to ``a_b_c``) are
    disambiguated deterministically: every colliding raw name gets a
    short hash of itself appended, so no sample silently shadows another
    and the same registry always renders the same text (scraping twice
    yields identical series names).  Per-tenant labeled twins render
    under the same family as ``{tenant="..."}`` samples, with tenant
    label values passed through the SAME sanitize+hash rule.

    ``openmetrics=True`` appends the mandatory ``# EOF`` trailer — the
    OpenMetrics framing a negotiating scraper (``Accept:
    application/openmetrics-text``) uses to detect truncated bodies; the
    ``/metrics`` handler selects it via content negotiation.
    """
    lines: list = []
    _render_histograms(lines)
    gauges = metrics.gauges()
    lgauges = metrics.labeled_gauges()
    lg_by_name: dict = {}
    for (raw, ten), v in lgauges.items():
        lg_by_name.setdefault(raw, {})[ten] = v
    gnames = _dedup_prom_names(set(gauges) | set(lg_by_name))
    gtlabels = _tenant_label_values({t for (_, t) in lgauges})
    for raw in sorted(gnames):
        name = f"nnstpu_{gnames[raw]}"
        meta = _series_meta(raw)
        lines.append(f"# HELP {name} "
                     f"{meta[0] if meta else 'instantaneous gauge'}")
        lines.append(f"# TYPE {name} gauge")
        if raw in gauges:
            lines.append(f"{name} {gauges[raw]:.9g}")
        for ten in sorted(lg_by_name.get(raw, ()),
                          key=lambda t: gtlabels[t]):
            lines.append(f'{name}{{tenant="{gtlabels[ten]}"}} '
                         f"{lg_by_name[raw][ten]:.9g}")
    snap = metrics.snapshot()
    lcounters = metrics.labeled_counters()
    lc_by_name: dict = {}
    for (raw, ten), v in lcounters.items():
        lc_by_name.setdefault(raw, {})[ten] = v
    counters = [raw for raw in set(snap) | set(lc_by_name)
                if raw not in gauges and raw not in lg_by_name]
    cnames = _dedup_prom_names(counters)
    ctlabels = _tenant_label_values({t for (_, t) in lcounters})
    for raw in sorted(counters):
        name = cnames[raw]
        meta = _series_meta(raw)
        # OpenMetrics: counter SAMPLES are named `<family>_total` (the
        # parser rejects a typed counter sample without the suffix);
        # untyped series stay "unknown" and keep the bare name
        sample = name
        if meta is not None:
            lines.append(f"# HELP nnstpu_{name} {meta[0]}")
            lines.append(f"# TYPE nnstpu_{name} {meta[1]}")
            if openmetrics and meta[1] == "counter":
                sample = f"{name}_total"
        if raw in snap:
            lines.append(f"nnstpu_{sample} {snap[raw]:.9g}")
        for ten in sorted(lc_by_name.get(raw, ()),
                          key=lambda t: ctlabels[t]):
            lines.append(f'nnstpu_{sample}{{tenant="{ctlabels[ten]}"}} '
                         f"{lc_by_name[raw][ten]:.9g}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


#: OpenMetrics media type (negotiated via the Accept header); the
#: classic Prometheus text exposition stays the default
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
_PROM_CONTENT_TYPE = "text/plain; version=0.0.4"


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_response(404)
            self.end_headers()
            return
        # Content negotiation: a scraper that asks for OpenMetrics gets
        # the matching Content-Type AND the `# EOF` trailer (its
        # truncation detector); everyone else keeps the classic text
        # exposition byte-for-byte.
        accept = self.headers.get("Accept", "") or ""
        om = "application/openmetrics-text" in accept
        body = metrics_text(openmetrics=om).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         OPENMETRICS_CONTENT_TYPE if om
                         else _PROM_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class _MetricsServer(http.server.ThreadingHTTPServer):
    # SO_REUSEADDR: a restart must rebind the port without waiting out
    # TIME_WAIT (http.server sets it too — pinned explicitly here so the
    # contract survives a base-class change)
    allow_reuse_address = True
    daemon_threads = True


def start_metrics_server(port: int = 0, host: str = "127.0.0.1"):
    """Serve ``/metrics`` on a daemon thread; returns the HTTPServer (its
    ``server_port`` reports the bound port).  Stop cleanly with
    :func:`stop_metrics_server` (or use the :func:`metrics_server`
    context manager)."""
    srv = _MetricsServer((host, port), _MetricsHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name=f"metrics:{srv.server_port}")
    srv._nns_thread = t  # joined by stop_metrics_server
    t.start()
    return srv


def stop_metrics_server(srv, timeout: float = 5.0) -> None:
    """Shut the ``/metrics`` endpoint down and release its port: stops the
    serve loop, joins the server thread, closes the listening socket.
    Safe to call twice."""
    srv.shutdown()
    t = getattr(srv, "_nns_thread", None)
    if t is not None and t.is_alive():
        t.join(timeout=timeout)
    srv.server_close()


@contextlib.contextmanager
def metrics_server(port: int = 0, host: str = "127.0.0.1"):
    """``with metrics_server() as srv:`` — endpoint for the block's
    lifetime, cleanly stopped on exit."""
    srv = start_metrics_server(port, host)
    try:
        yield srv
    finally:
        stop_metrics_server(srv)
