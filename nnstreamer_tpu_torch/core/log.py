"""Structured logging (reference analog: nnstreamer_log.c nns_logi/logw/loge).

Port of ``nnstreamer_tpu/core/log.py``: counters, gauges, latency
reservoirs and histograms, each with its tenant-labelled twin, as the
query front door, tracing and the sinks stamp them.  Trimmed, for the
slices that read them: the occupancy histograms
(``observe_bucketed``/``value_histograms``, the batching runner's) and
``fraction_over`` (the SLO engine's).

Also hosts the lightweight metrics registry promised by SURVEY.md §5.5:
frames in/out, queue depths, bytes moved, per-stage latency percentiles are
recorded in-process and dumped on demand — the reference had only GST debug
categories plus tensor_filter's latency property.

Three sample families (all rendered by ``utils/profiler.metrics_text`` in
Prometheus text format, docs/OBSERVABILITY.md):

* **counters** (:meth:`Metrics.count`) — monotonically increasing totals;
* **gauges** (:meth:`Metrics.gauge`) — set-not-add instantaneous values
  (queue depths, staleness watermarks — fed by the runtime's sampler);
* **distributions** (:meth:`Metrics.observe` /
  :meth:`Metrics.observe_latency`) — a BOUNDED per-series reservoir
  (decimating at ``_lat_cap`` samples, so a hot stage can never grow
  process memory without limit) from which quantiles derive, and — for
  ``observe_latency`` series — a cumulative fixed-bucket **histogram**
  (``LATENCY_BUCKETS``), the real ``_bucket``/``_sum``/``_count``
  exposition Prometheus can aggregate across scrapes.

Every family optionally splits **per tenant** (docs/SERVING.md "Front
door"): ``count/gauge/observe_latency`` accept ``tenant=``.  For
counters and latency observations a non-None tenant updates BOTH the
base series (the aggregate everyone already scrapes) and a labeled twin
rendered as ``{tenant="..."}`` samples under the same exposition
family.  Gauges are the exception: a tenant gauge writes ONLY the
labeled twin — gauges are set-not-add, so writing one tenant's value
through to the base sample would clobber the aggregate (the base gauge
is set separately, e.g. by the runtime sampler).  ``tenant=None`` is
byte-for-byte the pre-tenant hot path — no extra lookups, no labeled
state.

Thread-safety discipline: every mutation and every raw-state copy happens
under one lock, but derived work (sorting reservoirs for quantiles) runs
on the COPY outside the lock — concurrent runner writes never stall
behind a scrape's O(n log n).
"""

from __future__ import annotations

import bisect
import collections
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("NNS_TPU_LOG", "WARNING").upper()
        logging.basicConfig(level=getattr(logging, level, logging.WARNING), format=_FMT)
        _configured = True
    return logging.getLogger(name)


#: histogram bucket upper bounds (seconds) for every observe_latency
#: series: 100 µs .. 10 s log-ish spaced (explicit ``le`` labels in the
#: Prometheus exposition; the final implicit bucket is +Inf)
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


#: an admission (h2d) or materialization (d2h) wait above this is a real
#: transport/backlog stall, not a lock hop — ONE threshold for both
#: halves of the fetch-engine stall split (``<src>.h2d_stalls`` in
#: elements/source.py, ``<sink>.d2h_stalls`` in elements/sink.py) so the
#: two directions stay comparable.  docs/FETCH.md "Stall accounting".
STALL_FLOOR_S = 1e-3


class Metrics:
    """Process-wide counters + gauges + latency reservoirs/histograms,
    thread-safe (see module docstring for the lock discipline)."""

    #: nns-tsan lock discipline (lint --threads verifies statically,
    #: NNS_TPU_TSAN=1 verifies live — docs/ANALYSIS.md "Threads pass")
    _GUARDED_BY = {
        "_counters": "_lock", "_gauges": "_lock", "_lat": "_lock",
        "_hist": "_lock", "_lcounters": "_lock",
        "_lgauges": "_lock", "_llat": "_lock", "_lhist": "_lock",
    }

    def __init__(self):
        # function-level import: utils.locks is stdlib-only, but core.log
        # is imported package-wide at init and the lazy import keeps the
        # core -> utils edge out of module load order
        from ..utils.locks import make_lock

        self._lock = make_lock("Metrics._lock")
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._lat: Dict[str, List[float]] = collections.defaultdict(list)
        #: per-series reservoir bound: at cap, every other sample is
        #: dropped (decimation keeps a uniform-ish spread of the stream's
        #: lifetime instead of only its head or tail)
        self._lat_cap = 4096
        # name -> [bucket_counts(len(LATENCY_BUCKETS)+1 incl +Inf),
        #          sum, count]
        self._hist: Dict[str, list] = {}
        # labeled twins, keyed (name, tenant) — populated only when a
        # caller passes tenant= (docs/SERVING.md "Front door")
        self._lcounters: Dict[Tuple[str, str], float] = \
            collections.defaultdict(float)
        self._lgauges: Dict[Tuple[str, str], float] = {}
        self._llat: Dict[Tuple[str, str], List[float]] = \
            collections.defaultdict(list)
        self._lhist: Dict[Tuple[str, str], list] = {}

    def count(self, name: str, value: float = 1.0,
              tenant: Optional[str] = None) -> None:
        with self._lock:
            self._counters[name] += value
            if tenant is not None:
                self._lcounters[(name, tenant)] += value

    def gauge(self, name: str, value: float,
              tenant: Optional[str] = None) -> None:
        """Set an instantaneous value (queue depth, staleness watermark)."""
        with self._lock:
            if tenant is not None:
                self._lgauges[(name, tenant)] = float(value)
            else:
                self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one sample of a distribution (batch occupancy, sizes,
        ...); snapshot() derives p50/p99/mean/n per series.  The reservoir
        is BOUNDED at ``_lat_cap`` (decimation), so a hot series costs
        O(cap) memory for the process lifetime, not O(samples)."""
        with self._lock:
            self._observe_locked(self._lat, name, value)

    def _observe_locked(self, store, key, value: float) -> None:
        r = store[key]
        if len(r) >= self._lat_cap:
            # reservoir decimation: keep every other sample
            del r[::2]
        r.append(value)

    def _hist_locked(self, store, key, i: int, seconds: float) -> None:
        h = store.get(key)
        if h is None:
            h = store[key] = [[0] * (len(LATENCY_BUCKETS) + 1), 0.0, 0]
        h[0][i] += 1
        h[1] += seconds
        h[2] += 1

    def observe_latency(self, name: str, seconds: float,
                        tenant: Optional[str] = None) -> None:
        """observe() + cumulative fixed-bucket histogram update — the
        series Prometheus can aggregate (``<name>_bucket{le=...}``).
        ``tenant`` additionally feeds the labeled twin series."""
        i = bisect.bisect_left(LATENCY_BUCKETS, seconds)
        with self._lock:
            self._observe_locked(self._lat, name, seconds)
            self._hist_locked(self._hist, name, i, seconds)
            if tenant is not None:
                key = (name, tenant)
                self._observe_locked(self._llat, key, seconds)
                self._hist_locked(self._lhist, key, i, seconds)

    def observe_latency_labeled(self, name: str, seconds: float,
                                tenant: str) -> None:
        """Update ONLY the labeled twin (no base-series sample) — for
        call sites that already fed the base series once per dispatch
        and split the amortized per-row time across member tenants."""
        i = bisect.bisect_left(LATENCY_BUCKETS, seconds)
        with self._lock:
            key = (name, tenant)
            self._observe_locked(self._llat, key, seconds)
            self._hist_locked(self._lhist, key, i, seconds)

    def percentile(self, name: str, q: float,
                   tenant: Optional[str] = None) -> Optional[float]:
        with self._lock:
            if tenant is not None:
                r = list(self._llat.get((name, tenant), ()))
            else:
                r = list(self._lat.get(name, ()))
        if not r:
            return None
        r.sort()  # on the copy — never under the lock
        idx = min(len(r) - 1, max(0, math.ceil(q / 100.0 * len(r)) - 1))
        return r[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            lat = {name: list(r) for name, r in self._lat.items() if r}
        for name, s in lat.items():  # derived stats on copies, lock-free
            s.sort()
            out[f"{name}.p50"] = s[len(s) // 2]
            out[f"{name}.p99"] = s[min(len(s) - 1, int(len(s) * 0.99))]
            out[f"{name}.mean"] = sum(s) / len(s)
            out[f"{name}.n"] = float(len(s))
        return out

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> Dict[str, Tuple[List[int], float, int]]:
        """Copy of every latency histogram: name -> (per-bucket counts
        incl. the final +Inf bucket, sum_seconds, count)."""
        with self._lock:
            return {name: (list(h[0]), h[1], h[2])
                    for name, h in self._hist.items()}

    # -- labeled (per-tenant) accessors -----------------------------------
    def labeled_histograms(self) -> Dict[Tuple[str, str],
                                         Tuple[List[int], float, int]]:
        """Copy of every tenant-labeled latency histogram:
        (name, tenant) -> (bucket counts incl. +Inf, sum_seconds, n)."""
        with self._lock:
            return {key: (list(h[0]), h[1], h[2])
                    for key, h in self._lhist.items()}

    def reservoir(self, name: str,
                  tenant: Optional[str] = None) -> List[float]:
        """Copy of one distribution's bounded reservoir (the quantile
        source) — base series, or the labeled twin when ``tenant``."""
        with self._lock:
            if tenant is not None:
                return list(self._llat.get((name, tenant), ()))
            return list(self._lat.get(name, ()))

    def labeled_counters(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            return dict(self._lcounters)

    def labeled_gauges(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            return dict(self._lgauges)

    def tenants(self, name: str) -> List[str]:
        """Sorted tenant label values seen on any labeled family whose
        series name equals ``name`` (histograms + counters + gauges)."""
        with self._lock:
            seen = {t for (n, t) in self._lhist if n == name}
            seen.update(t for (n, t) in self._lcounters if n == name)
            seen.update(t for (n, t) in self._lgauges if n == name)
        return sorted(seen)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._lat.clear()
            self._hist.clear()
            self._lcounters.clear()
            self._lgauges.clear()
            self._llat.clear()
            self._lhist.clear()


metrics = Metrics()


class Timer:
    """Context manager feeding a Metrics latency series."""

    def __init__(self, name: str, m: Metrics = metrics):
        self.name = name
        self.m = m

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.observe_latency(self.name, time.perf_counter() - self.t0)
        return False
