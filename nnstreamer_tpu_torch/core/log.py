"""Structured logging and the in-process metrics registry.

Port of ``nnstreamer_tpu/core/log.py`` (reference analog: nnstreamer_log.c
nns_logi/logw/loge), cut to what this package records: counters and
bounded latency reservoirs from which quantiles derive.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict, List

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("NNS_TPU_LOG", "WARNING").upper()
        logging.basicConfig(level=getattr(logging, level, logging.WARNING), format=_FMT)
        _configured = True
    return logging.getLogger(name)


class Metrics:
    """Process-wide counters + latency reservoirs, thread-safe:
    every mutation and raw-state copy happens under one lock, derived work
    (sorting for quantiles) runs on the copy outside it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._lat: Dict[str, List[float]] = collections.defaultdict(list)
        #: per-series reservoir bound: at cap, every other sample is dropped
        self._lat_cap = 4096

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe_latency(self, name: str, seconds: float) -> None:
        with self._lock:
            r = self._lat[name]
            if len(r) >= self._lat_cap:
                del r[::2]
            r.append(seconds)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            lat = {name: list(r) for name, r in self._lat.items() if r}
        for name, s in lat.items():
            s.sort()
            out[f"{name}.p50"] = s[len(s) // 2]
            out[f"{name}.p99"] = s[min(len(s) - 1, int(len(s) * 0.99))]
            out[f"{name}.mean"] = sum(s) / len(s)
            out[f"{name}.n"] = float(len(s))
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._lat.clear()


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
