"""Global configuration registry.

Port of ``nnstreamer_tpu/core/config.py`` (reference: ``nnstreamer_conf.c``
+ ``nnstreamer.ini``), cut to the settings this package reads: the
filter priority, queue capacity, prompt bucketing and latency switch of
the LLM paths, the flight recorder's mode and ring size, which the
query front door and the runtime's trace hooks read, the sinks' fetch
window and the runtime's bound on elastic stage restarts.  Populated
from (in priority order) :func:`set_config` > environment > the ini file
named by ``NNS_TPU_CONF`` > defaults.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
import threading
from typing import List, Optional

_ENV_CONF = "NNS_TPU_CONF"
_ENV_FW_PRIORITY = "NNS_TPU_FILTER_PRIORITY"
_ENV_BUCKETING = "NNS_TPU_SHAPE_BUCKETING"
_ENV_TRACE = "NNS_TPU_TRACE"
_ENV_TRACE_RING = "NNS_TPU_TRACE_RING"
_ENV_REDUCE_OUTPUTS = "NNS_TPU_REDUCE_OUTPUTS"
_ENV_FETCH_DEPTH = "NNS_TPU_FETCH_DEPTH"
_ENV_STAGE_RESTARTS = "NNS_TPU_MAX_STAGE_RESTARTS"


@dataclasses.dataclass
class Config:
    #: framework priority for tensor_filter framework=auto
    filter_priority: List[str] = dataclasses.field(
        default_factory=lambda: ["llm"])
    #: default queue capacity between pipeline stages (buffers)
    queue_capacity: int = 4
    #: pad flexible shapes up to the next bucket (the llm filter pads
    #: prompts to power-of-two lengths)
    shape_bucketing: bool = True
    #: emit per-stage latency measurements
    enable_latency: bool = True
    #: flight-recorder trace mode (utils/tracing.py): ``off`` = no
    #: recorder installed (hot paths pay one pointer check), ``ring`` =
    #: bounded ring of span events, ``full`` = unbounded capture
    trace_mode: str = "off"
    #: span capacity of the ``ring`` trace mode
    trace_ring_capacity: int = 65536
    #: residency planner (``pipeline/residency.py``): let a filter switch
    #: to its model's reduced output (deeplab's native-stride score map)
    #: when every consumer below it admits any geometry
    reduce_outputs: bool = True
    #: sink fetch window (``elements/sink.py``): up to this many buffers
    #: resolve their device-to-host copy or deferred ``host_post`` on a
    #: pool while the app pops earlier ones, in FIFO order
    fetch_depth: int = 2
    #: elastic stage restarts: a restartable (pure) stage whose
    #: ``process()`` raises is re-entered in place this many times,
    #: losing the one buffer, before the pipeline fails (0 = fail fast)
    max_stage_restarts: int = 0

    @classmethod
    def load(cls) -> "Config":
        cfg = cls()
        path = os.environ.get(_ENV_CONF)
        if path and os.path.exists(path):
            ini = configparser.ConfigParser()
            ini.read(path)
            if ini.has_option("filter", "priority"):
                cfg.filter_priority = _split(ini.get("filter", "priority"))
            if ini.has_option("common", "queue_capacity"):
                cfg.queue_capacity = ini.getint("common", "queue_capacity")
            if ini.has_option("common", "shape_bucketing"):
                cfg.shape_bucketing = ini.getboolean("common",
                                                     "shape_bucketing")
            if ini.has_option("common", "trace_mode"):
                cfg.trace_mode = ini.get("common",
                                         "trace_mode").strip().lower()
            if ini.has_option("common", "trace_ring_capacity"):
                cfg.trace_ring_capacity = ini.getint(
                    "common", "trace_ring_capacity")
            if ini.has_option("common", "reduce_outputs"):
                cfg.reduce_outputs = ini.getboolean("common",
                                                    "reduce_outputs")
            if ini.has_option("common", "fetch_depth"):
                cfg.fetch_depth = ini.getint("common", "fetch_depth")
            if ini.has_option("common", "max_stage_restarts"):
                cfg.max_stage_restarts = ini.getint(
                    "common", "max_stage_restarts")
        if os.environ.get(_ENV_FW_PRIORITY):
            cfg.filter_priority = _split(os.environ[_ENV_FW_PRIORITY])
        if os.environ.get(_ENV_BUCKETING):
            cfg.shape_bucketing = os.environ[_ENV_BUCKETING].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_TRACE):
            cfg.trace_mode = os.environ[_ENV_TRACE].strip().lower()
        if os.environ.get(_ENV_TRACE_RING):
            cfg.trace_ring_capacity = int(os.environ[_ENV_TRACE_RING])
        if os.environ.get(_ENV_REDUCE_OUTPUTS):
            cfg.reduce_outputs = os.environ[_ENV_REDUCE_OUTPUTS].lower() in (
                "1", "true", "yes", "on")
        if os.environ.get(_ENV_FETCH_DEPTH):
            cfg.fetch_depth = int(os.environ[_ENV_FETCH_DEPTH])
        if os.environ.get(_ENV_STAGE_RESTARTS):
            cfg.max_stage_restarts = int(os.environ[_ENV_STAGE_RESTARTS])
        return cfg


def _split(s: str) -> List[str]:
    return [p.strip() for p in s.replace(":", ",").split(",") if p.strip()]


_config: Optional[Config] = None
_lock = threading.Lock()


def get_config() -> Config:
    global _config
    if _config is None:
        with _lock:
            if _config is None:
                _config = Config.load()
    return _config


def set_config(cfg: Config) -> None:
    global _config
    with _lock:
        _config = cfg


def reset_config() -> None:
    global _config
    with _lock:
        _config = None
