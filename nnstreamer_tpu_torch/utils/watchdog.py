"""Timeout watchdog for hang detection.

Port of ``nnstreamer_tpu/utils/watchdog.py``, the same arm/feed/disarm
timer and ``call_with_watchdog``; its post-mortem is this package's
flight recorder (``utils/tracing.py``).

Reference analog: ``nnstreamer_watchdog.c`` (SURVEY §2.1/§5.3) — a GLib
timer the trainer/query elements arm around operations that can wedge
(sub-plugin train step, remote response wait); firing raises an element
error instead of hanging the pipeline forever.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..core.log import logger
from .tracing import dump_recent_to_log

log = logger(__name__)


class Watchdog:
    """Arm/feed/disarm timer.  If ``timeout`` elapses without a feed, the
    ``on_timeout`` callback fires (once per arming) on the watchdog thread.

    >>> wd = Watchdog(5.0, lambda: pipeline.abort("trainer hung"))
    >>> with wd:                  # armed
    ...     for batch in data:
    ...         step(batch)
    ...         wd.feed()         # still alive
    """

    _GUARDED_BY = {"_timer": "_lock", "_fired": "_lock", "_gen": "_lock"}

    def __init__(self, timeout: float, on_timeout: Callable[[], None]):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._fired = False
        # Arming generation: a pending _fire that lost the race against a
        # feed/disarm/re-arm (Timer.cancel cannot stop a callback that has
        # already STARTED and is blocked on our lock) sees a stale
        # generation and returns — it must neither fire with an expired
        # deadline nor double-fire after a re-arm.
        self._gen = 0

    def arm(self) -> "Watchdog":
        with self._lock:
            self._fired = False
            self._schedule_locked()
        return self

    def _schedule_locked(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._gen += 1
        self._timer = threading.Timer(self.timeout, self._fire,
                                      args=(self._gen,))
        self._timer.daemon = True
        self._timer.start()

    def _fire(self, gen: int) -> None:
        with self._lock:
            if self._fired or self._timer is None or gen != self._gen:
                return
            self._fired = True
        # Post-mortem FIRST (never raises, no-op when tracing is off):
        # the hang report carries the flight recorder's recent timeline —
        # including the stalled stage's last span — even if on_timeout
        # aborts the process.
        dump_recent_to_log(
            log, reason=f"watchdog fired after {self.timeout}s")
        self.on_timeout()

    def feed(self) -> None:
        """Reset the countdown (call from the watched loop).

        A documented NO-OP on a watchdog that is disarmed or has already
        FIRED: the timeout callback ran (or is running), and feeding must
        neither resurrect the countdown nor re-fire it — the watched
        operation was already declared hung, and racing a feed against the
        in-flight ``on_timeout`` would otherwise re-arm a timer nobody
        owns.  Re-arm explicitly with :meth:`arm` to reuse the watchdog.
        """
        with self._lock:
            if self._timer is None or self._fired:
                return
            self._schedule_locked()

    def disarm(self) -> None:
        """Stop the countdown.  Safe to call at ANY point relative to the
        timer — including after ``_fire`` has started (the callback either
        completed already or sees the bumped generation and returns): never
        raises, never lets a second fire through."""
        with self._lock:
            self._gen += 1
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    @property
    def fired(self) -> bool:
        return self._fired

    def __enter__(self) -> "Watchdog":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


def call_with_watchdog(fn: Callable, timeout: float, what: str = "call"):
    """Run ``fn()`` on a helper thread; raise TimeoutError if it exceeds
    ``timeout`` seconds.  The wedged thread is daemonized (Python cannot
    kill it) — "report, don't recover", like the reference watchdog.  Used
    by tensor_trainer around the sub-plugin epoch."""
    box: dict = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            box["exc"] = e

    t = threading.Thread(target=run, name=f"watchdog-{what}", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        dump_recent_to_log(
            log, reason=f"{what} exceeded watchdog timeout {timeout}s")
        raise TimeoutError(f"{what} exceeded watchdog timeout {timeout}s")
    if "exc" in box:
        raise box["exc"]
    return box["result"]
