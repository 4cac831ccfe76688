"""The port's watchdog against the JAX package's: each case runs on both
``Watchdog`` classes (as ``tests/test_aux.py`` holds the JAX one): it
fires once per arming, a feed postpones the fire, a disarm or a feed
racing the fire lets no second fire through; ``call_with_watchdog``
returns, re-raises, or raises TimeoutError alike."""

import threading
import time

import pytest

from nnstreamer_tpu.utils import watchdog as jwd
from nnstreamer_tpu_torch.utils import watchdog as twd

MODS = pytest.mark.parametrize("wd_mod", [jwd, twd], ids=["jax", "torch"])


@MODS
def test_fires_without_feed(wd_mod):
    fired = threading.Event()
    with wd_mod.Watchdog(0.05, fired.set):
        assert fired.wait(1.0)


@MODS
def test_feed_defers(wd_mod):
    fired = threading.Event()
    with wd_mod.Watchdog(0.15, fired.set) as wd:
        for _ in range(4):
            time.sleep(0.05)
            wd.feed()
        assert not fired.is_set()
    time.sleep(0.25)
    assert not fired.is_set()  # disarmed on exit


@MODS
def test_fires_once_per_arming(wd_mod):
    count = []
    wd = wd_mod.Watchdog(0.03, lambda: count.append(1)).arm()
    time.sleep(0.2)
    wd.disarm()
    assert count == [1] and wd.fired
    wd.arm()  # a new arming fires again, once
    time.sleep(0.2)
    wd.disarm()
    assert count == [1, 1]


@MODS
def test_disarm_during_fire_lets_no_second_fire(wd_mod):
    started, release = threading.Event(), threading.Event()
    count = []

    def on_timeout():
        count.append(1)
        started.set()
        release.wait(2.0)

    wd = wd_mod.Watchdog(0.02, on_timeout).arm()
    assert started.wait(1.0)
    wd.disarm()  # the callback is still running: a clean no-op
    release.set()
    time.sleep(0.1)
    assert count == [1] and wd.fired


@MODS
def test_feed_after_fire_is_a_noop(wd_mod):
    count = []
    wd = wd_mod.Watchdog(0.02, lambda: count.append(1)).arm()
    time.sleep(0.1)
    wd.feed()
    time.sleep(0.1)
    wd.disarm()
    wd.feed()
    time.sleep(0.1)
    assert count == [1]


@MODS
def test_stale_fire_cannot_outrun_feed_or_rearm(wd_mod):
    count = []
    wd = wd_mod.Watchdog(60.0, lambda: count.append(1)).arm()
    stale = wd._gen
    wd.feed()
    wd._fire(stale)
    assert count == [] and not wd.fired
    wd._fire(wd._gen)
    assert count == [1] and wd.fired
    wd.disarm()
    old = wd._gen
    wd.arm()
    wd._fire(old)
    assert count == [1]
    wd.disarm()


@MODS
def test_call_with_watchdog_returns_and_reraises(wd_mod):
    assert wd_mod.call_with_watchdog(lambda: 41 + 1, 5.0) == 42

    def boom():
        raise KeyError("inner")

    with pytest.raises(KeyError, match="inner"):
        wd_mod.call_with_watchdog(boom, 5.0)


@MODS
def test_call_with_watchdog_times_out(wd_mod):
    release = threading.Event()
    try:
        with pytest.raises(TimeoutError, match="step exceeded watchdog timeout"):
            wd_mod.call_with_watchdog(lambda: release.wait(5.0), 0.05, what="step")
    finally:
        release.set()  # the wedged helper thread ends


def test_fire_dumps_the_flight_recorder(monkeypatch):
    """The post-mortem comes first, from this package's recorder."""
    calls = []
    monkeypatch.setattr(twd, "dump_recent_to_log",
                        lambda log, reason="": calls.append(reason))
    fired = threading.Event()
    with twd.Watchdog(0.02, fired.set):
        assert fired.wait(1.0)
    assert calls == ["watchdog fired after 0.02s"]
