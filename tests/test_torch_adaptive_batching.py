"""The adaptive bucket ladder in the port against the JAX package's
(``nnstreamer_tpu/pipeline/batching.py`` ``AdaptiveLadder``,
``tests/test_adaptive_batching.py``), on the CPU: the same occupancy
sequences give the same ladders (mint after ``MINT_AFTER``, exact
occupancies never mint, the budget, warm start, ``align``), the variant
budget, ladder-rounded sizes above the top sharing one step, and the
pipeline contract: skew mints a bucket and stops the pad waste, adaptive
output equals static output bitwise, a warm-started ladder is captured
as given, and ``[ladders]`` keeps stage names' case.  Ladder and budget
arithmetic is compared exactly; outputs (float32 ``x * 2``) exactly."""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core.config import Config as JConfig, parse_ladders as jparse
from nnstreamer_tpu.pipeline import batching as jb
from nnstreamer_tpu.pipeline.plan import (ADAPTIVE_EXTRA_DEFAULT as J_EXTRA,
                                          adaptive_variant_budget as jbudget)
from nnstreamer_tpu_torch.core.config import Config, parse_ladders
from nnstreamer_tpu_torch.core.log import metrics
from nnstreamer_tpu_torch.pipeline import batching as tb
from nnstreamer_tpu_torch.pipeline.plan import (ADAPTIVE_EXTRA_DEFAULT,
                                                adaptive_variant_budget)

DESC = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
        "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 "
        "accelerator=true:cpu name=f ! tensor_sink name=out")


def _both(*args, **kw):
    return tb.AdaptiveLadder(*args, **kw), jb.AdaptiveLadder(*args, **kw)


def _same(mine, want):
    assert mine.sizes() == want.sizes()
    assert mine.export() == want.export()


# -- the ladder: exactly the JAX package's ------------------------------------------

def test_mint_after_persistent_skew():
    mine, want = _both((1, 2, 4, 8), budget=6, mint_after=4)
    for lad in (mine, want):
        lad.observe(3)  # transient: below mint_after
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 8)
    for _ in range(4):
        mine.observe(6)
        want.observe(6)
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 6, 8)
    assert [mine.bucket_for(n) for n in (5, 6)] == \
        [want.bucket_for(n) for n in (5, 6)] == [6, 6]


def test_exact_occupancies_never_mint():
    mine, want = _both((1, 2, 4, 8), budget=8, mint_after=1)
    for n in (1, 2, 4, 8):
        mine.observe(n)
        want.observe(n)
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 8)


def test_budget_clamps_minting():
    mine, want = _both((1, 2, 4, 8), budget=5, mint_after=1)
    for n in (6, 5, 3):
        mine.observe(n)
        want.observe(n)
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 6, 8)


def test_warm_start_pre_mints():
    mine, want = _both((1, 2, 4, 8), budget=8, warm=[6, 3])
    _same(mine, want)
    assert mine.export() == [1, 2, 3, 4, 6, 8]


def test_align_assignment_reruns_warm_mints():
    mine, want = _both((1, 2, 4, 8, 16), budget=8, warm=[6, 10])
    _same(mine, want)
    mine.align = want.align = 4
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 8, 12, 16)
    for _ in range(tb.MINT_AFTER):
        mine.observe(5)
        want.observe(5)
    _same(mine, want)


def test_sharded_rounding_still_applies():
    """Minted sizes are replica-aligned, so ``shard_bucket_for``'s rounding
    is a no-op on them: every replica still gets equal rows (the JAX
    package's test, on both classes)."""
    mine, want = _both((1, 2, 4, 8), budget=8, align=4, mint_after=1)
    mine.observe(6)
    want.observe(6)
    _same(mine, want)
    assert mine.sizes() == (1, 2, 4, 8)  # aligned up to 8: already a bucket
    mine, want = _both((1, 2, 4, 16), budget=8, align=4, mint_after=1)
    mine.observe(6)
    want.observe(6)
    _same(mine, want)
    assert 8 in mine.sizes()  # minted as the aligned size
    assert tb.shard_bucket_for(6, 4, mine.sizes()) == 8 == \
        jb.shard_bucket_for(6, 4, want.sizes())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_occupancy_streams_equal_jax(seed):
    """Long seeded streams of skewed occupancies, buckets and budgets:
    every drain's bucket and the final ladder as the JAX class gives."""
    rng = np.random.default_rng(seed)
    base = tuple(sorted(set(rng.choice([1, 2, 4, 8, 16, 32], 4).tolist())))
    mine, want = _both(base, budget=int(rng.integers(0, 9)),
                       mint_after=int(rng.integers(1, 6)))
    skew = rng.integers(1, 40, 3)
    for _ in range(400):
        n = int(rng.choice(skew)) if rng.random() < 0.8 else int(rng.integers(1, 40))
        assert mine.bucket_for(n) == want.bucket_for(n)
    _same(mine, want)


def test_variant_budget_arithmetic_equal_jax():
    assert ADAPTIVE_EXTRA_DEFAULT == J_EXTRA
    for base in (1, 4, 9, 12):
        for stages in (0, 1, 2, 4):
            for mcv in (0, 3, 8, 10, 24, 100):
                assert adaptive_variant_budget(base, stages, mcv) == \
                    jbudget(base, stages, mcv)
    assert adaptive_variant_budget(9, 1, 0) == 9 + ADAPTIVE_EXTRA_DEFAULT
    assert adaptive_variant_budget(9, 2, 24) == 12
    assert adaptive_variant_budget(9, 4, 8) == 9


def test_runner_above_top_occupancies_share_rounded_steps():
    br = tb.BatchRunner(lambda a: (a[0] * 2.0,), buckets=[2, 4])
    out5 = br.run([(np.full((4,), float(i), np.float32),) for i in range(5)])
    out7 = br.run([(np.full((4,), float(i), np.float32),) for i in range(7)])
    assert len(out5) == 5 and len(out7) == 7
    assert {key[0] for key in br._sets} == {8}  # both ladder-rounded to 2*top
    assert br.census.captures == 1
    assert tb.ladder(1000) == jb.ladder(1000)


# -- config ------------------------------------------------------------------------

def test_parse_ladders_equal_jax():
    for s in ("f:1|2|4|6;g:1|2|8", "MyFilter:1|2|6", " a+b : 1 | 3 ;; ", ""):
        assert parse_ladders(s) == jparse(s)


def test_ini_ladders_preserve_stage_name_case(tmp_path, monkeypatch):
    ini = tmp_path / "nns.ini"
    ini.write_text("[common]\nbatch_max = 8\nbatch_buckets = 1,2,6\n"
                   "batch_linger_ms = 2.5\nadaptive_buckets = true\n"
                   "dispatch_depth = 3\ndonate_ingress = false\n"
                   "max_compiled_variants = 12\n"
                   "[ladders]\nMyFilter = 1,2,6\nsrc+t+F = 1,4\n")
    monkeypatch.setenv("NNS_TPU_CONF", str(ini))
    monkeypatch.delenv("NNS_TPU_BUCKET_LADDERS", raising=False)
    cfg, jcfg = Config.load(), JConfig.load()
    assert cfg.bucket_ladders == jcfg.bucket_ladders == {
        "MyFilter": [1, 2, 6], "src+t+F": [1, 4]}
    for field in ("batch_max", "batch_buckets", "batch_linger_ms",
                  "adaptive_buckets", "dispatch_depth", "donate_ingress",
                  "max_compiled_variants"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_env_knobs_equal_jax(monkeypatch):
    monkeypatch.delenv("NNS_TPU_CONF", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent")
    for k, v in (("NNS_TPU_BATCH_MAX", "16"), ("NNS_TPU_DISPATCH_DEPTH", "4"),
                 ("NNS_TPU_DONATE_INGRESS", "off"),
                 ("NNS_TPU_ADAPTIVE_BUCKETS", "yes"),
                 ("NNS_TPU_MAX_COMPILED_VARIANTS", "7"),
                 ("NNS_TPU_BUCKET_LADDERS", "f:1|2|6")):
        monkeypatch.setenv(k, v)
    cfg, jcfg = Config.load(), JConfig.load()
    for field in ("batch_max", "dispatch_depth", "donate_ingress",
                  "adaptive_buckets", "max_compiled_variants", "bucket_ladders"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_defaults_equal_jax():
    cfg, jcfg = Config(), JConfig()
    for field in ("batch_max", "batch_buckets", "batch_linger_ms",
                  "adaptive_buckets", "bucket_ladders", "dispatch_depth",
                  "donate_ingress", "max_compiled_variants"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


# -- the pipeline --------------------------------------------------------------------

def _push_bursts(p, burst, bursts):
    """A skewed steady state: bursts of ``burst`` buffers, each pulled to
    completion before the next, so every drain sees ``burst`` rows
    (the linger collects stragglers)."""
    outs = []
    k = 0
    for _ in range(bursts):
        for _ in range(burst):
            p.push("src", ntt.Buffer([np.full((16,), float(k), np.float32)], pts=k))
            k += 1
        for _ in range(burst):
            outs.append(p.pull("out", timeout=60))
    return outs


def test_skewed_occupancy_refines_and_cuts_pad_waste():
    metrics.reset()
    p = ntt.Pipeline(DESC, queue_capacity=32, batch_max=8, batch_linger_ms=60.0,
                     adaptive_buckets=True)
    with p:
        _push_bursts(p, 6, 40)
        waste_mid = metrics.snapshot().get("f.batch_pad_waste", 0.0)
        assert 6 in p.element("f")._batch_ladder.sizes()
        _push_bursts(p, 6, 10)
        waste_end = metrics.snapshot().get("f.batch_pad_waste", 0.0)
        p.eos()
        p.wait(timeout=60)
    assert p.ladder_snapshot()["f"].count(6) == 1
    assert waste_end == waste_mid, (waste_mid, waste_end)
    assert metrics.snapshot().get("f.ladder_minted", 0) >= 1
    runner = p.element("f")._batchers
    [(_, br)] = runner.values()
    assert (6, (((16,), "torch.float32"),)) in br.census.signatures


def test_adaptive_bit_identical_to_static_ladder():
    frames = [np.full((16,), float(i), np.float32) for i in range(36)]

    def run(adaptive):
        p = ntt.Pipeline(DESC, queue_capacity=48, batch_max=8,
                         adaptive_buckets=adaptive, batch_linger_ms=5.0)
        with p:
            for i, x in enumerate(frames):
                p.push("src", ntt.Buffer([x], pts=i))
            outs = [p.pull("out", timeout=60) for _ in frames]
            p.eos()
            p.wait(timeout=60)
        return outs

    jp = nt.Pipeline(DESC.replace("accelerator=true:cpu ", ""), queue_capacity=48,
                     batch_max=8, adaptive_buckets=True, data_parallel=1)
    with jp:
        for i, x in enumerate(frames):
            jp.push("src", nt.Buffer([x], pts=i))
        want = [jp.pull("out", timeout=60) for _ in frames]
        jp.eos()
        jp.wait(timeout=60)
    for x, y, w in zip(run(True), run(False), want):
        assert bytes(np.asarray(x.tensors[0])) == bytes(np.asarray(y.tensors[0]))
        assert bytes(np.asarray(x.tensors[0])) == bytes(np.asarray(w.tensors[0]))
        assert x.pts == y.pts == w.pts


def test_warm_started_pipeline_captures_the_refined_ladder():
    metrics.reset()
    p = ntt.Pipeline(DESC, queue_capacity=32, batch_max=8, batch_linger_ms=60.0,
                     adaptive_buckets=True, bucket_ladders={"f": [1, 2, 4, 6, 8]})
    jp = nt.Pipeline(DESC.replace("accelerator=true:cpu ", ""), batch_max=8,
                     adaptive_buckets=True, bucket_ladders={"f": [1, 2, 4, 6, 8]},
                     data_parallel=1)
    assert p._ladder_budget == jp._ladder_budget
    with p:
        assert p.element("f")._batch_ladder.sizes() == (1, 2, 4, 6, 8)
        assert p.ladder_snapshot() == jp.ladder_snapshot()
        _push_bursts(p, 6, 3)
        p.eos()
        p.wait(timeout=60)
    snap = metrics.snapshot()
    if snap.get("f.batch_occupancy.p99", 0) >= 6.0:  # the drains coalesced
        assert snap.get("f.batch_pad_waste", 0.0) == 0.0
        [(_, br)] = p.element("f")._batchers.values()
        assert 6 in {key[0] for key in br.census.signatures}


def test_ladder_snapshot_empty_without_adaptive():
    p = ntt.Pipeline(DESC, batch_max=8)
    assert p.ladder_snapshot() == {}
    assert getattr(p.element("f"), "_batch_ladder", None) is None
