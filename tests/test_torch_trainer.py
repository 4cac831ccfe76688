"""The port's trainer sub-plugin and checkpoints against the JAX package's
(``nnstreamer_tpu/trainer/subplugin.py``, ``trainer/checkpoint.py``), on
the CPU.

The same numpy-seeded samples go through ``JaxTrainer`` and the port's
``Trainer`` (registered as ``jax`` too).  Tolerances: per-epoch stats and
parameters within ``ATOL`` absolute and ``RTOL`` relative at float32
(XLA's and torch's float32 products and optimizer updates round
differently; Adam's first steps are close to ``lr * sign(g)``, so a
rounding difference in a small gradient shows as a few 1e-6 in the
parameters).  The port against itself (streaming against
host-accumulate, resume against the straight run) is bitwise.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import mobilenet as jmob
from nnstreamer_tpu.trainer import checkpoint as jckpt
from nnstreamer_tpu.trainer.subplugin import JaxTrainer
from nnstreamer_tpu_torch.core import registry
from nnstreamer_tpu_torch.filters.base import tree_flatten
from nnstreamer_tpu_torch.models import mobilenet as tmob, zoo as tzoo
from nnstreamer_tpu_torch.trainer import checkpoint as ckpt
from nnstreamer_tpu_torch.trainer.subplugin import (TRAINER_PROGRAMS, Trainer,
                                                    TrainerError)

torch.set_num_threads(2)

ATOL = 2e-5
RTOL = 1e-5
CPU = {"accelerator": "true:cpu"}


def _toy(n=24, in_dim=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((in_dim, classes)).astype(np.float32)
    xs = rng.standard_normal((n, in_dim)).astype(np.float32)
    ys = np.argmax(xs @ w, axis=1).astype(np.int32)[:, None]
    return xs, ys


def _train_stream(tr, xs, ys, epochs=1, n_valid=0):
    stats = []
    n = len(xs)
    for _ in range(epochs):
        for i in range(n):
            tr.push_data([xs[i]], [ys[i]], is_validation=i >= n - n_valid)
        stats.append(tr.train_epoch())
    return stats


def _port(props):
    tr = Trainer()
    tr.open({**props, **CPU})
    return tr


def _host(tree):
    return [t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in tree_flatten(tree)[0]]


def _bitwise(a, b):
    la, lb = _host(a), _host(b)
    return len(la) == len(lb) and all(np.array_equal(x, y) for x, y in zip(la, lb))


def test_trainer_registered_as_jax():
    assert registry.get(registry.KIND_TRAINER, "jax") is Trainer


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_streaming_trainer_matches_jax(optimizer):
    """mlp:4:8:3 over the same stream (23 samples, 3 of them validation,
    a window of 8: full and partial windows): every epoch's four stats and
    the final parameters within ATOL/RTOL of JaxTrainer's; the same
    number of steps."""
    xs, ys = _toy(23)
    props = {"model": "mlp:4:8:3", "learning_rate": 0.05, "batch_size": 8,
             "optimizer": optimizer}
    jtr = JaxTrainer()
    jtr.open(dict(props))
    ttr = _port(props)
    js = _train_stream(jtr, xs, ys, epochs=3, n_valid=3)
    ts = _train_stream(ttr, xs, ys, epochs=3, n_valid=3)
    for a, b in zip(js, ts):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert ttr.step == jtr.step == 9
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    for a, b in zip(jl, _host(ttr.params)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_streaming_matches_host_accumulated():
    """The window-streaming path is bitwise the host-accumulated epoch (the
    same captured step): same losses, same params, same step count,
    including a partial tail window (23 % 8 != 0); one step signature
    each."""
    xs, ys = _toy(23)
    runs = []
    for host in (False, True):
        tr = _port({"model": "mlp:4:8:3", "learning_rate": 0.05, "batch_size": 8,
                    "host_accumulate": "true" if host else "false"})
        runs.append((tr, _train_stream(tr, xs, ys, epochs=3)))
    (ts, ss), (th, sh) = runs
    assert [s["training_loss"] for s in ss] == [s["training_loss"] for s in sh]
    assert _bitwise(ts.params, th.params)
    assert ts.step == th.step == 9
    for tr in (ts, th):
        assert tr.compile_counts() == {"step": 1}
        assert len(tr.census.signatures) == 1 and tr.census.captures == 1


def test_census_pinned_across_epoch_churn():
    """The step and the eval are captured once each for the trainer's
    life: partial tail windows, another validation count and a validation
    set bigger than one window reuse them."""
    xs, ys = _toy(23)
    tr = _port({"model": "mlp:4:8:3", "learning_rate": 0.05, "batch_size": 8})
    _train_stream(tr, xs, ys, epochs=4, n_valid=3)
    _train_stream(tr, xs[:20], ys[:20], epochs=1, n_valid=11)
    assert tr.compile_counts() == {"step": 1, "eval": 1}
    assert len(tr.compile_counts()) == TRAINER_PROGRAMS
    assert tr.census.captures == TRAINER_PROGRAMS
    assert len(tr.census.signatures) == TRAINER_PROGRAMS
    assert tr.census.replays == tr.step - 1 + 6 - 1  # 6 validation chunks


@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_save_kill_resume_bitwise(tmp_path, optimizer):
    """2 epochs + checkpoint + a FRESH trainer resuming 2 more == 4 epochs
    straight, bitwise: params, optimizer moments, step count."""
    xs, ys = _toy(24)
    props = {"model": "mlp:4:8:3", "learning_rate": 0.05, "batch_size": 8,
             "optimizer": optimizer}
    ck = str(tmp_path / "resume.ckpt")
    straight = _port(props)
    _train_stream(straight, xs, ys, epochs=4)
    first = _port(props)
    _train_stream(first, xs, ys, epochs=2)
    first.save(ck)
    resumed = _port({**props, "model_load_path": ck})
    assert resumed.step == first.step == 6
    _train_stream(resumed, xs, ys, epochs=2)
    assert resumed.step == straight.step
    assert _bitwise(resumed.params, straight.params)
    assert _bitwise(resumed.opt_state(), straight.opt_state())


def test_resume_restores_opt_state(tmp_path):
    """Adam's moments survive the checkpoint, nonzero and exact."""
    xs, ys = _toy(8)
    tr = _port({"model": "mlp:4:8:3", "learning_rate": 0.05})
    _train_stream(tr, xs, ys)
    ck = tr.save(str(tmp_path / "opt.ckpt"))
    tr2 = _port({"model": "mlp:4:8:3", "learning_rate": 0.05, "model_load_path": ck})
    a, b = _host(tr.opt_state()), _host(tr2.opt_state())
    assert len(a) == len(b) == 2 * 4 + 2  # + count, name
    assert any(np.any(x != 0) for x in b[:-1])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_state_bytes():
    """The parameter bytes, and the card-resident training state: Adam's two
    moments per parameter and the window (inputs and labels)."""
    xs, ys = _toy(8)
    tr = _port({"model": "mlp:4:8:3", "batch_size": 8})
    n_params = 4 * 8 + 8 + 8 * 3 + 3
    assert tr.param_nbytes() == 4 * n_params
    _train_stream(tr, xs, ys)
    step_counts = 4 * len(tr._leaves)  # Adam's float32 step per leaf
    assert tr.train_state_bytes() == 2 * 4 * n_params + step_counts + 8 * (4 * 4 + 4)


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.ones(2)]}
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, params, step=7)
    got, opt, step = ckpt.load_checkpoint(path)
    assert step == 7 and opt is None
    np.testing.assert_array_equal(got["a"], params["a"])
    np.testing.assert_array_equal(got["b"][0], params["b"][0])


def test_fsync_checkpoint_atomic(tmp_path, monkeypatch):
    """The fsync path writes tmp -> fsync -> atomic rename: the roundtrip
    is exact, no temporary survives, and a write that fails half way
    leaves the previous checkpoint whole."""
    params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = str(tmp_path / "ck")
    got = ckpt.save_checkpoint(path, params, step=5, fsync=True)
    back, _, step = ckpt.load_checkpoint(got)
    assert step == 5
    np.testing.assert_array_equal(back["a"], params["a"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]

    def torn(blob, f):
        f.write(b"half a blob")
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt.pickle, "dump", torn)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(path, {"a": np.zeros(3, np.float32)}, step=9, fsync=True)
    monkeypatch.undo()
    back, _, step = ckpt.load_checkpoint(path)
    assert step == 5
    np.testing.assert_array_equal(back["a"], params["a"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_jax_written_checkpoint(tmp_path, monkeypatch):
    """A JAX trainer's checkpoint holds optax's state, which the port cannot
    read: a named CheckpointError, and a trainer resuming from it raises.
    The JAX package's params-only checkpoint (its MLP draws) reads, and a
    port trainer resumes from it."""
    monkeypatch.setitem(__import__("sys").modules, "orbax.checkpoint", None)
    xs, ys = _toy(8)
    jtr = JaxTrainer()
    jtr.open({"model": "mlp:4:8:3", "learning_rate": 0.05})
    _train_stream(jtr, xs, ys)
    path = str(tmp_path / "jax.ckpt")
    jtr.save(path)
    with pytest.raises(ckpt.CheckpointError, match="optax"):
        ckpt.load_checkpoint(path)
    with pytest.raises(ckpt.CheckpointError, match="optax"):
        _port({"model": "mlp:4:8:3", "model_load_path": path})

    only = jckpt.save_checkpoint(str(tmp_path / "params.ckpt"),
                                 jax.tree_util.tree_map(np.asarray, jtr.params),
                                 step=3)
    tr = _port({"model": "mlp:4:8:3", "model_load_path": only})
    assert tr.step == 3
    for a, b in zip(jax.tree_util.tree_leaves(jtr.params), _host(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(str(tmp_path / "other.ckpt"), "wb") as f:
        pickle.dump({"params": {"a": torch.zeros(2)}, "step": 0}, f)
    with pytest.raises(ckpt.CheckpointError, match="torch"):
        ckpt.load_checkpoint(str(tmp_path / "other.ckpt"))


def test_named_errors():
    """mesh= waits for the multi-device slice; with no card and no
    ``accelerator=true:cpu`` the trainer refuses to carry on on the CPU."""
    with pytest.raises(TrainerError, match="mesh"):
        _port({"model": "mlp:4:8:3", "mesh": "data:2"})
    tr = Trainer()
    if torch.cuda.is_available():
        tr.open({"model": "mlp:4:8:3"})
        assert tr.device.type == "cuda"
    else:
        with pytest.raises(TrainerError, match="accelerator=true:cpu"):
            tr.open({"model": "mlp:4:8:3"})


def test_resume_refuses_another_model_or_optimizer(tmp_path):
    xs, ys = _toy(8)
    tr = _port({"model": "mlp:4:8:3", "learning_rate": 0.05})
    _train_stream(tr, xs, ys)
    ck = tr.save(str(tmp_path / "a.ckpt"))
    with pytest.raises(TrainerError, match="mismatch"):
        _port({"model": "mlp:4:16:3", "model_load_path": ck})
    with pytest.raises(TrainerError, match="'adam'"):
        _port({"model": "mlp:4:8:3", "optimizer": "momentum", "model_load_path": ck})


# -- a zoo model: mobilenet_v1 at width 0.25 against the JAX trainer -----------

_MOB = {"width": "0.25", "size": "32", "classes": "4"}


@functools.lru_cache(maxsize=None)
def _mobilenet_tree():
    tree = jmob.init_params(width=0.25, classes=4, seed=0)
    return jax.tree_util.tree_map(np.asarray, tree)


def _mobilenet_ref(opts, device):
    return tmob.build_bundle(tmob.params_from_jax(_mobilenet_tree(), device), opts,
                             "mobilenet_v1_learn_jax_weights")


tzoo.register_model("mobilenet_v1_learn_jax_weights", _mobilenet_ref)


def test_mobilenet_adam_step_against_jax():
    """One Adam step of mobilenet_v1 (width 0.25, 32x32, 4 classes) at
    float32 compute from the JAX package's weights: the loss, the accuracy
    and every parameter after the step within ATOL/RTOL of the JAX
    trainer's (the JAX trainer's apply switched to float32 compute).  The
    port keeps float32 masters and trains them."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ys = np.arange(4, dtype=np.int32)[:, None]
    props = {**_MOB, "batch_size": 4, "learning_rate": 1e-3, "optimizer": "adam"}
    jtr = JaxTrainer()
    jtr.open({"model": "mobilenet_v1", **props})
    jtr.apply_fn = functools.partial(jmob.apply, compute_dtype="float32")
    ttr = _port({"model": "mobilenet_v1_learn_jax_weights", "dtype": "float32", **props})
    assert all(p.dtype == torch.float32 for p in ttr._leaves)
    js = _train_stream(jtr, xs, ys)[0]
    ts = _train_stream(ttr, xs, ys)[0]
    np.testing.assert_allclose(ts["training_loss"], js["training_loss"], rtol=RTOL)
    assert ts["training_accuracy"] == js["training_accuracy"]
    want = tmob.params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu")
    for a, b in zip(_host(want), _host(ttr.params)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    # the first moments are 0.1 x the gradients: within 1e-5 of each
    # leaf's largest (ReLU6 differentiated as jnp.clip is, 1/2 at 0 and 6)
    mu = tmob.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.opt_state[0].mu), "cpu")
    for a, b in zip(_host(mu), _host(ttr.opt_state()["exp_avg"])):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())


def test_zoo_trainer_keeps_float32_masters_and_computes_bf16():
    """Without ``dtype``, the zoo model computes in bfloat16 (the serving
    default) over float32 master parameters equal to the model's float32
    draws, and a ``[1, H, W, C]`` sample (the model's batch of one) trains
    as one row."""
    ttr = _port({"model": "mobilenet_v1", **_MOB, "batch_size": 2})
    master = tmob.init_params(width=0.25, classes=4, seed=0)
    for a, b in zip(_host(master), _host(ttr.params)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for i in range(2):
        ttr.push_data([rng.standard_normal((1, 32, 32, 3)).astype(np.float32)],
                      [np.asarray([i], np.int32)], False)
    assert tuple(ttr._wx.shape) == (2, 32, 32, 3)
    s = ttr.train_epoch()
    assert np.isfinite(s["training_loss"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in ttr._leaves)
    assert not _bitwise(master, ttr.params)
