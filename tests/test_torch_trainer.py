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


def test_named_errors(monkeypatch):
    """mesh= with an axis the trainer lacks, or more slots than the
    process owns, raises in the JAX trainer's words; with no card and no
    ``accelerator=true:cpu`` the trainer refuses to carry on on the CPU."""
    monkeypatch.delenv("NNS_TPU_DEVICE_SLOTS", raising=False)
    with pytest.raises(TrainerError, match="needs 2 devices, have 1"):
        _port({"model": "mlp:4:8:3", "mesh": "data:2"})
    with pytest.raises(TrainerError, match="axis 'seq' \\(valid: data, model\\)"):
        _port({"model": "mlp:4:8:3", "mesh": "seq:2"})
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


# -- mesh= (the trainer's own mesh over the process's slots) -------------------

def _mesh_run(trainer, mesh, xs, ys, epochs=3):
    p = {"model": "mlp:4:8:3", "learning_rate": 0.05, "batch_size": 8}
    if mesh:
        p["mesh"] = mesh
    tr = trainer(p)
    losses = []
    for _ in range(epochs):
        for i in range(len(xs)):
            tr.push_data([xs[i]], [ys[i]], False)
        losses.append(tr.train_epoch()["training_loss"])
    return tr, losses


def _jax_trainer(props):
    tr = JaxTrainer()
    tr.open(props)
    return tr


def test_mesh_data_parallel_trajectory(monkeypatch):
    """The port of ``tests/test_learn.py::test_mesh_data_parallel_trajectory``:
    data:4 over four slots against the mesh-less trainer, the 3-epoch
    losses within the JAX test's rtol 1e-5 / atol 1e-7 and the parameters
    within rtol 1e-5 / atol 1e-6 (the gradient is the slot-order sum of
    per-slot partials, another order than one step's); a data:1 mesh
    bitwise the mesh-less run; the JAX package's data:4 losses within
    RTOL; the census: one step program (a capture per slot and the
    update) and no eval."""
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((24, 4)).astype(np.float32)
    ys = rng.integers(0, 3, (24, 1)).astype(np.int32)
    t0, l0 = _mesh_run(_port, None, xs, ys)
    t1, l1 = _mesh_run(_port, "data:1", xs, ys)
    t4, l4 = _mesh_run(_port, "data:4", xs, ys)
    assert l0 == l1 and _bitwise(t0.params, t1.params)
    assert np.allclose(l0, l4, rtol=1e-5, atol=1e-7)
    for a, b in zip(_host(t0.params), _host(t4.params)):
        assert np.allclose(a, b, rtol=1e-5, atol=1e-6)
    assert t4.compile_counts() == {"step": 1}
    assert t4.census.captures == 5  # four slots' steps and the update
    _, jl4 = _mesh_run(_jax_trainer, "data:4", xs, ys)
    np.testing.assert_allclose(l4, jl4, rtol=RTOL)


def test_mesh_2d_pspecs_shard_params(monkeypatch):
    """The port of ``tests/test_learn.py::test_mesh_2d_pspecs_shard_params``
    with the port's own counters: mobilenet_v1 at (data:2, model:2) trains
    with a finite loss and a pinned census; the whole-model vision
    forward keeps its weights whole under the model axis (as a serving
    stage does: ``param_shards`` 0, every leaf a replica, one
    replication), where the JAX package cuts the pointwise kernels."""
    from nnstreamer_tpu_torch.core.log import metrics

    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")
    metrics.reset()
    tr = _port({"model": "mobilenet_v1", "classes": "4", "width": "0.25",
                "size": "32", "batch_size": 4, "mesh": "data:2,model:2",
                "learning_rate": 0.01, "dtype": "float32"})
    assert tr._mesh.shape["data"] == 2 and tr._mesh.shape["model"] == 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 32, 3)).astype(np.float32)
    for _ in range(2):
        for i in range(4):
            tr.push_data([x], [np.asarray([i % 4], np.int32)], False)
        s = tr.train_epoch()
    assert np.isfinite(s["training_loss"])
    assert tr.compile_counts() == {"step": 1}
    snap = metrics.snapshot()
    assert snap.get("trainer.param_shards") == 0.0
    assert snap.get("trainer.param_replicas") == float(len(tr._leaves))
    assert snap.get("trainer.param_replications") == 1.0
    # one whole copy: the four slots on one device read the same leaves
    assert list(tr._replicas) == [str(tr.device)]


def test_trainer_data_parallel_mesh(tmp_path, monkeypatch):
    """The port of ``tests/test_trainer.py::test_trainer_data_parallel_mesh``:
    data:8 over eight slots, 16 samples a window, a finite loss, and the
    JAX trainer's epoch within RTOL."""
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((16, 4)).astype(np.float32)
    ys = rng.integers(0, 3, (16, 1)).astype(np.int32)
    stats = []
    for make in (_port, _jax_trainer):
        tr = make({"model": "mlp:4:8:3", "mesh": "data:8", "batch_size": 16,
                   "learning_rate": 0.05})
        for i in range(16):
            tr.push_data([xs[i]], [ys[i]], is_validation=False)
        stats.append(tr.train_epoch()["training_loss"])
    assert np.isfinite(stats[0])
    np.testing.assert_allclose(stats[0], stats[1], rtol=RTOL)


def _gap(a, b):
    """The norm of ``a - b`` over the norm of ``b``, over every leaf."""
    num = sum(float((x.double() - y.double()).pow(2).sum()) for x, y in zip(a, b))
    return (num / sum(float(y.double().pow(2).sum()) for y in b)) ** 0.5


def test_mesh_first_summed_gradient_is_the_mesh_less_one(monkeypatch):
    """mobilenet_v1 at float32 with Adam: each slot of data:2 reads only
    its own run of the window (a partial window's rows past ``count``
    masked), and the first window's slot-order sum of the slots'
    gradients is the mesh-less step's within 1e-5 of its norm (the same
    sums in another association; 3.9e-8 on the CPU), where one slot's
    part alone or counted twice reads 0.57 or 0.66; the losses within the JAX
    test's rtol 1e-5 / atol 1e-7, data:1 bitwise."""
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "2")
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((10, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (10, 1)).astype(np.int32)

    def run(mesh):
        p = {"model": "mobilenet_v1", "classes": "10", "width": "0.25",
             "size": "32", "batch_size": 4, "learning_rate": 1e-3,
             "dtype": "float32"}
        if mesh:
            p["mesh"] = mesh
        tr = _port(p)
        apply = tr.apply_fn

        def counted(params, x):
            rows.add(x.shape[0])
            return apply(params, x)

        tr.apply_fn, rows = counted, set()
        losses, first = [], None
        for _ in range(2):
            for i in range(10):
                tr.push_data([xs[i]], [ys[i]], False)
                if first is None and tr.step == 1:
                    first = ([q.grad.clone() for q in tr._leaves],
                             [[g.clone() for g in s] for s in tr._slot_grads or ()])
            losses.append(tr.train_epoch()["training_loss"])
        return tr, losses, first, rows

    t0, l0, (g0, _), rows0 = run(None)
    t1, l1, _, _ = run("data:1")
    t2, l2, (g2, parts), rows2 = run("data:2")
    assert l0 == l1 and _bitwise(t0.params, t1.params)
    assert len(parts) == 2 and t2._slot_steps is not None
    assert rows0 == {4} and rows2 == {2}  # each slot its own two rows
    # a gradient tree per slot, as the deep lint prices it
    assert t2.train_state_bytes() == t0.train_state_bytes() + 2 * t0.param_nbytes()
    assert _gap(g2, g0) < 1e-5
    assert _gap(parts[0], g0) > 0.1
    assert _gap([2 * x for x in parts[0]], g0) > 0.1
    assert np.allclose(l0, l2, rtol=1e-5, atol=1e-7)
