"""The port's process group (``nnstreamer_tpu_torch/parallel/distributed.py``)
against the JAX package's ``tests/test_parallel.py`` (single process) and
``tests/test_distributed_multiprocess.py`` (two processes), on the CPU.

The two-process tests start two child processes that join one gloo group
through a ``file://`` rendezvous under ``tmp_path`` (no port to race on),
each at one OpenMP thread, waited for with a timeout and killed in a
``finally``.  Bitwise references (the in-process ``model=2`` run, the
in-process ``seq=2`` ring) are computed in rank 0 itself, at the same
thread count; the JAX references in this process.  Tolerances: the
cross-rank values bitwise; the two-rank ``llama_tiny`` logits within
1e-4 of the JAX unsharded forward (the JAX two-process test's bound)."""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.parallel import distributed as jdist
from nnstreamer_tpu.parallel import global_mesh as jglobal_mesh
from nnstreamer_tpu_torch.parallel import distributed as dist
from nnstreamer_tpu_torch.parallel import global_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the longest a child may take (it imports torch and runs a tiny model)
CHILD_S = 90


# -- one process ---------------------------------------------------------------

def test_distributed_single_process_fallback(monkeypatch):
    """No coordinator configured -> the single-process default, as the
    JAX module's; one process with a coordinator likewise."""
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")
    assert dist.initialize() is False and jdist.initialize() is False
    assert not dist.is_initialized()
    assert dist.global_device_count() == 8
    assert dist.local_device_count() == dist.global_device_count()
    assert dist.initialize("file:///nonexistent/rdv", 1, 0) is False
    assert dist.process_index() == 0 and dist.process_count() == 1


def test_global_mesh_axes(monkeypatch):
    """``global_mesh(model=2)``: the JAX test's axes (data absorbs the
    rest), over eight slots as the JAX test's eight devices."""
    monkeypatch.setenv("NNS_TPU_DEVICE_SLOTS", "8")
    mesh, jmesh = global_mesh(model=2), jglobal_mesh(model=2)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] * 2 == len(jax.devices()) == mesh.size


@pytest.mark.parametrize("args,match", [
    (("file:///x", None, 0), "num_processes=None"),
    (("file:///x", 2, 2), "does not fit"),
    (("nohostport", 2, 0), "expected host:port"),
])
def test_counts_that_do_not_fit_raise(args, match):
    with pytest.raises(ValueError, match=match):
        dist.initialize(*args)
    assert not dist.is_initialized()


_CHILD = textwrap.dedent("""
    import json, sys, time
    import numpy as np
    import torch
    from nnstreamer_tpu_torch.parallel import distributed as dist

    mode, rank, rdv, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if mode == "missing-peer":
        t0 = time.monotonic()
        try:
            dist.initialize(f"file://{rdv}", 2, 0, timeout_s=3)
        except Exception as e:
            print("RAISED", round(time.monotonic() - t0, 2), type(e).__name__)
        else:
            print("JOINED")
        sys.exit(0)
    assert dist.initialize(f"file://{rdv}", 2, rank, timeout_s=60)
    res = {"rank": rank}
    try:
        import child_modes
        getattr(child_modes, mode.replace("-", "_"))(rank, res, out)
    finally:
        dist.shutdown()
    if rank == 0 and hasattr(child_modes, mode.replace("-", "_") + "_after"):
        getattr(child_modes, mode.replace("-", "_") + "_after")(res, out)
    json.dump(res, open(f"{out}/rank{rank}.json", "w"))
    print("DONE", rank, flush=True)
""")

_MODES = textwrap.dedent('''
    import numpy as np
    import torch
    from nnstreamer_tpu_torch.parallel import distributed as dist
    from nnstreamer_tpu_torch.parallel import global_mesh, make_mesh
    from nnstreamer_tpu_torch.parallel.sharding import (cross_rank_sum,
                                                        put_process_local)
    from nnstreamer_tpu_torch.models import llama

    def collectives(rank, res, out):
        """The JAX ordered-collectives witness: process-local rows over a
        global data axis (two slots a rank), one reduction a batch."""
        assert dist.local_device_count() == 2 and dist.global_device_count() == 4
        mesh = global_mesh()
        assert mesh.size == 4 and mesh.spans_ranks()
        vals = []
        for k in range(3):
            local = torch.arange(2, dtype=torch.float32) + 10 * rank + 100 * k
            arr = put_process_local(local, mesh)
            assert arr.shape == (4,) and len(arr.addressable_shards) == 2
            parts = [t.sum() for _, t in arr.addressable_shards]
            vals.append(float(cross_rank_sum(parts, "cpu", dist.group_of(mesh.flat))))
        res["batches"] = vals

    def _tiny(out):
        cfg = llama.PRESETS["llama_tiny"]
        z = np.load(f"{out}/tiny.npz")
        tree = {"embed": z["embed"], "ln_out": z["ln_out"], "lm_head": z["lm_head"],
                "layers": {k[7:]: z[k] for k in z.files if k.startswith("layers.")}}
        return cfg, llama.params_from_jax(tree, device="cpu")

    def tp(rank, res, out):
        """llama_tiny's weights cut over a model axis that spans the two
        ranks; rank 0 also cuts them over two slots of its own."""
        cfg, params = _tiny(out)
        mesh = make_mesh(model=2, data=1)
        group = mesh.model_group(0)
        assert [s.rank for s in group] == [0, 1]
        tp = llama.place_tp(params, cfg, [group[rank].device], ways=2, first=rank,
                            group=dist.group_of(group))
        assert len(tp.shards) == 1 and tp.ways == 2 and tp.local.n_heads == cfg.n_heads // 2
        toks = torch.tensor([[1, 7, 3, 9]])
        with torch.inference_mode():
            logits = llama.forward(tp, toks, cfg, "float32")
            if rank == 0:
                local = llama.place_tp(params, cfg, ["cpu", "cpu"])
                res["bitwise_in_process"] = bool(torch.equal(
                    llama.forward(local, toks, cfg, "float32"), logits))
        np.save(f"{out}/logits{rank}.npy", logits.numpy())
        # a trainer's mesh= over slots of another rank raises (it feeds
        # its own slots only, as the JAX trainer feeds its own devices)
        from nnstreamer_tpu_torch.trainer.subplugin import Trainer, TrainerError
        try:
            Trainer().open({"model": "mlp:4:8:3", "mesh": "data:2",
                            "accelerator": "true:cpu"})
        except TrainerError as e:
            res["trainer_mesh_error"] = str(e)

    def ring(rank, res, out):
        """A seq=2 ring over a global mesh, one slot a rank, against the
        in-process seq=2 ring on rank 0."""
        from nnstreamer_tpu_torch.parallel import ring_attention
        from nnstreamer_tpu_torch.parallel.mesh import Slot

        rng = np.random.default_rng(5)
        q, k, v = (rng.standard_normal((2, 32, 2, 8), dtype=np.float32)
                   for _ in range(3))
        mesh = global_mesh(seq=2, data=1)
        assert mesh.spans_ranks()
        got = ring_attention(mesh, q, k, v, causal=True)
        if rank == 0:
            local = make_mesh(seq=2, data=1, devices=[Slot(0, "cpu"), Slot(1, "cpu", 1)])
            want = ring_attention(local, q, k, v, causal=True)
            res["bitwise_in_process"] = bool(torch.equal(got, want))
        np.save(f"{out}/ring{rank}.npy", got.numpy())

    LLM = ("appsrc name=src ! tensor_filter name=llm framework=llm model=llama_tiny "
           "custom=max_new:6,dtype:float32,param_dtype:float32,serve:continuous,"
           "slots:2,block_size:8,prefill_chunk:8 accelerator=true:cpu ! "
           "tensor_sink name=out")
    PROMPTS = ([5, 9, 2, 7, 1, 3, 8, 4, 6, 11], [1, 2, 3])

    def serve(mp, check=None):
        import nnstreamer_tpu_torch as ntt

        p = ntt.Pipeline(LLM, model_parallel=mp)
        with p:
            fw = p.element("llm").fw
            if check is not None:
                check(fw)
            for pr in PROMPTS:
                p.push("src", np.asarray(pr, np.int32))
            by = {}
            for _ in range(6 * len(PROMPTS)):
                b = p.pull("out", timeout=60)
                by.setdefault(int(b.meta["stream_id"]), []).append(int(b.tensors[0][0]))
            p.eos("src")
            p.wait(timeout=60)
        return [by[k] for k in sorted(by)]

    def continuous(rank, res, out):
        def check(fw):
            assert fw.tp is not None and fw.tp.group is not None and fw.tp.ways == 2
            assert fw.census.eager
        res["tokens"] = serve(2, check)

    def continuous_after(res, out):
        """Rank 0, the group left: the same traffic over two slots of its own."""
        import os
        os.environ["NNS_TPU_DEVICE_SLOTS"] = "2"
        res["in_process"] = serve(2)
''')


def _children(tmp_path, mode, ranks=(0, 1), env_extra=None):
    """Run ``mode`` in one child per rank (one gloo group, a ``file://``
    rendezvous of its own); returns each rank's stdout and result."""
    (tmp_path / "child.py").write_text(_CHILD)
    (tmp_path / "child_modes.py").write_text(_MODES)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.update(OMP_NUM_THREADS="1", NNS_TPU_DEVICE_SLOTS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO,
                                           env.get("PYTHONPATH", "")]))
    env.update(env_extra or {})
    rdv = tmp_path / "rdv"
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(tmp_path / "child.py"), mode, str(r), str(rdv),
             str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in ranks]
        outs = []
        deadline = time.monotonic() + CHILD_S
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for r, (p, out) in zip(ranks, zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    res = [json.load(open(tmp_path / f"rank{r}.json"))
           if (tmp_path / f"rank{r}.json").exists() else None for r in ranks]
    return outs, res


def test_missing_peer_raises_within_timeout(tmp_path):
    """A coordinator whose second process never comes: initialize raises
    within its 3 s timeout (never a silent local-only mesh)."""
    [out], _ = _children(tmp_path, "missing-peer", ranks=(0,))
    line = next(l for l in out.splitlines() if l.startswith(("RAISED", "JOINED")))
    assert line.startswith("RAISED"), out
    assert float(line.split()[1]) < 30, line


def test_two_process_collectives_ordered(tmp_path):
    """The port of the JAX two-process witness: two slots a rank, a global
    mesh of four, process-local rows, three reductions in batch order."""
    _, res = _children(tmp_path, "collectives",
                       env_extra={"NNS_TPU_DEVICE_SLOTS": "2"})
    want = [float(sum((np.arange(2) + 10 * p + 100 * k).sum() for p in range(2)))
            for k in range(3)]
    assert res[0]["batches"] == res[1]["batches"] == want


def test_two_process_tensor_parallel_llama(tmp_path):
    """llama_tiny's weights cut over a model axis that spans two ranks:
    both ranks' logits bitwise equal, bitwise the in-process model=2
    run's, and within 1e-4 of the JAX unsharded forward; a trainer's
    mesh= naming the other rank's slot raises."""
    cfg = jl.PRESETS["llama_tiny"]
    params = jl.init_params(cfg, seed=0)
    flat = {k: np.asarray(v) for k, v in params.items() if k != "layers"}
    flat.update({f"layers.{k}": np.asarray(v) for k, v in params["layers"].items()})
    np.savez(tmp_path / "tiny.npz", **flat)
    _, res = _children(tmp_path, "tp")
    a, b = (np.load(tmp_path / f"logits{r}.npy") for r in (0, 1))
    assert a.tobytes() == b.tobytes()
    assert res[0]["bitwise_in_process"]
    ref = np.asarray(jl.forward(params, np.array([[1, 7, 3, 9]], np.int32), cfg,
                                compute_dtype="float32"))
    assert float(np.abs(a - ref).max()) < 1e-4
    assert "another rank" in res[0]["trainer_mesh_error"]


def test_two_process_ring_bitwise_in_process(tmp_path):
    """A seq=2 ring with one slot a rank: both ranks hold the whole
    output, bitwise the in-process seq=2 ring's."""
    _, res = _children(tmp_path, "ring")
    a, b = (np.load(tmp_path / f"ring{r}.npy") for r in (0, 1))
    assert a.tobytes() == b.tobytes()
    assert res[0]["bitwise_in_process"]


def test_two_process_continuous_filter_model_parallel(tmp_path):
    """The continuous llm filter at model_parallel=2 over two ranks (each
    runs the same pipeline on the same prompts): both ranks' sinks yield
    the same tokens, equal to the in-process model=2 run's; the census
    runs eagerly."""
    _, res = _children(tmp_path, "continuous")
    assert res[0]["tokens"] == res[1]["tokens"]
    assert [len(t) for t in res[0]["tokens"]] == [6, 6]
    assert res[0]["tokens"] == res[0]["in_process"]


def test_eager_census_matches_captured_path():
    """``Census.eager`` (the cross-rank and distinct-card steps) runs the
    steps the captured path runs: the continuous loop's tokens with the
    flag set equal those without it."""
    import nnstreamer_tpu_torch as ntt

    desc = ("appsrc name=src ! tensor_filter name=llm framework=llm "
            "model=llama_tiny custom=max_new:5,dtype:float32,serve:continuous,"
            "slots:2,block_size:8,prefill_chunk:8 accelerator=true:cpu ! "
            "tensor_sink name=out")
    got = []
    for eager in (False, True):
        p = ntt.Pipeline(desc)
        with p:
            fw = p.element("llm").fw
            fw.census.eager = eager
            p.push("src", np.arange(1, 12, dtype=np.int32))
            got.append([int(p.pull("out", timeout=60).tensors[0][0]) for _ in range(5)])
            assert fw.census.captures >= 1
            p.eos("src")
            p.wait(timeout=60)
    assert got[0] == got[1]


def test_chip_smoke_mesh_and_dist_phases_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py``'s mesh and dist phases on the CPU at a rehearsal
    size (llama_small cut to 2 layers at float32, 6 tokens; the ring at
    [1, 64, 4, 16] over four slots; the quick-start at 32 px): every
    check of both phases, the two ranks' children included — tokens equal
    on both ranks and to the in-process TP's, the first decode step
    bitwise, the cross-rank ring bitwise, the data-parallel frames bitwise
    the one-slot run's."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "N_LAYERS", 2)
    # float32 at 2 layers: the TP step's logits sit at round-off of the
    # unsharded step's, so the tie share is round-off's
    monkeypatch.setattr(cs, "MESH_TIE", 1e-5)
    # the in-process references at the children's one thread: the CPU's
    # GEMMs split their sums by the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    acc = "accelerator=true:cpu"
    small = "model=llama_small custom=vocab:32000,n_layers:2,dtype:float32,"
    base = (cs.MESH_DESC.replace("model=llama2_7b custom=", small)
            .replace(f"max_new:{cs.MESH_NEW}", "max_new:6")
            .replace("! tensor_sink", acc + " ! tensor_sink"))
    static = (cs.MESH_STATIC_DESC.replace("model=llama2_7b custom=", small)
              .replace("! tensor_sink", acc + " ! tensor_sink"))
    dev = torch.device("cpu")
    try:
        m, first = cs.phase_mesh(dev, base=base, new=6, static_desc=static, static_new=4,
                                 layers=2, size=32, frames_n=10, acc=acc,
                                 kernel_rows=False, ring=dict(shape=(1, 64, 4, 16), seq_t=64))
    finally:
        torch.set_num_threads(threads)
    assert m["dp"]["bitwise"] == 10
    assert m["ring"]["max_share"] <= cs.RING_TOL
    assert m["ring"]["max_logit_share"] <= cs.SEQ_TOL
    d = cs.phase_dist(dev, m, first, base=base, new=6, ring_shape=(1, 32, 4, 16),
                      out_dir=str(tmp_path / "dist"))
    assert d["tokens_equal"] and d["first_logits_bitwise"] and d["ring_bitwise"]
    assert [len(t) for t in d["ranks"][0]["ids"]] == [6, 6]
