"""The port's datareposink / datareposrc against the JAX package's: the
same pushes give the same data and meta files byte for byte, a set
written by either package replays through the other, and the per-epoch
shuffle gives the same order in both (a pure function of
``(shuffle-seed, epoch)``); index windows, manifests and bf16 samples."""

import json

import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as ntt

PKGS = {"jax": nt, "torch": ntt}
WAIT = 10.0
N = 10


def _samples(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((1, 4)).astype(np.float32),
             np.asarray([i], np.int32)] for i in range(n)]


def _write(pkg, data, meta, samples, extra=""):
    desc = ("appsrc name=src caps=other/tensors,num_tensors=2,dimensions=4:1.1,"
            f"types=float32.int32 ! datareposink location={data} json={meta} {extra}")
    with PKGS[pkg].Pipeline(desc) as p:
        for s in samples:
            p.push("src", list(s))
        p.eos("src")
        p.wait(timeout=WAIT)


def _read(pkg, props, n):
    with PKGS[pkg].Pipeline(f"datareposrc {props} ! tensor_sink name=out") as p:
        out = [p.pull("out", timeout=WAIT) for _ in range(n)]
        p.wait(timeout=WAIT)
    return out


def test_the_same_pushes_give_the_jax_files(tmp_path):
    files = {}
    for pkg in PKGS:
        d, m = tmp_path / f"{pkg}.bin", tmp_path / f"{pkg}.json"
        _write(pkg, d, m, _samples())
        files[pkg] = (d.read_bytes(), json.loads(m.read_text()))
    assert files["torch"] == files["jax"]
    assert files["torch"][1] == {"dims": "4:1,1", "types": "float32,int32",
                                 "total_samples": N, "sample_size": 20}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_a_set_replays_through_the_other_package(tmp_path, writer, reader):
    d, m = tmp_path / "set.bin", tmp_path / "set.json"
    want = _samples()
    _write(writer, d, m, want)
    got = _read(reader, f"location={d} json={m}", N)
    for g, w in zip(got, want):
        assert [np.asarray(t).tobytes() for t in g.tensors] == [t.tobytes() for t in w]
        assert [np.asarray(t).shape for t in g.tensors] == [(1, 4), (1,)]


def test_shuffled_epochs_replay_in_the_jax_order(tmp_path):
    d, m = tmp_path / "set.bin", tmp_path / "set.json"
    _write("jax", d, m, _samples())
    props = f"location={d} json={m} epochs=3 is-shuffle=true shuffle-seed=7"
    order = {pkg: [(b.meta["epoch"], b.meta["sample_index"], int(np.asarray(b.tensors[1])[0]))
                   for b in _read(pkg, props, 3 * N)] for pkg in PKGS}
    assert order["torch"] == order["jax"]
    epochs = [[i for e, i, _ in order["torch"] if e == k] for k in range(3)]
    assert all(sorted(e) == list(range(N)) for e in epochs)
    assert epochs[0] != epochs[1]  # every epoch its own order
    want = []
    for k in range(3):
        idx = list(range(N))
        np.random.default_rng((7, k)).shuffle(idx)
        want += idx
    assert [i for _, i, _ in order["torch"]] == want
    assert all(i == label for _, i, label in order["torch"])


def test_index_window(tmp_path):
    d, m = tmp_path / "set.bin", tmp_path / "set.json"
    _write("torch", d, m, _samples())
    props = f"location={d} json={m} start-sample-index=2 stop-sample-index=5"
    got = {pkg: [b.meta["sample_index"] for b in _read(pkg, props, 4)] for pkg in PKGS}
    assert got["torch"] == got["jax"] == [2, 3, 4, 5]


def test_manifest_replays_by_json_alone_across_shards(tmp_path):
    samples = _samples()
    _write("torch", tmp_path / "a.bin", tmp_path / "a.json", samples[:4], "manifest=true")
    _write("jax", tmp_path / "b.bin", tmp_path / "b.json", samples[4:])
    meta = json.loads((tmp_path / "a.json").read_text())
    assert meta["files"] == ["a.bin"]  # relative to the meta's directory
    meta["files"] = ["a.bin", "b.bin"]
    del meta["total_samples"]  # the shards' sizes say how many
    (tmp_path / "all.json").write_text(json.dumps(meta))
    got = {pkg: _read(pkg, f"json={tmp_path / 'all.json'}", N) for pkg in PKGS}
    for pkg in PKGS:
        assert [int(np.asarray(b.tensors[1])[0]) for b in got[pkg]] == list(range(N))


def test_bf16_samples_round_trip_as_their_words(tmp_path):
    d, m = tmp_path / "bf.bin", tmp_path / "bf.json"
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn(2, 3, generator=gen).to(torch.bfloat16) for _ in range(3)]
    with ntt.Pipeline(f"appsrc name=src ! datareposink location={d} json={m}") as p:
        for x in xs:
            p.push("src", x)
        p.eos("src")
        p.wait(timeout=WAIT)
    assert d.read_bytes() == b"".join(x.view(torch.int16).numpy().tobytes() for x in xs)
    assert json.loads(m.read_text())["types"] == "bfloat16"
    with ntt.Pipeline(f"datareposrc location={d} json={m} ! "
                      "tensor_sink name=out to-host=false") as p:
        got = [p.pull("out", timeout=WAIT).tensors[0] for _ in xs]
        p.wait(timeout=WAIT)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, x) for g, x in zip(got, xs))
    jgot = _read("jax", f"location={d} json={m}", len(xs))  # ml_dtypes' bfloat16
    assert [np.asarray(b.tensors[0]).view(np.int16).tobytes() for b in jgot] == \
        [x.view(torch.int16).numpy().tobytes() for x in xs]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_a_short_file_and_a_wrong_sample_size_raise(tmp_path, pkg):
    d, m = tmp_path / "set.bin", tmp_path / "set.json"
    _write("torch", d, m, _samples())
    d.write_bytes(d.read_bytes()[:-20])  # one sample short of the meta
    with pytest.raises(Exception, match="meta claims"):
        _read(pkg, f"location={d} json={m}", N)
    meta = json.loads(m.read_text())
    meta["sample_size"] = 24
    m.write_text(json.dumps(meta))
    with pytest.raises(Exception, match="sample_size"):
        PKGS[pkg].Pipeline(f"datareposrc location={d} json={m} ! tensor_sink name=out")
