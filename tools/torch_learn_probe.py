"""Probe of the port's trainer on the card: mobilenet_v1 224, batch 32,
Adam, with cuDNN's deterministic mode off and then on.  For each, a
trainer's first window captures its step; from the state before the
second window the first replay, an eager call of the step function and a
second replay are compared bitwise; the replay and the eager step are
timed with CUDA events (median); then a third window with validation
samples runs an epoch, and the peak memory is printed.

    python3 tools/torch_learn_probe.py        # on the card
"""
import sys, time, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from nnstreamer_tpu_torch.trainer.subplugin import Trainer
dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)
rng = np.random.default_rng(0)
xs = rng.standard_normal((96, 224, 224, 3), dtype=np.float32)
ys = rng.integers(0, 1001, (96, 1)).astype(np.int32)

def state(tr):
    return [p.detach().clone() for p in tr._leaves] + [t.clone() for p in tr._leaves for t in tr._opt.state[p].values()]

def restore(tr, st):
    with torch.no_grad():
        it = iter(st)
        for p in tr._leaves: p.copy_(next(it))
        for p in tr._leaves:
            for t in tr._opt.state[p].values(): t.copy_(next(it))

def cmp(a, b):
    d = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
    eq = all(torch.equal(x, y) for x, y in zip(a, b))
    return eq, d

def ms(fn, n):
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    fn(); torch.cuda.synchronize()
    t = []
    for _ in range(n):
        e0.record(); fn(); e1.record(); torch.cuda.synchronize(); t.append(e0.elapsed_time(e1))
    return float(np.median(t))

for det in (False, True):
    torch.backends.cudnn.deterministic = det
    tr = Trainer()
    t0 = time.perf_counter()
    tr.open({"model": "mobilenet_v1", "optimizer": "adam", "batch_size": 32, "learning_rate": 1e-3})
    for i in range(32):
        tr.push_data([xs[i]], [ys[i]], False)
    torch.cuda.synchronize()
    print("det", det, "open+first window (capture)", time.perf_counter() - t0, "captures", tr.compile_counts(), flush=True)
    s0 = state(tr)
    for i in range(32, 64):
        tr.push_data([xs[i]], [ys[i]], False)
    torch.cuda.synchronize()
    after = state(tr)
    restore(tr, s0); tr._step_fn(); torch.cuda.synchronize(); eager = state(tr)
    print("replay vs eager", cmp(after, eager), flush=True)
    restore(tr, s0); tr._step.replay(); torch.cuda.synchronize(); again = state(tr)
    print("replay vs replay", cmp(after, again), flush=True)
    restore(tr, s0); tr._step_fn(); torch.cuda.synchronize(); eager2 = state(tr)
    print("eager vs eager", cmp(eager, eager2), flush=True)
    print("replay ms", ms(tr._step.replay, 20), "eager ms", ms(tr._step_fn, 10), flush=True)
    for i in range(64, 96):
        tr.push_data([xs[i]], [ys[i]], i >= 80)
    st = tr.train_epoch()
    print("stats", st, tr.compile_counts(), "peak GB", torch.cuda.max_memory_allocated() / 1e9, flush=True)
    del tr
    torch.cuda.empty_cache()
