#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nnstreamer_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile every CUDA kernel of the main path from csrc/ (one
             nvcc per source, started together) and print the seconds.
2. kernels — hold each kernel against its plain PyTorch version on the
             card, at the shapes the main path gives it and a few more, and
             time kernel, plain version, one PyTorch library call computing
             the same function (the yardstick; the port never calls it) and
             the least time the card could take (the bound).
3. serve   — the main path through the entry points a user calls:
             ``appsrc ! tensor_filter framework=llm model=llama2_7b
             custom=quant:int4,... ! tensor_sink`` at full width (random
             weights from a seed), three prompts of 32, 200 and 700 token
             ids, 64 tokens pulled for each.  Launch counters are zeroed just
             before and read just after: every kernel must have run, flash
             attention once per layer per request, the int4 matmul 129 times
             per decoded token.
4. reference — on a small model, decode logits with the kernels on the
             card agree with the plain versions on the CPU.

Prints the card's name and power limit (nvidia-smi), a ``{"kernels": ...}``
JSON line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
card, outside a checkout, or when any phase fails it exits non-zero and
prints no result.  Per-shape detail goes to chiprun_out/chip_smoke.json.

``--profile`` adds one more 200-token request under torch.profiler and
writes its operator tables to chiprun_out/profile_decode.txt.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

#: published H100 rates (NVIDIA data sheet, dense): device memory bytes/s
#: and bf16 tensor-core flop/s, for the SXM part and the PCIe part
RATES = {"sxm": (3.35e12, 989e12), "pcie": (2.0e12, 756e12)}

#: llama2_7b int4 mats: name -> (packed rows Din/2, out F, launches per
#: decoded token, output dtype name)
INT4_MATS = {
    "wqkv": (2048, 12288, 32, "bf16"),
    "wo": (2048, 4096, 32, "bf16"),
    "wgu": (2048, 22016, 32, "bf16"),
    "w_down": (5504, 4096, 32, "bf16"),
    "lm_head": (2048, 32000, 1, "f32"),
}
INT4_ROWS = (1, 8, 32)
#: flash shapes (B, Sq, Skv, H, Hkv, D, causal): the main path's prompt
#: buckets (32, 256, 1023), the issue's 200 and 1024, grouped K/V, kv
#: longer than q, and one non-causal case
FLASH_SHAPES = [
    (1, 32, 32, 32, 32, 128, True),
    (1, 256, 256, 32, 32, 128, True),
    (1, 1023, 1023, 32, 32, 128, True),
    (1, 200, 200, 32, 32, 128, True),
    (1, 1024, 1024, 32, 32, 128, True),
    (1, 512, 512, 32, 8, 128, True),
    (1, 128, 512, 32, 32, 128, True),
    (1, 256, 256, 32, 32, 128, False),
]
PROMPT_LENS = (32, 200, 700)
MAX_NEW = 64
INT4_TOL = 2e-2   # max |kernel - plain| / max |plain|, bf16 activations
FLASH_TOL = 3e-2  # max |kernel - plain|, bf16 q/k/v drawn from N(0, 1)
REF_TOL = 2e-3    # f32 logits, kernels on the card vs plain on the CPU


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, flush, reps=20):
    """(median device ms, median host enqueue ms) of one call.  Device time
    is taken with CUDA events, L2 flushed before each call so weights come
    from device memory as they do in decode, and a spin kernel queued ahead
    of the start event so that the host has enqueued the call before the
    card reaches it: the events then see device time only."""
    import torch

    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    host = []
    for i in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)  # about 1 ms of clock cycles
        starts[i].record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2], sorted(host)[len(host) // 2]


def timings(kernel, plain, library, flush):
    """Kernel, plain version and library yardstick, timed in turns."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[key + "ms"], out[key + "enqueue_ms"] = timed_ms(fn, flush)
    return out


def phase_kernels(dev, bw, peak, flush):
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, (d2, f, per_token, odt_name) in INT4_MATS.items():
        odt = torch.bfloat16 if odt_name == "bf16" else torch.float32
        packed = torch.randint(-128, 128, (d2, f), generator=gen, device=dev,
                               dtype=torch.int8)
        scale = torch.rand((1, f), generator=gen, device=dev) * 1e-2 + 1e-3
        w = (i4.unpack_int4(packed).float() * scale).to(torch.bfloat16)
        for B in INT4_ROWS:
            h = torch.randn((B, 2 * d2), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            got = i4.matmul_int4(h, packed, scale, out_dtype=odt)
            plain = i4.matmul_int4_reference(h, packed, scale, out_dtype=odt)
            f32 = i4.matmul_int4_reference(h.float(), packed, scale)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            ref = plain.float().abs().max().item()
            err32 = (got.float() - f32).abs().max().item()
            check(err <= INT4_TOL * ref,
                  f"int4 {name} B={B}: max err {err} > {INT4_TOL} x {ref}")
            check(err32 <= INT4_TOL * f32.abs().max().item(),
                  f"int4 {name} B={B}: f32 err {err32}")
            nbytes = (h.numel() * 2 + packed.numel() + scale.numel() * 4
                      + B * f * got.element_size())
            ops = 2.0 * B * 2 * d2 * f
            rows.append(dict(
                kernel="matmul_int4", shape=name, B=B, out=odt_name,
                per_token=per_token, max_abs_err=err, max_abs_plain=ref,
                max_abs_err_vs_f32=err32,
                **timings(
                    lambda: i4.matmul_int4(h, packed, scale, out_dtype=odt),
                    lambda: i4.matmul_int4_reference(h, packed, scale,
                                                     out_dtype=odt),
                    lambda: torch.matmul(h, w), flush),
                bound_ms=max(nbytes / bw, ops / peak) * 1e3,
                bound_by="bytes" if nbytes / bw >= ops / peak else "operations"))
        del packed, scale, w

    for (b, sq, skv, h, hkv, d, causal) in FLASH_SHAPES:
        q = torch.randn((b, sq, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
        got = attention.flash_attention(q, k, v, causal=causal)
        plain = attention.attention_reference(q, k, v, causal=causal)
        f32 = attention.attention_reference(q.float(), k.float(), v.float(),
                                            causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        err32 = (got.float() - f32).abs().max().item()
        check(err <= FLASH_TOL, f"flash {(sq, skv, h, hkv, causal)}: max err {err}")
        check(err32 <= FLASH_TOL, f"flash {(sq, skv, h, hkv, causal)}: f32 err {err32}")
        # library yardstick: SDPA on [B, H, S, D] with K/V repeated per
        # query head and the back-aligned causal mask written out
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous()
        qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        mask = torch.arange(skv, device=dev)[None, :] <= qi if causal else None
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - f32).abs().max().item()
        if causal:
            pairs = sum(min(skv, max(0, i + skv - sq + 1)) for i in range(sq))
        else:
            pairs = sq * skv
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        ops = 4.0 * b * h * d * pairs
        rows.append(dict(
            kernel="flash_attention", shape=dict(B=b, Sq=sq, Skv=skv, H=h,
                                                 Hkv=hkv, D=d, causal=causal),
            max_abs_err=err, max_abs_err_vs_f32=err32,
            library_err_vs_f32=lib_err,
            **timings(
                lambda: attention.flash_attention(q, k, v, causal=causal),
                lambda: attention.attention_reference(q, k, v, causal=causal),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask), flush),
            bound_ms=max(nbytes / bw, ops / peak) * 1e3,
            bound_by="bytes" if nbytes / bw >= ops / peak else "operations"))
    return rows


def profile_request(run, prompt):
    """One request under torch.profiler: the device's busy share over the
    request and the top operators by device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        r = run(prompt)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in avgs) / 1e3
    with open(os.path.join(OUT_DIR, "profile_decode.txt"), "w") as fh:
        for key in ("self_device_time_total", "self_cpu_time_total"):
            fh.write(avgs.table(sort_by=key, row_limit=30) + "\n")
    top = sorted(avgs, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return dict(request=r, wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_device_ms={e.key: e.self_device_time_total / 1e3 for e in top})


def phase_serve(dev, profile=False):
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.filters.llm import _next_bucket
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    desc = ("appsrc name=src ! tensor_filter framework=llm model=llama2_7b "
            "custom=quant:int4,param_dtype:bfloat16,max_seq:1024,"
            f"max_new:{MAX_NEW},stream_chunk:64 ! tensor_sink name=out")
    t0 = time.perf_counter()
    pipe = ntt.Pipeline(desc)
    setup_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, 32000, (n,), generator=gen).to(torch.int32).numpy()
               for n in PROMPT_LENS]
    n_layers = 32
    requests = []

    def run(prompt):
        f0, q0 = attention.LAUNCHES.value, i4.LAUNCHES.value
        metrics.reset()
        t_push = time.perf_counter()
        pipe.push("src", prompt)
        outs, stamps = [], []
        for _ in range(MAX_NEW):
            outs.append(pipe.pull("out", timeout=600))
            stamps.append(time.perf_counter())
        for i, buf in enumerate(outs):
            ids = buf.tensors[0]
            check(ids.dtype == np.int32 and ids.shape == (1,)
                  and 0 <= int(ids[0]) < 32000, f"bad token buffer {ids!r}")
            check(buf.meta.get("stream_index") == i, "stream_index out of order")
            check(bool(buf.meta.get("stream_last")) == (i == MAX_NEW - 1),
                  "stream_last misplaced")
        snap = metrics.snapshot()
        return dict(
            prompt_len=len(prompt),
            # first token AT THE SINK: with stream_chunk:64 it leaves the
            # filter together with the first 64-token burst
            ttft_ms=(stamps[0] - t_push) * 1e3,
            prefill_ms=snap["llm.prefill.mean"] * 1e3,
            decode_tok_s=1.0 / snap["llm.decode_token.mean"],
            request_s=stamps[-1] - t_push,
            flash_launches=attention.LAUNCHES.value - f0,
            int4_launches=i4.LAUNCHES.value - q0,
            tokens=[int(b.tensors[0][0]) for b in outs[:8]])

    with pipe:
        warm = run(prompts[0])  # first-call library and allocator set-up
        attention.LAUNCHES.reset()
        i4.LAUNCHES.reset()
        for prompt in prompts:
            requests.append(run(prompt))
        launches = {"flash_attention": attention.LAUNCHES.value,
                    "matmul_int4": i4.LAUNCHES.value}
        prof = profile_request(run, prompts[1]) if profile else None
        pipe.eos("src")
        pipe.wait(timeout=120)
    for r in requests:
        bucket = min(_next_bucket(r["prompt_len"]), 1023)
        want_int4 = 129 * (MAX_NEW - 1) + (129 if bucket <= 32 else 0)
        check(r["flash_launches"] == n_layers,
              f"flash launches {r['flash_launches']} != {n_layers} per request")
        check(r["int4_launches"] == want_int4,
              f"int4 launches {r['int4_launches']} != {want_int4}")
        r["prefill_rows"] = bucket
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    return dict(setup_s=setup_s, warmup=warm, requests=requests,
                launches=launches, profile=prof,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def phase_reference(dev):
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg = llama.PRESETS["llama_small"]  # head dim 64, grouped K/V
    cpu = llama.init_params(cfg, seed=3, quant="int4")
    card = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(dev)) for k, v in cpu.items()}
    prompt = torch.randint(3, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(4))
    caches = [llama.init_cache(cfg, 1, "float32", d) for d in ("cpu", dev)]
    worst = 0.0
    tok = None
    for step in range(5):
        pos = 0 if step == 0 else 40 + step - 1
        x = prompt if step == 0 else tok
        outs = []
        for params, cache, d in ((cpu, caches[0], "cpu"), (card, caches[1], dev)):
            logits, _ = llama.forward_cached(params, x.to(d), cache, pos, cfg, "float32")
            outs.append(logits[:, -1].float().cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        worst = max(worst, err)
        check(bool(torch.isfinite(outs[1]).all()), "non-finite logits on the card")
        check(err <= REF_TOL * max(1.0, outs[0].abs().max().item()),
              f"reference step {step}: logits differ by {err}")
        tok = outs[0].argmax(-1, keepdim=True).to(torch.int32)
    return dict(model="llama_small int4 f32", steps=5, max_abs_logit_err=worst)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from nnstreamer_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    bw, peak = RATES["pcie" if "pcie" in card.lower() else "sxm"]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"build: {build_s:.1f} s ({time.perf_counter() - t0:.1f} s wall)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as fh:
        for name, text in kernels.build_log.items():
            fh.write(f"== {name}\n{text}\n")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = phase_kernels(dev, bw, peak, flush_buf.zero_)
    del flush_buf
    for r in rows:
        print(f"kernels: {r['kernel']} {r['shape']} B={r.get('B', '-')} "
              f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
              f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
              f"bound={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    serve = phase_serve(dev, profile="--profile" in sys.argv[1:])
    if serve["profile"]:
        pr = serve["profile"]
        print(f"profile: request {pr['wall_ms']:.1f} ms, device busy "
              f"{pr['device_busy_ms']:.1f} ms, idle share "
              f"{pr['device_idle_share']:.3f}; top {pr['top_device_ms']}", flush=True)
    for r in serve["requests"]:
        print(f"serve: prompt {r['prompt_len']} (prefill rows {r['prefill_rows']}) "
              f"ttft at sink {r['ttft_ms']:.1f} ms, prefill {r['prefill_ms']:.1f} ms, "
              f"decode {r['decode_tok_s']:.2f} tok/s, request {r['request_s']:.2f} s, "
              f"flash x{r['flash_launches']}, int4 x{r['int4_launches']}",
              flush=True)
    torch.cuda.empty_cache()
    ref = phase_reference(dev)
    print(f"reference: {ref}", flush=True)

    # one line per kernel: int4 per decoded token (129 launches at B=1),
    # flash per request at the 1023-row prompt bucket (32 launches)
    tok = [r for r in rows if r["kernel"] == "matmul_int4" and r["B"] == 1]
    fl = [r for r in rows if r["kernel"] == "flash_attention"
          and r["shape"]["Sq"] == 1023][0]
    summary = [
        dict(name="matmul_int4", route="cuda",
             source="nnstreamer_tpu_torch/csrc/int4_matmul.cu",
             replaces="nnstreamer_tpu/ops/int4_matmul.py:193",
             launches=serve["launches"]["matmul_int4"],
             max_abs_err=max(r["max_abs_err"] for r in rows
                             if r["kernel"] == "matmul_int4"),
             **{k: sum(r[k] * r["per_token"] for r in tok)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes"),
        dict(name="flash_attention", route="cuda",
             source="nnstreamer_tpu_torch/csrc/flash_attention.cu",
             replaces="nnstreamer_tpu/ops/attention.py:210",
             launches=serve["launches"]["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in rows
                             if r["kernel"] == "flash_attention"),
             **{k: 32 * fl[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=fl["bound_by"]),
    ]
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  rates=dict(bytes_per_s=bw, bf16_flops=peak), build_s=build_s,
                  kernels=rows, serve=serve, reference=ref, summary=summary)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(detail, fh, indent=1)
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
