#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nnstreamer_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile every CUDA kernel of the main path from csrc/ (one
             nvcc per source, started together) and print the seconds.
             The flash and int4 libraries' SASS (cuobjdump) must hold
             tensor-core (HGMMA) instructions and asynchronous copies (TMA:
             UTMALDG; for int4 UTMALDG or UBLKCP), the paged library's
             mma.sync (HMMA) and UTMALDG, and ptxas must report no spill
             for any of their bf16 kernels.
2. kernels — hold each kernel against its plain PyTorch version on the
             card, at the shapes the main path gives it and a few more, and
             time kernel, plain version, one PyTorch library call computing
             the same function (the yardstick; the port never calls it) and
             the least time the card could take (the bound).  Errors are
             per row (a batch row for int4 and paged; a batch row, query
             position and head for flash): max |kernel - plain| over the row
             within a share of the row's max |plain|, on bf16 and on f32
             inputs.  int4 runs the llama2_7b, llama_small and three ragged
             mats at B = 1, 5, 8, 17 and 32 and is held to the f32 plain
             version; at B = 8 and 32 on the llama2_7b mats two calls must
             agree bitwise, and row 0 must not change when the other rows
             do (what the continuous replay below relies on).  The five
             7B mats at B = 8, launched on two streams at once with
             different inputs, must equal the same launches run one after
             another, bitwise.  Paged runs the 7B 8-slot decode step,
             grouped heads (G = 4 and 8), D = 64 and 32, one 4096-position
             row, lengths at the partition edges and a full table, the
             speculative-verify shape (8 rows of T = 5 queries, at G = 1
             and 4; T = 8 at G = 8) and 4 rows of T = 9 at G = 8, which
             take gathered flash row by row; at the 7B step two calls must
             agree bitwise, and row 0 must not change when every other
             row's length and K/V do.
3. serve   — the static stream path through the entry points a user
             calls: ``appsrc ! tensor_filter framework=llm model=llama2_7b
             custom=quant:int4,... ! tensor_sink`` at full width (random
             weights from a seed), three prompts of 32, 200 and 700 token
             ids, 64 tokens pulled for each.  Launch counters are zeroed just
             before and read just after: every kernel must have run, flash
             attention once per layer per request, the int4 matmul 129 times
             per decoded token.  Decode replays one captured CUDA graph per
             batch size: after the warm-up request the filter's census must
             hold one signature and capture nothing more.
4. continuous — the continuous serving path: the same model behind
             ``custom=serve:continuous,slots:8,block_size:16,prefill_chunk:32,
             stream_chunk:8``, eight prompts of 32..700 token ids, four
             pushed first and four more once each of those has a token (late
             joiners), 64 tokens each.  Counters are zeroed after the loop's
             warm-up and read after the loop drained: paged attention 32
             launches per decode step, flash 32 per prefill chunk, int4 129
             per step or chunk (the loop counts its steps and chunks); every
             stream complete and in order, the block pool entirely free;
             the decode step captured once, in the warm-up, and never
             after (one signature in the census).  The loop's host time
             per decode step is printed.  Then, outside the counted run,
             every token of two streams (one of the first wave, one late
             joiner) is held against ``llama.forward_paged`` driven step
             by step on the card, and the loop's decode step, captured,
             against the same step called eagerly at the 7B 8-slot shape:
             from copies of the same inputs, pool and generator states
             (each generator seeded and drawn once, as at a stream's
             admission), eight replays and eight eager calls give bitwise
             equal tokens, positions and pool after every step, greedy
             and sampled (temperature 0.9, top_k 40); the replay's device
             and host time per step are printed beside the eager step's.
5. query   — the continuous cell over the query wire: the same model,
             settings (plus ``stream_idle_timeout:0.2``), prompts and waves
             served by ``tensor_query_serversrc ! tensor_filter !
             tensor_query_serversink`` to eight ``appsrc ! tensor_query_client
             ! tensor_sink`` pipelines over loopback TCP.  Counters are
             zeroed after the server's warm-up and read after the drain,
             with the continuous phase's checks (every stream whole and in
             order, none aborted, the pool free, prefill chunks, launches
             per step and chunk, one census signature and no capture
             after the warm-up, two streams against ``forward_paged``).
             Prints the aggregate over the wire beside the in-process
             one, first token at the client and decode tok/s per stream,
             the wire's per-token latency (client arrival minus
             ``emit_t``, one monotonic clock) and the host time per decode
             step, and how many streams are bitwise equal to the in-process
             run's.  Then, un-timed: a client that stops after one token
             of a 200-id prompt has its stream reaped exactly once
             (``llm.serve.reaped``) with the pool free again while a second
             client gets its whole stream, and one static request of 32
             ids over the wire (``serve`` unset) must give ``serve``'s 64
             tokens bitwise.
6. reference — on a small model, logits with the kernels on the card
             agree with the plain versions on the CPU: cached prefill and
             decode, and the paged path (chunked prefill, then decode with
             a parked row, then a [2, 5] verify-shaped step of two live
             rows), in f32; then the same model in bf16 (cached prefill and
             decode, chunked paged prefill), whose flash calls take the
             tensor-core kernel.
7. vision  — the vision path, which runs no kernel of csrc/ (cuDNN
             convolutions and torch ops, one captured CUDA graph per fused
             stage), batch 64, bf16, random weights from seed 0: (1) the
             README quick-start, ``appsrc max-inflight=4 ! tensor_transform
             ! tensor_filter framework=jax model=mobilenet_v1 (224, 1001
             classes) ! tensor_decoder mode=image_labeling ! tensor_sink``,
             3 warm-up and 30 timed batches of seeded uint8 frames: frames/s,
             p50/p99 per-batch latency (push admitted -> pull), the card's
             ms per batch (CUDA events over replays) and busy share, peak
             memory, the stage names (one fused stage) and the census
             (one signature, no capture after the warm-up); (2) the same
             frames with ``fuse=False``: labels and scores bitwise equal;
             (3) the first batch on the CPU at f32 with the same weights:
             scores within 2% of the frame's largest |logit|, labels equal
             wherever the CPU's top-1/top-2 gap exceeds that; (4) the
             quick-start fed by ``videotestsrc device=true`` (folded into
             the stage), 200 timed batches, and a truncated tail batch
             (2 x 64 + 10 frames, all processed before the first pull: a
             second signature, each buffer bitwise equal to fuse=False);
             (5) ssd_mobilenet (320, 2,000
             anchors, 91 classes) behind ``videotestsrc device=true
             pattern=ball`` with ``bounding_boxes option7=device
             option9=tensors`` and again with ``option7=host``: frames/s,
             census, and the first 33 batches' detections (valid rows,
             boxes, classes, scores) equal.  ``--profile`` adds each
             fused stage's kernels (chiprun_out/profile_vision.txt).
8. models  — the rest of BASELINE's model families in bench.py's form, no
             kernel of csrc/, batch 64, random weights from seed 0, each
             behind a folded device source and fused with its transform
             and decoder into one stage captured as one CUDA graph:
             yolov5s detection (640, 91 classes, 25,200 predictions,
             ``bounding_boxes option1=yolov5 option3=0.5 option7=device
             option9=tensors``), posenet (224, ``pose_estimation
             option4=tensors``), deeplab (224, ``image_segment
             option1=classmap``: the residency planner must pick the
             native-stride map, equal to the argmax of the ``upsample:0``
             scores; and again with ``upsample:1``, full resolution),
             speech_commands and wav2vec2 + ``ctc`` (``audiotestsrc
             device=true``, 16,000-sample windows, float32).  Each cell:
             3 warm-up and 50 timed batches (frames or windows/s, the
             card's ms per batch over 20 replays, busy share, peak
             memory), one stage and one census signature with no capture
             after the warm-up, ``fuse=False`` bitwise equal on the first
             3 batches (yolov5s: its model outputs), and its first frames
             (2 for yolov5s, 4 else) against the CPU at f32 with the
             card's weights: outputs within 3% of the frame's largest
             |output| (audio, float32 on both: 2e-3), decisions (classes,
             keypoint cells, tokens) equal where the CPU's top-2 gap
             exceeds twice the error.  yolov5s: NMS on the card equals
             NMS on the host at option3=0.5 and 0.0, and on the model's
             boxes widened to overlap, where NMS must suppress some (host
             NMS at option5=1.0 suppresses none); wav2vec2: the CTC ids
             equal the host argmax of the same logits.  ``--profile``
             writes each stage's kernels to chiprun_out/profile_models.txt.

Prints the card's name and power limit (nvidia-smi), a ``{"kernels": ...}``
JSON line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
card, outside a checkout, or when any phase fails it exits non-zero and
prints no result.  Per-shape detail goes to chiprun_out/chip_smoke.json.

``--profile`` adds one more 200-token request under torch.profiler and
writes its operator tables to chiprun_out/profile_decode.txt, and traces
the continuous phase's counted run (card activity only): the card's busy
ms per decode step and idle share over that run.
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

#: int4 mats: name -> (packed rows Din/2, out F, launches per decoded
#: token of llama2_7b, output dtype name).  The five llama2_7b mats, the
#: llama_small ones (dim 512, ffn 1024, 4 kv heads of 64) and three ragged
#: ones whose d2 and F are multiples of neither 64 nor 128: the weights of
#: "ragged_tma" still come by TMA (F % 16 == 0), those of "ragged" and
#: "odd" by the producer warp's own loads, and "odd"'s activations by
#: 2-byte loads (d2 % 8 != 0)
INT4_MATS = {
    "wqkv": (2048, 12288, 32, "bf16"),
    "wo": (2048, 4096, 32, "bf16"),
    "wgu": (2048, 22016, 32, "bf16"),
    "w_down": (5504, 4096, 32, "bf16"),
    "lm_head": (2048, 32000, 1, "f32"),
    "small_wqkv": (256, 1024, 0, "bf16"),
    "small_wo": (256, 512, 0, "bf16"),
    "small_wgu": (256, 2048, 0, "bf16"),
    "small_w_down": (512, 512, 0, "bf16"),
    "small_lm_head": (256, 2048, 0, "f32"),
    "ragged_tma": (1000, 1040, 0, "bf16"),
    "ragged": (1000, 1000, 0, "bf16"),
    "odd": (1001, 1001, 0, "f32"),
}
#: batch rows: static decode (1), a continuous decode step (8 slots), a
#: prefill chunk or the static 32-bucket (32), and two ragged counts
INT4_ROWS = (1, 5, 8, 17, 32)
#: rows at which two calls must agree bitwise and row 0 must not depend on
#: the other rows (what replay_stream assumes of the continuous loop)
INT4_BITWISE_ROWS = (8, 32)
#: flash shapes (B, Sq, Skv, H, Hkv, D, causal): the static path's prompt
#: buckets (32, 256, 1023) and 200, 1024; the continuous loop's chunked
#: prefill (32 queries on 32, 256 and 704 gathered positions, back
#: aligned); grouped K/V (4 and 2 heads per kv head), kv longer than q,
#: one non-causal case; llama_small's geometry (D = 64) and a D = 32 case
#: with two batch rows and ragged lengths
FLASH_SHAPES = [
    (1, 32, 32, 32, 32, 128, True),
    (1, 32, 256, 32, 32, 128, True),
    (1, 32, 704, 32, 32, 128, True),
    (1, 256, 256, 32, 32, 128, True),
    (1, 1023, 1023, 32, 32, 128, True),
    (1, 200, 200, 32, 32, 128, True),
    (1, 1024, 1024, 32, 32, 128, True),
    (1, 512, 512, 32, 8, 128, True),
    (1, 100, 100, 32, 8, 128, True),
    (1, 128, 512, 32, 32, 128, True),
    (1, 256, 256, 32, 32, 128, False),
    (1, 40, 40, 8, 4, 64, True),
    (2, 100, 137, 4, 2, 32, True),
]
#: the continuous loop's chunk shapes (Sq = prefill_chunk, Skv = gathered
#: positions): their time per chunk (32 launches) joins the summary line
FLASH_CHUNK_SKV = (32, 256, 704)
PROMPT_LENS = (32, 200, 700)
MAX_NEW = 64
#: int4, per batch row, against the f32 plain version on the same inputs:
#: max |kernel - f32 plain| over the row <= this share of the row's max
#: |f32 plain|.  bf16 outputs round each value by up to 2^-8 (0.39%) of
#: itself, so 1% is 2.5 times that; a dropped 8-row k-slice, split or packed row,
#: a swapped nibble or a wrong output column breaks it
#: (tests/test_torch_int4.py).  f32 outputs (the lm_head) and f32 inputs
#: differ from the plain version only in the order of the sum
INT4_ROW_TOL = 1e-2
INT4_ROW_TOL_F32 = 1e-4
REF_TOL = 2e-3    # f32 logits, kernels on the card vs plain on the CPU
#: bf16 llama_small logits, card against the CPU on the same parameters:
#: max |card - cpu| over a step's logits <= this share of the step's
#: max |cpu logit|.  Two bf16 evaluations that round in different places
#: spread by 3.0-3.8% of max |logit| on the CPU (the kernels' rounding
#: emulated: f32 accumulation, unnormalised probabilities), while a dropped
#: key tile or a wrong kv head in the prefill's flash moves the prefill
#: logits by 96-145% and each decode step's by 15-90%: 8% is twice the
#: spread and under every fault (tests/test_torch_bf16_reference.py).
#: Greedy tokens must be equal wherever the CPU's top-1/top-2 gap is
#: wider than the same share
BF16_REF_TOL = 8e-2
#: flash and paged, per row (flash: one batch row, query position and
#: head; paged: one live batch row): max |kernel - plain| over the row <=
#: this share of the row's max |plain|, bf16 inputs from N(0, 1); and the
#: same on f32 inputs, where a dropped or misread key tile or block of
#: even the longest row shows
ROW_TOL = 2e-2
ROW_TOL_F32 = 1e-4
PAGED_BS = 16
#: paged shapes (name, B, T, H, Hkv, D, context lengths, table width): the
#: continuous path's llama2_7b decode step (8 slots, mixed lengths), the
#: same with grouped K/V (4 and 8 query heads per kv head), head dims 64
#: and 32, one row at 4096 positions, lengths at the edges of the kernel's
#: 256-position partitions and a row filling its whole table; then the
#: speculative-verify step (T = 5 queries per row; the first row's context
#: holds only its suffix), the same with 4 query heads per kv head (20
#: query rows: two 16-row tiles) and at T = 8 with 8 (64 rows: four
#: tiles), and last 9 queries with 8 query heads per kv head (72 rows,
#: past the kernel: each row through gathered flash attention)
PAGED_LENS = (0, 1, 33, 100, 257, 512, 700, 1000)
PAGED_SHAPES = [
    ("7b", 8, 1, 32, 32, 128, PAGED_LENS, 64),
    ("7b_kv8", 8, 1, 32, 8, 128, PAGED_LENS, 64),
    ("g8", 8, 1, 64, 8, 128, PAGED_LENS, 64),
    ("d64", 8, 1, 32, 32, 64, PAGED_LENS, 64),
    ("d32", 8, 1, 32, 32, 32, PAGED_LENS, 64),
    ("long", 1, 1, 32, 32, 128, (4096,), 256),
    ("edges", 4, 1, 32, 32, 128, (255, 256, 257, 1024), 64),
    ("7b_spec", 8, 5, 32, 32, 128, (5, 6, 33, 100, 257, 512, 700, 1000), 64),
    ("spec_kv8", 8, 5, 32, 8, 128, (5, 6, 33, 100, 257, 512, 700, 1000), 64),
    ("spec_g8", 8, 8, 64, 8, 128, (8, 9, 33, 100, 257, 512, 700, 1000), 64),
    ("wide", 4, 9, 64, 8, 128, (0, 9, 300, 1000), 64),
]
#: paged shapes at which two calls must agree bitwise and row 0 must not
#: depend on the other rows
PAGED_BITWISE = ("7b",)
#: int4 mats launched on two streams at once (the five llama2_7b mats at
#: a continuous decode step's 8 rows), rounds of launches
INT4_STREAM_MATS = ("wqkv", "wo", "wgu", "w_down", "lm_head")
INT4_STREAM_ROWS = 8
INT4_STREAM_ROUNDS = 4
PAGED_POOL_BLOCKS = 512
#: continuous phase: first wave, then the late joiners (token ids each)
CONT_WAVES = ((32, 200, 450, 700), (64, 128, 300, 600))
CONT_DESC = ("appsrc name=src ! tensor_filter name=llm framework=llm "
             "model=llama2_7b custom=quant:int4,param_dtype:bfloat16,"
             f"max_seq:1024,max_new:{MAX_NEW},serve:continuous,slots:8,"
             "block_size:16,prefill_chunk:32,stream_chunk:8 "
             "invoke-dynamic=true ! tensor_sink name=out")
#: the query phase: the continuous cell's options behind the query pair,
#: with a dead client's grace of 0.2 s (a 64-token stream lasts about
#: eight 62 ms decode chunks on the card, so a grace near 0.5 s would let
#: it finish before the reap)
QUERY_CUSTOM = (CONT_DESC.split("custom=")[1].split(" ")[0]
                + ",stream_idle_timeout:0.2")
#: continuous streams whose every token is held against forward_paged
#: driven outside the loop: the first of the first wave, the first joiner
CONT_CHECKED = (0, len(CONT_WAVES[0]))
#: a near tie there: top-1/top-2 gap under this share of the row's max
#: |logit|.  The replay runs the loop's own arithmetic at the loop's
#: shapes (a row's result does not depend on the other rows), so only a
#: gap at rounding level counts as a tie
CONT_TIE = 1e-4
N_LAYERS = 32
#: the graph-against-eager check at the 7B 8-slot decode step: each
#: slot's position (None: parked; one parked row, so that the sink block's
#: one write is deterministic too), the sampler settings of its runs, and
#: the blocks each live slot reserves past its position (the timed
#: replays advance it)
GRAPH_POS = (31, 199, 449, None, 699, 63, 127, 599)
GRAPH_SAMPLERS = (("greedy", 0.0, 0), ("sampled", 0.9, 40))
GRAPH_SPARE = 48
#: replays held against as many eager calls, each compared bitwise
GRAPH_STEPS = 8


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


def ptxas_entries(text):
    """{kernel entry: {"registers", "spill_stores", "spill_loads"}} from
    nvcc's ``-Xptxas -v`` report."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sass_counts(name, ops):
    """How many of each SASS instruction the built library of
    ``csrc/<name>.cu`` holds (``cuobjdump -sass``)."""
    from nnstreamer_tpu_torch.ops import kernels

    out = subprocess.run([kernels.toolkit_program("cuobjdump"), "-sass",
                          str(kernels.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    return {op: out.stdout.count(op) for op in ops}


def bf16_kernels(name, entry):
    """ptxas's registers and spills of the library's kernels whose name
    holds ``entry``; each must spill nothing."""
    from nnstreamer_tpu_torch.ops import kernels

    found = {k: e for k, e in ptxas_entries(kernels.build_report(name)).items()
             if entry in k}
    check(bool(found), f"{name} library: ptxas reported no {entry}")
    for k, e in found.items():
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"{name} bf16 kernel spills: {k} {e}")
    return sorted(found.values(), key=str)


def phase_build_evidence():
    """What the built libraries really hold: SASS counts of tensor-core
    (HGMMA for wgmma, HMMA for mma.sync) and asynchronous copy (UTMALDG
    for TMA, UBLKCP for cp.async.bulk) instructions, and each bf16
    kernel's registers and spills as ptxas reports them."""
    sass = sass_counts("flash_attention", ("HGMMA", "UTMALDG"))
    check(sass["HGMMA"] > 0, "flash library: no HGMMA (wgmma) instruction in its SASS")
    check(sass["UTMALDG"] > 0, "flash library: no UTMALDG (TMA load) instruction in its SASS")
    int4_sass = sass_counts("int4_matmul", ("HGMMA", "UTMALDG", "UBLKCP"))
    check(int4_sass["HGMMA"] > 0, "int4 library: no HGMMA (wgmma) instruction in its SASS")
    check(int4_sass["UTMALDG"] + int4_sass["UBLKCP"] > 0,
          "int4 library: no asynchronous copy (UTMALDG or UBLKCP) in its SASS")
    paged_sass = sass_counts("paged_attention", ("HMMA", "UTMALDG"))
    check(paged_sass["HMMA"] > 0, "paged library: no HMMA (mma.sync) instruction in its SASS")
    check(paged_sass["UTMALDG"] > 0, "paged library: no UTMALDG (TMA load) instruction in its SASS")
    return dict(sass=sass, bf16_kernels=bf16_kernels("flash_attention", "flash_bf16_kernel"),
                int4_sass=int4_sass,
                int4_bf16_kernels=bf16_kernels("int4_matmul", "int4_bf16_kernel"),
                paged_sass=paged_sass,
                paged_bf16_kernels=bf16_kernels("paged_attention", "paged_split_bf16"))


def print_row(r):
    row_err = f" row_err={r['max_row_err']:.3g}" if "max_row_err" in r else ""
    if r["kernel"] == "matmul_int4":
        row_err += (f" f32in_row_err={r['max_row_err_f32_inputs']:.3g}"
                    f" vs_bf16_plain={r['max_row_err_vs_bf16_plain']:.3g}"
                    f" bitwise={r['bitwise']}")
    if r["kernel"] == "paged_attention":
        row_err += (f" route={r['route']} f32_row_err={r['max_row_err_vs_f32']:.3g}"
                    f" f32in_row_err={r['max_row_err_f32_inputs']:.3g}"
                    f" bitwise={r['bitwise']}")
    print(f"kernels: {r['kernel']} {r['shape']} B={r.get('B', '-')} "
          f"err={r['max_abs_err']:.3g}{row_err} ms={r['ms']:.4f} "
          f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
          f"bound={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)


def phase_kernels(dev, bw, peak, flush):
    """Every kernel against its plain version at its shapes, and the int4
    two-stream check; returns (rows, the two-stream result)."""
    import torch

    from nnstreamer_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, (d2, f, per_token, odt_name) in INT4_MATS.items():
        packed = torch.randint(-128, 128, (d2, f), generator=gen, device=dev,
                               dtype=torch.int8)
        scale = torch.rand((1, f), generator=gen, device=dev) * 1e-2 + 1e-3
        w = (i4.unpack_int4(packed).float() * scale).to(torch.bfloat16)
        for B in INT4_ROWS:
            rows.append(int4_row(dev, gen, bw, peak, flush, name, packed, scale,
                                 w, B, per_token, odt_name))
            print_row(rows[-1])
        del packed, scale, w
    streams = int4_two_streams(dev, gen)
    print(f"kernels: int4 on two streams at once {streams}", flush=True)

    for shape in FLASH_SHAPES:
        rows.append(flash_row(dev, gen, bw, peak, flush, *shape))
        print_row(rows[-1])

    for shape in PAGED_SHAPES:
        rows.append(paged_row(dev, gen, bw, peak, flush, *shape))
        print_row(rows[-1])
    return rows, streams


def int4_two_streams(dev, gen):
    """The five llama2_7b int4 mats at INT4_STREAM_ROWS rows, launched on
    two streams at once (one input set each, every mat in turn on both
    streams, INT4_STREAM_ROUNDS times), against the same launches run one
    after another on the current stream: every output bitwise equal.  Two
    launches in flight on two streams must not share split-K tickets."""
    import torch

    from nnstreamer_tpu_torch.ops import int4_matmul as i4

    mats = []
    for name in INT4_STREAM_MATS:
        d2, f, _, odt_name = INT4_MATS[name]
        packed = torch.randint(-128, 128, (d2, f), generator=gen, device=dev,
                               dtype=torch.int8)
        scale = torch.rand((1, f), generator=gen, device=dev) * 1e-2 + 1e-3
        odt = torch.bfloat16 if odt_name == "bf16" else torch.float32
        hs = [torch.randn((INT4_STREAM_ROWS, 2 * d2), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
        mats.append((packed, scale, odt, hs))
    want = [[i4.matmul_int4(h, packed, scale, out_dtype=odt) for h in hs]
            for packed, scale, odt, hs in mats]
    main = torch.cuda.current_stream()
    side = [torch.cuda.Stream(device=dev) for _ in range(2)]
    for st in side:
        st.wait_stream(main)
    got = []
    for _ in range(INT4_STREAM_ROUNDS):
        outs = [[None, None] for _ in mats]
        for m, (packed, scale, odt, hs) in enumerate(mats):
            for k, st in enumerate(side):
                with torch.cuda.stream(st):
                    outs[m][k] = i4.matmul_int4(hs[k], packed, scale, out_dtype=odt)
        got.append(outs)
    for st in side:
        main.wait_stream(st)
    torch.cuda.synchronize()
    equal = sum(bitwise_equal(outs[m][k], want[m][k])
                for outs in got for m in range(len(mats)) for k in range(2))
    total = INT4_STREAM_ROUNDS * len(mats) * 2
    check(equal == total, f"int4 on two streams: {total - equal} of {total} "
                          f"outputs differ from the launches run one by one")
    return dict(mats=list(INT4_STREAM_MATS), B=INT4_STREAM_ROWS,
                rounds=INT4_STREAM_ROUNDS, bitwise_equal=equal, outputs=total)


def row_errs(got, want, live=None):
    """(max abs error, max over rows of the row's max abs error over the
    row's max |want|); a row is everything but the last axis."""
    diff = (got.float() - want.float()).abs().flatten(0, -2).amax(-1)
    scale = want.float().abs().flatten(0, -2).amax(-1)
    if live is not None:
        diff, scale = diff[live], scale[live]
    return diff.max().item(), (diff / scale).max().item()


def bitwise_equal(a, b):
    """Whether two tensors of one float dtype hold the same bits."""
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return bool(torch.equal(a.view(ints), b.view(ints)))


def int4_row(dev, gen, bw, peak, flush, name, packed, scale, w, B, per_token,
             odt_name):
    """The int4 kernel against its plain version at one mat and row count.
    bf16 activations (the tensor-core route) are held per row against the
    f32 plain version on the same values, f32 activations (the CUDA-core
    route) the same with an f32 output; the error against the bf16 plain
    version is kept as a number only.  At INT4_BITWISE_ROWS on the
    llama2_7b mats, two calls must agree bitwise, and so must row 0 when
    every other row changes."""
    import torch

    from nnstreamer_tpu_torch.ops import int4_matmul as i4

    d2, f = packed.shape
    odt = torch.bfloat16 if odt_name == "bf16" else torch.float32
    tol = INT4_ROW_TOL if odt == torch.bfloat16 else INT4_ROW_TOL_F32
    h = torch.randn((B, 2 * d2), generator=gen, device=dev, dtype=torch.bfloat16)
    h32 = h.float()
    got = i4.matmul_int4(h, packed, scale, out_dtype=odt)
    plain = i4.matmul_int4_reference(h, packed, scale, out_dtype=odt)
    f32 = i4.matmul_int4_reference(h32, packed, scale, out_dtype=torch.float32)
    got_f32in = i4.matmul_int4(h32, packed, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err, rel = row_errs(got, f32)
    err_bf16, rel_bf16 = row_errs(got, plain)
    err_f32in, rel_f32in = row_errs(got_f32in, f32)
    shape = f"int4 {name} (d2 {d2}, F {f}) B={B}"
    check(rel <= tol, f"{shape}: row error {rel} > {tol} of the row's scale")
    check(rel_f32in <= INT4_ROW_TOL_F32,
          f"{shape}: f32-input row error {rel_f32in} > {INT4_ROW_TOL_F32}")
    bitwise = None
    if per_token and B in INT4_BITWISE_ROWS:
        again = i4.matmul_int4(h, packed, scale, out_dtype=odt)
        h_other = h.clone()
        h_other[1:] = torch.randn((B - 1, 2 * d2), generator=gen, device=dev,
                                  dtype=torch.bfloat16)
        other = i4.matmul_int4(h_other, packed, scale, out_dtype=odt)
        torch.cuda.synchronize()
        bitwise = dict(repeat=bitwise_equal(got, again),
                       row0_alone=bitwise_equal(got[0], other[0]))
        check(bitwise["repeat"], f"{shape}: two calls on the same inputs differ")
        check(bitwise["row0_alone"],
              f"{shape}: row 0 changed when only the other rows did")
    nbytes = (h.numel() * 2 + packed.numel() + scale.numel() * 4
              + B * f * got.element_size())
    ops = 2.0 * B * 2 * d2 * f
    return dict(
        kernel="matmul_int4", shape=name, d2=d2, F=f, B=B, out=odt_name,
        per_token=per_token, max_abs_err=err, max_row_err=rel,
        max_abs_err_vs_bf16_plain=err_bf16, max_row_err_vs_bf16_plain=rel_bf16,
        max_abs_err_f32_inputs=err_f32in, max_row_err_f32_inputs=rel_f32in,
        bitwise=bitwise,
        **timings(
            lambda: i4.matmul_int4(h, packed, scale, out_dtype=odt),
            lambda: i4.matmul_int4_reference(h, packed, scale, out_dtype=odt),
            lambda: torch.matmul(h, w), flush),
        bound_ms=max(nbytes / bw, ops / peak) * 1e3,
        bound_by="bytes" if nbytes / bw >= ops / peak else "operations")


def flash_row(dev, gen, bw, peak, flush, b, sq, skv, h, hkv, d, causal):
    """The flash kernel against its plain version at one shape: bf16 inputs
    against the plain version on the same inputs and on their f32 copies,
    and the f32 inputs against the f32 plain version, each per row."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops import attention

    shape = (sq, skv, h, hkv, d, causal)
    q = torch.randn((b, sq, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    qf, kf, vf = q.float(), k.float(), v.float()
    got = attention.flash_attention(q, k, v, causal=causal)
    plain = attention.attention_reference(q, k, v, causal=causal)
    f32 = attention.attention_reference(qf, kf, vf, causal=causal)
    got_f32in = attention.flash_attention(qf, kf, vf, causal=causal)
    torch.cuda.synchronize()
    err, rel = row_errs(got, plain)
    err32, rel32 = row_errs(got, f32)
    err_f32in, rel_f32in = row_errs(got_f32in, f32)
    check(rel <= ROW_TOL, f"flash {shape}: row error {rel} of the row's scale")
    check(rel32 <= ROW_TOL, f"flash {shape}: f32 row error {rel32}")
    check(rel_f32in <= ROW_TOL_F32, f"flash {shape}: f32-input row error {rel_f32in}")
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
    return dict(
        kernel="flash_attention", shape=dict(B=b, Sq=sq, Skv=skv, H=h,
                                             Hkv=hkv, D=d, causal=causal),
        max_abs_err=err, max_row_err=rel, max_abs_err_vs_f32=err32,
        max_row_err_vs_f32=rel32, max_abs_err_f32_inputs=err_f32in,
        max_row_err_f32_inputs=rel_f32in, library_err_vs_f32=lib_err,
        **timings(
            lambda: attention.flash_attention(q, k, v, causal=causal),
            lambda: attention.attention_reference(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask), flush),
        bound_ms=max(nbytes / bw, ops / peak) * 1e3,
        bound_by="bytes" if nbytes / bw >= ops / peak else "operations")


def paged_inputs(dev, gen, b, t, h, hkv, d, lens, max_blocks, seed):
    """bf16 q [b, t, h, d] and pools, blocks scattered through a 512-block
    pool (a permutation from ``seed``), sentinel entries past each row."""
    import math

    import torch

    nbk, bs, bf = PAGED_POOL_BLOCKS, PAGED_BS, torch.bfloat16
    q = torch.randn((b, t, h, d), generator=gen, device=dev, dtype=bf)
    kp = torch.randn((nbk, bs, hkv, d), generator=gen, device=dev, dtype=bf)
    vp = torch.randn((nbk, bs, hkv, d), generator=gen, device=dev, dtype=bf)
    perm = torch.randperm(nbk, generator=torch.Generator().manual_seed(seed))
    tables = torch.full((b, max_blocks), nbk, dtype=torch.int32)
    used = 0
    for r, n in enumerate(lens):
        need = math.ceil(n / bs)
        tables[r, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, tables.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)


def paged_row_alone(dev, gen, q, kp, vp, tables, lens_t):
    """Row 0 given the batch's longest context (the longest row moved to
    the front), then every other row's query, length, blocks and K/V
    changed: row 0's output must not change, bitwise."""
    import math

    import torch

    from nnstreamer_tpu_torch.ops import attention

    order = [int(lens_t.argmax())] + [r for r in range(len(lens_t)) if r != int(lens_t.argmax())]
    q, tables, lens_t = q[order], tables[order], lens_t[order]
    want = attention.paged_attention(q, kp, vp, tables, lens_t)
    nbk, bs = kp.shape[0], kp.shape[1]
    mine = tables[0, :math.ceil(int(lens_t[0]) / bs)].long()
    free = torch.ones(nbk, dtype=torch.bool, device=dev)
    free[mine] = False
    q2, kp2, vp2 = q.clone(), kp.clone(), vp.clone()
    q2[1:] = torch.randn(q2[1:].shape, generator=gen, device=dev, dtype=q.dtype)
    kp2[free] = torch.randn(kp2[free].shape, generator=gen, device=dev, dtype=kp.dtype)
    vp2[free] = torch.randn(vp2[free].shape, generator=gen, device=dev, dtype=vp.dtype)
    lens2 = lens_t.clone()
    lens2[1:] = lens_t[1:].flip(0)
    spare = free.nonzero().flatten()
    tables2 = tables.clone()
    tables2[1:] = nbk
    used = 0
    for r in range(1, len(lens2)):
        need = math.ceil(int(lens2[r]) / bs)
        tables2[r, :need] = spare[used:used + need].to(torch.int32)
        used += need
    got = attention.paged_attention(q2, kp2, vp2, tables2, lens2)
    torch.cuda.synchronize()
    return bitwise_equal(want[0], got[0])


def paged_row(dev, gen, bw, peak, flush, name, b, t, h, hkv, d, lens, max_blocks):
    """The paged kernel against its plain version at one shape (T query
    rows per batch row): bf16 inputs against the plain version on the same
    inputs and on their f32 copies, f32 inputs against the f32 plain
    version, per live batch row; exact zeros at context 0.  At
    PAGED_BITWISE shapes, bitwise repeat and row-0 independence.  A shape
    past the kernel's query rows goes where ``paged_route`` sends it, its
    context lengths on the CPU."""
    import math

    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops import attention

    bs = PAGED_BS
    q, kp, vp, tables, lens_t = paged_inputs(dev, gen, b, t, h, hkv, d, lens, max_blocks,
                                             seed=len(lens))
    live = lens_t > 0
    route = attention.paged_route(b, t, h // hkv)
    lens_in = lens_t if route == "kernel" else lens_t.cpu()

    got = attention.paged_attention(q, kp, vp, tables, lens_in)
    plain = attention.paged_attention_reference(q, kp, vp, tables, lens_t)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    f32 = attention.paged_attention_reference(qf, kf, vf, tables, lens_t)
    got_f32in = attention.paged_attention(qf, kf, vf, tables, lens_in)
    torch.cuda.synchronize()
    # a paged row is one batch row: its queries, heads and head dims together
    err, rel = row_errs(got.flatten(1), plain.flatten(1), live)
    err32, rel32 = row_errs(got.flatten(1), f32.flatten(1), live)
    err_f32in, rel_f32in = row_errs(got_f32in.flatten(1), f32.flatten(1), live)
    del kf, vf
    check(rel <= ROW_TOL, f"paged {name}: row error {rel} of the row's scale")
    check(rel32 <= ROW_TOL, f"paged {name}: f32 row error {rel32}")
    check(rel_f32in <= ROW_TOL_F32,
          f"paged {name}: f32-input row error {rel_f32in}")
    check(bool((got[~live] == 0).all()) and bool((got_f32in[~live] == 0).all()),
          f"paged {name}: context-0 rows not zero")
    bitwise = None
    if name in PAGED_BITWISE:
        again = attention.paged_attention(q, kp, vp, tables, lens_t)
        torch.cuda.synchronize()
        bitwise = dict(repeat=bitwise_equal(got, again),
                       row0_alone=paged_row_alone(dev, gen, q, kp, vp, tables, lens_t))
        check(bitwise["repeat"], f"paged {name}: two calls on the same inputs differ")
        check(bitwise["row0_alone"],
              f"paged {name}: row 0 changed when only the other rows did")
    # library yardstick: SDPA over K/V already gathered from the pool and
    # padded to [B, H, Lmax, D], with each query's mask; the gather is
    # timed on its own
    nbk = kp.shape[0]
    lmax = max(lens)
    idx = tables[:, :math.ceil(lmax / bs)].long().clamp(max=nbk - 1)

    def gather():
        k = kp[idx].reshape(b, -1, hkv, d)[:, :lmax]
        v = vp[idx].reshape(b, -1, hkv, d)[:, :lmax]
        return (k.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous(),
                v.repeat_interleave(h // hkv, dim=2).transpose(1, 2).contiguous())

    kt, vt = gather()
    qt = q.transpose(1, 2).contiguous()
    qpos = lens_t[:, None] - t + torch.arange(t, device=dev)[None, :]
    mask = (torch.arange(lmax, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = (lib.transpose(1, 2).float() - f32)[live].abs().max().item()
    # what the function must move: the live positions' K and V rows, q and
    # out, the lengths and the live table entries; each query row attends
    # the positions up to its own
    nbytes = (sum(lens) * hkv * d * 2 * 2 + 2 * q.numel() * 2 + 4 * b
              + 4 * sum(math.ceil(n / bs) for n in lens))
    ops = 4.0 * h * d * sum(n - t + i + 1 for n in lens if n for i in range(t))
    gather_ms, _ = timed_ms(gather, flush)
    return dict(
        kernel="paged_attention", route=route,
        shape=dict(name=name, B=b, T=t, H=h, Hkv=hkv, D=d, lens=list(lens), bs=bs,
                   max_blocks=max_blocks),
        max_abs_err=err, max_row_err=rel, max_abs_err_vs_f32=err32,
        max_row_err_vs_f32=rel32, max_abs_err_f32_inputs=err_f32in,
        max_row_err_f32_inputs=rel_f32in, library_err_vs_f32=lib_err, bitwise=bitwise,
        **timings(
            lambda: attention.paged_attention(q, kp, vp, tables, lens_in),
            lambda: attention.paged_attention_reference(q, kp, vp, tables, lens_t),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            flush),
        library_gather_ms=gather_ms,
        bound_ms=max(nbytes / bw, ops / peak) * 1e3,
        bound_by="bytes" if nbytes / bw >= ops / peak else "operations")


def profile_request(run, prompt):
    """One request under torch.profiler: the device's busy share over the
    request and the top operators by device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        # the profiler's own start and stop (seconds, with a graph's
        # nodes to trace) stay outside the request's wall time
        t0 = time.perf_counter()
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

    desc = ("appsrc name=src ! tensor_filter name=llm framework=llm model=llama2_7b "
            "custom=quant:int4,param_dtype:bfloat16,max_seq:1024,"
            f"max_new:{MAX_NEW},stream_chunk:64 ! tensor_sink name=out")
    t0 = time.perf_counter()
    pipe = ntt.Pipeline(desc)
    setup_s = time.perf_counter() - t0
    prompts = _serve_prompts()
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
            tokens=[int(b.tensors[0][0]) for b in outs[:8]],
            ids=[int(b.tensors[0][0]) for b in outs])

    with pipe:
        warm = run(prompts[0])  # first-call set-up and the decode capture
        census = pipe.element("llm").fw.census
        warm_captures = census.captures
        attention.LAUNCHES.reset()
        i4.LAUNCHES.reset()
        for prompt in prompts:
            requests.append(run(prompt))
        launches = {"flash_attention": attention.LAUNCHES.value,
                    "matmul_int4": i4.LAUNCHES.value}
        prof = profile_request(run, prompts[1]) if profile else None
        census_line = census_of(census, warm_captures)
        pipe.eos("src")
        pipe.wait(timeout=120)
    for r in requests:
        bucket = min(_next_bucket(r["prompt_len"]), 1023)
        want_int4 = 129 * (MAX_NEW - 1) + (129 if bucket <= 32 else 0)
        check(r["flash_launches"] == N_LAYERS,
              f"flash launches {r['flash_launches']} != {N_LAYERS} per request")
        check(r["int4_launches"] == want_int4,
              f"int4 launches {r['int4_launches']} != {want_int4}")
        r["prefill_rows"] = bucket
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    check(census_line["signatures"] == ["('static', 1, 'bfloat16', False)"],
          f"static census: {census_line}")
    return dict(setup_s=setup_s, warmup=warm, requests=requests,
                launches=launches, profile=prof, census=census_line,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def census_of(census, warm_captures):
    """A filter's census after its warm-up: no capture may follow it."""
    line = dict(signatures=sorted(str(s) for s in census.signatures),
                captures=census.captures,
                captures_after_warmup=census.captures - warm_captures,
                replays=census.replays)
    check(line["captures_after_warmup"] == 0,
          f"{line['captures_after_warmup']} captures after the warm-up")
    return line


def replay_stream(fw, loop, prompt, ids, dev):
    """Hold a greedy stream the loop served against ``llama.forward_paged``
    driven step by step outside the loop, on the card, at the loop's
    shapes: the prompt in chunks of ``prefill_chunk`` on one row, then
    decode steps over every slot with the stream in row 0 and the other
    rows parked, teacher-forced on the stream's own tokens.  Every token
    must be the argmax of its step's logits, or within a near tie of it.
    Returns the counts: tokens compared, equal to the argmax, near ties,
    the least top-1/top-2 gap and the largest |logit|."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg, params, C, bs, B = fw.cfg, fw.bundle.params, fw.prefill_chunk, \
        fw.block_size, fw.slots
    T = len(prompt)
    P = -(-T // C) * C
    n_blocks = -(-(P + len(ids)) // bs)
    pool = llama.init_paged_cache(cfg, n_blocks, bs, dtype=fw.dtype, device=dev)
    tables = torch.full((B, loop.max_blocks), n_blocks, dtype=torch.int32)
    tables[0, :n_blocks] = torch.arange(n_blocks, dtype=torch.int32)
    tables = tables.to(dev)
    toks = np.zeros((1, P), np.int32)
    toks[0, :T] = prompt
    rows = []
    with torch.inference_mode():
        for p in range(0, P, C):
            logits, pool = llama.forward_paged(
                params, torch.from_numpy(toks[:, p:p + C]).to(dev), pool,
                tables[:1], np.asarray([p], np.int64), cfg, fw.dtype,
                logit_off=T - 1 - p if p + C >= P else 0)
        rows.append(logits[0, -1].float().cpu())
        pos = np.full((B,), loop.park, np.int64)
        for i, t in enumerate(ids[:-1]):
            pos[0] = T + i
            x = torch.zeros((B, 1), dtype=torch.int32)
            x[0, 0] = t
            logits, pool = llama.forward_paged(
                params, x.to(dev), pool, tables, torch.from_numpy(pos).to(dev),
                cfg, fw.dtype)
            rows.append(logits[0, -1].float().cpu())
    near, least, equal, scale = 0, float("inf"), 0, 0.0
    for i, (row, g) in enumerate(zip(rows, ids)):
        top2 = row.topk(2).values
        gap = (top2[0] - top2[1]).item()
        least = min(least, gap)
        scale = max(scale, row.abs().max().item())
        equal += int(g == int(row.argmax()))
        tie = CONT_TIE * row.abs().max().item()
        if gap < tie:
            near += 1
            check(row[g].item() >= top2[0].item() - 2 * tie,
                  f"continuous token {i}: {g} is not one of the near-tied ones")
        else:
            check(g == int(row.argmax()),
                  f"continuous token {i}: {g}, forward_paged chooses "
                  f"{int(row.argmax())}")
    return dict(tokens_compared=len(ids), equal_to_argmax=equal,
                near_ties=near, least_top2_gap=least, max_abs_logit=scale)


def graph_vs_eager(fw, loop, dev, flush):
    """The loop's decode step (``paged_decode_step``) at the 7B 8-slot
    shape, captured by a census of its own, against the same step called
    eagerly: each side has its own copies of the same tokens, positions,
    tables, live mask, pool (random, from one seed) and per-slot
    generators.  As in the loop, each generator is seeded, draws once
    eagerly (a stream's first token) and then feeds the steps:
    ``GRAPH_STEPS`` replays against as many eager calls, and after each
    one the two sides must agree bitwise in the tokens, the positions and
    every pool block (so a generator that did not advance between
    replays would show).  Greedy, then sampled.  Then each side is timed
    (``timed_ms``: device ms and host ms per step).  Launches here are
    held back from the counters."""
    import torch

    from nnstreamer_tpu_torch.filters.llm import paged_decode_step
    from nnstreamer_tpu_torch.models import llama
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.pipeline.graphs import Census

    cfg, params, B, bs = fw.cfg, fw.bundle.params, fw.slots, fw.block_size
    shape = (cfg.n_layers, loop.n_blocks + 1, bs, cfg.n_kv_heads, cfg.head_dim)
    perm = torch.randperm(loop.n_blocks, generator=torch.Generator().manual_seed(13))
    tables = torch.full((B, loop.max_blocks), loop.sentinel, dtype=torch.int32)
    pos = torch.full((B,), loop.park, dtype=torch.long)
    used = 0
    for s, p in enumerate(GRAPH_POS):
        if p is not None:
            need = -(-(p + GRAPH_SPARE) // bs)
            tables[s, :need] = perm[used:used + need].to(torch.int32)
            used += need
            pos[s] = p
    live = torch.tensor([p is not None for p in GRAPH_POS])
    tok = torch.randint(3, cfg.vocab, (B,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(14))

    def side():
        return dict(pool={k: torch.empty(shape, dtype=torch.bfloat16, device=dev)
                          for k in ("k", "v")},
                    tok=tok.to(dev, copy=True), pos=pos.to(dev, copy=True),
                    tables=tables.to(dev, copy=True), live=live.to(dev, copy=True),
                    gens=[torch.Generator(device=dev) for _ in range(B)])

    first_logits = torch.randn((1, cfg.vocab), generator=torch.Generator().manual_seed(16))

    def reset(st, temperature, top_k):
        for i, k in enumerate(("k", "v")):
            st["pool"][k].normal_(generator=torch.Generator(device=dev).manual_seed(15 + i))
        st["tok"].copy_(tok)
        st["pos"].copy_(pos)
        for i, g in enumerate(st["gens"]):
            g.manual_seed(100 + i)
            llama.sample_token_per_slot(first_logits.to(dev), [g], temperature, top_k)

    out = {}
    with torch.inference_mode(), kernels.held_launches():
        for name, temperature, top_k in GRAPH_SAMPLERS:
            graph_side, eager_side = side(), side()
            steps = [paged_decode_step(params, cfg, fw.dtype, st["pool"], st["tok"],
                                       st["pos"], st["tables"], st["live"], st["gens"],
                                       temperature, top_k)
                     for st in (graph_side, eager_side)]
            census = Census(dev)
            replay = census.capture(name, steps[0], generators=graph_side["gens"]).replay
            reset(graph_side, temperature, top_k)
            reset(eager_side, temperature, top_k)
            r = dict(steps=GRAPH_STEPS, tokens=[])
            for i in range(GRAPH_STEPS):
                replay()
                steps[1]()
                equal = dict(
                    tokens_equal=torch.equal(graph_side["tok"], eager_side["tok"]),
                    positions_equal=torch.equal(graph_side["pos"], eager_side["pos"]),
                    pool_equal=all(torch.equal(graph_side["pool"][k], eager_side["pool"][k])
                                   for k in ("k", "v")))
                check(all(equal.values()), f"graph against eager, {name}, step {i}: {equal}")
                r["tokens"].append(graph_side["tok"].tolist())
            r.update(equal)
            # a stream's tokens move from step to step: the draws (and the
            # greedy choices) follow the state the previous step left
            check(len({tuple(t) for t in r["tokens"]}) > 1,
                  f"graph against eager, {name}: the same tokens at every step")
            r["graph_ms"], r["graph_host_ms"] = timed_ms(replay, flush)
            r["eager_ms"], r["eager_host_ms"] = timed_ms(steps[1], flush)
            out[name] = r
            del graph_side, eager_side, steps, replay, census
            torch.cuda.empty_cache()
    return out


def phase_continuous(dev, profile=False):
    """The continuous serving path at llama2_7b int4, with late joiners."""
    import contextlib
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    t0 = time.perf_counter()
    pipe = ntt.Pipeline(CONT_DESC)
    setup_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(2)
    lens = [n for wave in CONT_WAVES for n in wave]
    prompts = [torch.randint(3, 32000, (n,), generator=gen).to(torch.int32).numpy()
               for n in lens]
    n_streams = len(prompts)
    got = {i: [] for i in range(n_streams)}
    arrived = {i: [] for i in range(n_streams)}
    pushed = {}

    def push(i):
        pushed[i] = time.perf_counter()
        pipe.push("src", ntt.Buffer([prompts[i]], meta={"req": i}))

    def pull_one():
        buf = pipe.pull("out", timeout=600)
        r = buf.meta["req"]
        got[r].append(buf)
        arrived[r].append(time.perf_counter())

    traced = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
              if profile else contextlib.nullcontext())
    with pipe:
        fw = pipe.element("llm").fw
        t0 = time.perf_counter()
        loop = fw.serve_loop()
        warmup_s = time.perf_counter() - t0
        warm_captures = fw.census.captures
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        first = len(CONT_WAVES[0])
        with traced as prof:
            t_start = time.perf_counter()
            for i in range(first):
                push(i)
            while any(not got[i] for i in range(first)):
                pull_one()
            for i in range(first, n_streams):
                push(i)
            while sum(len(v) for v in got.values()) < n_streams * MAX_NEW:
                pull_one()
            t_end = time.perf_counter()
            pipe.eos("src")
            pipe.wait(timeout=120)  # the loop has drained: nothing in flight
            torch.cuda.synchronize()
            t_traced = time.perf_counter()
        launches = {k: c.value for k, c in counters.items()}
        stats = dict(loop.stats)
        census_line = census_of(fw.census, warm_captures)
        free_ok = sorted(loop._free) == list(range(loop.n_blocks))
        tables_ok = bool((loop._tables == loop.sentinel).all())
        parked_ok = bool((loop._pos == loop.park).all())
        n_blocks = loop.n_blocks
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        # outside the counted run: served tokens against forward_paged
        replayed = {}
        for i in CONT_CHECKED:
            check(len(got[i]) == MAX_NEW, f"stream {i}: {len(got[i])} tokens")
            replayed[i] = dict(prompt_len=lens[i], **replay_stream(
                fw, loop, prompts[i], [int(b.tensors[0][0]) for b in got[i]], dev))
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        graph = graph_vs_eager(fw, loop, dev, flush_buf.zero_)
        del flush_buf
    streams = []
    for i in range(n_streams):
        bufs = got[i]
        check(len(bufs) == MAX_NEW, f"stream {i}: {len(bufs)} tokens")
        for j, buf in enumerate(bufs):
            ids = buf.tensors[0]
            check(ids.dtype == np.int32 and ids.shape == (1,)
                  and 0 <= int(ids[0]) < 32000, f"bad token buffer {ids!r}")
            check(buf.meta.get("stream_index") == j,
                  f"stream {i}: stream_index out of order")
            check(bool(buf.meta.get("stream_last")) == (j == MAX_NEW - 1),
                  f"stream {i}: stream_last misplaced")
            check(not buf.meta.get("stream_aborted"), f"stream {i} aborted")
        emit = [b.meta["emit_t"] for b in bufs]
        streams.append(dict(
            prompt_len=lens[i], late_joiner=i >= first,
            ttft_ms=(arrived[i][0] - pushed[i]) * 1e3,
            decode_tok_s=(MAX_NEW - 1) / (emit[-1] - emit[0]),
            tokens=[int(b.tensors[0][0]) for b in bufs[:8]],
            ids=[int(b.tensors[0][0]) for b in bufs]))
    check(free_ok and tables_ok and parked_ok,
          f"pool not free after the drain: free list {free_ok}, tables "
          f"{tables_ok}, positions {parked_ok}")
    steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
    want_chunks = sum(math.ceil(n / 32) for n in lens)
    check(chunks == want_chunks, f"prefill chunks {chunks} != {want_chunks}")
    check(launches["paged_attention"] == N_LAYERS * steps,
          f"paged launches {launches['paged_attention']} != 32 x {steps} steps")
    check(launches["flash_attention"] == N_LAYERS * chunks,
          f"flash launches {launches['flash_attention']} != 32 x {chunks} chunks")
    check(launches["matmul_int4"] == 129 * (steps + chunks),
          f"int4 launches {launches['matmul_int4']} != 129 x {steps + chunks}")
    check(census_line["signatures"] == ["('continuous', 8, 'bfloat16', False)"],
          f"continuous census: {census_line}")
    busy = None
    if profile:
        traced_ms = (t_traced - t_start) * 1e3
        busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                      for e in prof.key_averages()) / 1e3
        busy = dict(traced_ms=traced_ms, device_busy_ms=busy_ms,
                    device_busy_ms_per_step=busy_ms / steps,
                    device_idle_share=1.0 - busy_ms / traced_ms)
    return dict(setup_s=setup_s, warmup_s=warmup_s, streams=streams,
                window_s=t_end - t_start,
                aggregate_tok_s=n_streams * MAX_NEW / (t_end - t_start),
                decode_steps=steps, prefill_chunks=chunks, launches=launches,
                host_us_per_step=stats["decode_host_s"] / steps * 1e6,
                census=census_line, busy=busy, graph_vs_eager=graph,
                n_blocks=n_blocks, peak_mem_gb=peak_gb, replayed=replayed)


def query_server(desc_custom, sid):
    """A query server around the llm filter (named ``llm``)."""
    import nnstreamer_tpu_torch as ntt

    return ntt.Pipeline(
        f"tensor_query_serversrc name=ssrc port=0 id={sid} ! "
        "tensor_filter name=llm framework=llm model=llama2_7b "
        f"custom={desc_custom} invoke-dynamic=true ! "
        f"tensor_query_serversink id={sid}")


class QueryClient:
    """One ``appsrc ! tensor_query_client ! tensor_sink`` pipeline and a
    thread pulling one stream from it.  A callback at the sink stamps
    each buffer's arrival on the host's monotonic clock, the clock the
    serve loop's ``emit_t`` is on."""

    def __init__(self, port):
        import threading

        import nnstreamer_tpu_torch as ntt

        self.pipe = ntt.Pipeline(
            f"appsrc name=src ! tensor_query_client port={port} "
            "timeout=600 ! tensor_sink name=out")
        self.bufs, self.arrived = [], []
        self.first = threading.Event()
        self.thread = None
        self.error = None
        self.pipe.element("out").connect_new_data(
            lambda b: b.meta.__setitem__("_arrive_t", time.monotonic()))

    def start(self):
        self.pipe.start()
        return self

    def push(self, prompt, n):
        import threading

        self.pushed = time.monotonic()
        self.pipe.push("src", prompt)
        self.thread = threading.Thread(target=self._pull, args=(n,),
                                       daemon=True)
        self.thread.start()

    def _pull(self, n):
        try:
            for _ in range(n):
                buf = self.pipe.pull("out", timeout=600)
                self.bufs.append(buf)
                self.arrived.append(buf.meta["_arrive_t"])
                self.first.set()
        except BaseException as e:  # noqa: BLE001 - reported by join()
            self.error = e
            self.first.set()

    def join(self):
        self.thread.join(timeout=900)
        check(self.error is None, f"query client failed: {self.error!r}")
        check(not self.thread.is_alive(), "query client did not finish")
        return self.bufs

    def close(self):
        self.pipe.eos("src")
        self.pipe.wait(timeout=120)
        self.pipe.stop()


def phase_query(dev, serve, cont):
    """The continuous cell over the query wire: the same model, settings,
    prompts and waves as ``phase_continuous``, served by
    ``tensor_query_serversrc ! tensor_filter ! tensor_query_serversink``
    to eight client pipelines over loopback TCP.  Then, un-timed, a client
    that disconnects mid-stream (reaped once, pool free) and one static
    request over the wire (bitwise equal to ``phase_serve``'s)."""
    import math
    import statistics

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    gen = torch.Generator().manual_seed(2)
    lens = [n for wave in CONT_WAVES for n in wave]
    prompts = [torch.randint(3, 32000, (n,), generator=gen).to(torch.int32).numpy()
               for n in lens]
    n_streams, first = len(prompts), len(CONT_WAVES[0])
    t0 = time.perf_counter()
    srv = query_server(QUERY_CUSTOM, 71)
    setup_s = time.perf_counter() - t0
    out = dict(setup_s=setup_s)
    with srv:
        port = srv.element("ssrc").bound_port
        el = srv.element("llm")
        fw = el.fw
        t0 = time.perf_counter()
        loop = fw.serve_loop()
        out["warmup_s"] = time.perf_counter() - t0
        warm_captures = fw.census.captures
        clients = [QueryClient(port).start() for _ in range(n_streams)]
        stats0 = dict(loop.stats)
        for c in counters.values():
            c.reset()
        t_start = time.monotonic()
        for i in range(first):
            clients[i].push(prompts[i], MAX_NEW)
        for i in range(first):
            check(clients[i].first.wait(600), f"query stream {i}: no first token")
        for i in range(first, n_streams):
            clients[i].push(prompts[i], MAX_NEW)
        got = [c.join() for c in clients]
        t_end = max(c.arrived[-1] for c in clients)
        check(fw.drain(120), "serve loop did not drain")
        launches = {k: c.value for k, c in counters.items()}
        stats = {k: loop.stats[k] - stats0[k] for k in stats0}
        census_line = census_of(fw.census, warm_captures)
        pool_ok = dict(free=sorted(loop._free) == list(range(loop.n_blocks)),
                       tables=bool((loop._tables == loop.sentinel).all()),
                       parked=bool((loop._pos == loop.park).all()))
        check(all(pool_ok.values()), f"query: pool not free after the drain: {pool_ok}")
        for c in clients:
            c.close()
        streams, lat = [], []
        for i, bufs in enumerate(got):
            check(len(bufs) == MAX_NEW, f"query stream {i}: {len(bufs)} tokens")
            for j, buf in enumerate(bufs):
                ids = np.asarray(buf.tensors[0])
                check(ids.dtype == np.int32 and ids.shape == (1,)
                      and 0 <= int(ids[0]) < 32000, f"bad token buffer {ids!r}")
                check(buf.meta.get("stream_index") == j,
                      f"query stream {i}: stream_index out of order")
                check(bool(buf.meta.get("stream_last")) == (j == MAX_NEW - 1),
                      f"query stream {i}: stream_last misplaced")
                check(not buf.meta.get("stream_aborted"), f"query stream {i} aborted")
            emit = [b.meta["emit_t"] for b in bufs]
            lat += [a - e for a, e in zip(clients[i].arrived, emit)]
            ids = [int(b.tensors[0][0]) for b in bufs]
            streams.append(dict(
                prompt_len=lens[i], late_joiner=i >= first,
                ttft_ms=(clients[i].arrived[0] - clients[i].pushed) * 1e3,
                decode_tok_s=(MAX_NEW - 1) / (emit[-1] - emit[0]),
                equal_to_in_process=ids == cont["streams"][i]["ids"], ids=ids))
        steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
        want_chunks = sum(math.ceil(n / 32) for n in lens)
        check(chunks == want_chunks, f"query: prefill chunks {chunks} != {want_chunks}")
        check(launches["paged_attention"] == N_LAYERS * steps,
              f"query: paged launches {launches['paged_attention']} != 32 x {steps}")
        check(launches["flash_attention"] == N_LAYERS * chunks,
              f"query: flash launches {launches['flash_attention']} != 32 x {chunks}")
        check(launches["matmul_int4"] == 129 * (steps + chunks),
              f"query: int4 launches {launches['matmul_int4']} != 129 x {steps + chunks}")
        check(census_line["signatures"] == ["('continuous', 8, 'bfloat16', False)"],
              f"query census: {census_line}")
        replayed = {}
        for i in CONT_CHECKED:
            replayed[i] = dict(prompt_len=lens[i], **replay_stream(
                fw, loop, prompts[i], streams[i]["ids"], dev))
        lat.sort()
        out.update(
            streams=streams, window_s=t_end - t_start,
            aggregate_tok_s=n_streams * MAX_NEW / (t_end - t_start),
            wire_ms_p50=statistics.median(lat) * 1e3,
            wire_ms_p99=lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            decode_steps=steps, prefill_chunks=chunks, launches=launches,
            host_us_per_step=stats["decode_host_s"] / steps * 1e6,
            census=census_line, replayed=replayed, pool=pool_ok,
            bitwise_equal_streams=sum(s["equal_to_in_process"] for s in streams))

        # un-timed: a client that stops after one token of a 200-id prompt
        seen = []
        emit_token = el._emit_serve_token

        def spy(src_buf, tensors, meta):
            seen.append(dict(meta))
            emit_token(src_buf, tensors, meta)

        el._emit_serve_token = spy
        base = metrics.snapshot()
        doomed = QueryClient(port).start()
        doomed.push(prompts[1], 1)
        doomed.join()
        dead_sid = doomed.bufs[0].meta["stream_id"]
        doomed.pipe.stop()
        survivor = QueryClient(port).start()
        survivor.push(prompts[0], MAX_NEW)
        bufs = survivor.join()
        survivor.close()
        check(fw.drain(120), "serve loop did not drain after the dead client")
        snap = metrics.snapshot()
        el._emit_serve_token = emit_token
        check([b.meta.get("stream_index") for b in bufs] == list(range(MAX_NEW))
              and bufs[-1].meta.get("stream_last")
              and not any(b.meta.get("stream_aborted") for b in bufs),
              "dead client: the survivor's stream is not whole")
        mine = [m for m in seen if m.get("stream_id") == dead_sid]
        emitted = sum(1 for m in mine if not m.get("stream_aborted"))
        reaped = snap.get("llm.serve.reaped", 0.0) - base.get("llm.serve.reaped", 0.0)
        pool_ok = dict(free=sorted(loop._free) == list(range(loop.n_blocks)),
                       tables=bool((loop._tables == loop.sentinel).all()),
                       parked=bool((loop._pos == loop.park).all()))
        out["dead_client"] = dict(
            doomed_emitted=emitted, reaped=reaped,
            reaped_blocks=snap.get("llm.serve.reaped_blocks", 0.0)
            - base.get("llm.serve.reaped_blocks", 0.0),
            terminator=mine[-1].get("abort_reason") if mine else None,
            survivor_equal_to_in_process=[int(b.tensors[0][0]) for b in bufs]
            == cont["streams"][0]["ids"], pool=pool_ok)
        check(reaped == 1, f"dead client: llm.serve.reaped rose by {reaped}, not 1")
        check(emitted < MAX_NEW, f"dead client: the doomed stream emitted {emitted}")
        check(all(pool_ok.values()), f"dead client: pool not free: {pool_ok}")
    del srv, el, fw, loop
    torch.cuda.empty_cache()

    # un-timed: the static path over the wire, phase_serve's options
    srv = query_server(f"quant:int4,param_dtype:bfloat16,max_seq:1024,"
                       f"max_new:{MAX_NEW},stream_chunk:64", 72)
    with srv:
        c = QueryClient(srv.element("ssrc").bound_port).start()
        prompt = next(p for p in _serve_prompts() if len(p) == 32)
        c.push(prompt, MAX_NEW)
        bufs = c.join()
        c.close()
    ids = [int(b.tensors[0][0]) for b in bufs]
    want = next(r["ids"] for r in serve["requests"] if r["prompt_len"] == 32)
    check([b.meta.get("stream_index") for b in bufs] == list(range(MAX_NEW))
          and bufs[-1].meta.get("stream_last"), "static over the wire: stream not whole")
    check(ids == want, "static over the wire: tokens differ from phase_serve's")
    out["static_over_wire"] = dict(tokens=len(ids), equal_to_serve=True)
    del srv
    torch.cuda.empty_cache()
    return out


def _serve_prompts():
    """phase_serve's prompts (the same generator and seed)."""
    import torch

    gen = torch.Generator().manual_seed(1)
    return [torch.randint(3, 32000, (n,), generator=gen).to(torch.int32).numpy()
            for n in PROMPT_LENS]


def params_to(params, dev):
    """A copy of a llama parameter tree (one nested level) on ``dev``."""
    return {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(dev)) for k, v in params.items()}


def phase_reference_paged(dev):
    """llama_small int4 f32 through forward_paged: kernels on the card
    against plain versions on the CPU, same params, non-contiguous tables.
    Row 0 prefills 40 tokens in chunks of 16 (padded to 48), then rows 0
    and 1 decode 5 steps with row 1 parked; then row 1 prefills 16 tokens
    of its own and both rows take one [2, 5] step (the shape of a
    speculative verify step), every position's logits compared."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg = llama.PRESETS["llama_small"]
    cpu = llama.init_params(cfg, seed=5, quant="int4", device="cpu")
    card = params_to(cpu, dev)
    bs, n_blocks, max_blocks, T, C = 16, 16, 8, 40, 16
    tables = torch.full((2, max_blocks), n_blocks, dtype=torch.int32)
    tables[0, :3] = torch.tensor([11, 3, 14])
    sides = [(cpu, llama.init_paged_cache(cfg, n_blocks, bs, "float32", device="cpu"),
              tables, "cpu"),
             (card, llama.init_paged_cache(cfg, n_blocks, bs, "float32", device=dev),
              tables.to(dev), dev)]
    prompt = np.zeros((1, 48), np.int32)
    prompt[0, :T] = torch.randint(3, cfg.vocab, (T,),
                                  generator=torch.Generator().manual_seed(6)).numpy()
    worst = 0.0

    def step(toks, pos, rows, logit_off=None, rows_from=0, all_positions=False):
        nonlocal worst
        outs = []
        for params, pool, tbl, d in sides:
            logits, _ = llama.forward_paged(
                params, torch.from_numpy(toks).to(d), pool, tbl[rows_from:rows_from + rows],
                np.asarray(pos, np.int64), cfg, "float32", logit_off=logit_off)
            outs.append((logits if all_positions else logits[0, -1]).float().cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        worst = max(worst, err)
        check(bool(torch.isfinite(outs[1]).all()), "non-finite paged logits")
        check(err <= REF_TOL * max(1.0, outs[0].abs().max().item()),
              f"paged reference at {pos}: logits differ by {err}")
        return int(outs[0].argmax())

    for p in range(0, 48, C):
        tok = step(prompt[:, p:p + C], [p], 1,
                   logit_off=T - 1 - p if p + C >= 48 else C - 1)
    for i in range(5):
        tok = step(np.asarray([[tok], [tok]], np.int32),
                   [T + i, max_blocks * bs], 2)
    for params, pool, tbl, d in sides:  # row 0 reaches a 4th block
        tbl[0, 3] = 1
        tbl[1, :2] = torch.tensor([6, 9], dtype=torch.int32)
    step(prompt[:, 16:32], [0], 1, rows_from=1)
    verify = np.asarray([[tok, 5, 6, 7, 8], [9, 10, 11, 12, 13]], np.int32)
    step(verify, [T + 5, 16], 2, all_positions=True)
    return dict(model="llama_small int4 f32, paged", prefill_chunks=4,
                decode_steps=5, verify_steps=1, max_abs_logit_err=worst)


def phase_reference(dev):
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg = llama.PRESETS["llama_small"]  # head dim 64, grouped K/V
    cpu = llama.init_params(cfg, seed=3, quant="int4", device="cpu")
    card = params_to(cpu, dev)
    prompt = torch.randint(3, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(4))
    caches = [llama.init_cache(cfg, 1, "float32", device=d) for d in ("cpu", dev)]
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


def phase_reference_bf16(dev):
    """llama_small int4 in bf16 (parameters and compute): the kernels on
    the card against the plain versions on the CPU, same parameters.
    ``forward_cached`` prefills 40 tokens at position 0 (flash) and
    decodes 4 steps; ``forward_paged`` prefills the same prompt in 3 chunks
    of 16 (flash over the gathered blocks).  Each step's logits are held to
    BF16_REF_TOL of its max |logit|, and its greedy token to the CPU's
    wherever the CPU's top-1/top-2 gap is wider than that share."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg = llama.PRESETS["llama_small"]
    cpu = llama.init_params(cfg, seed=3, dtype="bfloat16", quant="int4", device="cpu")
    card = params_to(cpu, dev)
    T, C = 40, 16
    prompt = torch.randint(3, cfg.vocab, (1, T), generator=torch.Generator().manual_seed(4))
    steps = []

    def compare(what, want, got):
        scale = want.abs().max().item()
        err = (want - got).abs().max().item()
        top2 = want.topk(2).values
        gap = (top2[0] - top2[1]).item()
        held = gap > BF16_REF_TOL * scale
        check(bool(torch.isfinite(got).all()), f"bf16 reference {what}: non-finite logits")
        check(err <= BF16_REF_TOL * scale,
              f"bf16 reference {what}: logits differ by {err} > {BF16_REF_TOL} x {scale}")
        check(not held or int(got.argmax()) == int(want.argmax()),
              f"bf16 reference {what}: greedy {int(got.argmax())} on the card, "
              f"{int(want.argmax())} on the CPU (top-2 gap {gap})")
        steps.append(dict(step=what, rel_err=err / scale, top2_gap=gap,
                          greedy_held=held))
        return int(want.argmax())

    caches = [llama.init_cache(cfg, 1, "bfloat16", device=d) for d in ("cpu", dev)]
    tok = None
    for step in range(5):
        pos = 0 if step == 0 else T + step - 1
        x = prompt if step == 0 else torch.tensor([[tok]], dtype=torch.int32)
        want, got = (llama.forward_cached(params, x.to(d), cache, pos, cfg, "bfloat16")
                     [0][0, -1].float().cpu()
                     for params, cache, d in ((cpu, caches[0], "cpu"),
                                              (card, caches[1], dev)))
        tok = compare("cached prefill" if step == 0 else f"cached decode {step}",
                      want, got)
    bs, n_blocks, P = 16, 8, 48
    tables = torch.full((1, 4), n_blocks, dtype=torch.int32)
    tables[0, :3] = torch.tensor([5, 2, 7])
    pools = [llama.init_paged_cache(cfg, n_blocks, bs, "bfloat16", device=d)
             for d in ("cpu", dev)]
    toks = np.zeros((1, P), np.int32)
    toks[0, :T] = prompt.numpy()
    for p in range(0, P, C):
        off = T - 1 - p if p + C >= P else C - 1
        want, got = (llama.forward_paged(
            params, torch.from_numpy(toks[:, p:p + C]).to(d), pool, tables.to(d),
            np.asarray([p], np.int64), cfg, "bfloat16", logit_off=off)[0][0, -1].float().cpu()
            for params, pool, d in ((cpu, pools[0], "cpu"), (card, pools[1], dev)))
        compare(f"paged chunk {p // C}", want, got)
    return dict(model="llama_small int4 bf16, cached and paged", steps=steps,
                max_rel_logit_err=max(s["rel_err"] for s in steps),
                greedy_held=sum(s["greedy_held"] for s in steps))


#: the vision phase: the README quick-start (mobilenet_v1 at 224, 1001
#: classes) and BASELINE config #2 in bench.py's form (ssd_mobilenet at 320,
#: 2,000 anchors, 91 classes), batch 64, bf16, random weights from seed 0
VISION_BATCH = 64
VISION_WARM = 3
VISION_TIMED = 30
#: batches timed after the warm-up where a device source feeds the stage
#: (a batch takes well under 10 ms there, so 30 would time ~10 ms)
VISION_SOURCE_TIMED = 200
NORM = "tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5"
QUICKSTART = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:{batch},"
              "types=uint8 max-inflight=4 ! " + NORM + " ! "
              "tensor_filter framework=jax model={model} custom=size:{size},batch:{batch}"
              "{custom} {acc} ! tensor_decoder mode=image_labeling ! tensor_sink name=out")
QUICKSTART_SRC = ("videotestsrc device=true batch={batch} num-buffers={frames} "
                  "width={size} height={size} name=src ! " + NORM + " ! "
                  "tensor_filter framework=jax model=mobilenet_v1 "
                  "custom=size:{size},batch:{batch} {acc} ! "
                  "tensor_decoder mode=image_labeling ! tensor_sink name=out max-buffers=4")
DETECTION = ("videotestsrc device=true batch={batch} num-buffers={frames} width={size} "
             "height={size} pattern=ball name=src ! " + NORM + " ! "
             "tensor_filter framework=jax model=ssd_mobilenet "
             "custom=size:{size},classes:91,batch:{batch}{custom} {acc} ! "
             "tensor_decoder mode=bounding_boxes option1=ssd option3=0.5 "
             "option4={size}:{size} option6=16 option7={nms} option9=tensors ! "
             "tensor_sink name=out max-buffers=4")
#: bf16 on the card against f32 on the CPU, same weights: a logit may differ
#: by this share of the frame's largest |logit| (bf16 keeps 8 bits, and
#: every one of the 28 convs and its scale and bias rounds to it), and a
#: frame's label is held only where the CPU's top-1/top-2 gap exceeds it
VISION_TOL = 0.02


def vision_stage(pipe, kind="fused"):
    """The fused stage of a pipeline (its census) and the stage names."""
    names = [s.element.name for s in pipe.stages]
    fused = [s.element for s in pipe.stages if s.element.kind == kind]
    check(len(fused) == 1, f"expected one fused stage, got {names}")
    return getattr(fused[0], "fused", fused[0]), names


def stage_card_ms(stage, reps=20):
    """Device ms of one replay of a fused stage's captured step (its one
    signature), by CUDA events around ``reps`` replays queued behind a
    spin kernel; None off the card."""
    import torch

    if stage.device.type != "cuda":
        return None
    (st,) = stage._sets.values()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        st.step.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stage_profile(stage, tag, fh):
    """The fused stage's callable run eagerly three times under
    torch.profiler (card activity): its top kernels by device ms per
    batch, as (name, ms) pairs, and the table into ``fh``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    (st,) = stage._sets.values()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            stage.composed(tuple(st.inputs))
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    fh.write(f"== {tag}\n" + avgs.table(sort_by="self_device_time_total",
                                          row_limit=25) + "\n")
    top = sorted(avgs, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:6]
    return [(e.key[:60], e.self_device_time_total / 3e3) for e in top]


def vision_host_fed(desc, frames, fuse=True):
    """Push every batch of ``frames`` through an appsrc pipeline: the
    first VISION_WARM one at a time (the capture), the rest from a pusher
    thread while this thread pulls.  Returns (outputs, timed stats)."""
    import threading

    import numpy as np

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(desc, fuse=fuse)
    outs, push_ts, e2e = [], {}, []
    with pipe:
        for f in frames[:VISION_WARM]:
            pipe.push("src", f)
            outs.append(pipe.pull("out", timeout=600))
        stage = names = None
        if fuse:
            stage, names = vision_stage(pipe)
            warm_captures = stage.census.captures

        def pusher():
            for i, f in enumerate(frames[VISION_WARM:]):
                push_ts[i] = time.perf_counter()
                pipe.push("src", f)
                push_ts[i] = time.perf_counter()  # admitted (max-inflight)

        t = threading.Thread(target=pusher, daemon=True)
        t0 = time.perf_counter()
        t.start()
        for i in range(len(frames) - VISION_WARM):
            outs.append(pipe.pull("out", timeout=600))
            e2e.append((time.perf_counter() - push_ts[i]) * 1e3)
        wall = time.perf_counter() - t0
        t.join(timeout=60)
        census = card_ms = None
        if fuse:
            census = census_of(stage.census, warm_captures)
            card_ms = stage_card_ms(stage)
        pipe.eos("src")
        pipe.wait(timeout=120)
    n = len(frames) - VISION_WARM
    lat = np.sort(np.asarray(e2e))
    stats = dict(frames_per_s=n * frames[0].shape[0] / wall,
                 p50_ms=float(np.percentile(lat, 50)),
                 p99_ms=float(np.percentile(lat, 99)), stages=names,
                 census=census, card_ms_per_batch=card_ms, stage=stage)
    return [(np.asarray(o.meta["label_index"]), np.asarray(o.meta["score"]))
            for o in outs], stats


def vision_pulled(desc, n, keep, batch):
    """Pull ``n`` buffers of ``batch`` frames from a pipeline with a device
    source; the rate over the last n - VISION_WARM pulls (the sink's queue
    is 4 deep, so the source is at most ~10 batches ahead when the clock
    starts).  Keeps the first ``keep`` buffers."""
    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(desc)
    outs = []
    with pipe:
        for _ in range(VISION_WARM):
            outs.append(pipe.pull("out", timeout=600))
        stage, names = vision_stage(pipe)
        warm_captures = stage.census.captures
        t0 = time.perf_counter()
        for _ in range(n - VISION_WARM):
            buf = pipe.pull("out", timeout=600)
            if len(outs) < keep:
                outs.append(buf)
        wall = time.perf_counter() - t0
        frames = (n - VISION_WARM) * batch
        census = census_of(stage.census, warm_captures)
        card_ms = stage_card_ms(stage)
        pipe.wait(timeout=120)
    return outs, dict(frames_per_s=frames / wall, stages=names, census=census,
                      card_ms_per_batch=card_ms, stage=stage)


def phase_vision(dev, size=224, det_size=320, batch=VISION_BATCH, acc="",
                 profile=False):
    """The vision path's five checks on ``dev`` (``acc`` is the filter's
    accelerator= property; empty on the card).  ``profile`` writes each
    fused stage's kernels to chiprun_out/profile_vision.txt."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.models import mobilenet, zoo

    on_card = dev.type == "cuda"
    out = {}
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
              for _ in range(VISION_WARM + VISION_TIMED)]
    qs = dict(size=size, batch=batch, model="mobilenet_v1", custom="", acc=acc)
    # 1. the quick-start, host-fed, fused
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    fused, out["quickstart"] = vision_host_fed(QUICKSTART.format(**qs), frames)
    if on_card:
        out["quickstart"]["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    check(len(out["quickstart"]["stages"]) == 3
          and out["quickstart"]["stages"][1].count("+") == 2,
          f"quick-start not fused into one stage: {out['quickstart']['stages']}")
    for ids, scores in fused:
        check(ids.shape == (batch,) and bool(np.isfinite(scores).all()),
              "quick-start: bad labels or scores")
    # 2. the same frames unfused on the same device: bitwise the same (one
    # program on the same inputs; the unfused transform runs on the host
    # in float32 with the same two IEEE operations)
    unfused, st = vision_host_fed(QUICKSTART.format(**qs), frames, fuse=False)
    out["unfused_frames_per_s"] = st["frames_per_s"]
    out["unfused_bitwise_equal"] = sum(
        bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
        for a, b in zip(fused, unfused))
    check(out["unfused_bitwise_equal"] == len(frames),
          f"fuse=False differs from fused in "
          f"{len(frames) - out['unfused_bitwise_equal']} batches")

    # 3. the first batch through the port on the CPU at f32, with the
    # weights the card drew (the zoo draws them on the build device)
    def card_weights(opts, device):
        params = mobilenet.init_params(seed=0, device=dev)
        params = {k: {n: t.cpu() for n, t in v.items()} for k, v in params.items()}
        return mobilenet.build_bundle(params, opts, "mobilenet_v1_card_weights")

    zoo.register_model("mobilenet_v1_card_weights", card_weights)
    ref = ntt.Pipeline(
        "appsrc name=src ! " + NORM + " ! tensor_filter framework=jax "
        f"model=mobilenet_v1_card_weights custom=size:{size},batch:{batch},"
        "dtype:float32 accelerator=true:cpu ! tensor_sink name=out")
    with ref:
        ref.push("src", frames[0])
        logits = np.asarray(ref.pull("out", timeout=600).tensors[0])
        ref.eos("src")
        ref.wait(timeout=60)
    top = np.sort(logits, axis=1)
    tol = VISION_TOL * np.abs(logits).max(axis=1)
    gap = top[:, -1] - top[:, -2]
    ids, scores = fused[0]
    held = gap > tol
    score_err = np.abs(scores - top[:, -1])
    out["cpu_reference"] = dict(
        frames_held=int(held.sum()), labels_equal=int((ids == logits.argmax(1))[held].sum()),
        max_score_err_share=float((score_err / np.abs(logits).max(axis=1)).max()),
        tol_share=VISION_TOL)
    check(bool((ids == logits.argmax(1))[held].all()),
          f"labels differ from the CPU's where the gap exceeds the tolerance: "
          f"{out['cpu_reference']}")
    check(bool((score_err <= tol).all()), f"scores off the CPU's: {out['cpu_reference']}")

    # 4. the quick-start with a folded device source
    n_src = VISION_WARM + VISION_SOURCE_TIMED
    _, out["quickstart_device_source"] = vision_pulled(QUICKSTART_SRC.format(
        size=size, batch=batch, frames=n_src * batch, acc=acc), n_src, 0, batch)
    names = out["quickstart_device_source"]["stages"]
    check(len(names) == 2 and names[0].startswith("src+"),
          f"device source not folded: {names}")
    # a truncated tail batch (two full batches and 10 frames), every
    # buffer processed before the first pull: a second signature, and
    # each pulled buffer still holds its own values
    rest = max(1, batch // 6)  # 10 of 64
    tail = QUICKSTART_SRC.format(size=size, batch=batch, frames=2 * batch + rest,
                                 acc=acc).replace(" max-buffers=4", "")
    late = []
    for fuse in (True, False):
        pipe = ntt.Pipeline(tail, fuse=fuse)
        with pipe:
            pipe.wait(timeout=300)
            late.append([(np.atleast_1d(b.meta["label_index"]),
                          np.atleast_1d(b.meta["score"]))
                         for b in (pipe.pull("out", timeout=60) for _ in range(3))])
        if fuse:
            stage, _ = vision_stage(pipe)
    out["tail_batch"] = dict(
        rows=[len(ids) for ids, _ in late[0]], signatures=len(stage.census.signatures),
        captures=stage.census.captures, bitwise_equal_to_unfused=sum(
            bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
            for a, b in zip(*late)))
    check(out["tail_batch"]["rows"] == [batch, batch, rest]
          and out["tail_batch"]["signatures"] == 2
          and out["tail_batch"]["bitwise_equal_to_unfused"] == 3,
          f"tail batch: {out['tail_batch']}")

    # 5. detection, NMS on the card against NMS on the host, same frames
    det = {}
    n_cmp = VISION_WARM + VISION_TIMED  # batches compared, device against host
    for nms in ("device", "host"):
        bufs, det[nms] = vision_pulled(DETECTION.format(
            size=det_size, batch=batch, frames=n_src * batch, custom="", acc=acc,
            nms=nms), n_src, n_cmp, batch)
        det[nms]["outputs"] = [[np.asarray(t) for t in b.tensors] for b in bufs]
    same, valid = 0, 0
    for a, b in zip(det["device"].pop("outputs"), det["host"].pop("outputs")):
        va, vb = a[3].astype(bool), b[3].astype(bool)
        valid += int(va.sum())
        same += int(np.array_equal(va, vb) and np.array_equal(a[0][va], b[0][vb])
                    and np.array_equal(a[1][va], b[1][vb])
                    and np.array_equal(a[2][va], b[2][vb]))
    det["valid_rows"] = valid
    det["batches_equal"] = same
    det["batches_compared"] = n_cmp
    out["detection"] = det
    check(same == n_cmp, f"device NMS differs from host NMS in {n_cmp - same} batches")
    check(valid > 0, "detection: no valid row in the batches compared")
    # NMS at work: at option3=0.0 every top-k candidate is live, so a
    # frame's kept scores differ from its top option6 candidates' exactly
    # where NMS suppressed one.  Device and host NMS, and host NMS with
    # option5=1.0 (no IoU exceeds 1: nothing suppressed), on the same frames
    n_low = VISION_WARM + 2
    low = {}
    for tag, nms, iou in (("device", "device", ""), ("host", "host", ""),
                          ("none suppressed", "host", " option5=1.0")):
        bufs, _ = vision_pulled(DETECTION.format(
            size=det_size, batch=batch, frames=n_low * batch, custom="", acc=acc,
            nms=nms).replace("option3=0.5", "option3=0.0" + iou), n_low, n_low, batch)
        low[tag] = [[np.asarray(t) for t in b.tensors] for b in bufs]
    same, valid, suppressed = 0, 0, 0
    for a, b, c in zip(low["device"], low["host"], low["none suppressed"]):
        va, vb, vc = (x[3].astype(bool) for x in (a, b, c))
        valid += int(va.sum())
        same += int(np.array_equal(va, vb) and np.array_equal(a[0][va], b[0][vb])
                    and np.array_equal(a[1][va], b[1][vb])
                    and np.array_equal(a[2][va], b[2][vb]))
        suppressed += sum(not np.array_equal(b[1][i][vb[i]], c[1][i][vc[i]])
                          for i in range(len(vb)))
    det["low_threshold"] = dict(batches_equal=same, batches_compared=n_low,
                                valid_rows=valid, frames=n_low * batch,
                                frames_with_suppression=suppressed)
    check(same == n_low and valid > 0 and suppressed > 0,
          f"detection at option3=0.0: {det['low_threshold']}")

    stages = {"quick-start": out["quickstart"], "device source":
              out["quickstart_device_source"], "detection option7=device":
              det["device"], "detection option7=host": det["host"]}
    for r in stages.values():
        stage = r.pop("stage")
        if r["card_ms_per_batch"] is not None:
            r["card_busy_share"] = (r["card_ms_per_batch"] * r["frames_per_s"]
                                    / batch / 1e3)
        r["_stage"] = stage
    if profile and on_card:
        with open(os.path.join(OUT_DIR, "profile_vision.txt"), "w") as fh:
            for tag, r in stages.items():
                r["top_kernels_ms"] = stage_profile(r["_stage"], tag, fh)
    for r in stages.values():
        del r["_stage"]
    return out


def card_share(r):
    if r["card_ms_per_batch"] is None:
        return "card time not measured"
    return (f"card {r['card_ms_per_batch']:.3f} ms per batch, busy share "
            f"{r['card_busy_share']:.3f}")


def print_vision(v):
    qs = v["quickstart"]
    print(f"vision: quick-start (mobilenet_v1 224, batch {VISION_BATCH}, host-fed, "
          f"max-inflight 4) {qs['frames_per_s']:.1f} frames/s, per batch p50 "
          f"{qs['p50_ms']:.2f} ms, p99 {qs['p99_ms']:.2f} ms, {card_share(qs)}, peak "
          f"{qs.get('peak_mem_gb', 0.0):.2f} GB; stages {qs['stages']}", flush=True)
    print(f"census: vision quick-start {qs['census']}", flush=True)
    print(f"vision: fuse=False {v['unfused_frames_per_s']:.1f} frames/s, "
          f"{v['unfused_bitwise_equal']} of {VISION_WARM + VISION_TIMED} batches "
          f"bitwise equal to fused", flush=True)
    print(f"vision: bf16 card against f32 CPU, first batch {v['cpu_reference']}",
          flush=True)
    src = v["quickstart_device_source"]
    print(f"vision: quick-start from videotestsrc device=true "
          f"{src['frames_per_s']:.1f} frames/s, {card_share(src)}; stages "
          f"{src['stages']}", flush=True)
    print(f"census: vision device source {src['census']}", flush=True)
    print(f"vision: tail batch, all processed before the first pull "
          f"{v['tail_batch']}", flush=True)
    det = v["detection"]
    for nms in ("device", "host"):
        print(f"vision: detection (ssd_mobilenet 320, 91 classes, batch "
              f"{VISION_BATCH}, option7={nms}) {det[nms]['frames_per_s']:.1f} "
              f"frames/s, {card_share(det[nms])}; stages {det[nms]['stages']}",
              flush=True)
        print(f"census: vision detection option7={nms} {det[nms]['census']}",
              flush=True)
    print(f"vision: detection option7=device against host: {det['batches_equal']} "
          f"of {det['batches_compared']} batches equal, {det['valid_rows']} valid "
          f"rows", flush=True)
    print(f"vision: detection at option3=0.0, device against host NMS "
          f"{det['low_threshold']}", flush=True)
    for tag, r in (("quick-start", qs), ("device source", src),
                   ("detection device NMS", det["device"]),
                   ("detection host NMS", det["host"])):
        if "top_kernels_ms" in r:
            print(f"profile: vision {tag} top kernels, ms per batch "
                  f"{r['top_kernels_ms']}", flush=True)


#: the models phase: bench.py's cells for the rest of BASELINE's model
#: families, batch 64, random weights from seed 0: yolov5s detection (640,
#: 91 classes, 25,200 predictions), posenet (224, 17 keypoints), deeplab
#: segmentation (224, 21 classes; the planner's native-stride map, and the
#: full resolution pinned by upsample:1), speech_commands and wav2vec2 +
#: CTC (1 s windows of 16,000 samples, float32 as bench.py runs them)
MODELS_BATCH = 64
MODELS_TIMED = 50
#: batches compared: fused against fuse=False, and in the cells' own checks
MODELS_CMP = 3
DIV = "tensor_transform mode=arithmetic option=typecast:float32,div:255.0"
_VSRC = ("videotestsrc device=true batch={batch} num-buffers={frames} width={size} "
         "height={size} pattern={pattern} name=src ! " + DIV + " ! ")
_ASRC = ("audiotestsrc device=true batch={batch} num-buffers={frames} "
         "samplesperbuffer={samples} rate=16000 name=src ! ")
_SINK = " ! tensor_sink name=out max-buffers=4"
MODEL_CELLS = {
    "yolov5s": _VSRC + "tensor_filter framework=jax model={model} custom=size:{size},"
    "classes:91,batch:{batch}{custom} {acc} ! tensor_decoder mode=bounding_boxes "
    "option1=yolov5 option3=0.5 option4={size}:{size} option6=16 option7=device "
    "option9=tensors" + _SINK,
    "posenet": _VSRC + "tensor_filter framework=jax model={model} custom=size:{size},"
    "batch:{batch}{custom} {acc} ! tensor_decoder mode=pose_estimation "
    "option2={size}:{size} option3=0.3 option4=tensors" + _SINK,
    "deeplab": _VSRC + "tensor_filter framework=jax model={model} custom=size:{size},"
    "batch:{batch}{custom} {acc} name=f ! tensor_decoder mode=image_segment "
    "option1=classmap" + _SINK,
    "speech_commands": _ASRC + "tensor_filter framework=jax model={model} "
    "custom=dtype:float32,batch:{batch}{custom} {acc}" + _SINK,
    "wav2vec2": _ASRC + "tensor_filter framework=jax model={model} "
    "custom=dtype:float32,batch:{batch},samples:{samples}{custom} {acc} ! "
    "tensor_decoder mode=ctc" + _SINK,
}
MODEL_NAMES = ("yolov5s", "posenet", "deeplab", "deeplab_full", "speech_commands",
               "wav2vec2")
AUDIO_CELLS = ("speech_commands", "wav2vec2")
#: the card's bf16 vision cells against the CPU at f32, same weights: a
#: model output may differ by this share of the frame's largest |output|
#: (at least 1; the port's own bf16 on the CPU reads up to 1.5% for deeplab
#: at full width).  The audio cells run float32 on the card too (TF32 off):
#: REF_TOL, the float32 bound of the reference phase.  A decision (a
#: class, a keypoint's cell, a token) must equal the CPU's wherever the
#: CPU's top-1/top-2 gap exceeds twice the frame's largest error
MODELS_TOL = 0.03


def _cut_decoder(desc):
    """A cell's string with its decoder cut: the model's own outputs."""
    import re

    return re.sub(r" ! tensor_decoder [^!]*!", " !", desc)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _register_card_weights(dev):
    """``<model>_card_weights``: the zoo model with the weights its seed
    draws on ``dev`` (the card), built where the pipeline asks (the CPU)."""
    from nnstreamer_tpu_torch.models import audio, posenet, segment, yolo, zoo

    def draw(name, o):
        seed = int(o.get("seed", 0))
        if name == "yolov5s":
            return yolo.init_v5s_params(
                classes=int(o.get("classes", 80)), width=float(o.get("width", 0.5)),
                depth=float(o.get("depth", 0.33)), seed=seed, device=dev)
        if name == "posenet":
            return posenet.init_params(width=float(o.get("width", 1.0)), seed=seed,
                                       device=dev)
        if name == "deeplab_mobilenet":
            return segment.init_params(width=float(o.get("width", 1.0)),
                                       classes=int(o.get("classes", 21)), seed=seed,
                                       device=dev)
        if name == "speech_commands":
            return audio.init_params_kws(classes=int(o.get("classes", 12)),
                                         mels=int(o.get("mels", 64)), seed=seed, device=dev)
        return audio.init_params_w2v(dim=int(o.get("dim", 256)),
                                     n_layers=int(o.get("n_layers", 4)),
                                     n_heads=int(o.get("n_heads", 4)),
                                     vocab=int(o.get("vocab", 32)), seed=seed, device=dev)

    bundles = {"yolov5s": lambda p, o, d, t: yolo.build_bundle_v5s(p, o, d, t),
               "posenet": lambda p, o, d, t: posenet.build_bundle(p, o, t),
               "deeplab_mobilenet": lambda p, o, d, t: segment.build_bundle(p, o, t),
               "speech_commands": lambda p, o, d, t: audio.build_bundle_kws(p, o, d, t),
               "wav2vec2": lambda p, o, d, t: audio.build_bundle_w2v(p, o, t)}
    for name, bundle in bundles.items():
        def build(opts, device, name=name, bundle=bundle):
            return bundle(_tree_to(draw(name, opts), device), opts, device,
                          f"{name}_card_weights")
        zoo.register_model(f"{name}_card_weights", build)


def _pulled(desc, n, fuse=True):
    """The first ``n`` buffers of a pipeline: (host arrays, meta) each."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(desc, fuse=fuse)
    with pipe:
        bufs = [pipe.pull("out", timeout=600) for _ in range(n)]
    return [([np.asarray(t) for t in b.tensors], b.meta) for b in bufs]


def _bitwise(a, b):
    import numpy as np

    return len(a) == len(b) and all(
        len(x[0]) == len(y[0]) and all(np.array_equal(p, q) for p, q in zip(x[0], y[0]))
        for x, y in zip(a, b))


def _decisions(name, x):
    """(decisions, top-1/top-2 gaps) of a model's first raw output: a
    keypoint's cell (posenet), a pixel's class (deeplab), a window's
    keyword (speech_commands), a frame's token (wav2vec2)."""
    import numpy as np

    if name == "posenet":
        x = x.reshape(x.shape[0], -1, x.shape[-1]).swapaxes(1, 2)
    top = np.sort(x, axis=-1)
    return x.argmax(-1), top[..., -1] - top[..., -2]


class ModelCell:
    """One cell's pipeline strings: ``desc(batch, frames)`` on the card,
    ``cpu(batch)`` the same cut before its decoder at f32 on the CPU with
    the card's weights."""

    def __init__(self, name, size, samples, custom, acc):
        self.name = name
        self.model = "deeplab_mobilenet" if name.startswith("deeplab") else name
        self.tmpl = MODEL_CELLS["deeplab" if name.startswith("deeplab") else name]
        self.fmt = dict(size=size, samples=samples, model=self.model, acc=acc,
                        pattern="smpte" if name.startswith("deeplab") else "ball",
                        custom=custom + (",upsample:1" if name == "deeplab_full" else ""))

    def desc(self, batch, frames, **kw):
        return self.tmpl.format(batch=batch, frames=frames, **dict(self.fmt, **kw))

    def cpu(self, batch):
        f32 = "" if self.name in AUDIO_CELLS else ",dtype:float32"
        return _cut_decoder(self.desc(batch, batch, model=f"{self.model}_card_weights",
                                      acc="accelerator=true:cpu",
                                      custom=self.fmt["custom"] + f32))


def model_cell(cell, dev, batch, timed):
    """The cell's fused run (rate, census, card ms, peak memory),
    ``fuse=False`` bitwise on the first batches, and its first frames
    against the CPU at f32.  Returns (stats, the first MODELS_CMP fused
    outputs, yolov5s' first batch of model outputs or None)."""
    import numpy as np
    import torch

    name, on_card = cell.name, dev.type == "cuda"
    n = VISION_WARM + timed
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    bufs, st = vision_pulled(cell.desc(batch, n * batch), n, MODELS_CMP, batch)
    if on_card:
        st["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    check(len(st["stages"]) == 2 and st["stages"][0].startswith("src+"),
          f"{name}: not one fused stage: {st['stages']}")
    check(len(st["stage"].census.signatures) == 1,
          f"{name}: {len(st['stage'].census.signatures)} signatures")
    fused = [([np.asarray(t) for t in b.tensors], b.meta) for b in bufs]
    check(all(np.isfinite(t).all() for ts, _ in fused for t in ts if t.dtype.kind == "f"),
          f"{name}: non-finite output")
    # fuse=False on the same device: bitwise.  yolov5s compares its model
    # outputs (its unfused decode is the host path's NMS over all 25,200
    # predictions, another algorithm than the fused top-k)
    cmp = cell.desc(batch, MODELS_CMP * batch)
    raw = None
    if name == "yolov5s":
        cmp = _cut_decoder(cmp)
        a = _pulled(cmp, MODELS_CMP)
        raw = a[0][0][0]
    else:
        a = fused
    b = _pulled(cmp, MODELS_CMP, fuse=False)
    st["unfused_bitwise_equal"] = sum(_bitwise([x], [y]) for x, y in zip(a, b))
    check(st["unfused_bitwise_equal"] == MODELS_CMP,
          f"{name}: fuse=False differs from fused in "
          f"{MODELS_CMP - st['unfused_bitwise_equal']} of {MODELS_CMP} batches")
    # the first frames on the CPU at f32 with the card's weights: the
    # outputs within the tolerance, the decisions where the CPU's gap
    # exceeds it
    n_ref = 2 if name == "yolov5s" else 4
    tol = REF_TOL if name in AUDIO_CELLS else MODELS_TOL
    card = _pulled(_cut_decoder(cell.desc(n_ref, n_ref)), 1)[0][0]
    cpu = _pulled(cell.cpu(n_ref), 1)[0][0]
    ref = dict(frames=n_ref, tol_share=tol, max_err_share=0.0)
    for c, r in zip(card, cpu):
        check(c.shape == r.shape, f"{name}: card {c.shape} against CPU {r.shape}")
        scale = np.abs(r).reshape(n_ref, -1).max(1).clip(min=1.0)
        err = np.abs(c - r).reshape(n_ref, -1).max(1) / scale
        ref["max_err_share"] = max(ref["max_err_share"], float(err.max()))
    if name != "yolov5s":
        # a decision can flip only where the gap is under twice the frame's
        # largest error of that output
        got, _ = _decisions(name, card[0])
        want, gap = _decisions(name, cpu[0])
        err = np.abs(card[0] - cpu[0]).reshape(n_ref, -1).max(1)
        held = gap > 2 * err.reshape((n_ref,) + (1,) * (gap.ndim - 1))
        ref.update(decisions=int(gap.size), held=int(held.sum()),
                   held_equal=int((got == want)[held].sum()))
        check(ref["held"] > 0 and ref["held_equal"] == ref["held"],
              f"{name}: decisions off the CPU's where the gap exceeds the tolerance: {ref}")
    check(ref["max_err_share"] <= tol, f"{name}: card against the CPU: {ref}")
    st["cpu_reference"] = ref
    return st, fused, raw


def _nms_match(a, b):
    """Two option9=tensors detection outputs: (equal on their valid rows,
    valid rows of a)."""
    import numpy as np

    va, vb = a[3].astype(bool), b[3].astype(bool)
    eq = bool(np.array_equal(va, vb) and np.array_equal(a[0][va], b[0][vb])
              and np.array_equal(a[1][va], b[1][vb]) and np.array_equal(a[2][va], b[2][vb]))
    return eq, int(va.sum())


def yolo_nms_checks(cell, dev, batch, fused, raw):
    """yolov5s' decode: option7=device against option7=host at the cell's
    option3=0.5 and at 0.0 (every top-k candidate live); then NMS at work
    on the card, at the cell's shape: the model's first batch with every
    box's w/h set to 0.1 of the frame (the random weights' own boxes are
    about 0.05 px wide and never overlap), device against host NMS, and
    host NMS at option5=1.0 (nothing suppressed)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.core.types import TensorsSpec
    from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes

    out = {}
    cmp = cell.desc(batch, MODELS_CMP * batch)
    host = _pulled(cmp.replace("option7=device", "option7=host"), MODELS_CMP)
    res = [_nms_match(a[0], b[0]) for a, b in zip(fused, host)]
    out["option3=0.5"] = dict(batches_equal=sum(e for e, _ in res), batches=MODELS_CMP,
                              valid_rows=sum(v for _, v in res))
    low = cmp.replace("option3=0.5", "option3=0.0")
    d = _pulled(low, MODELS_CMP)
    h = _pulled(low.replace("option7=device", "option7=host"), MODELS_CMP)
    res = [_nms_match(a[0], b[0]) for a, b in zip(d, h)]
    out["option3=0.0"] = dict(batches_equal=sum(e for e, _ in res), batches=MODELS_CMP,
                              valid_rows=sum(v for _, v in res))
    pred = raw.copy()
    pred[..., 2:4] = 0.1
    x = torch.from_numpy(pred).to(dev)
    size = cell.fmt["size"]
    outs = {}
    for tag, nms, iou in (("device", "device", "0.5"), ("host", "host", "0.5"),
                          ("none", "host", "1.0")):
        dec = BoundingBoxes(dict(option1="yolov5", option3="0.0", option4=f"{size}:{size}",
                                 option5=iou, option6="16", option7=nms, option9="tensors"))
        fn, _ = dec.device_fn(TensorsSpec.of([pred]))
        arrays = [t.cpu().numpy() for t in fn((x,))]
        outs[tag] = [np.asarray(t) for t in dec.host_post(arrays, Buffer(arrays)).tensors]
    eq, valid = _nms_match(outs["device"], outs["host"])
    vb, vc = outs["host"][3].astype(bool), outs["none"][3].astype(bool)
    out["overlapping_boxes"] = dict(
        equal=eq, valid_rows=valid, frames=len(vb), frames_with_suppression=sum(
            not np.array_equal(outs["host"][1][i][vb[i]], outs["none"][1][i][vc[i]])
            for i in range(len(vb))))
    check(out["option3=0.5"]["batches_equal"] == MODELS_CMP
          and out["option3=0.0"]["batches_equal"] == MODELS_CMP
          and out["option3=0.0"]["valid_rows"] > 0, f"yolov5s device against host NMS: {out}")
    r = out["overlapping_boxes"]
    check(r["equal"] and r["valid_rows"] > 0 and r["frames_with_suppression"] > 0,
          f"yolov5s NMS on overlapping boxes: {r}")
    return out


def phase_models(dev, batch=MODELS_BATCH, yolo_size=640, size=224, samples=16000,
                 custom="", acc="", timed=MODELS_TIMED, profile=False):
    """The models phase on ``dev`` (``acc``: the filters' accelerator=
    property, empty on the card; ``custom``: extra options of the vision
    models, to cut their widths in a CPU rehearsal).  ``profile`` writes
    each fused stage's kernels to chiprun_out/profile_models.txt."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.decoders.ctc import collapse_ctc

    _register_card_weights(dev)
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's peak counters exist from here
    out, stages = {}, {}
    for name in MODEL_NAMES:
        t0 = time.perf_counter()
        cell = ModelCell(name, yolo_size if name == "yolov5s" else size, samples,
                         "" if name in AUDIO_CELLS else custom, acc)
        st, fused, raw = model_cell(cell, dev, batch, timed)
        cmp = cell.desc(batch, MODELS_CMP * batch)
        if name == "yolov5s":
            st["nms"] = yolo_nms_checks(cell, dev, batch, fused, raw)
        elif name.startswith("deeplab"):
            st["reduced_outputs"] = ntt.Pipeline(cmp).residency.reduced_outputs
            st["map_shape"] = list(fused[0][0][0].shape)
            if name == "deeplab":
                # the planner's native map is the argmax of the upsample:0 scores
                scores = _pulled(_cut_decoder(cmp.replace(
                    f"batch:{batch}", f"batch:{batch},upsample:0")), MODELS_CMP)
                st["native_map_equal_to_argmax_of_upsample0"] = sum(
                    bool(np.array_equal(s[0][0].argmax(-1).astype(np.uint8), f[0][0]))
                    for s, f in zip(scores, fused))
                check(st["reduced_outputs"] == ["f"] and st[
                    "native_map_equal_to_argmax_of_upsample0"] == MODELS_CMP,
                    f"deeplab: planner {st['reduced_outputs']}, native map "
                    f"{st['native_map_equal_to_argmax_of_upsample0']} of {MODELS_CMP}")
            else:
                check(st["reduced_outputs"] == [] and st["map_shape"][1] == size,
                      f"deeplab upsample:1: {st['reduced_outputs']} {st['map_shape']}")
        elif name == "wav2vec2":
            logits = _pulled(_cut_decoder(cmp), MODELS_CMP)
            st["frames_per_window"] = int(logits[0][0][0].shape[1])
            st["ctc_equal_to_host_argmax"] = sum(
                [list(t) for t in meta["tokens"]] ==
                [list(t) for t in collapse_ctc(lg[0].argmax(-1).astype(np.int32), 0)]
                for (lg, _), (_, meta) in zip(logits, fused))
            check(st["ctc_equal_to_host_argmax"] == MODELS_CMP,
                  f"wav2vec2: CTC ids off the host argmax in "
                  f"{MODELS_CMP - st['ctc_equal_to_host_argmax']} batches")
        if st["card_ms_per_batch"] is not None:
            st["card_busy_share"] = (st["card_ms_per_batch"] * st["frames_per_s"]
                                     / batch / 1e3)
        st["cell_s"] = time.perf_counter() - t0
        stages[name] = st.pop("stage")
        out[name] = st
    if profile and dev.type == "cuda":
        with open(os.path.join(OUT_DIR, "profile_models.txt"), "w") as fh:
            for name, stage in stages.items():
                out[name]["top_kernels_ms"] = stage_profile(stage, name, fh)
    return out


def print_models(m):
    for name, r in m.items():
        unit = "windows/s" if name in AUDIO_CELLS else "frames/s"
        print(f"models: {name} (batch {MODELS_BATCH}) {r['frames_per_s']:.1f} {unit}, "
              f"{card_share(r)}, peak {r.get('peak_mem_gb', 0.0):.2f} GB, "
              f"{r['cell_s']:.1f} s; stages {r['stages']}", flush=True)
        print(f"census: models {name} {r['census']}", flush=True)
        print(f"models: {name} fuse=False {r['unfused_bitwise_equal']} of {MODELS_CMP} "
              f"batches bitwise equal; card against f32 CPU {r['cpu_reference']}",
              flush=True)
        for key in ("nms", "reduced_outputs", "map_shape",
                    "native_map_equal_to_argmax_of_upsample0", "frames_per_window",
                    "ctc_equal_to_host_argmax"):
            if key in r:
                print(f"models: {name} {key} {r[key]}", flush=True)
        if "top_kernels_ms" in r:
            print(f"profile: models {name} top kernels, ms per batch "
                  f"{r['top_kernels_ms']}", flush=True)


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
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  rates=dict(bytes_per_s=bw, bf16_flops=peak))

    def save():
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
            json.dump(detail, fh, indent=1)

    t0 = time.perf_counter()
    detail["build_s"] = kernels.build()
    print(f"build: {detail['build_s']:.1f} s ({time.perf_counter() - t0:.1f} s wall)",
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as fh:
        for name in kernels.SOURCES:
            fh.write(f"== {name}\n{kernels.build_report(name)}\n")
    evidence = detail["build_evidence"] = phase_build_evidence()
    print(f"build: flash SASS {evidence['sass']}, bf16 kernels (D = 128, 64, 32) "
          f"{evidence['bf16_kernels']}", flush=True)
    print(f"build: int4 SASS {evidence['int4_sass']}, bf16 kernels (N = 8, 16, 32) "
          f"{evidence['int4_bf16_kernels']}", flush=True)
    print(f"build: paged SASS {evidence['paged_sass']}, bf16 split kernels "
          f"(D = 32, 64, 128) {evidence['paged_bf16_kernels']}", flush=True)

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows, streams = phase_kernels(dev, bw, peak, flush_buf.zero_)
    del flush_buf
    detail.update(kernels=rows, int4_two_streams=streams)
    save()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    serve = detail["serve"] = phase_serve(dev, profile="--profile" in sys.argv[1:])
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
    print(f"census: static {serve['census']}", flush=True)
    torch.cuda.empty_cache()
    cont = detail["continuous"] = phase_continuous(
        dev, profile="--profile" in sys.argv[1:])
    for r in cont["streams"]:
        print(f"continuous: prompt {r['prompt_len']}"
              f"{' (late)' if r['late_joiner'] else ''} ttft at sink "
              f"{r['ttft_ms']:.1f} ms, decode {r['decode_tok_s']:.2f} tok/s",
              flush=True)
    print(f"continuous: {cont['aggregate_tok_s']:.2f} tok/s over "
          f"{cont['window_s']:.2f} s, {cont['decode_steps']} decode steps, "
          f"{cont['prefill_chunks']} prefill chunks, launches {cont['launches']}, "
          f"peak {cont['peak_mem_gb']:.2f} GB, warm-up {cont['warmup_s']:.1f} s",
          flush=True)
    print(f"continuous: tokens against forward_paged {cont['replayed']}", flush=True)
    print(f"census: continuous {cont['census']}", flush=True)
    print(f"continuous: host {cont['host_us_per_step']:.1f} us per decode step "
          f"(issuing it){'' if cont['busy'] is None else ', traced: ' + str(cont['busy'])}",
          flush=True)
    for name, r in cont["graph_vs_eager"].items():
        print(f"census: graph against eager at the 7B 8-slot step, {name}, "
              f"{r['steps']} steps: tokens {r['tokens_equal']}, positions {r['positions_equal']}, pool "
              f"{r['pool_equal']}; replay {r['graph_ms']:.3f} ms on the card, "
              f"{r['graph_host_ms'] * 1e3:.1f} us host; eager {r['eager_ms']:.3f} ms, "
              f"{r['eager_host_ms'] * 1e3:.1f} us host", flush=True)
    torch.cuda.empty_cache()
    query = detail["query"] = phase_query(dev, serve, cont)
    for r in query["streams"]:
        print(f"query: prompt {r['prompt_len']}"
              f"{' (late)' if r['late_joiner'] else ''} first token at the client "
              f"{r['ttft_ms']:.1f} ms, decode {r['decode_tok_s']:.2f} tok/s",
              flush=True)
    print(f"query: {query['aggregate_tok_s']:.2f} tok/s over the wire in "
          f"{query['window_s']:.2f} s (in process: {cont['aggregate_tok_s']:.2f} "
          f"in {cont['window_s']:.2f} s); wire per token p50 "
          f"{query['wire_ms_p50']:.3f} ms, p99 {query['wire_ms_p99']:.3f} ms; host "
          f"{query['host_us_per_step']:.1f} us per decode step (in process "
          f"{cont['host_us_per_step']:.1f}); {query['decode_steps']} decode steps, "
          f"{query['prefill_chunks']} prefill chunks, launches {query['launches']}",
          flush=True)
    print(f"query: {query['bitwise_equal_streams']} of {len(query['streams'])} "
          f"streams bitwise equal to the in-process run's; tokens against "
          f"forward_paged {query['replayed']}", flush=True)
    print(f"census: query {query['census']}", flush=True)
    print(f"query: dead client {query['dead_client']}; static over the wire "
          f"{query['static_over_wire']}", flush=True)
    save()
    torch.cuda.empty_cache()
    detail["reference"] = []
    for phase in (phase_reference, phase_reference_paged, phase_reference_bf16):
        detail["reference"].append(phase(dev))
        print(f"reference: {detail['reference'][-1]}", flush=True)
    save()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vision = detail["vision"] = phase_vision(
        dev, profile="--profile" in sys.argv[1:])
    vision["phase_s"] = time.perf_counter() - t0
    print_vision(vision)
    print(f"vision: phase {vision['phase_s']:.1f} s", flush=True)
    save()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    models = detail["models"] = phase_models(dev, profile="--profile" in sys.argv[1:])
    print_models(models)
    print(f"models: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # one line per kernel: int4 per decoded token (129 launches at B=1),
    # with the same 129 launches at B=8 (a continuous decode step) and
    # B=32 (a prefill chunk) beside it; flash per request at the 1023-row
    # prompt bucket (32 launches) and per continuous prefill chunk (32
    # launches at Sq = 32, by Skv), paged per continuous decode step at
    # the 7B 8-slot shape (32 launches); launches are the static serve
    # phase's plus the continuous phase's
    int4_rows = [r for r in rows if r["kernel"] == "matmul_int4"]

    def per_step(B, key):
        return sum(r[key] * r["per_token"] for r in int4_rows if r["B"] == B)

    fl = [r for r in rows if r["kernel"] == "flash_attention"
          and r["shape"]["Sq"] == 1023][0]
    chunk = {r["shape"]["Skv"]: r for r in rows if r["kernel"] == "flash_attention"
             and r["shape"]["Sq"] == 32 and r["shape"]["Skv"] in FLASH_CHUNK_SKV}
    paged_rows = [r for r in rows if r["kernel"] == "paged_attention"
                  and r["route"] == "kernel"]
    pg = [r for r in paged_rows if r["shape"]["name"] == "7b"][0]
    both = {k: serve["launches"][k] + cont["launches"][k]
            for k in serve["launches"]}
    summary = [
        dict(name="matmul_int4", route="cuda",
             source="nnstreamer_tpu_torch/csrc/int4_matmul.cu",
             replaces="nnstreamer_tpu/ops/int4_matmul.py:193",
             launches=both["matmul_int4"],
             max_abs_err=max(r["max_abs_err"] for r in int4_rows),
             max_row_err=max(r["max_row_err"] for r in int4_rows),
             **{k: per_step(1, k) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes",
             **{f"{what}_{k}": per_step(B, k) for what, B in (("step8", 8), ("chunk32", 32))
                for k in ("ms", "bound_ms", "library_ms")}),
        dict(name="flash_attention", route="cuda",
             source="nnstreamer_tpu_torch/csrc/flash_attention.cu",
             replaces="nnstreamer_tpu/ops/attention.py:210",
             launches=both["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in rows
                             if r["kernel"] == "flash_attention"),
             max_row_err=max(r["max_row_err"] for r in rows
                             if r["kernel"] == "flash_attention"),
             **{k: 32 * fl[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=fl["bound_by"],
             chunk_ms={str(n): N_LAYERS * r["ms"] for n, r in sorted(chunk.items())}),
        dict(name="paged_attention", route="cuda",
             source="nnstreamer_tpu_torch/csrc/paged_attention.cu",
             replaces="nnstreamer_tpu/ops/attention.py:429",
             launches=cont["launches"]["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in paged_rows),
             max_row_err=max(r["max_row_err"] for r in paged_rows),
             **{k: N_LAYERS * pg[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "library_ms")},
             bound_by=pg["bound_by"]),
    ]
    detail["summary"] = summary
    save()
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
