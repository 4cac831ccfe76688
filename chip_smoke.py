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
             for any of their bf16 kernels nor for the int8 conv kernels,
             whose library must hold mma.sync s8 (IMMA) and cp.async
             (LDGSTS).
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
             and 4; T = 8 at G = 8; the spec phase's [8, 4] at G = 1, and
             its draft's decode step, G = 2, D = 32) and 4 rows of T = 9
             at G = 8, which take gathered flash row by row; flash also at
             the draft's prefill chunk (D = 32); at the 7B step two calls must
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
             Each stream carries a tenant of its own, so the loop's
             timeline (``llm.serve.ttft_ms``, ``itl_ms``, ``queue_ms``,
             ``prefill_ms``, ``decode_ms``) reads per stream: one TTFT
             sample per stream, no later than its first token at the sink
             (so in every phase that serves this way); p50, p99 and counts
             are printed beside the sink's numbers.
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
6. prefix  — prefix sharing on the continuous cell (``prefix_cache`` at
             its default, on): a 512-token system prompt (seed 0) with
             eight distinct suffixes of 8..64 tokens, 64 tokens each; the
             first stream alone (cold: 17 prefill chunks), the second alone
             after it (a hit on the 32 blocks left resting in the free
             list: 1 chunk), the other six together.  Prints the chunks
             cold against per hit, first token at the sink cold against
             hit, ``prefix_hits`` and ``prefix_hit_blocks``; the first
             ``PREFIX_OFF_STREAMS`` streams bitwise equal to the same
             traffic through ``prefix_cache:0``,
             the pool free with every count 0, launches per step and
             chunk, one census signature and no capture after the
             warm-up.  Then the fork sub-case at ``prefill_chunk:24`` (a
             hit's suffix starts inside a block): three streams of 32
             tokens, ``cow_forks`` >= 1, bitwise equal to
             ``prefix_cache:0``.  Last, the cold stream and the first hit
             again under ``trace_mode="ring"``: as many ``serve.admit``,
             ``serve.prefix_hit`` and ``serve.prefill_chunk`` spans as
             admissions, hits and chunks, tokens equal to the untraced
             run's.
7. spec    — speculative decoding: the continuous cell's prompts and waves
             with ``draft:llama_tiny,spec_k:3,draft_seed:7`` (the [8, 4]
             verify: 32 int4 rows, the paged kernel at G = 1; the draft's
             prefill twin through flash at D = 32, its propose steps
             through paged at G = 2, D = 32).  Launches per round and
             chunk, the propose and verify steps one census signature
             each and no capture after the warm-up, no decode step; one
             stream (``SPEC_REPLAYED``: the first wave's shortest prompt)
             replayed at the verify shape (each token its step's argmax)
             and at the decode shape against the continuous phase's
             tokens (equal, or apart first at a near tie of
             ``SPEC_TIE``), and in f32 at both shapes, the logits spread
             between the shapes, the
             accept rate, rounds, target dispatches per token and tok/s
             beside the continuous phase's, and the round's captured steps
             timed against the decode step.  A sampled run
             (``temperature:0.8,seed:1``) twice, bitwise, one sampled
             signature each; the accept path at llama_small f32 with a
             same-weights draft (accept rate, streams equal to no draft).
8. files   — a model FILE at llama2_7b's full width and ``FILES_LAYERS``
             (8) layers, on every machine: the seed-0 bf16 tree (what the
             zoo's ``quant:int4`` draws and quantizes) is written as a
             3.6 GB BF16 GGUF with an embedded SentencePiece vocab (32,000
             pieces) and as a 2-layer HF checkpoint directory (two shards,
             index, config.json; loaded back bitwise), under build/files/
             (removed after).  The GGUF serves the continuous cell's
             traffic (``model=<file>``, ``stop_eos:0``) with ``quant:int4``
             (8 streams bitwise equal to the zoo model's at that depth,
             launches per step and chunk) and ``quant:int8`` (two streams
             against teacher-forced ``forward_paged``; no int4 launch); the
             captured decode step of int8, int4 and bf16 weights is timed
             at the full 32 layers on the zoo's model (CUDA events over
             replays); one static text request ("hello
             world" as bytes, ``stop_eos`` at its default, on) comes back as
             the vocab's pieces.  Prints load seconds, GB/s from the file,
             peak memory of each load and serve, and the phase's seconds.
9. elastic — live streams moved between two pipelines A and B of the
             continuous cell (both traced into the flight recorder's
             ring), the continuous phase's prompts and waves pushed on A:
             streams 3 and 0 (700 and 32 ids) drained together at the
             first chunk boundary after 3 tokens (9 tokens; the 700-id one
             holds 45 blocks) and adopted on B, stream 0 through a snapshot
             file
             (``save_stream_snapshot`` / ``load_stream_snapshot`` in
             chiprun_out/, removed after); stream 5 held in A's queue by a
             tenant quota of 0 and moved queued; stream 4 moved by one
             ``Autoscaler.evaluate()`` of a ``spill`` rule (its tenant's
             ``slo.burn_rate`` set above the band, ``spill_to=B``);
             stream 7 (600 ids) asked for while in prefill and moved once
             live.  Every stream's tokens, A's part then B's, bitwise equal
             to the continuous phase's for the same prompt (or parting at
             a near tie, ``replay_stream``'s rule), ``stream_index``
             without a gap, the id kept; both pools whole; no capture after
             warm-up on either pipeline; launches 32 paged per decode step,
             32 flash per chunk, 129 int4 per step or chunk over both
             loops, the steps' own launches by census; 5 ``elastic.drain``,
             5 ``elastic.adopt`` and 1 ``elastic.scale`` spans.  Then one
             sampled stream (``temperature:0.9,top_k:40``) drained after 8
             tokens from one pipeline and adopted on another, bitwise equal
             to the same stream undrained there (the slot's CUDA generator
             state rides the snapshot).  Prints per move the drain and
             adopt ms (the caller's wait, and the loop's spans), the
             snapshot's MB, the file's write and read seconds, and tok/s
             with the moves beside the continuous phase's.  Then the
             fetch window: the quick-start host-fed at ``fetch_depth`` 1
             and 4 in turns (1, 4, 4, 1, 1, 4), every run's outputs bitwise
             equal to the first's and in order, frames/s per run and the
             median per depth; and
             a stage restart: ``max_stage_restarts=2``, a host custom-easy
             stage failing once (on its third buffer; forced restartable)
             in front of a fused transform + ``scaler`` stage on the card:
             exactly that buffer lost, the rest right and in order, one
             restart, the card stage captured once.
10. reference — on a small model, logits with the kernels on the card
             agree with the plain versions on the CPU: cached prefill and
             decode, and the paged path (chunked prefill, then decode with
             a parked row, then a [2, 5] verify-shaped step of two live
             rows), in f32; then the same model in bf16 (cached prefill and
             decode, chunked paged prefill), whose flash calls take the
             tensor-core kernel.
11. vision — the vision path, which runs no kernel of csrc/ (cuDNN
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
12. models — the rest of BASELINE's model families in bench.py's form, no
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
13. batching — micro-batching, no kernel of csrc/: the README quick-start
             fed ONE frame per buffer (``dimensions=3:224:224:1``, 512
             seeded uint8 frames, queues 64 deep, no max-inflight),
             mobilenet_v1 224 bf16, ``batch_max`` 1 against 32, one run
             each (``BATCHING_RUNS``), streaming (a pusher thread against the pulls):
             frames/s, p50/p99 per frame, the occupancy histogram, pad
             waste, the census (one one-buffer step and at most one step
             per bucket, every bucket warmed first, no capture after), the
             card's ms per replay of each step (CUDA events) and busy share,
             peak and reserved memory; batched against unbatched (scores within
             ``VISION_TOL`` of the frame's largest |logit|, labels equal
             past that top-2 gap, from a batch_max=1 run without the
             decoder); bucket 32 rows bitwise at occupancies 17 and 32.
             bench.py's bench_batching (scaler, 256 floats, batch_max 8
             against 1) and bench_adaptive (a 1280-wide, 32-layer tanh MLP
             through custom-easy on the card, bursts of 6, adaptive against
             static: the refined ladder must hold 6) cells.  The dispatch
             window at ``dispatch_depth`` 1, 2, 4, one run each, each a
             backlog (every frame queued behind a held first one, so every
             run takes the same steps): outputs bitwise equal.  Ingress: the
             batch-64 quick-start and the per-frame backlog with the port's
             fresh pinned copy, with reused pinned slots (patched in), and
             with ``donate_ingress`` off, one run each: frames/s, host µs
             filling the static inputs, outputs bitwise equal.  The
             per-frame cell again at a 0.5 ms interpreter switch interval;
             one stack against one copy per row filling a bucket from card
             rows.  The vmap fallback is off for the phase (an op with no
             batching rule raises); the stage must be batchable, on the
             card, and drain more than one buffer.  ``--profile`` writes
             the bucket-32 step's kernels to chiprun_out/profile_batching.txt.

14. camera — the port's camera slice, no kernel of csrc/: raw 320x320 RGB
             frames as a camera delivers them (1-D uint8, 307,200 bytes:
             seeded noise with a moving box) pushed into ``appsrc
             max-inflight=8 ! tensor_converter ! tee``, one branch
             normalised into ssd_mobilenet 320 (91 classes, bf16, batch 1,
             one captured fused stage on the card) and a second tee, whose
             branches decode ``tensor_region`` (top 4) into
             ``tensor_crop``'s info pad and round-trip the detector's
             tensors through ``flexbuf``; the frame reaches ``tensor_crop``'s
             raw pad from the first tee (``CAMERA``).  Two timed runs of
             256 frames, pushed from a thread: frames/s, push-to-crop p50 and
             p99, the card's busy share (the stage's replay ms, CUDA events,
             times the frames over the wall time), the census (no capture
             after the warm-up), peak memory, ``crop.dropped`` (must stay 0).
             Every frame of every run: its crops are numpy slices of the
             frame pushed at the regions the tensor_region branch produced,
             which equal the host recompute from the wire's tensors; on a
             third, checked run the wire's tensors are bitwise the
             detector's.  The detector's stage must be on the card and its
             tee'd input not donated.  Then ``videotestsrc device=true
             pattern=random`` folded into the quick-start stage twice: two
             frames differ, the rerun draws bitwise the same frames, nothing
             captured after the first batch.
15. asr    — windowed streaming ASR, no kernel of csrc/: the JAX package's
             ``examples/asr_streaming_window.py`` string (``ASR``):
             ``audiotestsrc device=true`` 4,000-sample chunks into
             ``tensor_aggregator`` 16,000-sample windows at 75% overlap, into
             speech_commands at full width (64 mels, float32), once with
             the card-resident ring (``device=true``) and once with the host
             carry.  A checked run of each: the first 32 windows (tapped at
             the aggregator) and their scores bitwise between the carries,
             the ring allocated once and its edge counted resident.  Two
             timed runs of 256 windows, the carries in turns: windows/s
             between the first and last window at the sink, every score
             bitwise between the carries; the filter's card ms a window
             (its eager forward, CUDA events behind a 10 ms spin) and busy
             share.  The aggregator alone on card tensors: 100 chunks under
             ``torch.cuda.set_sync_debug_mode("error")`` (nothing may
             synchronize), one ring allocation, every window a storage of
             its own and bitwise its chunks.
16. v4l2   — the FIFO camera, no kernel of csrc/: a writer thread writes
             seeded 640x480 RGB frames (a moving box) into a FIFO under a
             temporary directory; ``v4l2src ! tee``, one branch through
             ``videoscale`` (bilinear, 320), ``tensor_converter``, the
             normalisation, ssd_mobilenet 320 (91 classes, bf16) and
             ``bounding_boxes option3=0.0 option4=640:480`` into the
             compositor's overlay pad, the other through ``queue`` to its
             base pad (``V4L2``).  A checked run of 128 frames (every group
             the compositor blends: its base is the camera's frame of that
             pts, the output is that frame where the overlay is clear and
             the overlay where it is opaque), then one timed run: frames/s,
             write-to-sink p50 and p99, ``<stage>.proc`` by stage; every
             frame in order, the writer joined, EOS.  A run whose writer
             stalls 2 s after 16 frames is stopped during the stall and must
             stop within 10 s.  128 frames replayed through ``filesrc
             blocksize=<frame> ! tensor_converter ! filesink``, the bytes
             equal.  On card tensors, against the same elements on host
             copies: ``tensor_if`` (``TENSOR_AVERAGE_VALUE`` and
             ``META_VALUE``), a ``tensor_sparse_enc`` / ``_dec`` round trip
             (float32 and bf16, wire bytes equal) and a bf16 ``filesink``.
17. transport — remote offload, no kernel of csrc/.  Remote detection:
             raw 320x320 RGB frames (the camera phase's) from ``appsrc`` into
             ``edgesink port=0``; a second pipeline ``edgesrc !
             tensor_converter ! tensor_transform ! tensor_filter`` on
             ssd_mobilenet 320 bf16, its ``bounding_boxes`` decode on the
             card, into ``mqttsink`` to this package's broker; a third
             ``mqttsrc ! tensor_sink`` (``REMOTE_*``).  At most
             ``TRANSPORT_WINDOW`` frames in flight (no queue on the way can
             drop).  A checked run of 256 frames, every frame's detections
             bitwise equal to the same frames through one local pipeline,
             then two timed runs, held so after the timing: frames/s,
             push-to-receive p50 and p99,
             ``<stage>.proc`` by stage, the detector's card ms and busy
             share, the census (no capture after the warm-up).  shm across
             two processes: this script run with ``--shm-producer`` puts
             128 frames on the card, normalises them to bf16 there and into
             ``shmsink`` (a segment named after this process's pid);
             ``shmsrc`` here feeds mobilenet_v1 224; every logit bitwise
             equal to a local run, the producer exited 0 (waited for, and
             killed in a ``finally``), its segment gone.  datarepo: 64
             seeded frames through ``datareposink``, replayed by
             ``datareposrc is-shuffle=true epochs=2`` into mobilenet_v1:
             the recomputed order, every logit bitwise.  Frameworks:
             ``framework=pytorch`` with a user ``nn.Module`` over
             mobilenet_v1's weights and with its TorchScript trace (a file),
             both on the card, against the fused stage of the zoo model
             (within ``VISION_TOL``); ``SingleShot`` of the zoo model bitwise
             equal to the pipeline.  gRPC: with ``grpcio``, a bf16 round
             trip bitwise; without it, the elements' clear error.  Prints
             which happened.
18. modelfiles — model files on the card (``MF_*``).  (a) ``int8_conv``
             at every distinct layer shape of a fully-quantized MobileNet-v1
             224 at batch 64, and at two 24-channel shapes it lacks
             (``MF_EXTRA_SHAPES``), on seeded operands in one of ``MF_FORMS``
             (uint8 or int8 in and out, no activation, relu or relu6, input
             zero points off 128 and 0): the fused entry (one launch, the
             unpadded activation's bytes to the next activation's) bitwise
             against its plain version with constants that spread the
             outputs over their range, ``int8_conv``'s int32 sums (the same
             entry) bitwise against a float64 conv of the integers; fused,
             plain and yardstick ms (median of 20, L2 flushed: ``torch._int_mm`` for
             the 1x1 layers and the FC, its N padded to 1008; float32 cuDNN,
             TF32 off, channels_last, for the first conv and the depthwise
             layers, each checked bitwise first), launches per forward, the
             bound (bytes over 3.35 TB/s, operations over 1,979 int8 TOPS);
             eight edge cases bitwise (ragged M and N, the GEMM's window
             path, both over 12 or 24 channels too, a depthwise multiplier, the dense kernel on int8, a 1001-wide
             FC); one CONV_2D with uint8 weights and per-axis zero points
             (the box sum, then the fused conv reading it) bitwise against
             the CPU.  (b)
             BASELINE's config #1 in its stock form: bench.py's quantized
             file (its draws, scales and bytes) written with the port's
             ``tflite_build``, through bench.py's pipeline (``videotestsrc
             device=true`` ! caps pin ! ``tensor_filter`` ! dequantizing
             ``tensor_transform`` ! ``image_labeling``), one captured fused
             stage, no capture after the warm-up, every replay 28
             ``int8_conv`` launches; frames/s, card ms a batch, busy share,
             peak memory; the first ``MF_CHECKED`` frames' uint8 logits
             bitwise equal to the port's plain path on the CPU, and every
             op's integer output of an eager card call too; one eager
             forward under torch.profiler, whose conv layers must be 28
             ``int8_conv`` kernels with nothing between the first 27 (no
             int32 sum leaves a kernel).  (c) The float
             twin (the same draws dequantized) through the same pipeline
             with the float scale, within ``MF_FLOAT_TOL`` of the CPU at
             f32.  (d) A MobileNet-v1 ``nn.Module`` exported by torch's own
             exporter (``dynamo=False``, the onnxscript post-step patched
             out wherever this torch keeps it) through ``tensor_filter`` on
             the card, within ``MF_ONNX_TOL`` of the module run eagerly on
             the card.
19. capi   — the C side (``CAPI_*``): the build phase compiled the
             port's ``libnnstpu`` and ``libnnstpu_capi`` (g++, beside the
             nvcc builds), the ``.so`` filter ``examples/torch_channel_swap.cc``
             (a BGR <-> RGB swap of uint8 frames) and the C program
             ``examples/torch_capi_classify.c`` against the C API.  The
             program runs in a child process (waited for at most ``WAIT_S``,
             killed in a ``finally``) that embeds the interpreter: the
             single-shot surface on mobilenet_v1 224 bf16 at batch 64 (the
             header's own example), on BASELINE's config #1 (the modelfiles
             phase's quantized file, every conv on ``int8_conv``) and on its
             first ``CAPI_CHECK_BLOCKS`` blocks (the same draws cut short,
             whose logits spread where the full file's are all the zero
             point), and on the ``.so``; then the pipeline surface,
             ``appsrc ! tensor_filter framework=custom ! tensor_filter
             framework=jax model=<.tflite> ! tensor_transform`` (bench.py's
             dequantization; with the filter one captured card stage)
             ``! tensor_sink``, ``CAPI_WARM``
             batches and ``CAPI_TIMED`` timed ones of 64 frames with up to
             ``CAPI_WINDOW`` in flight, and the cut file's pipeline for two
             batches.  Its inputs come from a counter hash that
             ``capi_bytes`` makes again here.  Checks: the quantized outputs
             (both files, single-shot and pipeline) and the ``.so``'s
             bitwise against the same models, pipelines and a numpy channel
             flip run in this process; the bf16 logits within
             ``VISION_TOL`` of this process's ``SingleShot`` (how many are
             bitwise is printed); the child holds the card's device nodes;
             the in-process pipeline's card stage runs on ``cuda`` and
             captures nothing after its first batch; the timed pipeline
             once more through ``capi.py`` from Python (bytes in and out),
             bitwise.
             Prints the C side's frames/s against this process's run of
             the same pipeline and the modelfiles cell, its single-invoke
             ms and its start-up seconds, with the card's name and power
             limit.
20. learn  — training and train-while-serve (``LEARN_*``; the learn
             phase's own docstring), and the trainer's ``mesh=data:2``
             over two slots against the mesh-less trainer (``learn_mesh``).
21. xray   — analysis and observability, run right after ``continuous``
             (``phase_xray``): ``analyze(CONT_DESC, deep=True)`` with
             ``torch.cuda.memory_allocated()`` unchanged across it; the
             continuous cell's first streams again with ``xray=True`` and
             ``explain()`` holding census drift 0 and every memory
             category within ``xray_hbm_tolerance``, the decode step's
             device time from CUDA events with its FLOPs within 2% of the
             hand count and its shares of 3.35 TB/s and 989 TFLOP/s; the
             window's tok/s beside the same traffic's with xray off,
             served just before; the
             quick-start through the batching runner (bucket drift 0,
             ``pad_waste_flops``); ``doctor --gate``; one ``metrics_text()``
             scrape whose ``batch_occupancy`` histogram parses; the pinned
             device-to-host rate (``link_d2h_mbps``'s default).
22. weave  — the front door across two processes, right after ``query``
             on its live server (traced in a ring): ``WEAVE_STREAMS`` of
             the query phase's prompts sent by ``appsrc !
             tensor_query_client tenant=weave ! tensor_sink`` in a child
             process under ``NNS_TPU_TSAN=1`` (``phase_weave``): its
             tokens bitwise the query phase's in-process clients', its
             ``locks.report()`` clean, the two rings merged by ``python
             -m nnstreamer_tpu_torch.tools.trace merge`` (byte for byte
             the merge made in process, which ``trace validate`` and
             ``summary`` read: two processes with their own epochs,
             aligned, an arrow each way per request, every ``query.send``
             before its server ``ingress`` within the carried
             uncertainty), and ``tools.slo report --url`` against this
             process's ``/metrics``: exit 0 met, 1 breached, estimates at
             or above the exact quantiles.  ``weave:`` lines: the merge's
             rings, spans and arrows, the largest clock uncertainty, the
             tokens/s the child received.

23. mesh   — the in-process mesh (``phase_mesh``) on slots of ``cuda:0``:
             llama2_7b int4 at ``model_parallel=2`` in the continuous cell
             against the same traffic unsharded, teacher-forced; one
             static ``custom=tp:2`` request; ring attention at
             ``RING_SHAPE`` over ``MESH_RING`` slots against the flash
             kernel, and ``forward_seq_parallel`` at ``SEQ_T`` tokens
             against the dense forward on the same int4 tree; the kernels
             at the shard shapes; the per-frame quick-start at
             ``data_parallel=2``, every frame bitwise the one-slot run's;
             ``mesh=data:2`` behind the query pair.
24. dist   — the multi-process mesh (``phase_dist``): two child processes
             (``--dist-rank``) join one gloo group through a ``file://``
             rendezvous and serve the mesh phase's tensor-parallel traffic
             with the model group across them: tokens equal on both ranks
             and to the in-process TP's, the first decode step's logits
             bitwise the in-process group's, a seq=2 ring across the ranks
             bitwise the in-process ring; ``dist:`` lines with tok/s beside
             the in-process and unsharded runs, the cross-rank sums' ms a
             decode step and each kernel's launches per rank.

Each phase prints ``phase: <name> <seconds> s`` when it ends and runs
under its deadline (``PHASE_DEADLINE_S``: past it faulthandler prints
every thread's stack and the run exits non-zero); no wait of the script
is longer than ``WAIT_S``.  ``total: <seconds> s`` comes before the
``{"kernels": ...}`` line; the run's budget is ``BUDGET_S`` (400 s).

``--yolo-bucket <tree> ...`` instead times yolov5s 640's bucket-8 step
(one replay, CUDA events) with the port of each given tree (a ``git
archive`` of a commit), the trees in the order given, one process each.

Prints the card's name and power limit (nvidia-smi), a ``{"kernels": ...}``
JSON line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
card, outside a checkout, or when any phase fails it exits non-zero and
prints no result.  Per-shape detail goes to chiprun_out/chip_smoke.json.

``--profile`` adds one more 200-token request under torch.profiler and
writes its operator tables to chiprun_out/profile_decode.txt, and traces
the continuous phase's counted run (card activity only): the card's busy
ms per decode step and idle share over that run.
"""

import concurrent.futures
import contextlib
import faulthandler
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

#: published H100 rates (NVIDIA data sheet, dense): device memory bytes/s
#: and bf16 tensor-core flop/s, for the SXM part and the PCIe part
RATES = {"sxm": (3.35e12, 989e12), "pcie": (2.0e12, 756e12)}

#: the longest any one wait of this script may take (a pull, a join, an
#: event, a child process): a stuck wait fails within it, with its stack
WAIT_S = 60
#: each phase's deadline in seconds: about 2.5 times its time in the
#: slower of two H100 runs (PERF.md section 4; the host-bound phases ran
#: up to 1.46 times slower in one run than in another), and at least 30 s;
#: past it faulthandler prints every thread's stack and the process exits
#: non-zero.  Their sum (1,200 s) is the 1,200 s the run is given, so a
#: hang anywhere ends the run inside it.  dist's (2.6 times its first run,
#: 25.3 s) and mesh's and learn's growth came out of xray, prefix, spec,
#: files, elastic, vision, models, batching, v4l2, transport, modelfiles
#: and capi, whose depth this slice cut (build's is 1.6 times: nvcc in
#: parallel)
PHASE_DEADLINE_S = dict(
    build=70, kernels=60, serve=30, continuous=70, xray=50, query=50, weave=60,
    prefix=50, spec=75, files=45, elastic=50, mesh=90, dist=65, reference=30, vision=30,
    models=35, batching=50, camera=30, asr=30, v4l2=30, transport=50, modelfiles=45,
    capi=45, learn=60)
#: the run's budget, every phase and the kernel build included
BUDGET_S = 400


class PhaseClock:
    """Times each phase of the run under its deadline: ``with
    phase("name"):`` arms ``faulthandler`` for ``PHASE_DEADLINE_S[name]``
    seconds, and prints ``phase: name <seconds> s`` when the phase ends;
    ``total()`` prints ``total:``, the seconds since the clock was made,
    against ``BUDGET_S``.  ``slack`` multiplies every deadline: the
    deadlines fit the plain run, and ``--profile``'s tracing (one phase's
    ``key_averages`` alone can take longer than its deadline) gets 4."""

    def __init__(self, slack=1):
        self.start = time.perf_counter()
        self.seconds = {}
        self.slack = slack

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        faulthandler.dump_traceback_later(PHASE_DEADLINE_S[name] * self.slack, exit=True)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()
        self.seconds[name] = s = time.perf_counter() - t0
        print(f"phase: {name} {s:.1f} s", flush=True)

    def total(self):
        s = time.perf_counter() - self.start
        print(f"total: {s:.1f} s (budget {BUDGET_S} s)", flush=True)
        return s


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
    # the llama_tiny draft's prefill twin: a 32-row chunk on 704 positions
    (1, 32, 704, 4, 2, 32, True),
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
    # the spec phase's steps: the target's [8, 4] verify (spec_k 3) and the
    # llama_tiny draft's decode-shaped propose steps (4 heads on 2, D = 32)
    ("7b_verify", 8, 4, 32, 32, 128, (4, 5, 33, 100, 257, 512, 700, 1000), 65),
    ("draft", 8, 1, 4, 2, 32, PAGED_LENS, 65),
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
                         capture_output=True, text=True, timeout=WAIT_S)
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
    from nnstreamer_tpu_torch.ops import kernels

    int8_kernels = {k: e for k, e in ptxas_entries(kernels.build_report("int8_conv")).items()
                    if "int8_conv" in k}
    check(len(int8_kernels) == 16, f"int8 conv library: ptxas reported {sorted(int8_kernels)}")
    for k, e in int8_kernels.items():
        check(e.get("spill_stores") == 0 and e.get("spill_loads") == 0,
              f"int8 conv kernel spills: {k} {e}")
    int8_sass = sass_counts("int8_conv", ("IMMA", "LDGSTS", "LDSM"))
    check(int8_sass["IMMA"] > 0, "int8 conv library: no IMMA (mma.sync s8) in its SASS")
    check(int8_sass["LDGSTS"] > 0, "int8 conv library: no LDGSTS (cp.async) in its SASS")
    paged_sass = sass_counts("paged_attention", ("HMMA", "UTMALDG"))
    check(paged_sass["HMMA"] > 0, "paged library: no HMMA (mma.sync) instruction in its SASS")
    check(paged_sass["UTMALDG"] > 0, "paged library: no UTMALDG (TMA load) instruction in its SASS")
    return dict(sass=sass, bf16_kernels=bf16_kernels("flash_attention", "flash_bf16_kernel"),
                int4_sass=int4_sass,
                int4_bf16_kernels=bf16_kernels("int4_matmul", "int4_bf16_kernel"),
                paged_sass=paged_sass,
                paged_bf16_kernels=bf16_kernels("paged_attention", "paged_split_bf16"),
                int8_sass=int8_sass, int8_kernels=sorted(int8_kernels.values(), key=str))


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
            outs.append(pipe.pull("out", timeout=WAIT_S))
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
        pipe.wait(timeout=WAIT_S)
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


def replay_stream(fw, loop, prompt, ids, dev, tie_share=None, other=None,
                  width=1, keep_rows=False, dtype=None, params=None):
    """Hold a greedy stream the loop served against ``llama.forward_paged``
    driven step by step outside the loop, on the card, at the loop's
    shapes: the prompt in chunks of ``prefill_chunk`` on one row, then
    decode steps over every slot with the stream in row 0 and the other
    rows parked, teacher-forced on the stream's own tokens.  Every token
    must be the argmax of its step's logits, or within a near tie of it
    (a top-1/top-2 gap under ``tie_share``, default ``CONT_TIE``, of the
    row's max |logit|).  ``other``: another greedy stream of the same
    prompt (the same model through other shapes); up to its first token
    that differs the two are one stream, and there both tokens must be
    near-tied.  ``width`` k + 1 drives the steps at the speculative verify
    shape instead, [slots, k + 1] with the stream's token in row 0's
    first column.  ``dtype``: the compute dtype (default the filter's;
    the pool takes it too), e.g. float32 over the same weights.  Returns
    the counts: tokens compared, equal to the
    argmax, near ties, the least top-1/top-2 gap and the largest |logit|
    (and the index of the first difference from ``other``, None if none;
    the logits rows themselves with ``keep_rows``).  ``params``: another
    tree of the model's (default the filter's own)."""
    tie_share = CONT_TIE if tie_share is None else tie_share
    dtype = fw.dtype if dtype is None else dtype
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    cfg, C, bs, B = fw.cfg, fw.prefill_chunk, fw.block_size, fw.slots
    params = fw.bundle.params if params is None else params
    T = len(prompt)
    P = -(-T // C) * C
    n_blocks = -(-(P + len(ids) + width - 1) // bs)
    pool = llama.init_paged_cache(cfg, n_blocks, bs, dtype=dtype, device=dev)
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
                tables[:1], np.asarray([p], np.int64), cfg, dtype,
                logit_off=T - 1 - p if p + C >= P else 0)
        rows.append(logits[0, -1].float().cpu())
        pos = np.full((B,), loop.park, np.int64)
        for i, t in enumerate(ids[:-1]):
            pos[0] = T + i
            x = torch.zeros((B, width), dtype=torch.int32)
            x[0, 0] = t
            logits, pool = llama.forward_paged(
                params, x.to(dev), pool, tables, torch.from_numpy(pos).to(dev),
                cfg, dtype)
            rows.append(logits[0, 0].float().cpu())
    near, least, equal, scale = 0, float("inf"), 0, 0.0
    for i, (row, g) in enumerate(zip(rows, ids)):
        top2 = row.topk(2).values
        gap = (top2[0] - top2[1]).item()
        least = min(least, gap)
        scale = max(scale, row.abs().max().item())
        equal += int(g == int(row.argmax()))
        tie = tie_share * row.abs().max().item()
        if gap < tie:
            near += 1
            check(row[g].item() >= top2[0].item() - 2 * tie,
                  f"continuous token {i}: {g} is not one of the near-tied ones")
        else:
            check(g == int(row.argmax()),
                  f"continuous token {i}: {g}, forward_paged chooses "
                  f"{int(row.argmax())}")
    out = dict(tokens_compared=len(ids), equal_to_argmax=equal,
               near_ties=near, least_top2_gap=least, max_abs_logit=scale)
    if other is not None:
        d = next((i for i, (a, b) in enumerate(zip(ids, other)) if a != b), None)
        if d is not None:
            row = rows[d]
            top = row.max().item()
            tie = tie_share * row.abs().max().item()
            check(row[ids[d]].item() >= top - 2 * tie
                  and row[other[d]].item() >= top - 2 * tie,
                  f"token {d}: {ids[d]} against {other[d]}, not a near tie")
        out["first_difference"] = d
    if keep_rows:
        out["rows"] = rows
    return out


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
    import math

    import torch
    from torch.profiler import ProfilerActivity

    prompts = continuous_prompts()
    lens = [len(p) for p in prompts]
    first = len(CONT_WAVES[0])
    groups = [(list(range(first)), "first"), (list(range(first, len(prompts))), "first")]
    traced = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
              if profile else None)
    out = {}

    def inside(fw, loop, res):
        # outside the counted run: served tokens against forward_paged
        out["replayed"] = {i: dict(prompt_len=lens[i], **replay_stream(
            fw, loop, prompts[i], res["ids"][i], dev)) for i in CONT_CHECKED}
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        out["graph_vs_eager"] = graph_vs_eager(fw, loop, dev, flush_buf.zero_)
        del flush_buf
        out["swaps"] = continuous_swaps(fw, loop, dev, prompts[CONT_CHECKED[0]])

    r = serve_traffic(CONT_DESC, prompts, groups, MAX_NEW, dev, inside=inside,
                      around=traced)
    streams = [dict(prompt_len=lens[i], late_joiner=i >= first, ttft_ms=r["ttft_ms"][i],
                    loop_ttft_ms=r["loop_ttft_ms"][i],
                    decode_tok_s=r["decode_tok_s"][i], tokens=ids[:8], ids=ids)
               for i, ids in enumerate(r["ids"])]
    launches, stats = r["launches"], r["stats"]
    steps, chunks = stats["decode_steps"], stats["prefill_chunks"]
    want_chunks = sum(math.ceil(n / 32) for n in lens)
    check(chunks == want_chunks, f"prefill chunks {chunks} != {want_chunks}")
    check(launches["paged_attention"] == N_LAYERS * steps,
          f"paged launches {launches['paged_attention']} != 32 x {steps} steps")
    check(launches["flash_attention"] == N_LAYERS * chunks,
          f"flash launches {launches['flash_attention']} != 32 x {chunks} chunks")
    check(launches["matmul_int4"] == 129 * (steps + chunks),
          f"int4 launches {launches['matmul_int4']} != 129 x {steps + chunks}")
    check(r["census"]["signatures"] == ["('continuous', 8, 'bfloat16', False)"],
          f"continuous census: {r['census']}")
    busy = None
    if profile:
        traced_ms = r["drained_s"] * 1e3
        busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                      for e in traced.key_averages()) / 1e3
        busy = dict(traced_ms=traced_ms, device_busy_ms=busy_ms,
                    device_busy_ms_per_step=busy_ms / steps,
                    device_idle_share=1.0 - busy_ms / traced_ms)
    return dict(setup_s=r["setup_s"], warmup_s=r["warmup_s"], streams=streams,
                window_s=r["window_s"], aggregate_tok_s=r["aggregate_tok_s"],
                decode_steps=steps, prefill_chunks=chunks, launches=launches,
                step_launches=r["step_launches"], eager_launches=r["eager_launches"],
                host_us_per_step=stats["decode_host_s"] / steps * 1e6,
                census=r["census"], busy=busy, graph_vs_eager=out["graph_vs_eager"],
                swaps=out["swaps"],
                n_blocks=r["n_blocks"], peak_mem_gb=r["peak_mem_gb"],
                replayed=out["replayed"], timeline=r["timeline"])


class StreamIds:
    """An emit target for ``fw.submit``: a stream's token ids, ``done`` at
    its last."""

    def __init__(self):
        import threading

        self.ids = []
        self.done = threading.Event()

    def __call__(self, tensors, meta):
        self.ids.append(int(tensors[0][0]))
        if meta.get("stream_last"):
            self.done.set()


#: the tokens of the stream served after the swap to tree B held against
#: an eager forward over B
CONT_SWAP_REPLAYED = 8


def continuous_swaps(fw, loop, dev, prompt):
    """Weight swaps into the live continuous loop (llama2_7b int4), with no
    second load of its tree.  A no-op swap of a clone of tree A keeps the
    next greedy stream of ``prompt`` bitwise the one served before it; a
    swap to tree B (llama2_7b's init at seed 1, built on the card) serves a
    stream whose first ``CONT_SWAP_REPLAYED`` tokens are each the argmax,
    or a ``CONT_TIE`` near tie, of an eager ``forward_paged`` over B's own
    tensors (the int4 and paged kernels outside the loop; the first from
    the prefill, the rest from the loop's captured decode steps), and whose
    prefill and first-step logits
    differ from A's; a swap back to A serves the first stream again,
    bitwise.  The captured steps read the new weights through the maps
    they baked: no swap recaptures a step.  Returns the swap ms, B's build
    seconds and the replay's counts."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.filters.base import tree_map
    from nnstreamer_tpu_torch.models import llama

    def stream():
        got = StreamIds()
        fw.submit([np.asarray(prompt, np.int32)], {}, got)
        check(got.done.wait(WAIT_S), "a stream after a swap did not finish")
        return got.ids

    def swap(tree, version):
        t0 = time.perf_counter()
        check(fw.swap_params(tree) == version, f"swap {version}: param version")
        return (time.perf_counter() - t0) * 1e3

    captures = fw.census.captures
    base = stream()
    tree_a = tree_map(lambda t: t.clone(), fw.bundle.params)
    out = dict(noop_swap_ms=swap(tree_a, loop.param_version + 1))
    check(stream() == base, "a no-op swap changed the greedy stream")
    t0 = time.perf_counter()
    tree_b = llama.init_params(fw.cfg, seed=1, dtype="bfloat16", device=dev,
                               quant="int4")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["tree_b_s"] = time.perf_counter() - t0
    out["swap_ms"] = swap(tree_b, loop.param_version + 1)
    ids_b = stream()
    check(ids_b != base, "the stream after the swap to B is A's")
    rep = replay_stream(fw, loop, prompt, ids_b[:CONT_SWAP_REPLAYED], dev, params=tree_b,
                        keep_rows=True)
    rows_b = rep.pop("rows")
    rows_a = replay_stream(fw, loop, prompt, base[:2], dev, params=tree_a,
                           keep_rows=True)["rows"]
    out["first_step_diff_from_a"] = [(b - a).abs().max().item()
                                     for a, b in zip(rows_a, rows_b)]
    check(all(d > 0 for d in out["first_step_diff_from_a"]),
          "B's prefill or first-step logits equal A's")
    out["b_against_eager"] = rep
    out["swap_back_ms"] = swap(tree_a, loop.param_version + 1)
    check(stream() == base, "the swap back to A does not give A's stream")
    check(fw.census.captures == captures,
          f"swaps recaptured: {fw.census.captures - captures} captures")
    out["captures"] = fw.census.captures
    out["param_version"] = loop.param_version
    return out


def query_server(desc_custom, sid, trace_mode=None, model="llama2_7b", acc=""):
    """A query server around the llm filter (named ``llm``; its sink is
    ``ssink``)."""
    import nnstreamer_tpu_torch as ntt

    return ntt.Pipeline(
        f"tensor_query_serversrc name=ssrc port=0 id={sid} ! "
        f"tensor_filter name=llm framework=llm model={model} "
        f"custom={desc_custom} invoke-dynamic=true {acc} ! "
        f"tensor_query_serversink name=ssink id={sid}", trace_mode=trace_mode)


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
            f"timeout={WAIT_S} ! tensor_sink name=out")
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
                buf = self.pipe.pull("out", timeout=WAIT_S)
                self.bufs.append(buf)
                self.arrived.append(buf.meta["_arrive_t"])
                self.first.set()
        except BaseException as e:  # noqa: BLE001 - reported by join()
            self.error = e
            self.first.set()

    def join(self):
        self.thread.join(timeout=WAIT_S)
        check(self.error is None, f"query client failed: {self.error!r}")
        check(not self.thread.is_alive(), "query client did not finish")
        return self.bufs

    def close(self):
        self.pipe.eos("src")
        self.pipe.wait(timeout=WAIT_S)
        self.pipe.stop()


#: the xray phase's LLM traffic: the continuous phase's first streams,
#: served with xray off, then on
XRAY_STREAMS = 2
#: the xray phase's quick-start through the batching runner: frames pushed
#: in one burst, and the batch_max of its bucket ladder
XRAY_FRAMES = 31
XRAY_BATCH_MAX = 8
#: bytes a pinned device-to-host copy of the link measurement moves, and
#: how many copies are timed
XRAY_LINK_BYTES = 256 << 20
XRAY_LINK_COPIES = 5


def xray_link(dev):
    """The card's device-to-host rate into pinned memory, MB/s (the median
    of ``XRAY_LINK_COPIES`` copies of ``XRAY_LINK_BYTES``, CUDA events)."""
    import torch

    src = torch.empty(XRAY_LINK_BYTES, dtype=torch.uint8, device=dev).fill_(7)
    dst = torch.empty(XRAY_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dst.copy_(src, non_blocking=True)  # warm
    torch.cuda.synchronize(dev)
    rates = []
    for _ in range(XRAY_LINK_COPIES):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        e1.synchronize()
        rates.append(XRAY_LINK_BYTES / (e0.elapsed_time(e1) * 1e-3) / 1e6)
    check(int(dst[-1]) == 7, "the pinned copy did not land")
    return dict(mbps=sorted(rates)[len(rates) // 2], rates=rates,
                bytes=XRAY_LINK_BYTES)


def xray_quickstart(dev, size=224, acc="", frames_n=XRAY_FRAMES):
    """The per-frame quick-start (mobilenet_v1 at 224) through the batching
    runner with xray on: a burst of ``XRAY_FRAMES`` frames into batch_max
    ``XRAY_BATCH_MAX``.  The bucket census must stay within the ladder
    (drift 0), every category ok; the pad rows' FLOPs are read."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.utils import xray

    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
              for _ in range(frames_n)]
    xray.registry.reset()
    metrics.reset()
    desc = PER_FRAME.format(size=size, cap=frames_n + 8, acc=acc, tail=LABELING)
    pipe = ntt.Pipeline(desc, batch_max=XRAY_BATCH_MAX, queue_capacity=frames_n + 8,
                        xray=True)
    [st] = [s for s in pipe.stages if s.element.kind == "fused"]
    with pipe:
        for f in frames:
            pipe.push("src", f)
        outs = [pipe.pull("out", timeout=WAIT_S) for _ in frames]
        rep = pipe.explain()
    check(len(outs) == frames_n, "quick-start under xray lost frames")
    snap = metrics.snapshot()
    name = st.element.name
    progs = rep["census"]["programs"]
    check(rep["census"]["drift_total"] == 0,
          f"quick-start census drift: {rep['census']['drift']}")
    check(all(c["ok"] for c in rep["hbm"]["categories"].values()),
          f"quick-start ledger: {rep['hbm']['categories']}")
    batch = progs.get(f"{name}/batch")
    check(batch is not None and batch["within"], f"quick-start census: {progs}")
    return dict(stage=name, census={k: dict(predicted=v["predicted"], live=v["live_compiles"],
                                            allow=v["allow"]) for k, v in progs.items()},
                drift_total=rep["census"]["drift_total"],
                pad_waste_rows=snap.get(f"{name}.batch_pad_waste", 0.0),
                pad_waste_flops=snap.get(f"{name}.pad_waste_flops", 0.0),
                device_time=rep["device_time"].get(name),
                ledger={c: v["measured"] for c, v in rep["hbm"]["categories"].items()},
                scrape=xray_scrape(name))


def xray_scrape(stage):
    """One ``metrics_text()`` scrape: the stage's ``batch_occupancy``
    histogram parsed (cumulative buckets, +Inf equal to the count)."""
    from nnstreamer_tpu_torch.utils.profiler import metrics_text

    text = metrics_text()
    fam = "nnstpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", f"{stage}.batch_occupancy")
    buckets = [(m.group(1), int(m.group(2))) for m in re.finditer(
        re.escape(fam) + r'_bucket\{le="([^"]+)"\} (\d+)', text)]
    count = re.search(re.escape(fam) + r"_count (\d+)", text)
    check(f"# TYPE {fam} histogram" in text and buckets and count,
          f"no {fam} histogram in the scrape")
    cum = [c for _, c in buckets]
    check(cum == sorted(cum) and buckets[-1][0] == "+Inf"
          and cum[-1] == int(count.group(1)), f"{fam}: bad buckets {buckets}")
    return dict(family=fam, buckets=buckets, count=int(count.group(1)),
                lines=len(text.splitlines()))


def phase_xray(dev, cont):
    """xray on the continuous cell (llama2_7b int4, the continuous phase's
    prompts and waves) and on the quick-start.

    1. Prediction: ``analyze(CONT_DESC, deep=True)`` on the card's config,
       with ``torch.cuda.memory_allocated()`` the same before and after.
    2. Reconciliation: ``CONT_DESC`` served with ``xray=True`` (the
       continuous phase's first ``XRAY_STREAMS`` streams of ``MAX_NEW``
       tokens);
       ``explain()`` must show census drift 0 (the loop's one captured
       step, as predicted), every memory category within
       ``xray_hbm_tolerance``; the decode step's device time from CUDA
       events, its FLOPs and bytes against a hand count and its shares of
       the card's bandwidth and peak FLOP/s are read.
    3. Overhead: the window's tok/s beside the same traffic's with xray
       off, served just before (and the continuous phase's eight
       streams); how many
       streams are equal to that run's is printed (a late joiner's slot
       mates, set by timing, can move a bf16 near tie).
    4. The quick-start through the batching runner (:func:`xray_quickstart`).
    5. ``doctor --gate``'s verdict lines; 6. a ``metrics_text()`` scrape;
    7. the pinned device-to-host rate (:func:`xray_link`)."""
    import contextlib
    import io

    import torch

    from nnstreamer_tpu_torch.analysis import analyze
    from nnstreamer_tpu_torch.filters.llm import serving_plan
    from nnstreamer_tpu_torch.models import llama
    from nnstreamer_tpu_torch.tools import doctor
    from nnstreamer_tpu_torch.utils import xray

    out = {}
    # 1. the prediction: no storage on the card
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    report = analyze(CONT_DESC, deep=True)
    lint_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated(dev)
    check(report.ok, f"deep lint of CONT_DESC: {report.render()}")
    check(after == before, f"the deep lint allocated {after - before} bytes on the card")
    res = report.resources
    out["predicted"] = dict(by_category=res.by_category(), programs=res.compiled_variants,
                            hbm_estimate=res.hbm_estimate, lint_s=lint_s,
                            memory_allocated=[before, after])
    # 2. the reconciliation, on the continuous phase's first streams (the
    # rest are cut to keep the run inside its budget)
    prompts = continuous_prompts()[:XRAY_STREAMS]
    groups = [(list(range(len(prompts))), "first")]
    # the same traffic with xray off, just before: the overhead's pair
    off = serve_traffic(CONT_DESC, prompts, groups, MAX_NEW, dev)
    xray.registry.reset()
    r = serve_traffic(CONT_DESC, prompts, groups, MAX_NEW, dev, xray=True)
    out["streams_equal_off"] = sum(a == b for a, b in zip(r["ids"], off["ids"]))
    out["streams"] = len(prompts)
    rep = r["explain"]
    check(rep["census"]["drift_total"] == 0, f"census drift: {rep['census']['drift']}")
    progs = rep["census"]["programs"]
    loop_key = "llm.serve/continuous"
    check(progs.get(loop_key, {}).get("live_compiles") == 1
          and progs[loop_key]["predicted"] == res.compiled_variants == 1,
          f"census: {progs}, predicted {res.compiled_variants}")
    bad = {c: v for c, v in rep["hbm"]["categories"].items() if not v["ok"]}
    check(not bad, f"memory categories out of tolerance: {bad}")
    check(rep["hbm"]["categories"]["params"]["measured"]
          == out["predicted"]["by_category"]["params"],
          "measured params differ from the deep lint's")
    dt = rep["device_time"].get("llm.serve")
    check(dt is not None and dt["dispatches"] > 0, f"no timed decode step: {rep['device_time']}")
    steps = dt["dispatches"]
    # the hand count of a decode step's matmul FLOPs at 8 rows: every
    # projection and the lm_head, 2 flops a weight a row
    cfg = llama.resolve_config("llama2_7b", {"max_seq": "1024"})
    L, D, H, Hkv, F = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden
    hd = cfg.head_dim
    weights = L * (D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F) + D * cfg.vocab
    hand_flops = 2.0 * 8 * weights
    plan = serving_plan(cfg, slots=8, block_size=16, prefill_chunk=32)
    check(abs(dt["static_flops"] - hand_flops) <= 0.02 * hand_flops,
          f"decode step FLOPs {dt['static_flops']} against the hand count {hand_flops}")
    check(dt["static_bytes"] >= weights // 2,
          f"decode step bytes {dt['static_bytes']} under the int4 weights' {weights // 2}")
    bw, peak = xray.peak_bw(), xray.peak_flops()
    ms = dt["device_ns"] / steps / 1e6
    out["decode_step"] = dict(
        replays=steps, ms=ms, flops=dt["flops_total"] / steps,
        bytes=dt["bytes_total"] / steps, static_flops=dt["static_flops"],
        static_bytes=dt["static_bytes"], hand_flops=hand_flops, int4_weight_bytes=weights // 2,
        kv_bytes_per_ctx_token=plan["decode_bytes_per_ctx_token"], mfu=dt["mfu"],
        bw_fraction=dt["bw_fraction"], roofline_fraction=dt["roofline_fraction"],
        peak_flops=peak, peak_bw=bw, dropped=dt["dropped"])
    out["ledger"] = {c: dict(predicted=v["predicted"], measured=v["measured"],
                             ratio=v["ratio"]) for c, v in rep["hbm"]["categories"].items()}
    out["memory_allocated"] = rep["hbm"].get("device_bytes_in_use")
    out["memory_reserved"] = rep["hbm"].get("device_bytes_reserved")
    out["categories_total"] = rep["hbm"]["categories_total"]
    out["eager"] = rep["census"]["eager"]
    # 3. the overhead: this window against the run just before it, and the
    # continuous phase's (both xray off)
    out["tok_s"] = dict(xray_on=r["aggregate_tok_s"], xray_off=off["aggregate_tok_s"],
                        on_window_s=r["window_s"], off_window_s=off["window_s"],
                        continuous_phase=cont["aggregate_tok_s"])
    # 4. the quick-start's bucket census
    out["quickstart"] = xray_quickstart(dev)
    # 5. doctor --gate on the card (the built-in bench pipeline)
    xray.registry.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = doctor.main(["--gate", "--frames", "48"])
    out["doctor"] = buf.getvalue().strip().splitlines()
    check(rc == 0 and out["doctor"][-1] == "doctor: OK", f"doctor --gate: {out['doctor']}")
    # 7. the link
    out["link"] = xray_link(dev)
    return out


def print_xray(x, card):
    p = x["predicted"]
    print(f"xray: deep lint of CONT_DESC in {p['lint_s']:.2f} s, memory_allocated "
          f"{p['memory_allocated'][0]} -> {p['memory_allocated'][1]} bytes; predicted "
          f"{p['programs']} captured step(s), categories {p['by_category']}", flush=True)
    d = x["decode_step"]
    print(f"xray: census drift 0; ledger {x['ledger']}; memory_allocated "
          f"{x['memory_allocated']} (reserved {x['memory_reserved']}) against the "
          f"categories' {x['categories_total']}; eager {x['eager']}", flush=True)
    print(f"xray: decode step (llama2_7b int4, 8 slots) {d['ms']:.3f} ms on the card "
          f"(CUDA events, {d['replays']} replays, {d['dropped']} dropped), "
          f"{d['flops'] / 1e9:.2f} GFLOP and {d['bytes'] / 1e9:.3f} GB a step (static "
          f"{d['static_flops'] / 1e9:.2f} GFLOP against the hand count "
          f"{d['hand_flops'] / 1e9:.2f}; {d['static_bytes'] / 1e9:.3f} GB, int4 weights "
          f"{d['int4_weight_bytes'] / 1e9:.3f}); bandwidth share {d['bw_fraction']:.4f} of "
          f"{d['peak_bw'] / 1e12:.2f} TB/s, FLOP/s share {d['mfu']:.5f} of "
          f"{d['peak_flops'] / 1e12:.0f} TFLOP/s, roofline {d['roofline_fraction']:.4f} "
          f"({card})", flush=True)
    t = x["tok_s"]
    print(f"xray: overhead: {t['xray_on']:.2f} tok/s with xray on ({t['on_window_s']:.2f} s) "
          f"against {t['xray_off']:.2f} off just before ({t['off_window_s']:.2f} s): "
          f"{(t['xray_on'] / t['xray_off'] - 1) * 100:+.2f}%; the continuous phase "
          f"{t['continuous_phase']:.2f} (off, 8 streams); streams equal to the off "
          f"run's {x['streams_equal_off']} of {x['streams']}", flush=True)
    q = x["quickstart"]
    print(f"xray: quick-start {q['stage']} census {q['census']}, drift {q['drift_total']}, "
          f"pad rows {q['pad_waste_rows']:.0f}, pad_waste_flops {q['pad_waste_flops']:.4g}; "
          f"scrape {q['scrape']['family']} buckets {q['scrape']['buckets']}", flush=True)
    print(f"xray: doctor --gate: {' | '.join(x['doctor'])}", flush=True)
    print(f"xray: link device->host (pinned) {x['link']['mbps']:.1f} MB/s "
          f"({card})", flush=True)


def phase_query(dev, serve, cont):
    """The continuous cell over the query wire: the same model, settings,
    prompts and waves as ``phase_continuous``, served by
    ``tensor_query_serversrc ! tensor_filter ! tensor_query_serversink``
    to eight client pipelines over loopback TCP.  Then, un-timed, a client
    that disconnects mid-stream (reaped once, pool free) and one static
    request over the wire (bitwise equal to ``phase_serve``'s).  The
    continuous server runs with ``trace_mode="ring"`` and is returned
    still serving, ``(result, server)``: the ``weave`` phase drives it
    from another process and stops it."""
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
    srv = query_server(QUERY_CUSTOM, 71, trace_mode="ring")
    setup_s = time.perf_counter() - t0
    out = dict(setup_s=setup_s)
    srv.start()
    try:
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
            check(clients[i].first.wait(WAIT_S), f"query stream {i}: no first token")
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
    except BaseException:
        srv.stop()
        raise
    live = srv
    del el, fw, loop

    # un-timed: the static path over the wire, phase_serve's options
    try:
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
    except BaseException:
        live.stop()
        raise
    del srv
    torch.cuda.empty_cache()
    return out, live


#: the weave phase's streams: the query phase's prompts of 32 and 200
#: ids (``continuous_prompts()``), which its in-process clients sent to
#: the same server; the child sends them one after another (four before
#: the dist phase came: PERF.md section 4's cuts)
WEAVE_STREAMS = (0, 1)
WEAVE_TENANT = "weave"
#: the SLO objectives the weave phase's report is held to: met (ten
#: minutes at p50 and p99) and breached (p99 under one microsecond)
WEAVE_MET = dict(p50_ms=600000.0, p99_ms=600000.0)
WEAVE_BREACHED = dict(p99_ms=0.001)


def weave_client(port, prompts_path, ring_path, new):
    """The weave phase's child process (``--weave-client``): ``appsrc !
    tensor_query_client tenant=weave ! tensor_sink`` traced in a ring,
    each prompt sent after the last one's stream ended; dumps its ring to
    ``ring_path`` and prints its tokens and ``locks.report()`` as one
    JSON line.  It needs no card: the caller hides it."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.utils import locks, tracing

    with open(prompts_path) as fh:
        prompts = [np.asarray(p, np.int32) for p in json.load(fh)]
    pipe = ntt.Pipeline(
        f"appsrc name=src ! tensor_query_client port={port} timeout={WAIT_S} "
        f"tenant={WEAVE_TENANT} ! tensor_sink name=out", trace_mode="ring")
    streams = []
    with pipe:
        t0 = time.monotonic()
        for prompt in prompts:
            pipe.push("src", prompt)
            bufs = [pipe.pull("out", timeout=WAIT_S) for _ in range(new)]
            check([b.meta.get("stream_index") for b in bufs] == list(range(new))
                  and bufs[-1].meta.get("stream_last")
                  and not any(b.meta.get("stream_aborted") for b in bufs),
                  "weave client: a stream is not whole")
            streams.append([int(b.tensors[0][0]) for b in bufs])
        window = time.monotonic() - t0
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    spans = tracing.dump_ring(ring_path, proc="client")
    print(json.dumps(dict(streams=streams, window_s=window, spans=spans,
                          epoch=tracing.trace_epoch(), tsan=locks.report())))
    return 0


def cli_env():
    """The environment of the CLI children: the checkout on the path, and
    no proxy between a scrape and ``127.0.0.1``."""
    env = {k: v for k, v in os.environ.items()
           if k.lower() not in ("http_proxy", "https_proxy", "all_proxy")}
    env["NO_PROXY"] = env["no_proxy"] = "127.0.0.1,localhost"
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def run_children(argvs, env):
    """Run each argv as a child process, all at once; ``[(rc, stdout,
    stderr)]`` in order.  Each is waited for at most ``WAIT_S`` and killed
    if it outlives the wait."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for a in argvs]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=WAIT_S)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT_S)
    return out


def phase_weave(dev, srv, prompts, ref, files_dir=None):
    """The front door across two processes: ``srv`` (a query server built
    with ``trace_mode="ring"`` around the llm filter ``llm``, its sink
    ``ssink``, still serving) answers ``prompts`` from a client in a
    child process (``weave_client``, under ``NNS_TPU_TSAN=1``).  ``ref``
    holds the streams an in-process client got for the same prompts from
    the same server.  Checked: the child's streams bitwise equal to
    ``ref``; its tsan report clean; its ring and this process's merged
    by ``tools.trace merge`` (byte for byte the same merge made here,
    which ``tools.trace validate`` and ``summary`` read: valid, aligned,
    two processes with their own epochs, an arrow each way per request,
    every ``query.send`` before its server ``ingress`` within the carried
    uncertainty); and ``tools.slo report --url``
    against this process's ``/metrics``: exit 0 for an objective met, 1
    for one breached, each estimate at or above the exact quantile read
    in process."""
    import shutil

    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4
    from nnstreamer_tpu_torch.utils import profiler, tracing

    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    port = srv.element("ssrc").bound_port
    fw = srv.element("llm").fw
    new = len(ref[0])
    # every path this phase writes carries this process's pid
    work = os.path.join(files_dir or OUT_DIR, f"weave-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    paths = {k: os.path.join(work, k) for k in (
        "prompts.json", "server.ring", "client.ring", "merged.json", "cli_merged.json",
        "met.json", "breached.json")}
    with open(paths["prompts.json"], "w") as fh:
        json.dump([p.tolist() for p in prompts], fh)
    for name, objective in (("met.json", WEAVE_MET), ("breached.json", WEAVE_BREACHED)):
        with open(paths[name], "w") as fh:
            json.dump(dict(tenants=[dict(tenant=WEAVE_TENANT, **objective)],
                           sinks=["ssink"]), fh)
    out, parts = {}, {}

    # the child: its own process, trace epoch and clock
    check(fw.drain(WAIT_S), "weave: the serve loop is busy")
    tracing.recorder.clear()
    env = cli_env()
    env.update(NNS_TPU_TSAN="1", CUDA_VISIBLE_DEVICES="")
    env.pop("NNS_TPU_TSAN_RAISE", None)
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    [(rc, so, se)] = run_children(
        [[sys.executable, os.path.abspath(__file__), "--weave-client", str(port),
          paths["prompts.json"], paths["client.ring"], str(new)]], env)
    parts["child"] = time.perf_counter() - t0
    check(rc == 0, f"weave client exited {rc}: {se[-4000:]}")
    child = json.loads(so.strip().splitlines()[-1])
    check(fw.drain(WAIT_S), "weave: the serve loop did not drain after the child")
    out["launches"] = {k: c.value for k, c in counters.items()}
    check(dev.type != "cuda" or all(v > 0 for v in out["launches"].values()),
          f"weave: a kernel of the path was not launched: {out['launches']}")
    check(child["streams"] == ref,
          "weave: the child's streams differ from the in-process client's")
    tsan = child["tsan"]
    check(tsan["enabled"] and tsan["acquisitions"] > 0
          and "StageQueue._lock" in tsan["locks"],
          f"weave: the child's tsan did not engage: {tsan}")
    check(not tsan["inversions"] and not tsan["guard_violations"],
          f"weave: the child's tsan report is not clean: {tsan}")
    out.update(streams=len(ref), tokens=sum(map(len, ref)),
               tok_s=sum(map(len, ref)) / child["window_s"],
               window_s=child["window_s"], client_spans=child["spans"],
               tsan=dict(acquisitions=tsan["acquisitions"], edges=tsan["edges"],
                         locks=tsan["locks"], inversions=0, guard_violations=0))
    out["server_spans"] = tracing.dump_ring(paths["server.ring"], proc="server")

    # the CLIs, each its own process, all at once: ``trace merge`` of the
    # two rings, ``validate`` and ``summary`` of the same merge made here
    # (the merge's bytes are then held equal to it), and the two SLO
    # reports against this process's /metrics
    merged, _stats = tracing.merge_ring_files([paths["server.ring"], paths["client.ring"]])
    with open(paths["merged.json"], "w") as fh:
        json.dump(merged, fh)
    msrv = profiler.start_metrics_server(0)
    try:
        trace_cli = [sys.executable, "-m", "nnstreamer_tpu_torch.tools.trace"]
        slo_cli = [sys.executable, "-m", "nnstreamer_tpu_torch.tools.slo", "report"]
        url = f"http://127.0.0.1:{msrv.server_port}/metrics"
        t0 = time.perf_counter()
        ((rc, so, se), (v_rc, v_so, v_se), (s_rc, s_so, s_se), (m_rc, m_so, m_se),
         (b_rc, b_so, b_se)) = run_children(
            [trace_cli + ["merge", paths["server.ring"], paths["client.ring"],
                          "--out", paths["cli_merged.json"]],
             trace_cli + ["validate", paths["merged.json"]],
             trace_cli + ["summary", paths["merged.json"]],
             slo_cli + [paths["met.json"], "--url", url, "--interval", "0.5", "--json"],
             slo_cli + [paths["breached.json"], "--url", url, "--interval", "0.5"]],
            cli_env())
        parts["clis"] = time.perf_counter() - t0
    finally:
        profiler.stop_metrics_server(msrv)
    check(rc == 0, f"weave: trace merge exited {rc}: {so}{se[-4000:]}")
    out["merge_line"] = so.strip()
    with open(paths["merged.json"], "rb") as fh, open(paths["cli_merged.json"], "rb") as gh:
        check(fh.read() == gh.read(),
              "weave: trace merge wrote other bytes than the same merge in process")
    check(v_rc == 0 and v_so.startswith("OK:"),
          f"weave: trace validate exited {v_rc}: {v_so}{v_se[-4000:]}")
    check(s_rc == 0 and s_so.split()[:2] == ["stage", "kind"],
          f"weave: trace summary exited {s_rc}: {s_so[:2000]}{s_se[-4000:]}")
    out["summary_rows"] = len(s_so.strip().splitlines()) - 1
    check(m_rc == 0, f"weave: slo report of a met objective exited {m_rc}: "
          f"{m_so}{m_se[-4000:]}")
    check(b_rc == 1 and "BREACH" in b_so,
          f"weave: slo report of a breached objective exited {b_rc}: {b_so}{b_se[-4000:]}")
    est = json.loads(m_so)["tenants"][WEAVE_TENANT]
    exact = {q: metrics.percentile("ssink.e2e_latency", q, tenant=WEAVE_TENANT) * 1e3
             for q in (50, 99)}
    check(est["requests"] > 0 and est["p50_ms"] >= exact[50] and est["p99_ms"] >= exact[99],
          f"weave: slo estimates {est} below the exact quantiles {exact}")
    out["slo"] = dict(requests=est["requests"], p50_ms=est["p50_ms"], p99_ms=est["p99_ms"],
                      exact_p50_ms=exact[50], exact_p99_ms=exact[99], met_rc=m_rc,
                      breached_rc=b_rc)

    # the merged trace
    out["merged"] = weave_merged_checks(merged, child["epoch"], tracing.trace_epoch(),
                                        len(prompts))
    rings, spans, arrows = map(int, re.search(
        r"(\d+) rings, (\d+) spans, (\d+) cross-wire arrows", out["merge_line"]).groups())
    check(rings == 2 and spans == out["server_spans"] + out["client_spans"]
          and arrows == out["merged"]["arrows"],
          f"weave: merge printed {out['merge_line']!r}")
    out["merged"].update(rings=rings, spans=spans)
    out["parts_s"] = parts
    shutil.rmtree(work)
    return out


def print_weave(w):
    """The weave phase's lines."""
    m, slo = w["merged"], w["slo"]
    print(f"weave: merge {m['rings']} rings, {m['spans']} spans, {m['arrows']} "
          f"cross-wire arrows ({m['requests']} requests, an arrow each way), "
          f"aligned offsets {m['aligned_offset_ns']} ns", flush=True)
    print(f"weave: largest clock uncertainty {m['max_uncertainty_us']:.1f} us", flush=True)
    print(f"weave: the child received {w['tokens']} tokens in {w['window_s']:.2f} s, "
          f"{w['tok_s']:.2f} tok/s ({w['streams']} streams one after another, bitwise "
          f"equal to the in-process clients' of the query phase); "
          f"its tsan {w['tsan']}; launches {w['launches']}; parts (s) {w['parts_s']}",
          flush=True)
    print(f"weave: slo report p50 {slo['p50_ms']} ms (exact {slo['exact_p50_ms']:.3f}), "
          f"p99 {slo['p99_ms']} ms (exact {slo['exact_p99_ms']:.3f}) over "
          f"{slo['requests']} tokens; met exit {slo['met_rc']}, breached exit "
          f"{slo['breached_rc']}; summary {w['summary_rows']} rows", flush=True)


def weave_merged_checks(merged, client_epoch, server_epoch, requests):
    """The merged trace of one server and one client ring: two processes
    with their own epochs, both aligned; for each of the client's
    ``requests`` requests an arrow client -> server and one server ->
    client, and its ``query.send`` no later than the server's adopted
    ``ingress`` plus the arrow's uncertainty.  Returns the counts."""
    evs = merged["traceEvents"]
    align = merged["otherData"]["weave"]
    check(len(align) == 2 and all(a["aligned"] for a in align),
          f"weave: merged trace not aligned: {align}")
    check({a["epoch"] for a in align} == {client_epoch, server_epoch}
          and client_epoch != server_epoch, f"weave: epochs {align}")
    pids = {e["args"]["name"].split(" epoch=")[0]: e["pid"] for e in evs
            if e.get("ph") == "M" and e["name"] == "process_name"}
    check(sorted(pids) == ["client", "server"] and len(set(pids.values())) == 2,
          f"weave: processes {pids}")
    cpid, spid = pids["client"], pids["server"]
    tids = {e["pid"]: set() for e in evs if e.get("ph") in ("X", "i")}
    for e in evs:
        if e.get("ph") in ("X", "i") and "trace_id" in e.get("args", {}):
            tids[e["pid"]].add(e["args"]["trace_id"])
    minted = {pid: {t for t in tids.get(pid, ()) if t >> 32 == ep}
              for pid, ep in ((cpid, client_epoch), (spid, server_epoch))}
    check(minted[cpid] and not (minted[cpid] & minted[spid]),
          "weave: the processes' trace ids overlap")
    sends = {e["args"]["trace_id"]: e for e in evs
             if e.get("name") == "query.send" and e["pid"] == cpid}
    check(len(sends) == requests, f"weave: {len(sends)} client query.send spans, "
          f"not {requests}")
    starts = {e["id"]: e for e in evs if e.get("ph") == "s"}
    finishes = {e["id"]: e for e in evs if e.get("ph") == "f"}
    check(set(starts) == set(finishes), "weave: unpaired flow events")
    ways = {}
    for i, st in starts.items():
        ways.setdefault(st["args"]["trace_id"], set()).add((st["pid"], finishes[i]["pid"]))
    worst_us = 0.0
    for tid, send in sends.items():
        check(ways.get(tid, set()) >= {(cpid, spid), (spid, cpid)},
              f"weave: request {tid:#x} lacks an arrow each way: {ways.get(tid)}")
        ingress = [e for e in evs if e.get("name") == "ingress" and e["pid"] == spid
                   and e.get("args", {}).get("trace_id") == tid]
        unc_us = max(st["args"]["uncertainty_ns"] for st in starts.values()
                     if st["args"]["trace_id"] == tid) / 1e3
        worst_us = max(worst_us, unc_us)
        check(ingress and send["ts"] <= min(e["ts"] for e in ingress) + unc_us,
              f"weave: request {tid:#x}: query.send at {send['ts']} us after the "
              f"server's ingress {[e['ts'] for e in ingress]} beyond {unc_us} us")
    client = [a for a in align if a["epoch"] == client_epoch][0]
    check(abs(client["offset_ns"]) <= client["uncertainty_ns"],
          f"weave: both processes read this host's one monotonic clock, but the "
          f"client's offset {client['offset_ns']} ns exceeds its uncertainty "
          f"{client['uncertainty_ns']} ns")
    return dict(events=len(evs), arrows=len(starts), requests=requests,
                max_uncertainty_us=worst_us,
                aligned_offset_ns={a["proc"]: a["offset_ns"] for a in align})


class EagerLaunches:
    """Kernel launches of the eager ``llama.forward_paged`` calls (prefill
    chunks and the draft's prefill twin; a captured step's replays do not
    call it), by model: the growth of each launch counter across each
    call, keyed ``"dim<dim>_layers<n_layers>"``.  While a pipeline serves
    here its serve thread is the only one that launches, so a call's
    growth is that call's own.  A context manager: inside it
    ``llama.forward_paged`` is wrapped."""

    def __init__(self, counters):
        self.counters = counters
        self.by_model = {}

    def __enter__(self):
        from nnstreamer_tpu_torch.models import llama

        real = self._real = llama.forward_paged

        def counted(*args, **kw):
            cfg = kw["cfg"] if "cfg" in kw else args[5]
            before = {k: c.value for k, c in self.counters.items()}
            out = real(*args, **kw)
            tally = self.by_model.setdefault(f"dim{cfg.dim}_layers{cfg.n_layers}", {})
            for k, c in self.counters.items():
                tally[k] = tally.get(k, 0) + c.value - before[k]
            return out

        llama.forward_paged = counted
        return self

    def __exit__(self, *exc):
        from nnstreamer_tpu_torch.models import llama

        llama.forward_paged = self._real


#: the loop's serving timeline series (filters/llm.py ``_ContinuousLoop``)
TIMELINE = ("ttft_ms", "itl_ms", "queue_ms", "prefill_ms", "decode_ms")


def serve_traffic(desc, prompts, groups, max_new, dev, inside=None, around=None,
                  trace_mode=None, xray=False, pipe_kw=None):
    """Serve ``prompts`` through the continuous pipeline ``desc`` (its
    filter named ``llm``) in ``groups``: each ``(indices, wait)`` is pushed
    at once, and the next group follows when each of its streams has its
    first token (``wait="first"``) or all of them (``"all"``).  Launch
    counters and the peak memory are reset after the loop's warm-up and
    read after the drain; ``around`` (a context manager, e.g. a profiler)
    is entered just before the first push and left after the drain;
    ``inside(fw, loop, result)`` runs before the pipeline closes, outside
    the counted run; ``trace_mode`` and ``xray`` are the pipeline's (with
    xray on, ``result["explain"]`` is ``Pipeline.explain()`` after the
    drain).  Every stream must
    be whole and in order, none aborted, the block pool free again with
    every count 0, and no capture may follow the warm-up.  Each stream
    carries a tenant of its own, so the loop's tenant-labelled timeline
    (``llm.serve.ttft_ms`` ...) reads per stream: one TTFT per stream, no
    later than its first token at the sink.  Returns the streams' ids,
    first token at the sink (push to pull) and in the loop, decode tok/s,
    prefill chunks per ``"all"`` group, the loop's stats, launches (in
    all, by captured step and by model of the eager calls), the growth of
    the ``llm.serve`` counters, the census line, the timeline's p50 / p99
    / count per series, the seconds and peak memory of the pipeline's
    construction (the model's load) and the aggregate tok/s over the
    window.  ``pipe_kw``: more ``Pipeline`` arguments (the mesh phase's
    ``model_parallel``)."""
    import contextlib

    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    names = {id(c): k for k, c in counters.items()}
    n = len(prompts)
    got = {i: [] for i in range(n)}
    pushed, first_at, group_chunks = {}, {}, []
    tenants = [f"run{time.monotonic_ns()}.{i}" for i in range(n)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pipe = ntt.Pipeline(desc, trace_mode=trace_mode, xray=xray, **(pipe_kw or {}))
    res = dict(setup_s=time.perf_counter() - t0)
    res["setup_peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None)

    def pull_one():
        buf = pipe.pull("out", timeout=WAIT_S)
        r = buf.meta["req"]
        got[r].append(buf)
        first_at.setdefault(r, time.perf_counter())

    with pipe, EagerLaunches(counters) as eager:
        fw = pipe.element("llm").fw
        t0 = time.perf_counter()
        loop = fw.serve_loop()
        res["warmup_s"] = time.perf_counter() - t0
        warm_captures = fw.census.captures
        before = {k: v for k, v in metrics.snapshot().items()
                  if k.startswith("llm.serve.")}
        for c in counters.values():
            c.reset()
        eager.by_model.clear()
        census0 = {sig: dict(t) for sig, t in fw.census.launches.items()}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stats0 = dict(loop.stats)
        with around if around is not None else contextlib.nullcontext():
            t_start = time.perf_counter()
            for group, wait in groups:
                c0 = loop.stats["prefill_chunks"]
                for i in group:
                    pushed[i] = time.perf_counter()
                    pipe.push("src", ntt.Buffer([prompts[i]], meta={
                        "req": i, "_tenant": tenants[i]}))
                need = 1 if wait == "first" else max_new
                while any(len(got[i]) < need for i in group):
                    pull_one()
                if wait == "all":
                    group_chunks.append(loop.stats["prefill_chunks"] - c0)
            while sum(len(v) for v in got.values()) < n * max_new:
                pull_one()
            t_end = time.perf_counter()
            pipe.eos("src")
            pipe.wait(timeout=WAIT_S)  # the loop has drained: nothing in flight
            if dev.type == "cuda":
                torch.cuda.synchronize()
            res["drained_s"] = time.perf_counter() - t_start
        res["launches"] = {k: c.value for k, c in counters.items()}
        res["step_launches"] = {
            str(sig): {names[id(c)]: v - census0.get(sig, {}).get(c, 0)
                       for c, v in t.items()}
            for sig, t in fw.census.launches.items()}
        res["eager_launches"] = {m: dict(t) for m, t in eager.by_model.items()}
        res["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None)
        res["stats"] = {k: loop.stats[k] - stats0[k] for k in stats0}
        res["census"] = census_of(fw.census, warm_captures)
        after = metrics.snapshot()
        res["serve_counters"] = {k: v - before.get(k, 0.0) for k, v in after.items()
                                 if k.startswith("llm.serve.")
                                 and not k.endswith("accept_rate")}
        res["pool_free"] = (sorted(loop._free) == list(range(loop.n_blocks))
                            and bool((loop._ref == 0).all())
                            and bool((loop._tables == loop.sentinel).all())
                            and bool((loop._pos == loop.park).all()))
        res["n_blocks"], res["indexed_blocks"] = loop.n_blocks, len(loop._prefix_index)
        res["ids"] = [[int(b.tensors[0][0]) for b in got[i]] for i in range(n)]
        if xray:
            res["explain"] = pipe.explain()
        if inside is not None:
            inside(fw, loop, res)
    check(res["pool_free"], "block pool not free after the drain, or a count left")
    # every launch of the run is a captured step's or an eager call's
    for k in counters:
        parts = sum(t.get(k, 0) for t in res["step_launches"].values()) + \
            sum(t.get(k, 0) for t in res["eager_launches"].values())
        check(parts == res["launches"][k],
              f"{k}: {res['launches'][k]} launches, {parts} by step and model")
    for i in range(n):
        bufs = got[i]
        check(len(bufs) == max_new, f"stream {i}: {len(bufs)} tokens")
        for j, buf in enumerate(bufs):
            ids = buf.tensors[0]
            check(ids.dtype == np.int32 and ids.shape == (1,)
                  and 0 <= int(ids[0]) < 32000, f"bad token buffer {ids!r}")
            check(buf.meta.get("stream_index") == j,
                  f"stream {i}: stream_index out of order")
            check(bool(buf.meta.get("stream_last")) == (j == max_new - 1),
                  f"stream {i}: stream_last misplaced")
            check(not buf.meta.get("stream_aborted"), f"stream {i} aborted")
    res["ttft_ms"] = [(first_at[i] - pushed[i]) * 1e3 for i in range(n)]
    loop_ttft = [metrics.reservoir("llm.serve.ttft_ms", t) for t in tenants]
    check(all(len(v) == 1 for v in loop_ttft),
          f"loop TTFT samples per stream {[len(v) for v in loop_ttft]}, want one each")
    res["loop_ttft_ms"] = [v[0] for v in loop_ttft]
    late = [i for i in range(n) if res["loop_ttft_ms"][i] > res["ttft_ms"][i]]
    check(not late, f"streams {late}: the loop's TTFT is later than the sink's first token")
    res["timeline"] = {}
    for name in TIMELINE:
        vals = [x for t in tenants for x in metrics.reservoir(f"llm.serve.{name}", t)]
        res["timeline"][name] = dict(p50=float(np.percentile(vals, 50)),
                                     p99=float(np.percentile(vals, 99)), n=len(vals))
    res["decode_tok_s"] = [(max_new - 1) / (got[i][-1].meta["emit_t"]
                                            - got[i][0].meta["emit_t"])
                           for i in range(n)]
    res["spec_draft"] = [[b.meta.get("spec_draft") for b in got[i]] for i in range(n)]
    res["group_chunks"] = group_chunks
    res["window_s"] = t_end - t_start
    res["aggregate_tok_s"] = n * max_new / (t_end - t_start)
    return res


#: the prefix phase: one 512-token system prompt and eight distinct
#: suffixes of 8..64 tokens (seed 0), 64 tokens each, through the
#: continuous cell's options with prefix sharing at its default (on)
PREFIX_SYSTEM = 512
PREFIX_SUFFIXES = (8, 16, 24, 32, 40, 48, 56, 64)
#: the fork sub-case: prefill_chunk 24 starts a hit's suffix at 504, inside
#: block 31 (block_size 16), which is forked; three streams of 32 tokens
#: streams the prefix_cache:0 run serves, held bitwise against the sharing run
PREFIX_OFF_STREAMS = 4
PREFIX_FORK_CHUNK = 24
PREFIX_FORK_STREAMS = 3
PREFIX_FORK_NEW = 32


def prefix_prompts():
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(0)
    system = torch.randint(3, 32000, (PREFIX_SYSTEM,), generator=gen)
    return [np.concatenate([system.to(torch.int32).numpy(), torch.randint(
        3, 32000, (n,), generator=gen).to(torch.int32).numpy()])
        for n in PREFIX_SUFFIXES]


def check_cell_launches(r, int4=True, tag="continuous", layers=N_LAYERS):
    """A continuous run's launches: paged one per layer per decode step,
    flash one per layer per prefill chunk and, with int4 weights, the int4
    matmul four per layer and one more (129 at 32 layers) per step or
    chunk (none without)."""
    steps, chunks = r["stats"]["decode_steps"], r["stats"]["prefill_chunks"]
    want = dict(paged_attention=layers * steps, flash_attention=layers * chunks,
                matmul_int4=(4 * layers + 1) * (steps + chunks) if int4 else 0)
    check(r["launches"] == want, f"{tag} launches {r['launches']} != {want}")


def span_counts(t0_ns):
    """The loop's spans (stage ``llm.serve``) in the process's flight
    recorder since ``t0_ns``, by kind."""
    from nnstreamer_tpu_torch.utils import tracing

    out = {}
    for e in tracing.recorder.events():
        if e.stage == "llm.serve" and e.ts >= t0_ns:
            out[e.kind] = out.get(e.kind, 0) + 1
    return out


def phase_prefix(dev, base=CONT_DESC):
    """Prefix sharing at llama2_7b int4 (``base``: the continuous cell's
    pipeline): the first stream prefills the system prompt cold and
    alone; the second, alone after it, hits the 32 blocks it left resting
    in the free list; the other six hit together.  The first
    ``PREFIX_OFF_STREAMS`` streams through ``prefix_cache:0`` (cold, alone,
    then together) must give the same tokens bitwise.  Then
    the fork sub-case at ``prefill_chunk:24``, on and off.  Last, the cold
    stream and the first hit once more under ``trace_mode="ring"``: its
    ``serve.admit``, ``serve.prefix_hit`` and ``serve.prefill_chunk`` spans
    must number the admissions, hits and chunks, and its tokens equal the
    untraced run's."""
    import math

    from nnstreamer_tpu_torch.utils import tracing

    prompts = prefix_prompts()
    groups = [([0], "all"), ([1], "all"), (list(range(2, len(prompts))), "all")]
    on = serve_traffic(base, prompts, groups, MAX_NEW, dev)
    # prefix_cache:0 serves the first four streams (cold, alone, then two
    # together; the other four are cut to keep the run inside its budget)
    off = serve_traffic(base.replace("stream_chunk:8", "stream_chunk:8,prefix_cache:0"),
                        prompts[:PREFIX_OFF_STREAMS],
                        [([0], "all"), ([1], "all"),
                         (list(range(2, PREFIX_OFF_STREAMS)), "all")], MAX_NEW, dev)
    cold_chunks = math.ceil(len(prompts[0]) / 32)
    hit_chunks = [math.ceil((len(p) - PREFIX_SYSTEM) / 32) for p in prompts[1:]]
    check(on["group_chunks"] == [cold_chunks, hit_chunks[0], sum(hit_chunks[1:])],
          f"prefill chunks {on['group_chunks']}, want {cold_chunks}, "
          f"{hit_chunks[0]}, {sum(hit_chunks[1:])}")
    check(off["group_chunks"][1] == math.ceil(len(prompts[1]) / 32),
          f"prefix_cache:0 prefill chunks {off['group_chunks']}")
    sc = on["serve_counters"]
    check(sc.get("llm.serve.prefix_hits") == len(prompts) - 1
          and sc.get("llm.serve.prefix_hit_blocks")
          == (len(prompts) - 1) * PREFIX_SYSTEM // 16,
          f"prefix counters {sc}")
    check(not off["serve_counters"].get("llm.serve.prefix_hits"),
          "prefix_cache:0 hit the cache")
    equal = [a == b for a, b in zip(on["ids"][:PREFIX_OFF_STREAMS], off["ids"])]
    check(all(equal), f"tokens with sharing against prefix_cache:0: {equal}")
    for r in (on, off):
        check_cell_launches(r, tag="prefix")
        check(r["census"]["signatures"] == ["('continuous', 8, 'bfloat16', False)"],
              f"prefix census: {r['census']}")
    fork_desc = base.replace("prefill_chunk:32", f"prefill_chunk:{PREFIX_FORK_CHUNK}") \
        .replace(f"max_new:{MAX_NEW}", f"max_new:{PREFIX_FORK_NEW}")
    fprompts = prompts[:PREFIX_FORK_STREAMS]
    fgroups = [([i], "all") for i in range(PREFIX_FORK_STREAMS)]
    fork_on = serve_traffic(fork_desc, fprompts, fgroups, PREFIX_FORK_NEW, dev)
    fork_off = serve_traffic(fork_desc.replace("stream_chunk:8",
                                               "stream_chunk:8,prefix_cache:0"),
                             fprompts, fgroups, PREFIX_FORK_NEW, dev)
    forks = fork_on["serve_counters"].get("llm.serve.cow_forks", 0)
    check(forks >= 1, f"fork sub-case: {forks} forks")
    fork_equal = [a == b for a, b in zip(fork_on["ids"], fork_off["ids"])]
    check(all(fork_equal), f"fork sub-case tokens against prefix_cache:0: {fork_equal}")
    # the traced run serves the cold stream and the first hit (the other six
    # are cut to keep the run inside its budget)
    t0 = time.monotonic_ns()
    ring = serve_traffic(base, prompts[:2], groups[:2], MAX_NEW, dev, trace_mode="ring")
    spans = span_counts(t0)
    tracing.recorder.configure("off")  # later phases run untraced
    want = {"serve.admit": 2,
            "serve.prefix_hit": ring["serve_counters"].get("llm.serve.prefix_hits"),
            "serve.prefill_chunk": ring["stats"]["prefill_chunks"]}
    check({k: spans.get(k) for k in want} == want,
          f"ring-traced prefix run: spans {spans}, want {want}")
    check(ring["ids"] == on["ids"][:2],
          "ring-traced prefix run: tokens differ from untraced")
    return dict(on=on, off=off, cold_chunks=on["group_chunks"][0],
                hit_chunks=[on["group_chunks"][1]] + hit_chunks[1:],
                streams_equal=sum(equal), fork_on=fork_on, fork_off=fork_off,
                cow_forks=forks, fork_streams_equal=sum(fork_equal), ring=ring,
                ring_spans=spans)


#: the spec phase: the continuous cell with a llama_tiny draft proposing
#: three tokens a round ([8, 4] verify: 32 int4 rows, the paged kernel at
#: G = 1), and the same with sampling
SPEC_K = 3
SPEC_OPTS = f",draft:llama_tiny,spec_k:{SPEC_K},draft_seed:7"
SPEC_SAMPLED = ",temperature:0.8,seed:1"
#: the sampled runs serve the first wave's first streams
SPEC_SAMPLED_WAVE = 2
#: speculative greedy tokens against plain greedy ones: the [8, 4] verify
#: and the [8, 1] decode step are two bf16 evaluations that round in
#: different places (other int4 and paged launch plans), so a step is a
#: near tie when its top-1/top-2 gap is under the repo's bf16 logits
#: tolerance (BF16_REF_TOL: twice the spread of two such evaluations)
SPEC_TIE = BF16_REF_TOL
#: each stream is also evaluated in f32 over the same weights: the verify
#: shape's bf16 logits may lie at most this many times as far from f32 as
#: the decode shape's (llama2_7b int4, random weights, on an H100: each
#: 8.5-11.8% of max |logit| at its worst step, PERF.md section 6)
SPEC_F32_RATIO = 1.3
#: the streams replayed outside the loop, each at the verify and at the
#: decode shape, and in f32 at both: the first wave's shortest prompt (the
#: replays are eager and host-bound, and a long prompt's prefill chunks
#: cost the most of them; one stream since the modelfiles phase came)
SPEC_REPLAYED = (0,)
#: the accept path: llama_small at f32 (params and compute), no quant, its
#: draft the same preset from the same seed, so the same weights
ACCEPT_DESC = ("appsrc name=src ! tensor_filter name=llm framework=llm "
               "model=llama_small custom=param_dtype:float32,dtype:float32,"
               "max_new:32,serve:continuous,slots:8,block_size:16,"
               "prefill_chunk:32,stream_chunk:8{opts} invoke-dynamic=true ! "
               "tensor_sink name=out")
ACCEPT_LENS = (16, 40, 75, 130)


def continuous_prompts():
    """phase_continuous's prompts (the same generator and seed)."""
    import torch

    gen = torch.Generator().manual_seed(2)
    return [torch.randint(3, 32000, (n,), generator=gen).to(torch.int32).numpy()
            for wave in CONT_WAVES for n in wave]


def step_state(fw, dev, cfgs, spare=128):
    """Fresh static tensors for a decode-shaped step captured outside the
    loop, at the filter's shapes: the 8-slot tables and positions with
    the slots at ``GRAPH_POS`` (one parked), each live slot's blocks
    reaching ``spare`` positions past it (the timed replays advance
    there), a random pool per config of ``cfgs``, random tokens, the
    live mask and per-slot generators."""
    import torch

    from nnstreamer_tpu_torch.filters import llm as tllm
    from nnstreamer_tpu_torch.models import llama

    B, bs = fw.slots, fw.block_size
    plan = tllm.serving_plan(fw.cfg, slots=B, block_size=bs,
                             prefill_chunk=fw.prefill_chunk,
                             draft_cfg=fw.draft_cfg, spec_k=fw.spec_k)
    n_blocks, max_blocks = plan["n_blocks"], plan["max_blocks"]
    park = max_blocks * bs
    tables = torch.full((B, max_blocks), n_blocks, dtype=torch.int32)
    pos = torch.full((B,), park, dtype=torch.long)
    used = 0
    for s, p in enumerate(GRAPH_POS):
        if p is not None:
            need = -(-(p + spare) // bs)
            tables[s, :need] = torch.arange(used, used + need, dtype=torch.int32)
            used += need
            pos[s] = p
    gen = torch.Generator(device=dev).manual_seed(21)
    pools = []
    for c in cfgs:
        pool = llama.init_paged_cache(c, n_blocks, bs, dtype=fw.dtype, device=dev)
        for t in pool.values():
            t.normal_(generator=gen)
        pools.append(pool)
    pos = pos.to(dev)
    return dict(pools=pools, tables=tables.to(dev), pos=pos, park=park, live=pos < park,
                tok=torch.randint(3, fw.cfg.vocab, (B,), dtype=torch.int32, device=dev,
                                  generator=gen),
                gens=[torch.Generator(device=dev) for _ in range(B)])


def decode_step_ms(fw, dev):
    """The loop's decode step (``paged_decode_step``, greedy) captured over
    fresh tensors (``step_state``) at the filter's shapes and weights:
    device ms per replay (``timed_ms``).  Launches here are held back
    from the counters."""
    import torch

    from nnstreamer_tpu_torch.filters import llm as tllm
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.pipeline.graphs import Census

    st = step_state(fw, dev, [fw.cfg])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    with torch.inference_mode(), kernels.held_launches():
        decode = Census(dev).capture("decode", tllm.paged_decode_step(
            fw.bundle.params, fw.cfg, fw.dtype, st["pools"][0], st["tok"], st["pos"],
            st["tables"], st["live"], st["gens"], 0.0))
        return timed_ms(decode.replay, flush)[0]


def spec_round_ms(fw, dev):
    """A speculative round's captured steps (propose, verify) against the
    plain decode step, all three captured by a census of their own over
    fresh tensors at the filter's shapes (``step_state``: the 7B 8-slot
    step with the slots at ``GRAPH_POS``, one parked, random pools and
    tokens).  Each is timed by ``timed_ms`` (device ms per replay, the
    same flush); the timed replays advance the positions into blocks
    reserved for them.  Launches here are held back from the counters."""
    import torch

    from nnstreamer_tpu_torch.filters import llm as tllm
    from nnstreamer_tpu_torch.ops import kernels
    from nnstreamer_tpu_torch.pipeline.graphs import Census

    cfg, dcfg, B, k = fw.cfg, fw.draft_cfg, fw.slots, fw.spec_k
    st = step_state(fw, dev, [cfg, dcfg])
    (pool, dpool), tables, pos, park = st["pools"], st["tables"], st["pos"], st["park"]
    tok, gens = st["tok"], st["gens"]
    tok_prev = tok.clone()
    props = torch.zeros((B, k), dtype=torch.int32, device=dev)
    out = torch.zeros((B, k + 2), dtype=torch.int32, device=dev)
    census = Census(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    with torch.inference_mode(), kernels.held_launches():
        propose = census.capture("propose", tllm.spec_propose_step(
            fw.draft_bundle.params, dcfg, fw.dtype, dpool, tok, tok_prev, pos, tables,
            props, None, gens, park, 0.0))
        verify = census.capture("verify", tllm.spec_verify_step(
            fw.bundle.params, cfg, fw.dtype, pool, tok, tok_prev, pos, tables, props,
            None, out, gens, park, 0.0))
        decode = census.capture("decode", tllm.paged_decode_step(
            fw.bundle.params, cfg, fw.dtype, pool, tok, pos, tables, st["live"], gens, 0.0))

        def round_():
            propose.replay()
            verify.replay()

        times = {name: timed_ms(fn, flush)[0] for name, fn in (
            ("propose_ms", propose.replay), ("verify_ms", verify.replay),
            ("round_ms", round_), ("decode_step_ms", decode.replay))}
    times["round_per_decode_step"] = times["round_ms"] / times["decode_step_ms"]
    return times


def phase_spec(dev, cont, base=CONT_DESC, accept_desc=ACCEPT_DESC,
               replayed_streams=SPEC_REPLAYED):
    """Speculative decoding at llama2_7b int4 with the llama_tiny draft, on
    the continuous cell's prompts and waves: greedy tokens held against
    the continuous phase's (``cont``) by the near-tie rule, the accept
    rate, rounds, target dispatches per token and tok/s beside the
    continuous cell's; a sampled run twice, bitwise; the accept path at
    llama_small with a same-weights draft.  ``replayed_streams`` are
    replayed outside the loop, in bf16 and in f32."""
    import torch

    prompts = continuous_prompts()
    first = len(CONT_WAVES[0])
    groups = [(list(range(first)), "first"), (list(range(first, len(prompts))), "first")]
    desc = base.replace("stream_chunk:8", "stream_chunk:8" + SPEC_OPTS)
    plain = [r["ids"] for r in cont["streams"]]
    replayed, verify_replayed, rounding, step_ms, models = {}, {}, {}, {}, {}

    def rule(fw, loop, res):
        models.update({m: f"dim{c.dim}_layers{c.n_layers}"
                       for m, c in (("target", fw.cfg), ("draft", fw.draft_cfg))})
        for i in replayed_streams:
            ids = res["ids"][i]
            # the loop's own arithmetic: each stream replayed at the verify
            # shape (a row's result does not depend on the other rows), so
            # only a gap at rounding level is a near tie
            v = replay_stream(fw, loop, prompts[i], ids, dev, width=SPEC_K + 1,
                              keep_rows=True)
            # the rule against plain greedy decode: the decode shape, the
            # continuous cell's tokens, bf16 near ties
            d = replay_stream(fw, loop, prompts[i], ids, dev, tie_share=SPEC_TIE,
                              other=plain[i], keep_rows=True)
            # the same weights in f32, teacher-forced alike, at the decode
            # shape and at the verify shape: the two f32 evaluations must
            # agree to f32 rounding (a fault of the verify shape, a wrong
            # mask, position or block, would show there too), and each
            # bf16 shape's distance from f32 is its rounding
            f = replay_stream(fw, loop, prompts[i], ids, dev, tie_share=SPEC_TIE,
                              other=plain[i], keep_rows=True, dtype="float32")
            fv = replay_stream(fw, loop, prompts[i], ids, dev, width=SPEC_K + 1,
                               tie_share=SPEC_TIE, keep_rows=True, dtype="float32")
            rows = {k: r.pop("rows") for k, r in (("verify", v), ("decode", d),
                                                  ("f32", f), ("f32_verify", fv))}

            def dist(a, b):
                errs = [(x - y).abs().max().item() / z.abs().max().item()
                        for x, y, z in zip(rows[a], rows[b], rows["f32"])]
                return dict(max=max(errs), mean=sum(errs) / len(errs), steps=errs)

            r = dict(verify_to_f32=dist("verify", "f32"),
                     decode_to_f32=dist("decode", "f32"),
                     verify_to_decode=dist("verify", "decode"),
                     f32_verify_to_f32=dist("f32_verify", "f32"),
                     f32_tokens_equal_to_argmax=f["equal_to_argmax"])
            check(r["f32_verify_to_f32"]["max"] <= REF_TOL,
                  f"stream {i}: in f32 the verify and the decode shape differ by "
                  f"{r['f32_verify_to_f32']['max']} > {REF_TOL} of max |logit|")
            # in bf16 the verify shape may lie no farther from f32 than the
            # decode shape's rounding does (a fault of the bf16 kernels at
            # the verify shape moves its logits by 15% or more)
            check(r["verify_to_f32"]["max"] <= SPEC_F32_RATIO * r["decode_to_f32"]["max"],
                  f"stream {i}: bf16 verify lies {r['verify_to_f32']['max']} from f32, "
                  f"decode {r['decode_to_f32']['max']}")
            fd = d["first_difference"]
            if fd is not None:
                # where spec and plain part, the context is still shared:
                # which of the two tokens does the f32 evaluation prefer
                row = rows["f32"][fd]
                gap = (row[ids[fd]] - row[plain[i][fd]]).item() / row.abs().max().item()
                r["f32_at_difference"] = dict(
                    step=fd, prefers="spec" if gap > 0 else "plain",
                    spec_minus_plain=gap)
            rounding[i] = r
            verify_replayed[i], replayed[i] = v, d
        step_ms.update(spec_round_ms(fw, dev))

    greedy = serve_traffic(desc, prompts, groups, MAX_NEW, dev, inside=rule)
    rounds, chunks = greedy["stats"]["spec_rounds"], greedy["stats"]["prefill_chunks"]
    check(greedy["stats"]["decode_steps"] == 0, "the decode step ran beside speculation")
    want = dict(paged_attention=rounds * (N_LAYERS + 2 * (SPEC_K + 1)),
                flash_attention=chunks * (N_LAYERS + 2),
                matmul_int4=129 * (rounds + chunks))
    check(greedy["launches"] == want, f"spec launches {greedy['launches']} != {want}")
    sigs = ["('propose', 8, 3, 'bfloat16', False)", "('verify', 8, 3, 'bfloat16', False)"]
    check(greedy["census"]["signatures"] == sigs, f"spec census: {greedy['census']}")
    # the new shapes' launches, as counted: by captured step, and the
    # draft's eager prefill twin by model
    steps_l, eager_l = greedy["step_launches"], greedy["eager_launches"]
    propose_l, verify_l = steps_l.get(sigs[0], {}), steps_l.get(sigs[1], {})
    draft_l = eager_l.get(models["draft"], {})
    spec_launches = dict(
        matmul_int4={"verify_8x4_32_rows": verify_l.get("matmul_int4", 0)},
        flash_attention={"draft_prefill_d32": draft_l.get("flash_attention", 0)},
        paged_attention={"verify_8x4_g1": verify_l.get("paged_attention", 0),
                         "propose_draft_8x1_g2_d32": propose_l.get("paged_attention", 0)})
    expected = dict(
        matmul_int4={"verify_8x4_32_rows": 129 * rounds},
        flash_attention={"draft_prefill_d32": 2 * chunks},
        paged_attention={"verify_8x4_g1": N_LAYERS * rounds,
                         "propose_draft_8x1_g2_d32": 2 * (SPEC_K + 1) * rounds})
    if dev.type == "cuda":
        check(spec_launches == expected,
              f"spec launches by shape {spec_launches} != {expected}")
    sc = greedy["serve_counters"]
    acc, rej = sc.get("llm.serve.spec_accepted", 0), sc.get("llm.serve.spec_rejected", 0)
    pairs = (acc + rej) / SPEC_K  # (stream, round) pairs
    flags = [f[1:] for f in greedy["spec_draft"]]
    check(all(set(f) <= {0, 1} for f in flags), "spec_draft missing on a round token")
    sampled = [serve_traffic(desc.replace("stream_chunk:8", "stream_chunk:8" + SPEC_SAMPLED),
                             prompts[:SPEC_SAMPLED_WAVE],
                             [(list(range(SPEC_SAMPLED_WAVE)), "first")], MAX_NEW, dev)
               for _ in range(2)]
    check(sampled[0]["ids"] == sampled[1]["ids"], "sampled speculation: two runs differ")
    for r in sampled:
        check(r["census"]["signatures"] == [x.replace("False", "True") for x in sigs],
              f"sampled spec census: {r['census']}")
    gen = torch.Generator().manual_seed(3)
    small = [torch.randint(3, 2048, (n,), generator=gen).to(torch.int32).numpy()
             for n in ACCEPT_LENS]
    sgroups = [(list(range(len(small))), "first")]
    accept = serve_traffic(accept_desc.format(opts=",draft:llama_small,spec_k:3,draft_seed:0"),
                           small, sgroups, 32, dev)
    accept_plain = serve_traffic(accept_desc.format(opts=""), small, sgroups, 32, dev)
    asc = accept["serve_counters"]
    a_acc, a_rej = asc.get("llm.serve.spec_accepted", 0), asc.get("llm.serve.spec_rejected", 0)
    # the draft is the target: only rounding-level disagreements may reject
    check(a_acc >= 0.9 * max(1, a_acc + a_rej),
          f"accept path: {a_acc} accepted, {a_rej} rejected with a same-weights draft")
    return dict(
        greedy=greedy, replayed=replayed, verify_replayed=verify_replayed,
        rounding=rounding, spec_launches=spec_launches, step_ms=step_ms,
        streams_equal_to_plain=sum(a == b for a, b in zip(greedy["ids"], plain)),
        accept_rate=acc / max(1, acc + rej), rounds=rounds, prefill_chunks=chunks,
        target_dispatches_per_token=pairs / max(1.0, acc + pairs),
        tok_s=greedy["aggregate_tok_s"], plain_tok_s=cont["aggregate_tok_s"],
        sampled=sampled, sampled_bitwise=sampled[0]["ids"] == sampled[1]["ids"],
        accept=accept, accept_plain=accept_plain,
        small_accept_rate=a_acc / max(1, a_acc + a_rej),
        small_streams_equal=sum(a == b for a, b in zip(accept["ids"], accept_plain["ids"])))


#: the files phase: llama2_7b's seed-0 bf16 tree (what the zoo's
#: ``quant:int4,param_dtype:bfloat16`` draws and quantizes) written as a
#: GGUF with an embedded SentencePiece vocab (``toy_vocab`` with these
#: merges, padded to 32,000 pieces with text pieces "▁p<i>" that merge
#: last, so random weights' tokens decode to visible text), and as a HF
#: checkpoint directory at full width and ``FILES_HF_LAYERS`` layers;
#: served from the GGUF
FILES_HF_LAYERS = 2
FILES_MERGES = {"▁h": 2.0, "▁he": 3.0, "ll": 2.5, "llo": 3.5, "▁hello": 5.0,
                "▁w": 1.0, "or": 1.5, "ld": 1.2, "▁world": 4.0}
FILES_TEXT = "hello world"
FILES_TEXT_NEW = 16
#: bytes the phase leaves free on the disk and in host memory (the GGUF
#: is read three times and should stay in the page cache)
FILES_SPARE = 4e9
#: the GGUF's depth, the same on every machine: 1.9 GB at llama2_7b's full
#: width; its streams are held against the zoo model at that depth, and
#: the decode step is timed at the full 32 layers
FILES_LAYERS = 4


def full_step_ms(dev, quant, base=CONT_DESC):
    """The continuous cell's captured decode step (``decode_step_ms``) on
    the zoo's model at full depth with ``quant`` weights ("int4", "int8"
    or "" for bf16)."""
    import torch

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(base.replace("quant:int4,", f"quant:{quant}," if quant else ""))
    with pipe:
        fw = pipe.element("llm").fw
        fw.serve_loop()
        ms = decode_step_ms(fw, dev) if dev.type == "cuda" else None
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    del pipe, fw
    torch.cuda.empty_cache()
    return ms


def files_desc(path, quant, base=CONT_DESC):
    """The continuous cell's pipeline (``base``) serving ``path`` with
    ``quant`` ("int4", "int8" or "" for bf16 weights) and ``stop_eos:0``
    (the file carries a real vocab, whose EOS would otherwise end
    streams)."""
    desc = re.sub(r"model=\S+", f"model={path}", base).replace(
        "stream_chunk:8", "stream_chunk:8,stop_eos:0")
    return desc.replace("quant:int4,", f"quant:{quant}," if quant else "")


def files_room(cfg, root, layers):
    """Check that the disk under ``root`` holds the GGUF of ``layers`` of
    ``cfg``'s layers and the HF directory, and that host memory holds the
    GGUF (it is read three times and should stay in the page cache).
    Returns (free disk, available memory)."""
    import shutil

    from nnstreamer_tpu_torch.models import llama

    shapes = sum(a * b for a, b in llama._mat_shapes(cfg).values()) * 2 + 2 * cfg.dim * 4
    fixed = 2 * cfg.vocab * cfg.dim * 2 + cfg.dim * 4
    disk = shutil.disk_usage(root).free
    with open("/proc/meminfo") as fh:
        mem = next(int(line.split()[1]) * 1024 for line in fh
                   if line.startswith("MemAvailable:"))
    gguf_b = fixed + layers * shapes
    check(disk - fixed - FILES_HF_LAYERS * shapes - gguf_b >= FILES_SPARE
          and mem - gguf_b >= FILES_SPARE,
          f"files: {disk / 1e9:.1f} GB of disk and {mem / 1e9:.1f} GB of host memory "
          f"do not hold a {layers}-layer GGUF of {gguf_b / 1e9:.1f} GB")
    return disk, mem


def phase_files(dev, cont, base=CONT_DESC, cfg=None):
    """Serve a model FILE at llama2_7b's full width: write the GGUF (and
    the 2-layer HF directory, loaded back bitwise), then serve the GGUF
    as the continuous cell with ``quant:int4`` (8 streams bitwise equal to
    the continuous phase's ``cont``), with ``quant:int8`` (held against
    teacher-forced ``forward_paged``), time the captured decode step of
    each and of bf16 weights, and answer one static text request through
    the file's own vocab.  Files live in a temporary directory under
    build/files/, removed at the end.  ``base`` and ``cfg`` (default
    llama2_7b at ``max_seq`` 1024) are the cell's pipeline and model, for
    a rehearsal at a small size."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.models import gguf, llama, tokenizer
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "files")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    out = {}
    try:
        cfg = cfg or dataclasses.replace(llama.PRESETS["llama2_7b"], max_seq=1024)
        full = cfg.n_layers
        layers = min(full, FILES_LAYERS)
        disk, mem = files_room(cfg, tmp, layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
        out.update(layers=layers, disk_free_gb=disk / 1e9, mem_available_gb=mem / 1e9)
        pad = cfg.vocab - tokenizer.toy_vocab(FILES_MERGES).n_vocab
        tok = tokenizer.toy_vocab({**FILES_MERGES,
                                   **{f"▁p{i}": -2e4 for i in range(pad)}})
        path, hf_dir = os.path.join(tmp, "llama2_7b.gguf"), os.path.join(tmp, "hf")

        with torch.inference_mode():
            params = llama.init_params(cfg, seed=0, dtype="bfloat16", device=dev)
            t0 = time.perf_counter()
            gguf.export_llama(path, params, cfg, tokenizer=tok)
            out["gguf_write_s"] = time.perf_counter() - t0
            out["gguf_gb"] = os.path.getsize(path) / 1e9
            hcfg = dataclasses.replace(cfg, n_layers=FILES_HF_LAYERS)
            head = {k: params[k] for k in ("embed", "ln_out", "lm_head")}
            head["layers"] = {k: v[:FILES_HF_LAYERS] for k, v in params["layers"].items()}
            t0 = time.perf_counter()
            llama.export_hf(hf_dir, head, hcfg, shards=2)
            out["hf_write_s"] = time.perf_counter() - t0
            out["hf_gb"] = sum(os.path.getsize(os.path.join(hf_dir, f))
                               for f in os.listdir(hf_dir)) / 1e9
            t0 = time.perf_counter()
            got, got_cfg = llama.load_checkpoint(hf_dir, dtype="bfloat16", device=dev)
            torch.cuda.synchronize()
            out["hf_load_s"] = time.perf_counter() - t0
            same = [torch.equal(got[k], head[k]) for k in ("embed", "ln_out", "lm_head")]
            same += [torch.equal(got["layers"][k], v) for k, v in head["layers"].items()]
            check(all(same) and got_cfg == hcfg,
                  f"files: the HF directory loads back otherwise ({same}, {got_cfg})")
            del params, head, got
        torch.cuda.empty_cache()

        prompts = continuous_prompts()
        first = len(CONT_WAVES[0])
        groups = [(list(range(first)), "first"), (list(range(first, len(prompts))), "first")]
        want = [r["ids"] for r in cont["streams"]] if layers == full else serve_traffic(
            base.replace("max_seq:1024", f"max_seq:1024,n_layers:{layers}"),
            prompts, groups, MAX_NEW, dev)["ids"]
        lens = [len(p) for p in prompts]

        def tokenizer_of(fw, loop, res):
            res["file_tokenizer"] = (type(fw.tokenizer).__name__, fw.tokenizer.n_vocab,
                                     fw.stop_eos)

        def replayed(fw, loop, res):
            res["replayed"] = {i: dict(prompt_len=lens[i], **replay_stream(
                fw, loop, prompts[i], res["ids"][i], dev)) for i in CONT_CHECKED}
            tokenizer_of(fw, loop, res)

        runs = {}
        for quant, inside in (("int4", tokenizer_of), ("int8", replayed)):
            r = runs[quant] = serve_traffic(files_desc(path, quant, base), prompts,
                                            groups, MAX_NEW, dev, inside=inside)
            check(r["file_tokenizer"] == ("SentencePieceTokenizer", cfg.vocab, False),
                  f"files {quant}: tokenizer {r['file_tokenizer']}")
            check_cell_launches(r, int4=quant == "int4", tag=f"files {quant}", layers=layers)
            check(r["census"]["signatures"] == ["('continuous', 8, 'bfloat16', False)"],
                  f"files {quant} census: {r['census']}")
            r["load_gb_s"] = out["gguf_gb"] / r["setup_s"]
            torch.cuda.empty_cache()
        equal = [a == b for a, b in zip(runs["int4"]["ids"], want)]
        check(all(equal), f"files: GGUF int4 streams against the continuous phase's: {equal}")
        out.update(int4=runs["int4"], int8=runs["int8"], int4_streams_equal=sum(equal))

        # bf16 weights: the decode step alone
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pipe = ntt.Pipeline(files_desc(path, "", base))
        bf16 = dict(setup_s=time.perf_counter() - t0,
                    setup_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        with pipe:
            pipe.element("llm").fw.serve_loop()
            pipe.eos("src")
            pipe.wait(timeout=WAIT_S)
        bf16["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        bf16["load_gb_s"] = out["gguf_gb"] / bf16["setup_s"]
        out["bf16"] = bf16
        del pipe
        torch.cuda.empty_cache()

        # the captured decode step by weight type at the model's full depth
        # (the zoo's llama2_7b: the same shapes, kernels and weight types)
        out["step_ms"] = {name: full_step_ms(dev, q, base) for name, q in (
            ("int8", "int8"), ("int4", "int4"), ("bf16", ""))}

        # one static text request through the file's own vocab
        desc = re.sub(r"max_new:\d+,serve:continuous,slots:8,", f"max_new:{FILES_TEXT_NEW},",
                      re.sub(r"model=\S+", f"model={path}", base))
        t0 = time.perf_counter()
        pipe = ntt.Pipeline(desc)
        text = dict(setup_s=time.perf_counter() - t0)
        prompt = np.frombuffer(FILES_TEXT.encode(), np.uint8)
        with pipe:
            fw = pipe.element("llm").fw
            check(fw.stop_eos and fw.tokenizer.n_vocab == cfg.vocab,
                  f"files text: stop_eos {fw.stop_eos}, vocab {fw.tokenizer.n_vocab}")
            text["prompt_ids"] = fw._to_tokens(prompt)[0].tolist()
            check(text["prompt_ids"] == tok.encode(FILES_TEXT.encode()),
                  f"files text: prompt ids {text['prompt_ids']}")
            f0, q0 = attention.LAUNCHES.value, i4.LAUNCHES.value
            pipe.push("src", prompt)
            bufs = [pipe.pull("out", timeout=WAIT_S)]
            while not bufs[-1].meta.get("stream_last"):
                bufs.append(pipe.pull("out", timeout=WAIT_S))
            text["launches"] = {"flash_attention": attention.LAUNCHES.value - f0,
                                "matmul_int4": i4.LAUNCHES.value - q0}
            pipe.eos("src")
            pipe.wait(timeout=WAIT_S)
        text["ids"] = [int(b.tensors[0][0]) for b in bufs]
        pieces = [bytes(np.asarray(b.tensors[1])) for b in bufs]
        check(len(bufs) <= FILES_TEXT_NEW
              and pieces == [tok.decode_piece(i) for i in text["ids"]]
              and (len(bufs) == FILES_TEXT_NEW or text["ids"][-1] == tok.eos),
              f"files text: {len(bufs)} tokens {text['ids']}, pieces {pieces}")
        check(all(v > 0 for v in text["launches"].values()),
              f"files text: launches {text['launches']}")
        text["text"] = b"".join(pieces).decode("utf-8", "replace")
        out["text"] = text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def print_files(r):
    print(f"files: {r['layers']} of {N_LAYERS} layers (disk free "
          f"{r['disk_free_gb']:.1f} GB, host memory available "
          f"{r['mem_available_gb']:.1f} GB); GGUF {r['gguf_gb']:.2f} GB written in "
          f"{r['gguf_write_s']:.1f} s ({r['gguf_gb'] / r['gguf_write_s']:.2f} GB/s); HF "
          f"directory ({FILES_HF_LAYERS} layers, 2 shards) {r['hf_gb']:.2f} GB written in "
          f"{r['hf_write_s']:.1f} s, loaded back bitwise in {r['hf_load_s']:.2f} s "
          f"({r['hf_gb'] / r['hf_load_s']:.2f} GB/s)", flush=True)
    for q in ("int4", "int8", "bf16"):
        x = r[q]
        serve = (f", serve peak {x['peak_mem_gb']:.2f} GB, {x['aggregate_tok_s']:.2f} "
                 f"tok/s in {x['window_s']:.2f} s" if "window_s" in x else
                 f", peak {x['peak_mem_gb']:.2f} GB")
        print(f"files: {q} load {x['setup_s']:.2f} s ({x['load_gb_s']:.2f} GB/s from "
              f"the file), load peak {x['setup_peak_gb']:.2f} GB{serve}", flush=True)
    s = r["step_ms"]
    if s["int8"] is not None:
        print(f"files: decode step ms at {N_LAYERS} layers int8 {s['int8']:.3f} / int4 "
              f"{s['int4']:.3f} / bf16 {s['bf16']:.3f} (int8 / bf16 "
              f"{s['int8'] / s['bf16']:.3f})", flush=True)
    print(f"files: int4 from the GGUF: {r['int4_streams_equal']} of "
          f"{len(r['int4']['ids'])} streams bitwise equal to the zoo model's at "
          f"{r['layers']} layers; "
          f"int8 tokens against forward_paged {r['int8']['replayed']}", flush=True)
    for q in ("int4", "int8"):
        print(f"files: {q} loop timeline {r[q]['timeline']}; launches "
              f"{r[q]['launches']}; census {r[q]['census']}", flush=True)
    t = r["text"]
    print(f"files: static text {FILES_TEXT!r} -> prompt ids {t['prompt_ids']}, "
          f"{len(t['ids'])} ids {t['ids']}, text {t['text']!r}, load {t['setup_s']:.2f} s, "
          f"launches {t['launches']}", flush=True)
    print(f"files: phase {r['phase_s']:.1f} s", flush=True)


#: the elastic phase: the continuous cell on two pipelines A and B at
#: once (both traced into the flight recorder's ring, so the moves' spans
#: are counted), the continuous phase's prompts and waves, and live
#: streams moved from A to B.  Streams 3 and 0 (700 and 32 ids) move
#: live after ELASTIC_AFTER tokens, drained at one chunk boundary (the
#: wave prefills at once while nothing decodes, so that boundary is at 9
#: tokens: 700 + 8 positions, 45 blocks), 0 through a snapshot file; stream 5 is held in A's queue by a tenant quota of 0
#: and moves queued; stream 7 (600 ids, 19 chunks, prefilled after 4 and
#: 6) is asked for while in prefill and moves once live; stream 4 moves by
#: the autoscaler's spill
ELASTIC_LIVE = (3, 0)
ELASTIC_FILE = 0
ELASTIC_QUEUED = 5
ELASTIC_PREFILL = 7
ELASTIC_SPILL = 4
ELASTIC_AFTER = 3
#: the sampled move: one stream at these sampler settings, moved after
#: ELASTIC_SAMPLED_AFTER tokens, against the same stream undrained
ELASTIC_SAMPLED = ",temperature:0.9,top_k:40"
ELASTIC_SAMPLED_AFTER = 8
ELASTIC_SAMPLED_PROMPT = 1
#: the fetch window: the quick-start host-fed at these depths, in turns
#: (1, 4, 4, 1, ...) FETCH_PAIRS times: a host-fed rate spreads by tens of
#: percent from run to run on a shared host, so one run each says nothing
FETCH_DEPTHS = (1, 4)
FETCH_PAIRS = 2
#: the stage restart: a host stage that fails on its RESTART_FAIL_AT-th
#: buffer (after the card stage's capture), in front of a fused card
#: stage; RESTART_BUFFERS pushed
RESTART_FAIL_AT = 3
RESTART_BUFFERS = 8
RESTART_DESC = ("appsrc name=src caps=other/tensors,dimensions=16,types=float32 ! "
                "tensor_filter name=flaky framework=custom-easy model={model} ! "
                "tensor_transform mode=arithmetic option=typecast:float32,add:1.0 ! "
                "tensor_filter framework=jax model=scaler custom=scale:2.0,dims:16 {acc} ! "
                "tensor_sink name=out")


def pool_whole(loop):
    """Every block of a continuous loop's pool free with every count 0,
    every table entry the sentinel and every slot parked."""
    return (sorted(loop._free) == list(range(loop.n_blocks))
            and bool((loop._ref == 0).all())
            and bool((loop._tables == loop.sentinel).all())
            and bool((loop._pos == loop.park).all()))


class Tokens:
    """A sink callback that keeps each stream's buffers by ``req``."""

    def __init__(self, side):
        import threading

        self.side = side
        self.lock = threading.Lock()
        self.by_req = {}

    def __call__(self, buf):
        with self.lock:
            self.by_req.setdefault(buf.meta["req"], []).append(buf)

    def count(self, req):
        with self.lock:
            return len(self.by_req.get(req, ()))

    def first_meta(self, req):
        with self.lock:
            return self.by_req[req][0].meta


def wait_for(cond, what, timeout=WAIT_S):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"timed out waiting for {what}")
        time.sleep(0.001)


def snapshot_mib(snap):
    return sum(snap[k].numel() * snap[k].element_size()
               for k in ("blocks_k", "blocks_v") if k in snap) / 2**20


def elastic_greedy(dev, cont, base):
    """The greedy moves and the spill (see ELASTIC_*).  Every stream's
    tokens, A's part and B's together, must equal the continuous phase's
    for the same prompt bitwise (or part from it at a near tie,
    replay_stream's rule), with stream_index going on without a gap."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import Metrics
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4
    from nnstreamer_tpu_torch.trainer import checkpoint
    from nnstreamer_tpu_torch.utils import elastic, tracing

    on_card = dev.type == "cuda"
    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    prompts = continuous_prompts()
    n, first = len(prompts), len(CONT_WAVES[0])
    ref = [s["ids"] for s in cont["streams"]]
    # the first wave shares one tenant, so that one quota holds it back
    tag = f"el{time.monotonic_ns()}"
    wave = f"{tag}.wave"
    tenants = [wave] * first + [f"{tag}.{i}" for i in range(first, n)]
    t0 = time.perf_counter()
    pa = ntt.Pipeline(base, trace_mode="ring")
    pb = ntt.Pipeline(base, trace_mode="ring")
    res = dict(setup_s=time.perf_counter() - t0, moves={})
    ta, tb = Tokens("A"), Tokens("B")
    pa.element("out").connect_new_data(ta)
    pb.element("out").connect_new_data(tb)
    with pa, pb:
        fa, fb = pa.element("llm").fw, pb.element("llm").fw
        la, lb = fa.serve_loop(), fb.serve_loop()
        warm = (fa.census.captures, fb.census.captures)
        census0 = [{sig: dict(t) for sig, t in fw.census.launches.items()}
                   for fw in (fa, fb)]
        stats0 = (dict(la.stats), dict(lb.stats))
        for c in counters.values():
            c.reset()
        t_ns = time.monotonic_ns()

        def push(i):
            pa.push("src", ntt.Buffer([prompts[i]], meta={"req": i,
                                                          "_tenant": tenants[i]}))

        def record(i, how, snap, drain_ms, adopt_ms, **kw):
            res["moves"][i] = dict(how=how, prompt_len=len(prompts[i]),
                                   kind=snap["kind"], sidx=snap.get("sidx", 0),
                                   blocks=-(-snap.get("pos", 0) // snap["block_size"]),
                                   snapshot_mib=snapshot_mib(snap), drain_ms=drain_ms,
                                   adopt_ms=adopt_ms, **kw)

        def drain(sid):
            t1 = time.perf_counter()
            snap = pa.drain_stream(sid)
            return snap, (time.perf_counter() - t1) * 1e3

        def move(i, how, sid, via_file=False, drained=None):
            snap, drain_ms = drained or drain(sid)
            kw = {}
            if via_file:
                path = os.path.join(OUT_DIR, "elastic_snapshot.pkl")
                t1 = time.perf_counter()
                checkpoint.save_stream_snapshot(path, snap)
                kw["file_write_s"] = time.perf_counter() - t1
                kw["file_mib"] = os.path.getsize(path) / 2**20
                t1 = time.perf_counter()
                loaded = checkpoint.load_stream_snapshot(path)
                kw["file_read_s"] = time.perf_counter() - t1
                os.remove(path)
                check(all(torch.equal(loaded[k], snap[k].cpu())
                          for k in ("blocks_k", "blocks_v")),
                      "the snapshot file does not give back its blocks")
                snap = loaded
            t1 = time.perf_counter()
            pb.adopt_stream(snap)
            record(i, how, snap, drain_ms, (time.perf_counter() - t1) * 1e3, **kw)

        def sid_of(i, state=None):
            for sid, info in pa.serve_streams().items():
                if info["tenant"] == tenants[i] and state in (None, info["state"]):
                    return sid
            return None

        # the first wave waits at quota 0 until all of it is queued, then
        # comes in at once: admitted in one pass, it is prefilled with the
        # budget waived and decodes in step, as the live moves assume.  Let
        # in as it arrives, the 32-id stream would decode while the others
        # take one prefill chunk a step, and end before the 700-id stream
        # had its first tokens
        la.set_tenant_quota(wave, 0)
        for i in range(first):
            push(i)
        wait_for(lambda: sum(info["tenant"] == wave and info["state"] == "queued"
                             for info in pa.serve_streams().values()) == first,
                 "the first wave in the queue")
        t_start = time.perf_counter()
        la.set_tenant_quota(wave, None)
        wait_for(lambda: all(ta.count(i) >= ELASTIC_AFTER for i in ELASTIC_LIVE),
                 "the live moves' tokens")
        # both drains asked for at once, so both run at one chunk boundary:
        # one after the other, the 45-block copy would let the 32-id
        # stream (and its wave) finish before its own drain
        with ThreadPoolExecutor(len(ELASTIC_LIVE)) as ex:
            drained = {i: ex.submit(drain, ta.first_meta(i)["stream_id"])
                       for i in ELASTIC_LIVE}
            drained = {i: f.result(timeout=WAIT_S) for i, f in drained.items()}
        for i in ELASTIC_LIVE:
            move(i, "file" if i == ELASTIC_FILE else "live", None,
                 via_file=i == ELASTIC_FILE, drained=drained[i])
        wait_for(lambda: all(ta.count(i) or i in ELASTIC_LIVE for i in range(first)),
                 "the first wave's first tokens")
        la.set_tenant_quota(tenants[ELASTIC_QUEUED], 0)
        for i in range(first, n):
            push(i)
        wait_for(lambda: sid_of(ELASTIC_QUEUED, "queued") is not None,
                 "the queued stream")
        move(ELASTIC_QUEUED, "queued", sid_of(ELASTIC_QUEUED, "queued"))
        wait_for(lambda: ta.count(ELASTIC_SPILL) >= ELASTIC_AFTER,
                 f"stream {ELASTIC_SPILL}'s tokens")
        m = Metrics()
        m.gauge("slo.burn_rate", 9.0, tenant=tenants[ELASTIC_SPILL])
        scaler = elastic.Autoscaler(
            pa, {"rules": [{"tenant": tenants[ELASTIC_SPILL], "burn_above": 2.0,
                            "burn_below": 0.5, "action": "spill",
                            "cooldown_s": 60.0}]}, spill_to=pb, metrics=m)
        t1 = time.perf_counter()
        res["spill_edges"] = scaler.evaluate()
        spill_ms = (time.perf_counter() - t1) * 1e3
        check(res["spill_edges"] == 1,
              f"spill: {res['spill_edges']} action edges; A's streams "
              f"{pa.serve_streams()}, stream {ELASTIC_SPILL}'s tenant "
              f"{tenants[ELASTIC_SPILL]}, {ta.count(ELASTIC_SPILL)} tokens")
        res["moves"][ELASTIC_SPILL] = dict(how="spill", prompt_len=len(prompts[ELASTIC_SPILL]),
                                           kind="live", spill_ms=spill_ms)
        wait_for(lambda: sid_of(ELASTIC_PREFILL, "admitting") or sid_of(ELASTIC_PREFILL, "live"),
                 f"stream {ELASTIC_PREFILL}'s admission")
        sid7 = sid_of(ELASTIC_PREFILL)
        state7 = pa.serve_streams()[sid7]["state"]
        check(state7 == "admitting", f"stream {ELASTIC_PREFILL} is {state7}, not in prefill")
        move(ELASTIC_PREFILL, "prefill", sid7)
        res["moves"][ELASTIC_PREFILL]["state_when_asked"] = state7
        total = n * MAX_NEW
        wait_for(lambda: sum(ta.count(i) + tb.count(i) for i in range(n)) >= total,
                 "every token")
        t_end = time.perf_counter()
        pa.eos("src")
        pb.eos("src")
        pa.wait(timeout=WAIT_S)
        pb.wait(timeout=WAIT_S)
        if on_card:
            torch.cuda.synchronize()
        res["launches"] = {k: c.value for k, c in counters.items()}
        stats = [{k: lp.stats[k] - s0[k] for k in s0} for lp, s0 in zip((la, lb), stats0)]
        res["stats"] = {k: stats[0][k] + stats[1][k] for k in stats[0]}
        res["stats_by_side"] = dict(A=stats[0], B=stats[1])
        step = {k: 0 for k in counters}
        names = {id(c): k for k, c in counters.items()}
        for fw, c0 in zip((fa, fb), census0):
            for sig, t in fw.census.launches.items():
                for c, v in t.items():
                    step[names[id(c)]] += v - c0.get(sig, {}).get(c, 0)
        res["step_launches"] = step
        res["census"] = dict(A=census_of(fa.census, warm[0]), B=census_of(fb.census, warm[1]))
        res["pool_whole"] = dict(A=pool_whole(la), B=pool_whole(lb))
        spans = {}
        for e in tracing.recorder.events():
            if e.ts >= t_ns and e.kind.startswith("elastic."):
                spans.setdefault(e.kind, []).append(e.dur / 1e6)
        res["spans"] = {k: len(v) for k, v in spans.items()}
        res["span_ms"] = spans
        # streams: A's part then B's, in stream_index order
        res["streams"] = []
        for i in range(n):
            a, b = ta.by_req.get(i, []), tb.by_req.get(i, [])
            bufs = a + b
            idx = [buf.meta["stream_index"] for buf in bufs]
            ids = [int(buf.tensors[0][0]) for buf in bufs]
            check(idx == list(range(MAX_NEW)),
                  f"stream {i}: stream_index {idx[:4]}... ({len(a)} on A, {len(b)} on B)")
            check(bool(bufs[-1].meta.get("stream_last")) and not any(
                buf.meta.get("stream_aborted") for buf in bufs), f"stream {i}: bad end")
            check(len({buf.meta["stream_id"] for buf in bufs}) == 1,
                  f"stream {i}: its id changed in the move")
            r = dict(prompt_len=len(prompts[i]), on_a=len(a), on_b=len(b),
                     bitwise_equal=ids == ref[i])
            if ids != ref[i]:
                r["replayed"] = replay_stream(fb, lb, prompts[i], ids, dev, other=ref[i])
            res["streams"].append(r)
    res["moves"][ELASTIC_SPILL]["sidx"] = res["streams"][ELASTIC_SPILL]["on_a"]
    check(all(res["pool_whole"].values()), f"pools after the moves: {res['pool_whole']}")
    want_spans = {"elastic.drain": 5, "elastic.adopt": 5, "elastic.scale": 1}
    check(res["spans"] == want_spans, f"spans {res['spans']} != {want_spans}")
    moved = set(res["moves"])
    check(all(res["streams"][i]["on_b"] > 0 for i in moved)
          and all(res["streams"][i]["on_b"] == 0 for i in range(n) if i not in moved),
          "streams not where they were moved")
    check(res["moves"][ELASTIC_QUEUED]["kind"] == "queued"
          and res["moves"][ELASTIC_QUEUED]["sidx"] == 0
          and res["streams"][ELASTIC_QUEUED]["on_a"] == 0, "the queued move")
    if on_card:
        steps, chunks = res["stats"]["decode_steps"], res["stats"]["prefill_chunks"]
        check_cell_launches(res, tag="elastic")
        check(res["step_launches"] == dict(paged_attention=N_LAYERS * steps,
                                           flash_attention=0,
                                           matmul_int4=129 * steps),
              f"elastic launches by captured step {res['step_launches']}")
    res["window_s"] = t_end - t_start
    res["aggregate_tok_s"] = n * MAX_NEW / (t_end - t_start)
    res["bitwise_equal_streams"] = sum(s["bitwise_equal"] for s in res["streams"])
    return res


def elastic_sampled(dev, base):
    """A sampled stream drained after ELASTIC_SAMPLED_AFTER tokens and
    adopted on a second pipeline continues bitwise as the same stream
    served undrained (each pipeline's first admission: the same seed)."""
    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    desc = base.replace("stream_chunk:8", "stream_chunk:8" + ELASTIC_SAMPLED)
    check(desc != base, "no sampler settings in the elastic phase's desc")
    prompt = continuous_prompts()[ELASTIC_SAMPLED_PROMPT]
    counters = {"paged_attention": attention.PAGED_LAUNCHES,
                "flash_attention": attention.LAUNCHES,
                "matmul_int4": i4.LAUNCHES}
    pa, pb = ntt.Pipeline(desc), ntt.Pipeline(desc)
    ta, tb = Tokens("A"), Tokens("B")
    pa.element("out").connect_new_data(ta)
    pb.element("out").connect_new_data(tb)
    res = {}
    with pa, pb:
        fa, fb = pa.element("llm").fw, pb.element("llm").fw
        la, lb = fa.serve_loop(), fb.serve_loop()
        warm = (fa.census.captures, fb.census.captures)
        stats0 = (dict(la.stats), dict(lb.stats))
        for c in counters.values():
            c.reset()
        # the reference: B's first admission, undrained
        pb.push("src", ntt.Buffer([prompt], meta={"req": "ref"}))
        wait_for(lambda: tb.count("ref") >= MAX_NEW, "the sampled reference")
        pa.push("src", ntt.Buffer([prompt], meta={"req": "moved"}))
        wait_for(lambda: ta.count("moved") >= ELASTIC_SAMPLED_AFTER, "sampled tokens")
        t1 = time.perf_counter()
        snap = pa.drain_stream(ta.first_meta("moved")["stream_id"])
        res["drain_ms"] = (time.perf_counter() - t1) * 1e3
        check(snap["greedy"] is False and snap.get("generator") == dev.type
              and snap.get("gen_state") is not None, "no generator state in the snapshot")
        t1 = time.perf_counter()
        pb.adopt_stream(snap)
        res["adopt_ms"] = (time.perf_counter() - t1) * 1e3
        wait_for(lambda: ta.count("moved") + tb.count("moved") >= MAX_NEW, "the moved stream")
        pa.eos("src")
        pb.eos("src")
        pa.wait(timeout=WAIT_S)
        pb.wait(timeout=WAIT_S)
        res["launches"] = {k: c.value for k, c in counters.items()}
        res["stats"] = {k: la.stats[k] - stats0[0][k] + lb.stats[k] - stats0[1][k]
                        for k in stats0[0]}
        res["census"] = dict(A=census_of(fa.census, warm[0]), B=census_of(fb.census, warm[1]))
        res["pool_whole"] = dict(A=pool_whole(la), B=pool_whole(lb))
        moved = ta.by_req["moved"] + tb.by_req.get("moved", [])
        ref = [int(b.tensors[0][0]) for b in tb.by_req["ref"]]
        ids = [int(b.tensors[0][0]) for b in moved]
    res.update(sidx=snap["sidx"], snapshot_mib=snapshot_mib(snap),
               bitwise_equal=ids == ref, distinct_tokens=len(set(ref)))
    check([b.meta["stream_index"] for b in moved] == list(range(MAX_NEW)),
          "sampled move: stream_index not continuous")
    check(res["bitwise_equal"], f"sampled move: {ids} != {ref}")
    check(all(res["pool_whole"].values()), f"sampled pools: {res['pool_whole']}")
    if dev.type == "cuda":
        check_cell_launches(res, tag="elastic sampled")
    return res


def elastic_fetch(dev, size=224, batch=None, acc="", pairs=FETCH_PAIRS):
    """The README quick-start host-fed at each fetch depth, in turns: the
    same frames, every run's outputs bitwise equal to the first's and in
    order; frames/s, p50 and p99 per run, and the median per depth."""
    import numpy as np

    batch = batch or VISION_BATCH
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
              for _ in range(VISION_WARM + VISION_TIMED)]
    desc = QUICKSTART.format(size=size, batch=batch, model="mobilenet_v1",
                             custom="", acc=acc)
    first, runs, equal = None, [], 0
    order = [FETCH_DEPTHS[(k + k // 2) % 2] for k in range(2 * pairs)]
    for depth in order:
        got, st = vision_host_fed(desc, frames, fetch_depth=depth)
        first = got if first is None else first
        equal += all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                     for x, y in zip(first, got))
        runs.append(dict(depth=depth, frames_per_s=st["frames_per_s"],
                         p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
                         window_peak=st["fetch_window_peak"]))
    check(equal == len(order), f"fetch depths: {len(order) - equal} runs differ")
    out = dict(runs=runs, bitwise_equal_runs=equal)
    for d in FETCH_DEPTHS:
        mine = [r for r in runs if r["depth"] == d]
        out[d] = {k: float(np.median([r[k] for r in mine]))
                  for k in ("frames_per_s", "p50_ms", "p99_ms")}
        out[d]["frames_per_s_runs"] = [r["frames_per_s"] for r in mine]
    return out


def elastic_restart(dev, acc=""):
    """A card pipeline with max_stage_restarts=2: a host custom-easy stage
    failing once on buffer RESTART_FAIL_AT (forced restartable, as the
    JAX package's test does: the planner rightly calls a host callable
    impure) in front of a fused transform+scaler stage on the card.
    Exactly that buffer is lost, the rest arrive in order and right, and
    the card stage, captured on the first buffer, captures nothing after."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.core.types import TensorsSpec
    from nnstreamer_tpu_torch.filters.custom_easy import (register_custom_easy,
                                                          unregister_custom_easy)

    name = f"elastic-flaky-{time.monotonic_ns()}"
    calls = {"n": 0}

    def work(ins):
        calls["n"] += 1
        if calls["n"] == RESTART_FAIL_AT:
            raise RuntimeError("injected stage fault")
        return [np.asarray(ins[0])]

    spec = TensorsSpec.from_string("16", "float32")
    register_custom_easy(name, work, in_spec=spec, out_spec=spec)
    restarts0 = metrics.snapshot().get("flaky.restarts", 0.0)
    p = ntt.Pipeline(RESTART_DESC.format(model=name, acc=acc), max_stage_restarts=2)
    try:
        flaky = [r for r in p._unique_runners() if r.element.name == "flaky"]
        check(len(flaky) == 1 and not flaky[0].stage.restartable,
              "the host custom-easy stage must not be planned restartable")
        flaky[0].stage.restartable = True
        stage, names = vision_stage(p)
        outs = []
        with p:
            for i in range(RESTART_BUFFERS):
                p.push("src", ntt.Buffer([np.full((16,), float(i), np.float32)], pts=i))
                if i == 0:
                    outs.append(p.pull("out", timeout=WAIT_S))
                    captures = stage.census.captures
            p.eos("src")
            p.wait(timeout=WAIT_S)
            while True:
                try:
                    outs.append(p.pull("out", timeout=1))
                except TimeoutError:
                    break
    finally:
        unregister_custom_easy(name)
    pts = [o.pts for o in outs]
    lost = RESTART_FAIL_AT - 1
    want = [i for i in range(RESTART_BUFFERS) if i != lost]
    check(pts == want, f"stage restart: delivered {pts}, want {want}")
    check(all(np.array_equal(np.asarray(o.tensors[0]),
                             np.full((16,), (o.pts + 1.0) * 2.0, np.float32)) for o in outs),
          "stage restart: wrong values")
    restarts = metrics.snapshot().get("flaky.restarts", 0.0) - restarts0
    check(restarts == 1, f"stage restart: {restarts} restarts")
    check(stage.census.captures == captures == 1,
          f"stage restart: the card stage captured {stage.census.captures} times")
    return dict(delivered=len(outs), lost=RESTART_BUFFERS - len(outs),
                restarts=restarts, stages=names,
                census=dict(captures=stage.census.captures, replays=stage.census.replays))


def phase_elastic(dev, cont, base=CONT_DESC, acc=""):
    """Elastic serving on the card: the greedy moves and the spill, the
    sampled move, the fetch window and a stage restart."""
    import torch

    out = {}
    t0 = time.perf_counter()
    out["greedy"] = elastic_greedy(dev, cont, base)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["sampled"] = elastic_sampled(dev, base)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["llm_s"] = time.perf_counter() - t0
    out["fetch"] = elastic_fetch(dev, acc=acc)
    out["restart"] = elastic_restart(dev, acc=acc)
    out["phase_s"] = time.perf_counter() - t0
    return out


def print_elastic(r, cont):
    g = r["greedy"]
    for i, mv in sorted(g["moves"].items()):
        print(f"elastic: stream {i} (prompt {mv['prompt_len']}) moved {mv['how']} "
              f"({mv['kind']}) after {mv['sidx']} tokens"
              + (f", {mv['blocks']} blocks, snapshot {mv['snapshot_mib']:.2f} MiB, "
                 f"drain {mv['drain_ms']:.2f} ms, adopt {mv['adopt_ms']:.2f} ms"
                 if "drain_ms" in mv else f", autoscaler evaluate {mv['spill_ms']:.2f} ms")
              + (f", file write {mv['file_write_s']:.4f} s read {mv['file_read_s']:.4f} s "
                 f"({mv['file_mib']:.2f} MiB)" if "file_write_s" in mv else ""), flush=True)
    print(f"elastic: span ms {g['span_ms']}", flush=True)
    print(f"elastic: {g['bitwise_equal_streams']} of {len(g['streams'])} streams bitwise "
          f"equal to the continuous phase's; {g['aggregate_tok_s']:.2f} tok/s with the "
          f"moves over {g['window_s']:.2f} s (the continuous phase without: "
          f"{cont['aggregate_tok_s']:.2f}); spans {g['spans']}; decode steps "
          f"{g['stats']['decode_steps']}, prefill chunks {g['stats']['prefill_chunks']}, "
          f"launches {g['launches']}; pools whole {g['pool_whole']}", flush=True)
    print(f"census: elastic {g['census']}", flush=True)
    s = r["sampled"]
    print(f"elastic: sampled move after {s['sidx']} tokens bitwise {s['bitwise_equal']} "
          f"({s['distinct_tokens']} distinct tokens), drain {s['drain_ms']:.2f} ms, "
          f"adopt {s['adopt_ms']:.2f} ms, snapshot {s['snapshot_mib']:.2f} MiB; "
          f"census {s['census']}", flush=True)
    f = r["fetch"]
    print("elastic: fetch window, medians of runs in turns: " + ", ".join(
        f"depth {d}: {f[d]['frames_per_s']:.1f} frames/s (runs "
        f"{[round(x, 1) for x in f[d]['frames_per_s_runs']]}; p50 {f[d]['p50_ms']:.2f} ms, "
        f"p99 {f[d]['p99_ms']:.2f} ms)" for d in FETCH_DEPTHS)
        + f"; {f['bitwise_equal_runs']} of {len(f['runs'])} runs bitwise equal to the first",
        flush=True)
    print(f"elastic: stage restart {r['restart']}", flush=True)
    print(f"elastic: phase {r['phase_s']:.1f} s (LLM part {r['llm_s']:.1f} s)", flush=True)


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


def vision_host_fed(desc, frames, fuse=True, **pipe_kw):
    """Push every batch of ``frames`` through an appsrc pipeline (built
    with ``pipe_kw``): the first VISION_WARM one at a time (the capture),
    the rest from a pusher thread while this thread pulls.  Returns
    (outputs, timed stats, with the sink's fetch window peak)."""
    import threading

    import numpy as np

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(desc, fuse=fuse, **pipe_kw)
    outs, push_ts, e2e = [], {}, []
    with pipe:
        for f in frames[:VISION_WARM]:
            pipe.push("src", f)
            outs.append(pipe.pull("out", timeout=WAIT_S))
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
            outs.append(pipe.pull("out", timeout=WAIT_S))
            e2e.append((time.perf_counter() - push_ts[i]) * 1e3)
        wall = time.perf_counter() - t0
        t.join(timeout=60)
        census = card_ms = None
        if fuse:
            census = census_of(stage.census, warm_captures)
            card_ms = stage_card_ms(stage)
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
        window_peak = pipe.element("out")._win_peak
    n = len(frames) - VISION_WARM
    lat = np.sort(np.asarray(e2e))
    stats = dict(frames_per_s=n * frames[0].shape[0] / wall,
                 p50_ms=float(np.percentile(lat, 50)),
                 p99_ms=float(np.percentile(lat, 99)), stages=names,
                 census=census, card_ms_per_batch=card_ms, stage=stage,
                 fetch_window_peak=window_peak)
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
            outs.append(pipe.pull("out", timeout=WAIT_S))
        stage, names = vision_stage(pipe)
        warm_captures = stage.census.captures
        t0 = time.perf_counter()
        for _ in range(n - VISION_WARM):
            buf = pipe.pull("out", timeout=WAIT_S)
            if len(outs) < keep:
                outs.append(buf)
        wall = time.perf_counter() - t0
        frames = (n - VISION_WARM) * batch
        census = census_of(stage.census, warm_captures)
        card_ms = stage_card_ms(stage)
        pipe.wait(timeout=WAIT_S)
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
        logits = np.asarray(ref.pull("out", timeout=WAIT_S).tensors[0])
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
            pipe.wait(timeout=WAIT_S)
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
MODELS_TIMED = 12
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
        bufs = [pipe.pull("out", timeout=WAIT_S) for _ in range(n)]
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


def print_prefix(r):
    on, fk = r["on"], r["fork_on"]
    print(f"prefix: prefill chunks cold {r['cold_chunks']} against per hit "
          f"{r['hit_chunks']}; first token at the sink alone, cold "
          f"{on['ttft_ms'][0]:.1f} ms against hit {on['ttft_ms'][1]:.1f} ms "
          f"(prefix_cache:0: {r['off']['ttft_ms'][1]:.1f} ms); the six hits "
          f"together {[round(t, 1) for t in on['ttft_ms'][2:]]} ms", flush=True)
    sc = on["serve_counters"]
    print(f"prefix: prefix_hits {sc.get('llm.serve.prefix_hits')}, prefix_hit_blocks "
          f"{sc.get('llm.serve.prefix_hit_blocks')}, cow_forks "
          f"{sc.get('llm.serve.cow_forks', 0)}, evictions "
          f"{sc.get('llm.serve.prefix_evictions', 0)}; indexed blocks "
          f"{on['indexed_blocks']} of {on['n_blocks']}", flush=True)
    print(f"prefix: {r['streams_equal']} of {len(r['off']['ids'])} streams bitwise equal "
          f"to prefix_cache:0; pool free after the drain (every count 0): "
          f"{on['pool_free']}; {on['aggregate_tok_s']:.2f} tok/s in "
          f"{on['window_s']:.2f} s (prefix_cache:0 {r['off']['aggregate_tok_s']:.2f} "
          f"in {r['off']['window_s']:.2f} s); prefill chunks {on['stats']['prefill_chunks']} "
          f"against {r['off']['stats']['prefill_chunks']}", flush=True)
    print(f"census: prefix {on['census']}", flush=True)
    print(f"prefix: first token in the loop alone, cold {on['loop_ttft_ms'][0]:.1f} ms "
          f"against hit {on['loop_ttft_ms'][1]:.1f} ms; loop timeline (ms) "
          f"{on['timeline']}", flush=True)
    print(f"prefix: under trace_mode=ring, spans {r['ring_spans']} for "
          f"{len(r['ring']['ids'])} admissions, "
          f"{r['ring']['serve_counters'].get('llm.serve.prefix_hits')} "
          f"hits, {r['ring']['stats']['prefill_chunks']} chunks; tokens equal to the "
          f"untraced run's; {r['ring']['aggregate_tok_s']:.2f} tok/s", flush=True)
    print(f"prefix: fork sub-case (llama2_7b, prefill_chunk:{PREFIX_FORK_CHUNK}, "
          f"{PREFIX_FORK_STREAMS} streams of {PREFIX_FORK_NEW}): cow_forks "
          f"{r['cow_forks']}, {r['fork_streams_equal']} of {PREFIX_FORK_STREAMS} "
          f"streams bitwise equal to prefix_cache:0, pool free {fk['pool_free']}, "
          f"prefill chunks {fk['group_chunks']} against {r['fork_off']['group_chunks']}, "
          f"census {fk['census']}", flush=True)


def print_spec(r):
    g = r["greedy"]
    lens = [n for wave in CONT_WAVES for n in wave]
    for i, (t, d) in enumerate(zip(g["ttft_ms"], g["decode_tok_s"])):
        print(f"spec: prompt {lens[i]}"
              f"{' (late)' if i >= len(CONT_WAVES[0]) else ''} ttft at sink "
              f"{t:.1f} ms, decode {d:.2f} tok/s", flush=True)
    print(f"spec: accept rate {r['accept_rate']:.4f} (random weights: the draft "
          f"and the target agree by chance only), {r['rounds']} rounds, "
          f"{r['prefill_chunks']} prefill chunks, target dispatches per emitted "
          f"token per stream {r['target_dispatches_per_token']:.4f}; "
          f"{r['tok_s']:.2f} tok/s in {g['window_s']:.2f} s against the continuous "
          f"cell's {r['plain_tok_s']:.2f}; host {g['stats']['decode_host_s'] / max(1, r['rounds']) * 1e6:.1f} "
          f"us per round; launches {g['launches']}", flush=True)
    diffs = [v.get("first_difference") for v in r["replayed"].values()]
    print(f"spec: greedy tokens by the near-tie rule (share {SPEC_TIE}): "
          f"{r['streams_equal_to_plain']} of {len(g['ids'])} streams equal to the "
          f"continuous cell's; streams {list(r['replayed'])} replayed: first "
          f"differences at {diffs}; near ties "
          f"{[v['near_ties'] for v in r['replayed'].values()]}", flush=True)
    print(f"spec: the same streams replayed at the [8, {SPEC_K + 1}] verify shape "
          f"{r['verify_replayed']}", flush=True)
    for i, d in r["rounding"].items():
        print(f"spec: rounding, stream {i} teacher-forced (max |diff| / max |f32 "
              f"logit|, max and mean over steps): verify to f32 "
              f"{d['verify_to_f32']['max']:.4f} / {d['verify_to_f32']['mean']:.4f}, "
              f"decode to f32 {d['decode_to_f32']['max']:.4f} / "
              f"{d['decode_to_f32']['mean']:.4f}, verify to decode "
              f"{d['verify_to_decode']['max']:.4f} / {d['verify_to_decode']['mean']:.4f}; "
              f"in f32 verify to decode shape {d['f32_verify_to_f32']['max']:.2e}; "
              f"f32 argmax equal to the spec token at {d['f32_tokens_equal_to_argmax']} "
              f"of {MAX_NEW} steps; at the first difference from plain greedy "
              f"{d.get('f32_at_difference')}", flush=True)
    print(f"spec: launches by shape (counted) {r['spec_launches']}", flush=True)
    t = r["step_ms"]
    print(f"spec: captured steps at the 7B 8-slot shape, device ms per replay: "
          f"propose {t['propose_ms']:.3f}, verify {t['verify_ms']:.3f}, round "
          f"{t['round_ms']:.3f} against the decode step's {t['decode_step_ms']:.3f} "
          f"({t['round_per_decode_step']:.3f}x)", flush=True)
    print(f"census: spec {g['census']}", flush=True)
    s0, s1 = r["sampled"]
    print(f"spec: sampled (temperature 0.8, seed 1, the first wave's first "
          f"{SPEC_SAMPLED_WAVE} streams) two runs bitwise {r['sampled_bitwise']}, {s0['aggregate_tok_s']:.2f} / "
          f"{s1['aggregate_tok_s']:.2f} tok/s, accept rate "
          f"{s0['serve_counters'].get('llm.serve.spec_accepted', 0) / max(1, s0['serve_counters'].get('llm.serve.spec_accepted', 0) + s0['serve_counters'].get('llm.serve.spec_rejected', 0)):.4f}, "
          f"census {s0['census']}", flush=True)
    print(f"spec: accept path (llama_small f32, draft llama_small from the "
          f"target's seed): accept rate {r['small_accept_rate']:.4f}, "
          f"{r['small_streams_equal']} of {len(r['accept']['ids'])} streams equal "
          f"to the same model without a draft; {r['accept']['aggregate_tok_s']:.2f} "
          f"tok/s against {r['accept_plain']['aggregate_tok_s']:.2f}", flush=True)


#: the batching phase: the README quick-start fed ONE frame per buffer (a
#: camera, an app's appsrc, query clients), mobilenet_v1 224 (1001
#: classes, bf16, seed 0), drained into bucketed steps of up to
#: BATCHING_MAX frames; no max-inflight, so the backlog is bounded by the
#: queues (BATCHING_QUEUE) and the drain can fill its buckets
BATCHING_FRAMES = 128
BATCHING_MAX = 32
BATCHING_RUNS = 1
BATCHING_QUEUE = 64
PER_FRAME = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,"
             "types=uint8 max-buffers={cap} ! " + NORM + " ! tensor_filter "
             "framework=jax model=mobilenet_v1 custom=size:{size},batch:1 {acc} ! "
             "{tail}tensor_sink name=out")
LABELING = "tensor_decoder mode=image_labeling ! "
WINDOW_DEPTHS = (1, 4)
#: bench.py's bench_batching cell (a backlogged small model) and its
#: bench_adaptive cell (bursts of 6 into a 32-layer MLP of width 1280)
SCALER_DESC = ("appsrc name=src caps=other/tensors,dimensions={dims},types=float32 ! "
               "tensor_filter framework=jax model=scaler custom=scale:1.5,dims:{dims} "
               "{acc} name=f ! tensor_sink name=out")
SCALER_DIMS = 256
SCALER_BUFFERS = 384
ADAPTIVE_DIMS = 1280
ADAPTIVE_LAYERS = 32
ADAPTIVE_BURST = 6
ADAPTIVE_BURSTS = 64
ADAPTIVE_WARM_BURSTS = 40
ADAPTIVE_DESC = ("appsrc name=src caps=other/tensors,dimensions={dims},types=float32 ! "
                 "tensor_filter framework=custom-easy model={model} name=f ! "
                 "tensor_sink name=out")


class FillClock:
    """Host seconds the fused stages and bucket steps spend filling their
    static inputs (``_StaticSet.fill``, ``_BucketSet.fill``), by wrapping
    both while the block runs."""

    def __enter__(self):
        from nnstreamer_tpu_torch.pipeline import batching, plan

        self.seconds, self.calls = 0.0, 0
        self._orig = [(plan._StaticSet, plan._StaticSet.fill),
                      (batching._BucketSet, batching._BucketSet.fill)]
        for cls, fill in self._orig:
            def timed(obj, tensors, _fill=fill):
                t0 = time.perf_counter()
                _fill(obj, tensors)
                self.seconds += time.perf_counter() - t0
                self.calls += 1

            cls.fill = timed
        return self

    def __exit__(self, *exc):
        for cls, fill in self._orig:
            cls.fill = fill


class SlotFill:
    """The other form of the ingress copy, patched in for the donation A/B
    (the port copies each host fill through fresh pinned memory): host
    frames go through pinned slots reused in turn, two per static set,
    each written again only after the copy that last read it has run."""

    def __enter__(self):
        import torch

        from nnstreamer_tpu_torch.pipeline import batching, plan

        self._orig = [(plan._StaticSet, plan._StaticSet.fill),
                      (batching._BucketSet, batching._BucketSet.fill)]
        static_fill, bucket_fill = (f for _, f in self._orig)

        def take(obj):
            if getattr(obj, "_ab_slots", None) is None:
                obj._ab_slots = [
                    ([torch.empty(tuple(x.shape), dtype=x.dtype, pin_memory=True)
                      for x in obj.inputs], torch.cuda.Event()) for _ in range(2)]
                obj._ab_next = 0
            hs, done = obj._ab_slots[obj._ab_next]
            done.synchronize()  # a no-op before its first record
            return hs

        def release(obj):
            obj._ab_slots[obj._ab_next][1].record()
            obj._ab_next = (obj._ab_next + 1) % len(obj._ab_slots)

        def slot_static(obj, tensors):
            if not obj.inputs[0].is_cuda or any(t.is_cuda for t in tensors):
                return static_fill(obj, tensors)
            for h, dst, src in zip(take(obj), obj.inputs, tensors):
                h.copy_(src)
                dst.copy_(h, non_blocking=True)
            release(obj)

        def slot_bucket(obj, rows):
            if not obj.inputs[0].is_cuda or any(c.is_cuda for r in rows for c in r):
                return bucket_fill(obj, rows)
            n = len(rows)
            hs = take(obj)
            for t, dst in enumerate(obj.inputs):
                torch.stack([r[t] for r in rows], out=hs[t][:n])
                dst[:n].copy_(hs[t][:n], non_blocking=True)
            release(obj)
            if n < obj.bucket:
                for dst in obj.inputs:
                    dst[n:].copy_(dst[n - 1:n].expand_as(dst[n:]))

        plan._StaticSet.fill = slot_static
        batching._BucketSet.fill = slot_bucket
        return self

    def __exit__(self, *exc):
        for cls, fill in self._orig:
            cls.fill = fill


def hold_first(el):
    """Hold the stage's next one-buffer process() until released, so the
    buffers pushed meanwhile queue up behind it.  (started, release)."""
    import threading

    started, release = threading.Event(), threading.Event()
    orig = type(el).process

    def held(pad, buf):
        started.set()
        check(release.wait(WAIT_S), "held stage never released")
        del el.process
        return orig(el, pad, buf)

    el.process = held
    return started, release


def warm_buckets(el, frame, batch_max, buckets=None):
    """Capture every bucket step of a batchable stage before a timed
    window: one process_batch per bucket of the ladder above 1 (a drain of
    one buffer takes the one-buffer step)."""
    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.elements.base import SINK
    from nnstreamer_tpu_torch.pipeline.batching import ladder

    for b in ladder(batch_max, buckets):
        if b > 1:
            el.process_batch(SINK, [ntt.Buffer([frame]) for _ in range(b)])


def step_card_ms(step, reps=20):
    """Device ms of one replay of a captured step (CUDA events around
    ``reps`` replays queued behind a spin kernel); None off the card."""
    import torch

    if step._graph is None:
        return None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        step.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bucket_card_ms(stage):
    """Card ms per replay of each step of a fused stage: 1 for the
    one-buffer step (its one signature), b for each bucket step."""
    out = {}
    for st in stage._sets.values():
        out[1] = step_card_ms(st.step)
    if stage._batcher is not None:
        for (b, _), st in stage._batcher._sets.items():
            out[b] = step_card_ms(st.step)
    return out


def occupancy_line(name):
    """The stage's occupancy histogram: {le bound: cumulative count}."""
    import numpy as np

    from nnstreamer_tpu_torch.core.log import metrics

    h = metrics.value_histograms().get(f"{name}.batch_occupancy")
    if h is None:
        return {}
    bounds, counts, _, _ = h
    cum = np.cumsum(counts).tolist()
    return {str(int(b)): c for b, c in zip(bounds, cum)} | {"+Inf": cum[-1]}


def per_frame_run(dev, frames, batch_max, size=224, acc="", depth=2, donate=True,
                  backlog=False, labels=True):
    """The per-frame quick-start (``PER_FRAME``) over ``frames``: the first
    frame pushed alone (the one-buffer capture), every bucket warmed, then
    the rest timed.  Streaming (default): a pusher thread pushes as fast as
    the queues admit while this thread pulls.  ``backlog``: the rest are
    all queued behind a held first frame before the stage is released, so
    the drains are 1, then ``batch_max`` at a time, then the remainder: the
    same steps in every run.  Returns (outputs, stats)."""
    import threading

    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics

    on_card = dev.type == "cuda"
    cap = len(frames) + 8 if backlog else BATCHING_QUEUE
    desc = PER_FRAME.format(size=size, cap=cap, acc=acc,
                            tail=LABELING if labels else "")
    base = base_reserved = 0
    if on_card:  # earlier pipelines' graphs freed: the peak is this run's
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        base_reserved = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = ntt.Pipeline(desc, batch_max=batch_max, queue_capacity=cap,
                        dispatch_depth=depth, donate_ingress=donate)
    [st] = [s for s in pipe.stages if s.element.kind == "fused"]
    stage = st.element
    check(st.batchable, f"the per-frame stage {stage.name} is not batchable")
    check(stage._ingress_put is donate, f"ingress donation planned {stage._ingress_put}")
    outs, e2e, push_ts = [], [], {}
    with pipe:
        pipe.push("src", frames[0])
        outs.append(pipe.pull("out", timeout=WAIT_S))
        check(stage.device.type == dev.type, f"the stage runs on {stage.device}")
        if batch_max > 1:
            warm_buckets(stage, frames[0], batch_max)
        if on_card:
            torch.cuda.synchronize()
        warm = stage.census.captures
        metrics.reset()
        rest = frames[1:]
        with FillClock() as fill:
            if backlog:
                started, release = hold_first(stage)
                pipe.push("src", rest[0])
                check(started.wait(WAIT_S), "the held stage never started")
                for f in rest[1:]:
                    pipe.push("src", f)
                runner = [r for r in pipe._unique_runners() if r.element is stage][0]
                deadline = time.monotonic() + WAIT_S
                while len(runner.queue._dq) < len(rest) - 1:
                    check(time.monotonic() < deadline, "backlog never queued")
                    time.sleep(0.001)
                t0 = time.perf_counter()
                release.set()
                outs.extend(pipe.pull("out", timeout=WAIT_S) for _ in rest)
                wall = time.perf_counter() - t0
            else:
                def pusher():
                    for i, f in enumerate(rest):
                        push_ts[i] = time.perf_counter()
                        pipe.push("src", f)

                t = threading.Thread(target=pusher, daemon=True)
                t0 = time.perf_counter()
                t.start()
                for i in range(len(rest)):
                    outs.append(pipe.pull("out", timeout=WAIT_S))
                    e2e.append((time.perf_counter() - push_ts[i]) * 1e3)
                wall = time.perf_counter() - t0
                t.join(timeout=60)
        snap = metrics.snapshot()
        occupancy = occupancy_line(stage.name)
        census = census_of(stage.census, warm)
        card = bucket_card_ms(stage) if on_card else {}
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9 if on_card else None
        # graph pools hold their captures' memory as reserved, not allocated
        reserved = ((torch.cuda.memory_reserved(dev) - base_reserved) / 1e9
                    if on_card else None)
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    n = len(rest)
    hist = metrics.value_histograms().get(f"{stage.name}.batch_occupancy")
    drains = {}
    if hist is not None:  # the default ladder's buckets are the histogram's
        for b, c in zip(hist[0], hist[1]):
            if c:
                drains[int(b)] = c
    else:
        drains[1] = n
    busy = None
    if card and all(card.get(b) is not None for b in drains):
        busy = sum(c * card[b] for b, c in drains.items()) / (wall * 1e3)
    lat = np.sort(np.asarray(e2e)) if e2e else None
    stats = dict(
        batch_max=batch_max, depth=depth, donate=donate, backlog=backlog,
        frames_per_s=n / wall, wall_s=wall,
        p50_ms=None if lat is None else float(np.percentile(lat, 50)),
        p99_ms=None if lat is None else float(np.percentile(lat, 99)),
        occupancy=occupancy, drains=drains,
        occupancy_max=max(drains), occupancy_mean=snap.get(
            f"{stage.name}.batch_occupancy.mean"),
        pad_waste=snap.get(f"{stage.name}.batch_pad_waste", 0.0),
        census=census, card_ms_by_bucket=card, busy_share=busy, peak_mem_gb=peak,
        reserved_gb=reserved,
        fill_us_per_frame=fill.seconds / n * 1e6, fill_calls=fill.calls)
    if labels:
        res = [(int(np.asarray(o.meta["label_index"]).reshape(-1)[0]),
                float(np.asarray(o.meta["score"]).reshape(-1)[0])) for o in outs]
    else:
        res = [np.asarray(o.tensors[0], np.float32).reshape(-1) for o in outs]
    return res, stats


def bucket_rows_bitwise(dev, frames, size, acc):
    """Rows of one bucket at two occupancies (17 and 32, both bucket 32)
    replay the same captured step: bitwise equal labels and scores."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(PER_FRAME.format(size=size, cap=BATCHING_QUEUE, acc=acc,
                                         tail=LABELING), batch_max=BATCHING_MAX)
    [stage] = [s.element for s in pipe.stages if s.batchable]
    with pipe:
        pipe.push("src", frames[0])
        pipe.pull("out", timeout=WAIT_S)
        from nnstreamer_tpu_torch.elements.base import SINK

        a = stage.process_batch(SINK, [ntt.Buffer([f]) for f in frames[:17]])
        b = stage.process_batch(SINK, [ntt.Buffer([f]) for f in frames[:32]])
        a = [o.resolve() for _, o in a]
        b = [o.resolve() for _, o in b[:17]]
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    equal = sum(np.array_equal(x.meta["label_index"], y.meta["label_index"])
                and np.array_equal(x.meta["score"], y.meta["score"])
                for x, y in zip(a, b))
    check(equal == 17, f"bucket 32 at occupancies 17 and 32: {equal} of 17 rows equal")
    buckets = sorted(k[0] for k in stage._batcher._sets)
    check(buckets == [32], f"bucket steps {buckets}")
    return equal


def batching_scaler(dev, acc="", n=SCALER_BUFFERS, dims=SCALER_DIMS):
    """bench.py's bench_batching cell: appsrc ! scaler ! sink backlogged,
    queue_capacity 64, batch_max 8 against 1 on identical input, best of
    three windows each, in turns (8, 1, 1, 8)."""
    import threading

    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics

    frames = [np.full((dims,), float(i % 7), np.float32) for i in range(8)]
    desc = SCALER_DESC.format(dims=dims, acc=acc)

    def run(bmax):
        p = ntt.Pipeline(desc, queue_capacity=64, batch_max=bmax)
        f = p.element("f")
        walls = []
        with p:
            for i in range(64):
                p.push("src", frames[i % 8])
            for _ in range(64):
                p.pull("out", timeout=WAIT_S)
            if bmax > 1:
                warm_buckets(f, frames[0], bmax)
            metrics.reset()
            for _ in range(3):
                def pusher():
                    for i in range(n):
                        p.push("src", frames[i % 8])

                t = threading.Thread(target=pusher, daemon=True)
                t0 = time.perf_counter()
                t.start()
                outs = [p.pull("out", timeout=WAIT_S) for _ in range(n)]
                walls.append(time.perf_counter() - t0)
                t.join(timeout=WAIT_S)
                check(not t.is_alive(), "the pusher never finished")
            snap = metrics.snapshot()
            p.eos()
            p.wait(timeout=60)
        check(all(np.array_equal(np.asarray(o.tensors[0]), frames[i % 8] * 1.5)
                  for i, o in enumerate(outs)), "scaler cell: wrong values")
        r = dict(frames_per_s=n / min(walls),
                 occupancy_mean=snap.get("f.batch_occupancy.mean"),
                 occupancy_p99=snap.get("f.batch_occupancy.p99"))
        if bmax > 1:
            [(_, br)] = f._batchers.values()
            check(br.census.device.type == dev.type,
                  f"scaler cell: bucket steps on {br.census.device}")
            check(r["occupancy_p99"] and r["occupancy_p99"] > 1,
                  "scaler cell: the runner never drained more than one buffer")
            r["census"] = dict(captures=br.census.captures, replays=br.census.replays)
        return r

    runs = {8: [], 1: []}
    for bmax in (8, 1, 1, 8):
        runs[bmax].append(run(bmax))
    best = {b: max(rs, key=lambda r: r["frames_per_s"]) for b, rs in runs.items()}
    return dict(runs={str(b): rs for b, rs in runs.items()},
                fps_batched=best[8]["frames_per_s"], fps_unbatched=best[1]["frames_per_s"],
                speedup=best[8]["frames_per_s"] / best[1]["frames_per_s"],
                occupancy_mean=best[8]["occupancy_mean"])


def batching_adaptive(dev, burst=ADAPTIVE_BURST, bursts=ADAPTIVE_BURSTS,
                      warm_bursts=ADAPTIVE_WARM_BURSTS, dims=ADAPTIVE_DIMS,
                      layers=ADAPTIVE_LAYERS):
    """bench.py's bench_adaptive cell: a custom-easy MLP (``layers`` of
    tanh(x @ w), w from default_rng(11) as in bench.py, on ``dev``) fed
    bursts of ``burst`` same-spec buffers, two pipelined, batch_max 8,
    adaptive_buckets on against off; best of three windows each.  The
    frames are pushed as tensors on ``dev`` (the bench's eight fixed
    arrays, uploaded once)."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.core.types import TensorsSpec
    from nnstreamer_tpu_torch.filters.custom_easy import (register_custom_easy,
                                                          unregister_custom_easy)

    w = torch.from_numpy((np.random.default_rng(11).standard_normal((dims, dims))
                          .astype(np.float32) * (0.9 / np.sqrt(dims)))
                         .astype(np.float32)).to(dev)

    def mlp(ins):
        x = ins[0]
        for _ in range(layers):
            x = torch.tanh(x @ w)
        return [x]

    name = f"chip-adaptive-mlp-{time.monotonic_ns()}"
    spec = TensorsSpec.from_string(str(dims), "float32")
    register_custom_easy(name, mlp, in_spec=spec, out_spec=spec, jax_traceable=True)
    frames = [torch.full((dims,), float(i % 7) * 0.1, dtype=torch.float32, device=dev)
              for i in range(8)]

    def run(adaptive):
        metrics.reset()
        p = ntt.Pipeline(ADAPTIVE_DESC.format(dims=dims, model=name), queue_capacity=64,
                         batch_max=8, adaptive_buckets=adaptive)
        walls = []
        with p:
            def cycle(n):
                k = 0
                for _ in range(2):
                    for _ in range(burst):
                        p.push("src", frames[k % 8])
                        k += 1
                for _ in range(n - 2):
                    for _ in range(burst):
                        p.pull("out", timeout=WAIT_S)
                    for _ in range(burst):
                        p.push("src", frames[k % 8])
                        k += 1
                for _ in range(2 * burst):
                    p.pull("out", timeout=WAIT_S)

            cycle(warm_bursts)
            waste0 = metrics.snapshot().get("f.batch_pad_waste", 0.0)
            [(_, br)] = p.element("f")._batchers.values()
            warm = br.census.captures
            for _ in range(3):
                t0 = time.perf_counter()
                cycle(bursts)
                walls.append(time.perf_counter() - t0)
            snap = metrics.snapshot()
            ladders = p.ladder_snapshot()
            p.eos()
            p.wait(timeout=60)
        check(br.census.device.type == dev.type,
              f"adaptive cell: bucket steps on {br.census.device}")
        check(snap.get("f.batch_occupancy.p99", 0) > 1,
              "adaptive cell: the runner never drained more than one buffer")
        return dict(frames_per_s=bursts * burst / min(walls),
                    pad_waste=snap.get("f.batch_pad_waste", 0.0),
                    pad_waste_timed=snap.get("f.batch_pad_waste", 0.0) - waste0,
                    occupancy_mean=snap.get("f.batch_occupancy.mean"),
                    ladder=ladders.get("f"), captures=br.census.captures,
                    captures_after_warmup=br.census.captures - warm)

    try:
        on, off = run(True), run(False)
    finally:
        unregister_custom_easy(name)
    check(on["ladder"] is not None and burst in on["ladder"],
          f"adaptive cell: the refined ladder {on['ladder']} lacks {burst}")
    return dict(adaptive=on, static=off, speedup=on["frames_per_s"] / off["frames_per_s"])


def fill_forms(dev, rows=BATCHING_MAX, size=224, reps=50):
    """Host µs to fill a bucket's static input from card rows: one
    torch.stack(out=) against one copy_ per row ([1, size, size, 3] uint8
    rows; the card's time of each too)."""
    import torch

    col = [torch.randint(0, 256, (1, size, size, 3), dtype=torch.uint8, device=dev)
           for _ in range(rows)]
    dst = torch.empty((rows, 1, size, size, 3), dtype=torch.uint8, device=dev)

    def stack():
        torch.stack(col, out=dst)

    def copies():
        for i, c in enumerate(col):
            dst[i].copy_(c)

    out = {}
    for name, fn in (("stack", stack), ("copies", copies)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        dev_ms, _ = timed_ms(fn, lambda: None, reps=20)
        out[name] = dict(host_us=host, card_us=dev_ms * 1e3)
    return out


def phase_batching(dev, size=224, frames_n=BATCHING_FRAMES, acc="",
                   runs=BATCHING_RUNS, profile=False):
    """Micro-batching on ``dev``: the per-frame quick-start at batch_max 1
    against BATCHING_MAX (streaming, ``runs`` each, in turns), its bucket rows bitwise
    across occupancies and its batched outputs against the unbatched
    logits; bench.py's two batching cells; the dispatch window at
    WINDOW_DEPTHS (backlog, bitwise); ingress donation on and off (the
    batch-64 quick-start and the per-frame backlog, bitwise).  An op with
    no batching rule raises (the vmap fallback is off) and fails the
    phase."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.pipeline.batching import ladder

    on_card = dev.type == "cuda"
    torch._C._functorch._set_vmap_fallback_enabled(False)
    out = {}
    try:
        rng = np.random.default_rng(5)
        frames = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
                  for _ in range(frames_n)]
        # 1. the slice's cell: per frame, batch_max 1 against BATCHING_MAX
        cell = {1: [], BATCHING_MAX: []}
        results = {}
        for k in range(2 * runs):
            bmax = (1, BATCHING_MAX)[(k + k // 2) % 2]
            res, st = per_frame_run(dev, frames, bmax, size=size, acc=acc)
            cell[bmax].append(st)
            results.setdefault(bmax, res)
            if bmax > 1:
                check(st["occupancy_max"] > 1,
                      "per-frame cell: the runner never drained more than one buffer")
                # the one-buffer step and at most one step per bucket above 1
                check(st["census"]["captures"] <= len(ladder(BATCHING_MAX)),
                      f"per-frame cell: {st['census']['captures']} captures")
        out["cell"] = {str(b): rs for b, rs in cell.items()}
        for b, rs in cell.items():
            out[f"median_{b}"] = {k: float(np.median([r[k] for r in rs]))
                                  for k in ("frames_per_s", "p50_ms", "p99_ms")}
        logits, _ = per_frame_run(dev, frames, 1, size=size, acc=acc, labels=False)
        lg = np.stack(logits)
        top = np.sort(lg, axis=1)
        scale = np.abs(lg).max(axis=1)
        held = (top[:, -1] - top[:, -2]) > VISION_TOL * scale
        batched, unbatched = results[BATCHING_MAX], results[1]
        score_ok = int(sum(abs(b[1] - u[1]) <= VISION_TOL * s
                           for b, u, s in zip(batched, unbatched, scale)))
        label_ok = sum(b[0] == u[0] for b, u, h in zip(batched, unbatched, held) if h)
        labels_equal = sum(b[0] == u[0] for b, u in zip(batched, unbatched))
        bitwise = sum(b == u for b, u in zip(batched, unbatched))
        check(score_ok == len(frames),
              f"batched scores off the unbatched ones: {len(frames) - score_ok} frames")
        check(label_ok == int(held.sum()),
              f"batched labels off the unbatched ones: {int(held.sum()) - label_ok} "
              "frames past the tie gap")
        out["against_unbatched"] = dict(
            frames=len(frames), scores_within_tol=score_ok, held=int(held.sum()),
            labels_equal_held=label_ok, labels_equal=labels_equal,
            bitwise=bitwise, max_score_diff_share=float(max(
                abs(b[1] - u[1]) / s for b, u, s in zip(batched, unbatched, scale))))
        out["bucket_rows_bitwise"] = bucket_rows_bitwise(dev, frames, size, acc)
        # 2-3. bench.py's two cells
        out["scaler"] = batching_scaler(dev, acc=acc)
        out["adaptive"] = batching_adaptive(dev)
        # 4. the dispatch window, backlog mode (the same steps every run)
        window = {d: [] for d in WINDOW_DEPTHS}
        first = None
        for d in WINDOW_DEPTHS:
            res, st = per_frame_run(dev, frames, BATCHING_MAX, size=size, acc=acc,
                                    depth=d, backlog=True)
            first = res if first is None else first
            st["bitwise_equal"] = res == first
            check(res == first, f"dispatch_depth {d}: outputs differ from the first run")
            window[d].append(st)
        out["window"] = {str(d): rs for d, rs in window.items()}
        # 5. ingress donation: the planned flags on and off, and the two
        # forms of the ingress copy (the port's fresh pinned memory against
        # reused pinned slots), one run each; every output bitwise equal
        qs_frames = [rng.integers(0, 256, (VISION_BATCH, size, size, 3), dtype=np.uint8)
                     for _ in range(VISION_WARM + VISION_TIMED)]
        qs_desc = QUICKSTART.format(size=size, batch=VISION_BATCH, model="mobilenet_v1",
                                    custom="", acc=acc)
        donation = {"quickstart": {}, "per_frame": {}}
        firsts = {}
        forms = ("fresh", "slot", "donate_off")
        for form in forms if on_card else ("fresh", "donate_off"):
            flag = form != "donate_off"
            with SlotFill() if form == "slot" else contextlib.nullcontext():
                with FillClock() as fill:
                    res, st = vision_host_fed(qs_desc, qs_frames, donate_ingress=flag)
                check(st["stage"]._ingress_put is flag, "quick-start donation not as asked")
                st = {k: v for k, v in st.items() if k != "stage"}
                st["fill_us_per_batch"] = fill.seconds / max(1, fill.calls) * 1e6
                firsts.setdefault("qs", res)
                st["bitwise_equal"] = all(
                    np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                    for x, y in zip(firsts["qs"], res))
                check(st["bitwise_equal"], f"quick-start, ingress {form}: outputs differ")
                donation["quickstart"].setdefault(form, []).append(st)
                res, st = per_frame_run(dev, frames, BATCHING_MAX, size=size, acc=acc,
                                        donate=flag, backlog=True)
                firsts.setdefault("pf", res)
                st["bitwise_equal"] = res == firsts["pf"]
                check(st["bitwise_equal"], f"per-frame, ingress {form}: outputs differ")
                donation["per_frame"].setdefault(form, []).append(st)
        out["donation"] = donation
        # the host: the same streaming cell with the interpreter's thread
        # switch interval at 0.5 ms instead of 5 (every stage is a thread)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(5e-4)
        try:
            out["switch_interval"] = {
                str(b): per_frame_run(dev, frames, b, size=size, acc=acc)[1]
                for b in (1, BATCHING_MAX)}
        finally:
            sys.setswitchinterval(interval)
        if on_card:
            out["fill_forms"] = fill_forms(dev, size=size)
            if profile:
                out["profile"] = batching_profile(dev, frames, size)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    return out


def batching_profile(dev, frames, size):
    """The bucket-32 step's callable (vmapped, run eagerly three times)
    under torch.profiler: its kernels by device time, written to
    chiprun_out/profile_batching.txt (NHWC conv kernels, no layout copy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import nnstreamer_tpu_torch as ntt

    pipe = ntt.Pipeline(PER_FRAME.format(size=size, cap=BATCHING_QUEUE, acc="",
                                         tail=LABELING), batch_max=BATCHING_MAX)
    [stage] = [s.element for s in pipe.stages if s.batchable]
    with pipe:
        pipe.push("src", frames[0])
        pipe.pull("out", timeout=WAIT_S)
        warm_buckets(stage, frames[0], BATCHING_MAX, buckets=[BATCHING_MAX])
        (st,) = stage._batcher._sets.values()
        vfn = torch.func.vmap(stage.composed)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                vfn(tuple(st.inputs))
            torch.cuda.synchronize()
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    avgs = prof.key_averages()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_batching.txt"), "w") as fh:
        fh.write(avgs.table(sort_by="self_device_time_total", row_limit=40) + "\n")
    top = sorted(avgs, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
    return [(e.key[:70], e.self_device_time_total / 3e3) for e in top]


def print_batching(r):
    for b in (1, BATCHING_MAX):
        for st in r["cell"][str(b)]:
            busy = "not measured" if st["busy_share"] is None else f"{st['busy_share']:.3f}"
            print(f"batching: per-frame quick-start (mobilenet_v1 224, batch 1 a buffer, "
                  f"{BATCHING_FRAMES} frames) batch_max={b}: {st['frames_per_s']:.1f} "
                  f"frames/s, per frame p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms, "
                  f"busy {busy}, peak {st['peak_mem_gb'] or 0.0:.3f} GB, reserved "
                  f"{st['reserved_gb'] or 0.0:.3f} GB, pad waste "
                  f"{st['pad_waste']:.0f}, drains {st['drains']}", flush=True)
        last = r["cell"][str(b)][-1]
        print(f"batching: batch_max={b} occupancy (cumulative) {last['occupancy']}; "
              f"card ms by bucket { {k: round(v, 4) for k, v in last['card_ms_by_bucket'].items() if v is not None} }",
              flush=True)
        print(f"census: batching batch_max={b} {last['census']}", flush=True)
        print(f"batching: median batch_max={b} {r[f'median_{b}']}", flush=True)
    print(f"batching: batched against unbatched {r['against_unbatched']}; bucket 32 rows "
          f"at occupancies 17 and 32: {r['bucket_rows_bitwise']} of 17 bitwise", flush=True)
    s = r["scaler"]
    print(f"batching: bench_batching cell (scaler, dims {SCALER_DIMS}, queue 64) "
          f"batch_max 8 {s['fps_batched']:.1f} against 1 {s['fps_unbatched']:.1f} "
          f"buffers/s: {s['speedup']:.3f}x, occupancy mean {s['occupancy_mean']}", flush=True)
    a = r["adaptive"]
    print(f"batching: bench_adaptive cell (MLP {ADAPTIVE_DIMS} x {ADAPTIVE_LAYERS}, bursts "
          f"of {ADAPTIVE_BURST}) adaptive {a['adaptive']['frames_per_s']:.1f} against "
          f"static {a['static']['frames_per_s']:.1f} buffers/s: {a['speedup']:.3f}x; pad "
          f"waste timed {a['adaptive']['pad_waste_timed']:.0f} against "
          f"{a['static']['pad_waste_timed']:.0f} (all {a['adaptive']['pad_waste']:.0f} "
          f"against {a['static']['pad_waste']:.0f}); refined ladder "
          f"{a['adaptive']['ladder']}", flush=True)
    for d, rs in r["window"].items():
        print(f"batching: dispatch_depth {d} (backlog) "
              f"{[round(x['frames_per_s'], 1) for x in rs]} frames/s, bitwise "
              f"{[x['bitwise_equal'] for x in rs]}", flush=True)
    for cell, d in r["donation"].items():
        for form, rs in d.items():
            key = "fill_us_per_batch" if cell == "quickstart" else "fill_us_per_frame"
            print(f"batching: ingress {form} {cell} "
                  f"{[round(x['frames_per_s'], 1) for x in rs]} frames/s, fill "
                  f"{[round(x[key], 2) for x in rs]} host us per "
                  f"{'batch' if cell == 'quickstart' else 'frame'}, bitwise "
                  f"{[x['bitwise_equal'] for x in rs]}", flush=True)
    for b, st in r["switch_interval"].items():
        print(f"batching: switch interval 0.5 ms, batch_max={b}: "
              f"{st['frames_per_s']:.1f} frames/s, p50 {st['p50_ms']:.2f} ms, busy "
              f"{st['busy_share']}", flush=True)
    if "fill_forms" in r:
        print(f"batching: filling a bucket-32 input from card rows {r['fill_forms']}",
              flush=True)
    if "profile" in r:
        print(f"profile: batching bucket 32 top kernels, ms per step {r['profile']}",
              flush=True)


CAMERA_FRAMES = 128
CAMERA_RUNS = 1
CAMERA_INFLIGHT = 8
CAMERA_REGIONS = 4
CAMERA_WARM = 4
#: the slice's pipeline: raw RGB bytes from a camera through detection;
#: one tee feeds the frame and the detector's top regions into
#: tensor_crop, another round-trips the detector's tensors through the
#: wire format
CAMERA = ("appsrc name=cam caps=video/x-raw,format=RGB,width={size},height={size},"
          f"framerate=30/1 max-inflight={CAMERA_INFLIGHT} ! tensor_converter ! tee name=t "
          "t. ! " + NORM + " ! tensor_filter framework=jax model={model} "
          "custom=size:{size},classes:91,batch:1{custom} {acc} ! tee name=d "
          "d. ! tensor_decoder name=region mode=tensor_region option1={size}:{size} "
          f"option2={CAMERA_REGIONS} ! crop.sink_1 "
          "d. ! tensor_decoder mode=flexbuf ! tensor_converter mode=flexbuf ! "
          "tensor_sink name=wire "
          "t. ! crop.sink_0 "
          "tensor_crop name=crop ! tensor_sink name=crops")
#: batches of the folded random source, and frames per batch (the vision
#: phase's quick-start batch, whose captured shape that phase has run)
CAMERA_RANDOM_BATCHES = 3
CAMERA_RANDOM_BATCH = VISION_BATCH


def camera_frames(n, size, seed):
    """``n`` frames as a camera delivers them, each one 1-D uint8 array of
    ``size * size * 3`` bytes (320 * 3 = 960 bytes a row: no stride
    padding): seeded noise with a box moving across it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    box = max(1, size // 4)
    for i in range(n):
        x, y = (i * 7) % (size - box), (i * 3) % (size - box)
        frames[i, y:y + box, x:x + box] = (255, 64, 0)
    return [f.reshape(-1) for f in frames]


def crop_slices(frame, regions):
    """What tensor_crop must emit for ``regions`` of an (H, W, C) frame:
    numpy slices, each region clipped to the frame."""
    import numpy as np

    h, w = frame.shape[:2]
    out = []
    for x, y, cw, ch in np.asarray(regions, np.int64).reshape(-1, 4):
        x0, y0 = int(np.clip(x, 0, w)), int(np.clip(y, 0, h))
        x1, y1 = int(np.clip(x + cw, 0, w)), int(np.clip(y + ch, 0, h))
        out.append(frame[y0:y1, x0:x1])
    return out


def tap_regions(pipe):
    """Record, by pts, the regions the tensor_region branch produces."""
    import numpy as np

    regions = {}
    dec = pipe.element("region").decoder
    decode = dec.decode

    def tap(tensors, buf):
        out = decode(tensors, buf)
        regions[buf.pts] = np.asarray(out.tensors[0]).copy()
        return out

    dec.decode = tap
    return regions


def tap_detector(stage):
    """Record, by pts, the fused stage's outputs on the host (a copy per
    frame, waiting for the card: the checked run only)."""
    dets = {}
    finish = stage._finish

    def tap(buf, out):
        new = finish(buf, out)
        dets[buf.pts] = [t.cpu() for t in new.tensors]
        return new

    stage._finish = tap
    return dets


def camera_run(pipe, frames, pts0):
    """Push ``frames`` (pts ``pts0 + i``) from a thread while this thread
    pulls each frame's crops and wire buffer in order -> (crops, wires,
    push-to-crop ms per frame, wall seconds)."""
    import threading

    import nnstreamer_tpu_torch as ntt

    push_ts = {}

    def pusher():
        for i, f in enumerate(frames):
            push_ts[i] = time.perf_counter()
            pipe.push("cam", ntt.Buffer([f], pts=pts0 + i))

    crops, wires, lat = [], [], []
    t = threading.Thread(target=pusher, daemon=True)
    t0 = time.perf_counter()
    t.start()
    for i in range(len(frames)):
        crops.append(pipe.pull("crops", timeout=WAIT_S))
        lat.append((time.perf_counter() - push_ts[i]) * 1e3)
        wires.append(pipe.pull("wire", timeout=WAIT_S))
    wall = time.perf_counter() - t0
    t.join(timeout=60)
    check(not t.is_alive(), "the camera pusher never finished")
    return crops, wires, lat, wall


def camera_check(frames, size, pts0, crops, wires, regions, dets):
    """Every frame of a run: its crops are numpy slices of the frame pushed
    at the regions the tensor_region branch produced, those regions equal
    the host recompute from the wire's detector tensors, and (``dets``)
    the wire's tensors are bitwise the detector's.  -> frames checked."""
    import numpy as np

    from nnstreamer_tpu_torch.decoders.direct_video import regions as host_regions

    for i, (f, c, w) in enumerate(zip(frames, crops, wires)):
        pts = pts0 + i
        check(c.pts == pts and w.pts == pts, f"frame {pts} out of order")
        boxes, scores = (np.asarray(t, np.float32) for t in w.tensors)
        want = host_regions(boxes, scores, CAMERA_REGIONS, size, size)
        if regions is not None:
            check(np.array_equal(regions[pts], want),
                  f"frame {pts}: tensor_region {regions[pts].tolist()} against the "
                  f"host recompute {want.tolist()}")
        frame = f.reshape(size, size, 3)
        got = [np.asarray(t) for t in c.tensors]
        sl = crop_slices(frame, want)
        check(len(got) == len(sl) and all(
            g.shape == s.shape and np.array_equal(g, s) for g, s in zip(got, sl)),
            f"frame {pts}: a crop is not the slice of its own frame")
        if dets:
            check(all(np.asarray(a).shape == tuple(b.shape)
                      and np.asarray(a).tobytes() == b.numpy().tobytes()
                      for a, b in zip(w.tensors, dets[pts])),
                  f"frame {pts}: the wire's tensors are not the detector's")
    return len(frames)


def camera_random(dev, size, acc, batches=CAMERA_RANDOM_BATCHES,
                  batch=CAMERA_RANDOM_BATCH):
    """``videotestsrc device=true pattern=random`` folded into the
    quick-start stage, twice with the same settings: the frames each run
    drew (recorded at the source), two of them differ, the second run's
    are bitwise the first's, and nothing is captured after the first
    batch."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt

    desc = QUICKSTART_SRC.format(batch=batch, frames=batches * batch, size=size,
                                 acc=acc).replace("name=src", "pattern=random name=src")
    runs = []
    for _ in range(2):
        pipe = ntt.Pipeline(desc)
        stage, _names = vision_stage(pipe)
        src = [s.element for s in pipe.stages if s.element.kind == "fused"][0].source
        drawn = []
        make = src.device_batch

        def tap(i0, n, device, _make=make, _drawn=drawn):
            out = _make(i0, n, device)
            _drawn.append(out.cpu())
            return out

        src.device_batch = tap
        with pipe:
            labels = [np.asarray(pipe.pull("out", timeout=WAIT_S).meta["label_index"])]
            warm = stage.census.captures
            labels += [np.asarray(pipe.pull("out", timeout=WAIT_S).meta["label_index"])
                       for _ in range(batches - 1)]
            census = census_of(stage.census, warm)
            pipe.wait(timeout=WAIT_S)
        check(stage.device.type == dev.type, f"the random-source stage runs on {stage.device}")
        runs.append((torch.cat(drawn), labels, census))
    (a, la, census), (b, lb, _) = runs
    check(a.shape == (batches * batch, size, size, 3) and a.dtype == torch.uint8,
          f"random frames {tuple(a.shape)} {a.dtype}")
    differ = not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[batch])
    check(differ, "two random frames are equal")
    same = torch.equal(a, b) and all(np.array_equal(x, y) for x, y in zip(la, lb))
    check(same, "a second random-source pipeline drew other frames")
    return dict(frames=int(a.shape[0]), frames_differ=differ, rerun_bitwise=same,
                census=census, mean=float(a.float().mean()))


def phase_camera(dev, size=320, frames_n=CAMERA_FRAMES, runs=CAMERA_RUNS, acc="",
                 custom="", model="ssd_mobilenet", random_size=224):
    """The slice's camera pipeline (``CAMERA``) at ``size``: ``runs`` timed
    runs of ``frames_n`` seeded frames, then a checked run of the same
    frames with the detector tapped, every frame of every run checked
    (``camera_check``); then the folded random source."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics

    on_card = dev.type == "cuda"
    frames = camera_frames(frames_n, size, seed=0)
    warm = camera_frames(CAMERA_WARM, size, seed=1)
    base = 0
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = ntt.Pipeline(CAMERA.format(size=size, model=model, custom=custom, acc=acc))
    stage, names = vision_stage(pipe)
    check(not stage._donate and not stage._ingress_put,
          "the detector's frames came through a tee and must not be donated")
    out = dict(size=size, frames=frames_n, stages=names, runs=[])
    regions = tap_regions(pipe)
    with pipe:
        crops, wires, _, _ = camera_run(pipe, warm, pts0=-len(warm))
        check(stage.device.type == dev.type, f"the detector's stage runs on {stage.device}")
        checked = camera_check(warm, size, -len(warm), crops, wires, regions, None)
        warm_captures = stage.census.captures
        for r in range(runs):
            metrics.reset()
            crops, wires, lat, wall = camera_run(pipe, frames, pts0=r * frames_n)
            snap = metrics.snapshot()
            check(snap.get("crop.dropped", 0) == 0 and snap.get("crop.out") == frames_n,
                  f"the crop collation dropped frames: {snap.get('crop.dropped')}")
            checked += camera_check(frames, size, r * frames_n, crops, wires, regions, None)
            lat = np.sort(np.asarray(lat))
            # each stage's mean ms a buffer (``<stage>.proc``: process,
            # and for all but the collator its emit, which may wait on a
            # full queue below)
            proc = {n: round(snap[f"{n}.proc.mean"] * 1e3, 4) for n in names
                    if f"{n}.proc.mean" in snap}
            out["runs"].append(dict(frames_per_s=frames_n / wall, wall_s=wall,
                                    p50_ms=float(np.percentile(lat, 50)),
                                    p99_ms=float(np.percentile(lat, 99)),
                                    crops=sum(len(c.tensors) for c in crops),
                                    stage_ms=proc))
        dets = tap_detector(stage)
        crops, wires, _, _ = camera_run(pipe, frames, pts0=runs * frames_n)
        checked += camera_check(frames, size, runs * frames_n, crops, wires, regions, dets)
        out["census"] = census_of(stage.census, warm_captures)
        out["card_ms"] = stage_card_ms(stage)
        out["peak_mem_gb"] = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9
                              if on_card else None)
        pipe.eos("cam")
        pipe.wait(timeout=WAIT_S)
    out["checked_frames"] = checked
    out["dropped"] = metrics.snapshot().get("crop.dropped", 0)
    for r in out["runs"]:
        r["busy_share"] = (None if out["card_ms"] is None
                           else frames_n * out["card_ms"] / (r["wall_s"] * 1e3))
    out["random"] = camera_random(dev, random_size, acc)
    return out


def print_camera(c):
    for i, r in enumerate(c["runs"]):
        busy = ("not measured" if r["busy_share"] is None
                else f"{r['busy_share']:.3f}")
        print(f"camera: run {i} ssd_mobilenet {c['size']} per frame, raw RGB bytes "
              f"through tee/tensor_region/tensor_crop and the flexbuf round trip: "
              f"{r['frames_per_s']:.1f} frames/s over {c['frames']} frames, push to "
              f"crop p50 {r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms, busy share "
              f"{busy}, {r['crops']} crops", flush=True)
        print(f"camera: run {i} mean ms a buffer by stage {r['stage_ms']}", flush=True)
    card = "not measured" if c["card_ms"] is None else f"{c['card_ms']:.3f} ms"
    peak = "not measured" if c["peak_mem_gb"] is None else f"{c['peak_mem_gb']:.3f} GB"
    print(f"camera: stages {c['stages']}; detector step {card} on the card per frame; "
          f"peak {peak}; crop.dropped {c['dropped']}; {c['checked_frames']} frames "
          f"checked (crops are slices of their own frame, regions equal the host "
          f"recompute, the wire's tensors bitwise the detector's on the last run)",
          flush=True)
    print(f"census: camera {c['census']}", flush=True)
    print(f"camera: random device source {c['random']}", flush=True)


#: windowed streaming ASR (the JAX package's examples/asr_streaming_window.py):
#: 4,000-sample chunks into 16,000-sample windows at 75% overlap, into
#: speech_commands at full width (64 mels, float32); ``{mode}`` is
#: ``device=true `` (the card-resident ring) or empty (the host carry)
ASR = ("audiotestsrc device=true num-buffers={chunks} samplesperbuffer=4000 rate=16000 "
       "freq=880 name=src ! tensor_aggregator frames_in=4000 frames_out=16000 "
       "frames_flush=4000 frames_dim=0 {mode}name=agg ! tensor_filter framework=jax "
       "model=speech_commands custom=dtype:float32 {acc} name=f ! tensor_sink name=out")
ASR_WINDOWS = 128
ASR_RUNS = 2
#: windows (and their scores) held bitwise between the two carries
ASR_CHECKED = 32
#: buffers the aggregator takes alone under the sync-debug trap
ASR_GATE_BUFFERS = 100
ASR_MODES = (("ring", "device=true "), ("host", ""))


def asr_run(mode, windows, acc, tap=False):
    """One run of ``ASR`` -> a dict: the scores, the windows tapped at the
    aggregator as host copies (or None), windows/s between the first and
    the last window at the sink, wall s from start, ``<stage>.proc`` by
    stage, and the pipeline."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.buffer import _to_numpy
    from nnstreamer_tpu_torch.core.log import metrics

    pipe = ntt.Pipeline(ASR.format(chunks=windows + 3, mode=mode, acc=acc))
    agg = pipe.element("agg")
    seen = None
    if tap:
        seen = []
        process = agg.process

        def tapped(pad, buf, _process=process):
            outs = _process(pad, buf)
            seen.extend(_to_numpy(b.tensors[0]).copy() for _, b in outs)
            return outs

        agg.process = tapped
    scores, stamps = [], []
    metrics.reset()
    t0 = time.perf_counter()
    with pipe:
        for _ in range(windows):
            scores.append(np.asarray(pipe.pull("out", timeout=WAIT_S).tensors[0]))
            stamps.append(time.perf_counter())
        pipe.wait(timeout=WAIT_S)
    snap = metrics.snapshot()
    names = [st.element.name for st in pipe.stages]
    return dict(scores=scores, windows=seen, pipe=pipe, wall_s=stamps[-1] - t0,
                windows_per_s=(windows - 1) / (stamps[-1] - stamps[0]),
                stage_ms={n: round(snap[f"{n}.proc.mean"] * 1e3, 4) for n in names
                          if f"{n}.proc.mean" in snap})


def asr_card_ms(pipe, dev, reps=20):
    """Device ms of the filter's step on one window (its eager forward,
    CUDA events; a 10 ms spin kernel ahead of each start event so the
    host has enqueued the whole forward before the card reaches it);
    None off the card."""
    import torch

    if dev.type != "cuda":
        return None
    fw = pipe.element("f")._ensure_fw()
    win = torch.randn(1, 16000, device=dev)
    for _ in range(2):
        fw.invoke([win])
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        torch.cuda._sleep(20_000_000)
        starts[i].record()
        fw.invoke([win])
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def asr_ring_gate(dev, buffers=ASR_GATE_BUFFERS):
    """The aggregator alone, ``device=true``, on card tensors: ``buffers``
    chunks appended under ``torch.cuda.set_sync_debug_mode("error")`` (a
    synchronizing call raises), one ring allocation, every window a
    storage of its own and bitwise the concatenation of its chunks."""
    import torch

    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator

    agg = TensorAggregator(dict(frames_in=4000, frames_out=16000, frames_flush=4000,
                                frames_dim=0, device="true"), name="agg")
    agg.ring_device = dev
    agg.configure({}, ["src"])
    gen = torch.Generator(device=dev).manual_seed(0)
    chunks = [torch.randn(1, 4000, device=dev, generator=gen) for _ in range(buffers)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        wins = [b.tensors[0] for x in chunks
                for _, b in agg.process("sink", Buffer([x]))]
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    check(len(wins) == buffers - 3, f"{len(wins)} windows from {buffers} chunks")
    check(agg.ring_allocations == 1, f"{agg.ring_allocations} ring allocations")
    ring = agg._rings.untyped_storage().data_ptr()
    ptrs = {w.untyped_storage().data_ptr() for w in wins}
    check(ring not in ptrs and len(ptrs) == len(wins),
          "a window shares storage with the ring or another window")
    same = all(torch.equal(w, torch.cat(chunks[i:i + 4], dim=1))
               for i, w in enumerate(wins))
    check(same, "a ring window is not the concatenation of its chunks")
    return dict(buffers=buffers, windows=len(wins), ring_allocations=agg.ring_allocations,
                ring_shape=list(agg._rings.shape), sync_debug=dev.type == "cuda")


def phase_asr(dev, windows=ASR_WINDOWS, runs=ASR_RUNS, acc="", checked=ASR_CHECKED):
    """Windowed streaming ASR with the device ring against the host carry:
    a checked run of each (the first ``checked`` windows tapped at the
    aggregator, windows and scores bitwise between the carries), then
    ``runs`` timed runs of ``windows`` windows each, the carries in turns
    (every score bitwise between them too); the filter's card ms per
    window and busy share; the aggregator alone under the sync trap."""
    import numpy as np

    on_card = dev.type == "cuda"
    out = dict(windows=windows, runs={k: [] for k, _ in ASR_MODES})
    ref = {}
    for key, mode in ASR_MODES:
        r = asr_run(mode, checked, acc, tap=True)
        pipe = r["pipe"]
        agg = pipe.element("agg")
        if key == "ring":
            check(agg.ring_allocations == 1, f"ring allocations {agg.ring_allocations}")
            check(agg.ring_device is not None and agg.ring_device.type == dev.type,
                  f"the ring sits on {agg.ring_device}")
            check(pipe.residency.resident_edges >= 1,
                  "the aggregator's edge does not count resident")
        ref[key] = (r["scores"], r["windows"])
    (s_ring, w_ring), (s_host, w_host) = ref["ring"], ref["host"]
    check(len(w_ring) == len(w_host) == checked, "tapped windows missing")
    wins_equal = all(a.tobytes() == b.tobytes() for a, b in zip(w_ring, w_host))
    scores_equal = all(a.tobytes() == b.tobytes() for a, b in zip(s_ring, s_host))
    check(wins_equal, "ring windows differ from the host carry's")
    check(scores_equal, "ring scores differ from the host carry's")
    check(all(s.shape == (1, 12) and np.isfinite(s).all() for s in s_ring),
          "speech_commands scores not finite or of the wrong shape")
    out.update(checked=checked, windows_bitwise=wins_equal, scores_bitwise=scores_equal)
    card_ms = None
    for _ in range(runs):
        timed = {}
        for key, mode in ASR_MODES:
            r = asr_run(mode, windows, acc)
            if card_ms is None:
                card_ms = asr_card_ms(r["pipe"], dev)
            timed[key] = r["scores"]
            rate = r["windows_per_s"]
            out["runs"][key].append(dict(
                windows_per_s=rate, wall_s=r["wall_s"], stage_ms=r["stage_ms"],
                busy_share=None if card_ms is None else rate * card_ms / 1e3))
        check(all(a.tobytes() == b.tobytes() for a, b in zip(timed["ring"], timed["host"])),
              "a timed run's ring scores differ from the host carry's")
    out["card_ms"] = card_ms
    out["all_scores_bitwise"] = True
    out["gate"] = asr_ring_gate(dev)
    out["on_card"] = on_card
    return out


def print_asr(a):
    card = "not measured" if a["card_ms"] is None else f"{a['card_ms']:.3f} ms"
    for key, _ in ASR_MODES:
        for i, r in enumerate(a["runs"][key]):
            busy = ("not measured" if r["busy_share"] is None
                    else f"{r['busy_share']:.3f}")
            print(f"asr: run {i} {key} carry, speech_commands f32, 4000-sample chunks into "
                  f"16000-sample windows: {r['windows_per_s']:.1f} windows/s over "
                  f"{a['windows']} windows ({r['wall_s']:.2f} s from start), busy share "
                  f"{busy}; mean ms a buffer by stage {r['stage_ms']}", flush=True)
    print(f"asr: filter step {card} on the card a window; first {a['checked']} windows "
          f"and scores bitwise between the carries {a['windows_bitwise']} / "
          f"{a['scores_bitwise']}, every timed score bitwise {a['all_scores_bitwise']}",
          flush=True)
    print(f"asr: the aggregator alone {a['gate']}", flush=True)


#: the FIFO camera: 640x480 RGB frames from a writer thread, through the
#: stock detection pipeline (``v4l2src ! tee``, one branch scaled to the
#: detector's 320 px and decoded into a 640x480 RGBA overlay, the other
#: queued to the compositor's base pad)
V4L2_W, V4L2_H = 640, 480
V4L2_FRAMES = 32
V4L2_RUNS = 1
#: the stall run: frames written before the writer stalls, and the stall
V4L2_STALL_AFTER = 16
V4L2_STALL_S = 2.0
#: frames replayed through filesrc ! tensor_converter ! filesink
V4L2_REPLAY = 32
V4L2 = ("v4l2src device={fifo} width={w} height={h} format=RGB num-buffers={n} "
        "name=camsrc ! tee name=cam "
        "cam. ! videoscale width={size} height={size} method=bilinear ! tensor_converter ! "
        + NORM + " ! tensor_filter framework=jax model=ssd_mobilenet "
        "custom=size:{size},classes:91{custom} {acc} ! tensor_decoder mode=bounding_boxes "
        "option3=0.0 option4={w}:{h} ! comp.sink_1 "
        "cam. ! queue ! comp.sink_0 "
        "compositor name=comp ! tensor_sink name=out")


class CameraFrames:
    """The FIFO camera's frames, ``[h, w, 3]`` uint8: one seeded noise frame
    with a box moving across it (frame ``i`` made again on demand)."""

    def __init__(self, w=V4L2_W, h=V4L2_H, seed=0):
        import numpy as np

        self.w, self.h = w, h
        self.base = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)

    def __call__(self, i):
        f = self.base.copy()
        box = self.h // 4
        x, y = (i * 7) % (self.w - box), (i * 3) % (self.h - box)
        f[y:y + box, x:x + box] = (255, 64, 0)
        return f


class FifoCamera:
    """A camera played by a writer thread: ``n`` frames written into a new
    FIFO at ``path``, the time each write ended kept; with ``stall_after``
    the writer pauses ``stall_s`` before frame ``stall_after``.  A reader
    that closes early ends the writer (a broken pipe)."""

    def __init__(self, path, frames, n, stall_after=None, stall_s=0.0):
        import threading

        self.path, self.frame, self.n = path, frames, n
        self.stall_after, self.stall_s = stall_after, stall_s
        self.written = {}
        self.error = None
        self.done = threading.Event()
        os.mkfifo(path)
        self.thread = threading.Thread(target=self._write, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _write(self):
        import errno

        try:
            deadline = time.monotonic() + 60
            while True:  # no reader yet: ENXIO; the pipeline opens it at start
                try:
                    fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
                    break
                except OSError as e:
                    if e.errno != errno.ENXIO or time.monotonic() > deadline:
                        raise
                    time.sleep(0.01)
            os.set_blocking(fd, True)
            try:
                for i in range(self.n):
                    if i == self.stall_after:
                        time.sleep(self.stall_s)
                    os.write(fd, self.frame(i).tobytes())
                    self.written[i] = time.perf_counter()
            finally:
                os.close(fd)
        except BrokenPipeError:
            pass  # the reader closed (a pipeline stopped mid-stream)
        except Exception as e:  # noqa: BLE001 - reported by join()
            self.error = e
        finally:
            self.done.set()

    def join(self, timeout=60):
        self.thread.join(timeout=timeout)
        check(not self.thread.is_alive(), "the FIFO writer thread never finished")
        check(self.error is None, f"the FIFO writer failed: {self.error!r}")


def tap_compositor(pipe, cam, frame_ns):
    """Check every group the compositor blends: the base is the camera's
    frame of that pts, and the output is the frame where the overlay is
    transparent and the overlay where it is opaque -> per-frame results."""
    import numpy as np

    comp = pipe.element("comp")
    real = comp.process_group
    res = []

    def tapped(bufs):
        outs = real(bufs)
        base = np.asarray(bufs["sink_0"].tensors[0])
        ov = np.asarray(bufs["sink_1"].tensors[0])
        out = np.asarray(outs[0][1].tensors[0])
        i = int(bufs["sink_0"].pts) // frame_ns
        alpha = ov[..., 3]
        res.append(dict(
            base=np.array_equal(base, cam.frame(i)),
            clear=np.array_equal(out[alpha == 0], base[alpha == 0]),
            opaque=np.array_equal(out[alpha == 255], ov[..., :3][alpha == 255]),
            overlay_px=int((alpha > 0).sum())))
        return outs

    comp.process_group = tapped
    return res


def v4l2_run(tmp, tag, n, size, acc, custom, stall_after=None, stop_after=None,
             tap=False):
    """One run of ``V4L2`` over a FIFO camera of ``n`` frames -> a dict:
    frames/s, write-to-sink p50/p99, ``<stage>.proc`` by stage, the frames
    checked; with ``stop_after`` the pipeline is stopped after that many
    frames, while the writer stalls, and the stop's seconds are kept."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics

    fifo = os.path.join(tmp, f"cam_{tag}")
    cam = FifoCamera(fifo, CameraFrames(), n, stall_after=stall_after,
                     stall_s=V4L2_STALL_S if stall_after is not None else 0.0)
    pipe = ntt.Pipeline(V4L2.format(fifo=fifo, w=V4L2_W, h=V4L2_H, n=n, size=size,
                                    acc=acc, custom=custom))
    names = [s.element.name for s in pipe.stages]
    frame_ns = int(1e9 / 30)
    groups = tap_compositor(pipe, cam, frame_ns) if tap else None
    metrics.reset()
    out = dict(frames=n, stages=names)
    lat, stamps = [], []
    want = n if stop_after is None else stop_after
    pipe.start()
    cam.start()
    try:
        t0 = time.perf_counter()
        for i in range(want):
            b = pipe.pull("out", timeout=WAIT_S)
            stamps.append(time.perf_counter())
            check(b.pts == i * frame_ns, f"frame {i} arrived as pts {b.pts}")
            x = np.asarray(b.tensors[0])
            check(x.shape == (V4L2_H, V4L2_W, 3) and x.dtype == np.uint8,
                  f"frame {i}: composited {x.shape} {x.dtype}")
            check("detections" in b.meta, f"frame {i} carries no detections")
            lat.append((stamps[-1] - cam.written[i]) * 1e3)
        if stop_after is None:
            pipe.wait(timeout=WAIT_S)  # EOS: num-buffers reached
            out["wall_s"] = stamps[-1] - t0
            out["frames_per_s"] = (n - 1) / (stamps[-1] - stamps[0])
        else:
            check(not cam.done.is_set() and len(cam.written) == stall_after,
                  "the writer was not stalled when the stop came")
            t1 = time.perf_counter()
            pipe.stop()
            out["stop_s"] = time.perf_counter() - t1
            check(out["stop_s"] < 10.0, f"stop took {out['stop_s']:.2f} s with the "
                  "writer stalled")
            check(all(not r.thread.is_alive() for r in pipe._unique_runners()),
                  "a stage thread outlived stop()")
    finally:
        pipe.stop()
        cam.join(timeout=60)
        os.unlink(fifo)
    snap = metrics.snapshot()
    out["stage_ms"] = {nm: round(snap[f"{nm}.proc.mean"] * 1e3, 4) for nm in names
                       if f"{nm}.proc.mean" in snap}
    lat = np.sort(np.asarray(lat))
    out["p50_ms"] = float(np.percentile(lat, 50))
    out["p99_ms"] = float(np.percentile(lat, 99))
    out["checked_frames"] = want
    if groups is not None:
        check(len(groups) == want, f"{len(groups)} groups composited for {want} frames")
        for k in ("base", "clear", "opaque"):
            check(all(g[k] for g in groups), f"a composited frame fails its {k} check")
        check(sum(g["overlay_px"] > 0 for g in groups) > 0, "no overlay was drawn")
        out["overlay_px_mean"] = float(np.mean([g["overlay_px"] for g in groups]))
    fused = [s.element for s in pipe.stages if s.element.kind == "fused"]
    check(len(fused) == 1, f"expected one fused stage, got {names}")
    out["device"] = str(fused[0].device)
    return out


def v4l2_replay(tmp, n=V4L2_REPLAY):
    """``n`` of the camera's frames in a file, replayed through
    ``filesrc blocksize=<frame> ! tensor_converter ! filesink``: the
    output file must hold the same bytes."""
    import nnstreamer_tpu_torch as ntt

    cam_path, out_path = os.path.join(tmp, "frames.raw"), os.path.join(tmp, "replay.raw")
    frames = CameraFrames()
    with open(cam_path, "wb") as f:
        for i in range(n):
            f.write(frames(i).tobytes())
    frame = V4L2_W * V4L2_H * 3
    pipe = ntt.Pipeline(
        f"filesrc location={cam_path} blocksize={frame} ! tensor_converter "
        f"input-dim=3:{V4L2_W}:{V4L2_H}:1 input-type=uint8 ! filesink location={out_path}")
    t0 = time.perf_counter()
    with pipe:
        pipe.wait(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    with open(cam_path, "rb") as a, open(out_path, "rb") as b:
        same = a.read() == b.read()
    check(same, "the filesink replay's bytes differ from the frames'")
    size = os.path.getsize(out_path)
    os.unlink(cam_path)
    os.unlink(out_path)
    return dict(frames=n, bytes=size, bitwise=same, wall_s=wall)


def card_elements(dev):
    """tensor_if, the sparse codec and a bf16 filesink on card tensors,
    each against the same element on host copies of the same tensors."""
    import tempfile

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.core.buffer import Buffer
    from nnstreamer_tpu_torch.elements.cond import TensorIf
    from nnstreamer_tpu_torch.elements.sink import FileSink, raw_bytes
    from nnstreamer_tpu_torch.elements.sparse import TensorSparseDec, TensorSparseEnc

    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(64, 128, device=dev, generator=gen) + 0.05 * k for k in range(-4, 5)]
    out = {}
    for value, opt in (("TENSOR_AVERAGE_VALUE", "0"), ("META_VALUE", "flag")):
        decide = {}
        for where in ("card", "host"):
            el = TensorIf(dict(compared_value=value, compared_value_option=opt,
                               operator="GT", supplied_value="0"))
            el.configure({}, ["src"])
            picks = []
            for k, x in enumerate(xs):
                b = Buffer([x if where == "card" else x.cpu().numpy()], pts=k)
                b.meta["flag"] = k - 4
                picks.append([o.pts for _, o in el.process("sink", b)])
            decide[where] = picks
        check(decide["card"] == decide["host"], f"tensor_if {value}: card against host")
        check(0 < sum(map(len, decide["card"])) < len(xs), f"tensor_if {value} is constant")
        out[value] = sum(map(len, decide["card"]))
    sparse = [torch.where(torch.rand(32, 48, device=dev, generator=gen) < 0.1,
                          torch.randn(32, 48, device=dev, generator=gen),
                          torch.zeros((), device=dev)).to(dt)
              for dt in (torch.float32, torch.bfloat16)]
    enc, dec = TensorSparseEnc({}), TensorSparseDec({})
    enc.configure({}, ["src"])
    dec.configure({}, ["src"])
    [(_, blobs)] = enc.process("sink", Buffer(list(sparse)))
    [(_, hblobs)] = enc.process("sink", Buffer([t.cpu() for t in sparse]))
    check(all(a.tobytes() == b.tobytes() for a, b in zip(blobs.tensors, hblobs.tensors)),
          "sparse wire bytes of card tensors differ from the host copies'")
    [(_, back)] = dec.process("sink", blobs)
    check(all(raw_bytes(a) == raw_bytes(b) for a, b in zip(back.tensors, sparse)),
          "the sparse round trip of card tensors changed them")
    out["sparse_bytes"] = [int(b.nbytes) for b in blobs.tensors]
    bf = torch.randn(3, 257, device=dev, generator=gen).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bf16.bin")
        fs = FileSink({"location": path})
        fs.start()
        fs.process("sink", Buffer([bf, bf[:, ::3]]))
        fs.stop()
        with open(path, "rb") as f:
            got = f.read()
    host = bf.cpu()
    want = (host.view(torch.int16).numpy().tobytes()
            + host[:, ::3].contiguous().view(torch.int16).numpy().tobytes())
    check(got == want, "the bf16 filesink's bytes differ from the host's")
    out["bf16_filesink_bytes"] = len(got)
    return out


def phase_v4l2(dev, size=320, frames_n=V4L2_FRAMES, runs=V4L2_RUNS, acc="", custom="",
               replay_n=V4L2_REPLAY):
    """The FIFO camera through the stock detection pipeline: a checked run
    (every composited group checked in a tap), ``runs`` timed runs, a run
    stopped while the writer stalls, the filesrc replay, and the stream
    elements on card tensors."""
    import tempfile

    out = dict(size=size, runs=[])
    with tempfile.TemporaryDirectory(prefix="nnstpu_cam_") as tmp:
        out["checked"] = v4l2_run(tmp, "checked", frames_n, size, acc, custom, tap=True)
        check(out["checked"]["device"].startswith(dev.type),
              f"the detector runs on {out['checked']['device']}")
        for r in range(runs):
            out["runs"].append(v4l2_run(tmp, f"run{r}", frames_n, size, acc, custom))
        out["stall"] = v4l2_run(tmp, "stall", frames_n, size, acc, custom,
                                stall_after=V4L2_STALL_AFTER, stop_after=V4L2_STALL_AFTER)
        out["replay"] = v4l2_replay(tmp, replay_n)
    out["elements"] = card_elements(dev)
    return out


def print_v4l2(v):
    c = v["checked"]
    print(f"v4l2: stages {c['stages']}; detector on {c['device']}; checked run "
          f"{c['checked_frames']} frames in order, each base the camera's frame and the "
          f"overlay composited onto it (mean {c['overlay_px_mean']:.0f} overlay px)",
          flush=True)
    for i, r in enumerate([c] + v["runs"]):
        what = "checked" if i == 0 else f"run {i - 1}"
        print(f"v4l2: {what} FIFO camera {V4L2_W}x{V4L2_H} RGB -> videoscale "
              f"{v['size']} -> ssd_mobilenet -> overlay -> compositor: "
              f"{r['frames_per_s']:.1f} frames/s over {r['frames']} frames, write to sink "
              f"p50 {r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms", flush=True)
        print(f"v4l2: {what} mean ms a buffer by stage {r['stage_ms']}", flush=True)
    s = v["stall"]
    print(f"v4l2: writer stalled {V4L2_STALL_S:.0f} s after {V4L2_STALL_AFTER} frames: "
          f"{s['checked_frames']} frames in order, stop in {s['stop_s']:.3f} s, writer "
          f"joined", flush=True)
    print(f"v4l2: filesrc replay {v['replay']}", flush=True)
    print(f"v4l2: stream elements on card tensors {v['elements']}", flush=True)


#: where the transport phase writes its datarepo set and TorchScript file
#: (removed after)
FILES_DIR = os.path.join(ROOT, "build", "files")
#: the transport phase: frames of each remote run, timed runs, frames in
#: flight between the pusher and the far end (well under every queue on
#: the way: edgesink's and the broker's 64 per subscriber, the shm ring's
#: 8 slots), warm-up frames
TRANSPORT_FRAMES = 64
TRANSPORT_RUNS = 1
TRANSPORT_WINDOW = 8
TRANSPORT_WARM = 4
#: shm frames from the producer process, datarepo samples and epochs,
#: frames through the framework and SingleShot checks
SHM_FRAMES = 32
REPO_SAMPLES = 64
REPO_EPOCHS = 2
FW_FRAMES = 16
#: the remote detection cell: raw RGB frames published by edgesink, a
#: second pipeline subscribing with edgesrc and publishing the decoded
#: detections to the broker, a third subscribing with mqttsrc
REMOTE_CAPS = "video/x-raw,format=RGB,width={size},height={size},framerate=30/1"
REMOTE_DET = ("tensor_converter ! " + NORM + " ! tensor_filter framework=jax "
              "model=ssd_mobilenet custom=size:{size},classes:91,batch:1{custom} {acc} ! "
              "tensor_decoder mode=bounding_boxes option1=ssd option3=0.5 "
              "option4={size}:{size} option6=16 option7=device option9=tensors")
REMOTE_PUB = "appsrc name=cam caps=" + REMOTE_CAPS + " ! edgesink name=pub port=0 topic=cam"
REMOTE_MID = ("edgesrc name=rx port={port} topic=cam ! " + REMOTE_CAPS + " ! "
              + REMOTE_DET + " ! mqttsink name=tx port={broker} topic=det")
REMOTE_SUB = "mqttsrc name=sub port={broker} topic=det ! tensor_sink name=out"
REMOTE_LOCAL = ("appsrc name=cam caps=" + REMOTE_CAPS + " ! " + REMOTE_DET
                + " ! tensor_sink name=out")
#: the shm cell: the producer process normalises frames to bf16 where they
#: lie (on the card) into shmsink; here shmsrc feeds mobilenet_v1
SHM_PRODUCER = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,"
                "types=uint8 ! " + NORM + " ! tensor_transform mode=typecast "
                "option=bfloat16 ! shmsink socket-path={name} buffers=8")
MOBILENET = ("tensor_transform mode=typecast option=float32 ! tensor_filter "
             "framework=jax model=mobilenet_v1 custom=size:{size},batch:1{custom} {acc} "
             "! tensor_sink name=out")
SHM_CONSUMER = ("shmsrc socket-path={name} num-buffers={n} connect-timeout={wait} ! "
                "other/tensors,dimensions=3:{size}:{size}:1,types=bfloat16 ! " + MOBILENET)
SHM_LOCAL = SHM_PRODUCER.split(" ! shmsink")[0] + " ! " + MOBILENET
REPO_SINK = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,types=uint8 "
             "! datareposink location={data} json={meta}")
REPO_SRC = ("datareposrc location={data} json={meta} epochs={epochs} is-shuffle=true "
            "shuffle-seed={seed} ! " + NORM + " ! " + MOBILENET)
REPO_LOCAL = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,types=uint8 "
              "! " + NORM + " ! " + MOBILENET)
FW_FUSED = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,types=float32 "
            "! tensor_filter name=f framework=jax model=mobilenet_v1 "
            "custom=size:{size},batch:1{custom} {acc} ! tensor_sink name=out")
FW_TORCH = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,types=float32 "
            "! tensor_filter name=f framework=pytorch model={model} {acc} "
            "! tensor_sink name=out")


def tensor_bytes(t):
    """(shape, dtype name, bytes) of a numpy array or a torch tensor."""
    import numpy as np
    import torch

    if isinstance(t, torch.Tensor):
        h = t.detach().cpu().contiguous()
        raw = (h.view(torch.int16) if h.dtype == torch.bfloat16 else h).numpy()
        return tuple(h.shape), str(h.dtype).replace("torch.", ""), raw.tobytes()
    a = np.ascontiguousarray(t)
    return a.shape, a.dtype.name, a.tobytes()


def same_tensors(a, b):
    return len(a) == len(b) and all(tensor_bytes(x) == tensor_bytes(y)
                                    for x, y in zip(a, b))


def windowed_run(push, pull, frames, pts0, window=TRANSPORT_WINDOW):
    """Push ``frames`` (pts ``pts0 + i``) from a thread, at most ``window``
    ahead of what this thread has pulled, and pull each in order ->
    (buffers, push-to-pull ms per frame, wall seconds).  ``push(buf)``,
    ``pull() -> buf``."""
    import threading

    import nnstreamer_tpu_torch as ntt

    credits = threading.Semaphore(window)
    push_ts, failed = {}, []

    def pusher():
        try:
            for i, f in enumerate(frames):
                if not credits.acquire(timeout=WAIT_S):
                    raise TimeoutError(f"frame {pts0 + i}: no credit in {WAIT_S} s")
                push_ts[i] = time.perf_counter()
                push(ntt.Buffer([f], pts=pts0 + i))
        except BaseException as e:  # noqa: BLE001 - reported by the puller
            failed.append(e)

    outs, lat = [], []
    t = threading.Thread(target=pusher, daemon=True)
    t0 = time.perf_counter()
    t.start()
    for i in range(len(frames)):
        check(not failed, f"the pusher failed: {failed[:1]}")
        buf = pull()
        lat.append((time.perf_counter() - push_ts[i]) * 1e3)
        check(buf.pts == pts0 + i, f"frame {pts0 + i}: got pts {buf.pts}")
        outs.append(buf)
        credits.release()
    wall = time.perf_counter() - t0
    t.join(timeout=WAIT_S)
    check(not t.is_alive() and not failed, f"the pusher never finished: {failed[:1]}")
    return outs, lat, wall


def transport_remote(dev, size, frames_n, runs, acc, custom):
    """The remote detection cell: edgesink -> edgesrc -> detector ->
    mqttsink -> broker -> mqttsrc, every checked frame's detections
    bitwise equal to the same frames through a local pipeline."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics
    from nnstreamer_tpu_torch.utils.broker import MqttLiteBroker

    frames = camera_frames(frames_n, size, seed=0)
    warm = camera_frames(TRANSPORT_WARM, size, seed=1)
    fmt = dict(size=size, acc=acc, custom=custom)
    local = ntt.Pipeline(REMOTE_LOCAL.format(**fmt))
    with local:
        run = functools.partial(windowed_run, lambda b: local.push("cam", b),
                                lambda: local.pull("out", timeout=WAIT_S))
        run(warm, pts0=0)
        want, _, _ = run(frames, pts0=len(warm))
        local.eos("cam")
        local.wait(timeout=WAIT_S)
    out = dict(size=size, frames=frames_n, runs=[])
    with MqttLiteBroker() as broker, ntt.Pipeline(REMOTE_PUB.format(**fmt)) as pub:
        edge = pub.element("pub")
        mid = ntt.Pipeline(REMOTE_MID.format(port=edge.bound_port, broker=broker.port,
                                             **fmt))
        sub = ntt.Pipeline(REMOTE_SUB.format(broker=broker.port))
        stage, names = vision_stage(mid)
        with mid, sub:
            wait_for(lambda: edge._subs, "edgesrc to subscribe")
            wait_for(lambda: broker.subscriber_count("det"), "mqttsrc to subscribe")
            run = functools.partial(windowed_run, lambda b: pub.push("cam", b),
                                    lambda: sub.pull("out", timeout=WAIT_S))
            run(warm, pts0=0)
            check(stage.device.type == dev.type, f"the detector runs on {stage.device}")
            warm_captures = stage.census.captures
            def bitwise(got):
                n = sum(same_tensors(g.tensors, w.tensors) for g, w in zip(got, want))
                check(n == frames_n, f"remote detection: {n} of {frames_n} frames "
                      "bitwise equal to the local pipeline's")
                return n

            got, _, _ = run(frames, pts0=len(warm))
            out["checked_frames"] = bitwise(got)
            out["outputs"] = [tensor_bytes(t)[:2] for t in got[0].tensors]
            for r in range(runs):
                metrics.reset()
                got, lat, wall = run(frames, pts0=len(warm) + (r + 1) * frames_n)
                snap = metrics.snapshot()
                check(snap.get("pub.dropped", 0) == 0, "edgesink dropped frames")
                out["checked_frames"] += bitwise(got)  # after the timing
                lat = np.sort(np.asarray(lat))
                out["runs"].append(dict(
                    frames_per_s=frames_n / wall, wall_s=wall,
                    p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)),
                    stage_ms={n: round(snap[f"{n}.proc.mean"] * 1e3, 4)
                              for p in (pub, mid, sub) for n in
                              (s.element.name for s in p.stages)
                              if f"{n}.proc.mean" in snap}))
            out["census"] = census_of(stage.census, warm_captures)
            out["card_ms"] = stage_card_ms(stage)
            out["stages"] = names
            pub.eos("cam")
            mid.wait(timeout=WAIT_S)
    for r in out["runs"]:
        r["busy_share"] = (None if out["card_ms"] is None
                           else frames_n * out["card_ms"] / (r["wall_s"] * 1e3))
    return out


def shm_producer(name, frames_n, size, device):
    """The shm cell's producer process: ``frames_n`` seeded frames, put on
    ``device`` and normalised to bf16 there, into ``shmsink``.  It exits
    within the transport phase's deadline, whatever becomes of the
    consumer."""
    import torch

    import nnstreamer_tpu_torch as ntt

    faulthandler.dump_traceback_later(PHASE_DEADLINE_S["transport"], exit=True)

    dev = torch.device(device)
    pipe = ntt.Pipeline(SHM_PRODUCER.format(size=size, name=name))
    with pipe:
        for i, f in enumerate(camera_frames(frames_n, size, seed=2)):
            x = torch.from_numpy(f.reshape(1, size, size, 3)).to(dev)
            pipe.push("src", ntt.Buffer([x], pts=i))
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
        stage = next(s.element for s in pipe.stages if s.element.kind == "fused")
        print(f"shm producer: {frames_n} frames, stage {stage.name} on {stage.device}",
              flush=True)
    return 0


def transport_shm(dev, size, frames_n, acc, custom):
    """The shm cell across two processes: a producer process (this
    script, ``--shm-producer``) fills the ring; ``shmsrc`` here feeds
    mobilenet_v1.  Every logit bitwise equal to the local pipeline's;
    the producer exited cleanly and its segment is gone."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt

    name = f"/nnstpu_smoke_{os.getpid()}"
    fmt = dict(size=size, acc=acc, custom=custom)
    local = ntt.Pipeline(SHM_LOCAL.format(**fmt))
    with local:
        for i, f in enumerate(camera_frames(frames_n, size, seed=2)):
            local.push("src", ntt.Buffer([torch.from_numpy(
                f.reshape(1, size, size, 3)).to(dev)], pts=i))
        want = [local.pull("out", timeout=WAIT_S) for _ in range(frames_n)]
        local.eos("src")
        local.wait(timeout=WAIT_S)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shm-producer",
                             name, str(frames_n), str(size), str(dev)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        pipe = ntt.Pipeline(SHM_CONSUMER.format(name=name, n=frames_n, wait=WAIT_S, **fmt))
        stage, _ = vision_stage(pipe)
        with pipe:
            got = [pipe.pull("out", timeout=WAIT_S) for _ in range(frames_n)]
            pipe.wait(timeout=WAIT_S)
        wall = time.perf_counter() - t0
        stdout, stderr = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    check(proc.returncode == 0, f"the shm producer exited {proc.returncode}: "
          f"{stderr[-2000:]}")
    check(stage.device.type == dev.type, f"the shm consumer runs on {stage.device}")
    bitwise = sum(g.pts == w.pts and np.array_equal(np.asarray(g.tensors[0]),
                                                     np.asarray(w.tensors[0]))
                  for g, w in zip(got, want))
    check(bitwise == frames_n, f"shm: {bitwise} of {frames_n} logits bitwise equal")
    gone = not os.path.exists("/dev/shm/" + name.lstrip("/"))
    check(gone, f"the producer left its segment {name}")
    return dict(frames=frames_n, size=size, bitwise=bitwise, segment_gone=gone,
                frames_per_s=frames_n / wall, wall_s=wall,
                producer=stdout.strip().splitlines()[-1])


def transport_repo(dev, size, n, epochs, acc, custom, seed=3):
    """datareposink writes ``n`` seeded frames; datareposrc replays them
    shuffled for ``epochs`` epochs through mobilenet_v1: each epoch in
    the order ``(seed, epoch)`` gives, every logit bitwise equal to the
    same frame's through a local pipeline."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt

    frames = [f.reshape(1, size, size, 3) for f in camera_frames(n, size, seed=4)]
    os.makedirs(FILES_DIR, exist_ok=True)
    data = os.path.join(FILES_DIR, "smoke_repo.bin")
    meta = os.path.join(FILES_DIR, "smoke_repo.json")
    fmt = dict(size=size, acc=acc, custom=custom, data=data, meta=meta)
    try:
        t0 = time.perf_counter()
        with ntt.Pipeline(REPO_SINK.format(**fmt)) as sink:
            for f in frames:
                sink.push("src", f)
            sink.eos("src")
            sink.wait(timeout=WAIT_S)
        write_s = time.perf_counter() - t0
        check(os.path.getsize(data) == n * frames[0].nbytes, "datareposink's file size")
        with ntt.Pipeline(REPO_LOCAL.format(**fmt)) as local:
            want = []
            for f in frames:
                local.push("src", f)
                want.append(np.asarray(local.pull("out", timeout=WAIT_S).tensors[0]))
            local.eos("src")
            local.wait(timeout=WAIT_S)
        t0 = time.perf_counter()
        src = ntt.Pipeline(REPO_SRC.format(epochs=epochs, seed=seed, **fmt))
        stage, _ = vision_stage(src)
        with src:
            got = [src.pull("out", timeout=WAIT_S) for _ in range(n * epochs)]
            src.wait(timeout=WAIT_S)
        infer_s = time.perf_counter() - t0
    finally:
        for path in (data, meta):
            if os.path.exists(path):
                os.remove(path)
    order = []
    for epoch in range(epochs):
        idx = list(range(n))
        np.random.default_rng((seed, epoch)).shuffle(idx)
        order += [(epoch, i) for i in idx]
    check([(b.meta["epoch"], b.meta["sample_index"]) for b in got] == order,
          "datareposrc's order is not the recomputed shuffle")
    firsts = [[i for e, i in order if e == k] for k in range(min(epochs, 2))]
    check(len(firsts) < 2 or firsts[0] != firsts[1], "two epochs replayed in the same order")
    bitwise = sum(np.array_equal(np.asarray(b.tensors[0]), want[i])
                  for b, (_, i) in zip(got, order))
    check(bitwise == n * epochs, f"datarepo: {bitwise} of {n * epochs} logits bitwise")
    check(stage.device.type == dev.type, f"the datarepo stage runs on {stage.device}")
    return dict(samples=n, epochs=epochs, size=size, bitwise=bitwise,
                write_samples_per_s=n / write_s, infer_samples_per_s=n * epochs / infer_s)


def transport_frameworks(dev, size, n, acc, custom):
    """``framework=pytorch`` with a user ``nn.Module`` and with its
    TorchScript trace (a file), both on ``dev``, against the same
    weights in the fused stage of ``framework=jax model=mobilenet_v1``;
    ``SingleShot`` of that model bitwise equal to the pipeline."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.filters.base import parse_custom_options
    from nnstreamer_tpu_torch.filters.torch_fw import register_torch_module
    from nnstreamer_tpu_torch.models import zoo

    rng = np.random.default_rng(5)
    xs = [rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32) for _ in range(n)]
    opts = f"size:{size},batch:1{custom}"
    bundle = zoo.build("mobilenet_v1", parse_custom_options(opts), device=dev)

    class Net(torch.nn.Module):
        def forward(self, x):
            return bundle.apply_fn(bundle.params, x)

    def run(desc):
        pipe = ntt.Pipeline(desc)
        with pipe:
            outs = []
            for x in xs:
                pipe.push("src", x)
                outs.append(np.asarray(pipe.pull("out", timeout=WAIT_S).tensors[0]))
            el = pipe.element("f")
            pipe.eos("src")
            pipe.wait(timeout=WAIT_S)
        return outs, el.device

    fmt = dict(size=size, acc=acc, custom=custom)
    fused, fused_dev = run(FW_FUSED.format(**fmt))
    register_torch_module("smoke_mobilenet", Net())
    t0 = time.perf_counter()
    module, module_dev = run(FW_TORCH.format(model="smoke_mobilenet", **fmt))
    module_s = time.perf_counter() - t0
    os.makedirs(FILES_DIR, exist_ok=True)
    path = os.path.join(FILES_DIR, "smoke_mobilenet.pt")
    try:
        with torch.no_grad():
            torch.jit.trace(Net(), torch.from_numpy(xs[0]).to(dev)).save(path)
        traced, traced_dev = run(FW_TORCH.format(model=path, **fmt))
    finally:
        if os.path.exists(path):
            os.remove(path)
    with ntt.SingleShot(framework="jax", model="mobilenet_v1", custom=opts,
                        accelerator=acc.split("=", 1)[1] if acc else "") as shot:
        single = [shot.invoke(x)[0] for x in xs]

    def err(a, b):
        return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
                   for x, y in zip(a, b))

    out = dict(frames=n, size=size, devices=sorted({str(d) for d in (
                   fused_dev, module_dev, traced_dev)}),
               module_vs_fused=err(module, fused), traced_vs_module=err(traced, module),
               module_bitwise=all(np.array_equal(a, b) for a, b in zip(module, fused)),
               singleshot_bitwise=all(np.array_equal(a, b) for a, b in zip(single, fused)),
               module_ms=module_s * 1e3 / n)
    check(out["devices"] == [str(dev)], f"the frameworks ran on {out['devices']}")
    check(out["module_vs_fused"] <= VISION_TOL and out["traced_vs_module"] <= VISION_TOL,
          f"framework=pytorch against the fused stage: {out}")
    check(out["singleshot_bitwise"], "SingleShot differs from the pipeline")
    return out


def transport_grpc(dev, n=4):
    """A bf16 round trip over gRPC (tensor_sink_grpc -> tensor_src_grpc),
    bitwise; without grpcio, the elements' clear error at construction."""
    import torch

    import nnstreamer_tpu_torch as ntt

    try:
        import grpc  # noqa: F401
    except ImportError:
        try:
            ntt.Pipeline("tensor_src_grpc port=0 ! tensor_sink name=out")
        except Exception as e:  # noqa: BLE001 - the error is the result
            check("grpcio is not installed" in str(e), f"gRPC without grpcio: {e!r}")
            return dict(grpc=False, error=str(e).splitlines()[0][:160])
        check(False, "tensor_src_grpc constructed without grpcio")
    gen = torch.Generator(device=dev).manual_seed(6)
    xs = [torch.randn(1, 224, 224, 3, generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(n)]
    src = ntt.Pipeline(f"tensor_src_grpc name=rx host=127.0.0.1 port=0 num-buffers={n} "
                       "! tensor_sink name=out to-host=false")
    with src:
        port = src.element("rx").bound_port
        with ntt.Pipeline(f"appsrc name=src ! tensor_sink_grpc host=127.0.0.1 "
                          f"port={port}") as snd:
            for x in xs:
                snd.push("src", x)
            got = [src.pull("out", timeout=WAIT_S) for _ in range(n)]
            snd.eos("src")
            snd.wait(timeout=WAIT_S)
        src.wait(timeout=WAIT_S)
    bitwise = sum(same_tensors(b.tensors, [x]) for b, x in zip(got, xs))
    check(bitwise == n, f"gRPC bf16: {bitwise} of {n} bitwise")
    return dict(grpc=True, port=port, bitwise=bitwise, dtype="bfloat16")


def phase_transport(dev, size=320, frames_n=TRANSPORT_FRAMES, runs=TRANSPORT_RUNS,
                    small=224, shm_n=SHM_FRAMES, repo_n=REPO_SAMPLES, fw_n=FW_FRAMES,
                    acc="", custom=""):
    """The slice's path: remote detection, shm across two processes,
    datarepo replay, the torch framework and SingleShot, gRPC."""
    out = {}
    for key, fn in (
            ("remote", lambda: transport_remote(dev, size, frames_n, runs, acc, custom)),
            ("shm", lambda: transport_shm(dev, small, shm_n, acc, custom)),
            ("repo", lambda: transport_repo(dev, small, repo_n, REPO_EPOCHS, acc, custom)),
            ("torch", lambda: transport_frameworks(dev, small, fw_n, acc, custom)),
            ("grpc", lambda: transport_grpc(dev))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
    return out


def print_transport(t):
    r = t["remote"]
    for i, x in enumerate(r["runs"]):
        busy = "not measured" if x["busy_share"] is None else f"{x['busy_share']:.3f}"
        print(f"transport: remote run {i} ssd_mobilenet {r['size']} over edge and MQTT: "
              f"{x['frames_per_s']:.1f} frames/s over {r['frames']} frames, push to "
              f"receive p50 {x['p50_ms']:.2f} ms p99 {x['p99_ms']:.2f} ms, busy share "
              f"{busy}", flush=True)
        print(f"transport: remote run {i} mean ms a buffer by stage {x['stage_ms']}",
              flush=True)
    card = "not measured" if r["card_ms"] is None else f"{r['card_ms']:.3f} ms"
    print(f"transport: remote {r['checked_frames']} frames (the checked and timed runs) "
          f"bitwise equal to the local pipeline's; detector {card} a frame on the card; outputs "
          f"{r['outputs']}; stages {r['stages']}", flush=True)
    print(f"census: transport {r['census']}", flush=True)
    s = t["shm"]
    print(f"transport: shm {s['frames']} frames {s['size']} px across two processes, "
          f"{s['bitwise']} logits bitwise, segment gone {s['segment_gone']}, "
          f"{s['frames_per_s']:.1f} frames/s with the producer's start-up; "
          f"{s['producer']}", flush=True)
    d = t["repo"]
    print(f"transport: datarepo {d['samples']} samples x {d['epochs']} shuffled epochs, "
          f"{d['bitwise']} logits bitwise; write {d['write_samples_per_s']:.1f} "
          f"samples/s, replay {d['infer_samples_per_s']:.1f} samples/s", flush=True)
    f = t["torch"]
    print(f"transport: framework=pytorch on {f['devices']}: module against the fused "
          f"stage {f['module_vs_fused']:.3g} (bitwise {f['module_bitwise']}), "
          f"TorchScript against the module {f['traced_vs_module']:.3g}, "
          f"{f['module_ms']:.2f} ms a frame; SingleShot bitwise {f['singleshot_bitwise']}",
          flush=True)
    g = t["grpc"]
    print(f"transport: gRPC {'bf16 round trip ' + str(g['bitwise']) + ' bitwise' if g['grpc'] else 'not installed: ' + g['error']}",
          flush=True)
    print("transport: parts " + ", ".join(f"{k} {v['phase_s']:.1f} s"
                                          for k, v in t.items()), flush=True)


#: the modelfiles phase: BASELINE's config #1 in its stock form, a
#: fully-quantized MobileNet-v1 224 .tflite (bench.py's file: seed 42,
#: uint8 activations at 0.05 / 128, int8 per-axis weights, int32 biases,
#: 1001 classes) at batch 64
MF_SIZE = 224
MF_CLASSES = 1001
MF_BATCH = 64
MF_ACT = (0.05, 128)
MF_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
             (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))
#: batches timed after the warm-up (the quantized cell; the float twin half)
MF_TIMED = 10
#: frames of the first batch held bitwise against the CPU's plain path
MF_CHECKED = 16
#: the float twin on the card against the CPU at f32 (TF32 off): a logit
#: may differ by this share of the frame's largest |logit| (28 layers of
#: sums in another order: cuDNN's against the CPU's)
MF_FLOAT_TOL = 1e-4
#: the .onnx MobileNet on the card against its exporting module, run
#: eagerly on the card: a probability may differ by this share of the
#: frame's largest (the exporter folds each BatchNorm into its conv, and
#: the port runs the convs channels_last: other sums, other roundings)
MF_ONNX_TOL = 1e-3
MF_ONNX_BATCH = 16
MF_ONNX_BATCHES = 3
#: int8 tensor-core peak, dense (NVIDIA data sheet): SXM and PCIe parts
INT8_RATES = {"sxm": 1979e12, "pcie": 1513e12}
#: the shapes of the forward named in the phase's lines (the first conv,
#: the first depthwise, a 512 -> 512 pointwise at 14, the FC)
MF_NAMED = ("conv 3->32 k3 s2 @224", "dw 32 k3 s1 @112", "pw 512->512 @14",
            "fc 1024->1001")
MF_QUANT = ("videotestsrc device=true batch={batch} num-buffers={frames} width={size} "
            "height={size} name=src ! other/tensors,num_tensors=1,"
            "dimensions=3:{size}:{size}:{batch},types=uint8,format=static ! "
            "tensor_filter framework=jax model={model} name=f {acc} ! "
            "tensor_transform mode=arithmetic option=typecast:float32,add:-128.0,mul:0.1 "
            "name=deq ! tensor_decoder mode=image_labeling ! "
            "tensor_sink name=out max-buffers=4")
MF_FLOAT_NORM = "tensor_transform mode=arithmetic option=typecast:float32,add:-128.0,mul:0.05"
MF_FLOAT = ("videotestsrc device=true batch={batch} num-buffers={frames} width={size} "
            "height={size} name=src ! " + MF_FLOAT_NORM + " ! "
            "tensor_filter framework=jax model={model} name=f {acc} ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out max-buffers=4")


def mobilenet_layers(size=MF_SIZE, classes=MF_CLASSES):
    """The integer layers of the MobileNet-v1 file, in order: (label,
    kind, input edge, cin, cout, kernel, stride), kind ``conv``, ``dw`` or
    ``fc``."""
    out = [(f"conv 3->32 k3 s2 @{size}", "conv", size, 3, 32, 3, 2)]
    hw, cin = -(-size // 2), 32
    for cout, stride in MF_BLOCKS:
        out.append((f"dw {cin} k3 s{stride} @{hw}", "dw", hw, cin, cin, 3, stride))
        hw = -(-hw // stride)
        out.append((f"pw {cin}->{cout} @{hw}", "conv", hw, cin, cout, 1, 1))
        cin = cout
    out.append((f"fc {cin}->{classes}", "fc", 1, cin, classes, 1, 1))
    return out


def mobilenet_tflite(size=MF_SIZE, classes=MF_CLASSES, batch=MF_BATCH, quantized=True,
                     blocks=MF_BLOCKS):
    """bench.py's fully-quantized MobileNet-v1 file (``_quant_mobilenet_file``,
    the same draws from seed 42, names, scales and bytes), written with the
    port's ``tflite_build``.  ``quantized=False``: its float twin, the same
    topology over the same int8 draws dequantized (float32 weights, zero
    biases, float32 input and logits).  ``blocks``: the depthwise-separable
    blocks, ``MF_BLOCKS`` or its first few (the same draws for the layers
    kept; the FC's come next)."""
    import numpy as np

    from nnstreamer_tpu_torch.models import tflite_build

    rng = np.random.default_rng(42)
    s_act, z_act = MF_ACT
    m = tflite_build.ModelWriter()
    act = (np.uint8, dict(quant_scale=[s_act], quant_zero_point=[z_act])) if quantized \
        else (np.float32, {})
    x = m.add_input([batch, size, size, 3], dtype=act[0], **act[1])

    def qconv(h, cin, cout, k, stride, hw, dw=False):
        if dw:
            w = rng.integers(-127, 128, (1, k, k, cin)).astype(np.int8)
            ax, nscale = 3, cin
            kind, fan = "DEPTHWISE_CONV_2D", k * k
        else:
            w = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
            ax, nscale = 0, cout
            kind, fan = "CONV_2D", k * k * cin
        sw = [2.0 / (127.0 * np.sqrt(fan))] * nscale
        nb = cout if not dw else cin
        if quantized:
            wi = m.add_const(w, f"w{hw}_{cin}_{cout}", quant_scale=sw,
                             quant_zero_point=[0] * nscale, quant_axis=ax)
            bi = m.add_const(np.zeros((nb,), np.int32), f"b{hw}_{cin}_{cout}",
                             quant_scale=[s_act * sw[0]] * nscale,
                             quant_zero_point=[0] * nscale, quant_axis=0)
        else:
            wi = m.add_const(w.astype(np.float32) * np.float32(sw[0]), f"w{hw}_{cin}_{cout}")
            bi = m.add_const(np.zeros((nb,), np.float32), f"b{hw}_{cin}_{cout}")
        oh = -(-hw // stride)
        return m.add_op(kind, [h, wi, bi], [batch, oh, oh, nb], out_dtype=act[0],
                        options={"padding": "SAME", "stride": (stride, stride),
                                 "act": "relu6"}, **act[1]), oh

    h, hw = qconv(x, 3, 32, 3, 2, size)
    cin = 32
    for cout, stride in blocks:
        h, hw = qconv(h, cin, cin, 3, stride, hw, dw=True)
        h, hw = qconv(h, cin, cout, 1, 1, hw)
        cin = cout
    axes = m.add_const(np.asarray([1, 2], np.int32), "mean_axes")
    h = m.add_op("MEAN", [h, axes], [batch, cin], out_dtype=act[0],
                 options={"keep_dims": False}, **act[1])
    fw = rng.integers(-127, 128, (classes, cin)).astype(np.int8)
    s_fc = 2.0 / (127.0 * np.sqrt(cin))
    if quantized:
        fwi = m.add_const(fw, "fcw", quant_scale=[s_fc], quant_zero_point=[0])
        fbi = m.add_const(np.zeros((classes,), np.int32), "fcb",
                          quant_scale=[s_act * 2.0 / (127.0 * np.sqrt(cin))],
                          quant_zero_point=[0])
        y = m.add_op("FULLY_CONNECTED", [h, fwi, fbi], [batch, classes],
                     out_dtype=np.uint8, options={"act": None},
                     quant_scale=[0.1], quant_zero_point=[128])
    else:
        fwi = m.add_const(fw.astype(np.float32) * np.float32(s_fc), "fcw")
        fbi = m.add_const(np.zeros((classes,), np.float32), "fcb")
        y = m.add_op("FULLY_CONNECTED", [h, fwi, fbi], [batch, classes],
                     options={"act": None})
    return m.finish(outputs=[y])


#: the fused rows' forms, taken in turn by layer shape: (input dtype,
#: output dtype, fused activation); every one comes up in the forward
MF_FORMS = (("uint8", "uint8", "none"), ("uint8", "uint8", "relu6"),
            ("int8", "int8", "relu"), ("uint8", "int8", "none"),
            ("int8", "uint8", "relu6"))


def int8_layer_case(dev, gen, i, kind, hw, cin, cout, k, stride, batch):
    """Seeded operands of one layer at its real widths, in the ``i``-th of
    ``MF_FORMS``: the raw unpadded activation ``x`` [B, hw, hw, Cin] (an
    FC's [B, 1, 1, K]) in that dtype, its zero point (never 128 for uint8,
    never 0 for int8: the pad value and the correction are not 0), the
    kernel [O, k, k, Cin/groups], the SAME pads; and the padded int8 input
    ``x8p`` of ``int8_conv``'s int32 sums."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models.tflite import _same_pads

    x_dt, out_dt, act = MF_FORMS[i % len(MF_FORMS)]
    if kind == "fc":
        shape, w_shape, groups, pads = (batch, 1, 1, cin), (cout, 1, 1, cin), 1, ((0, 0), (0, 0))
    else:
        pads = _same_pads((hw, hw), (k, k), (stride, stride), (1, 1))
        shape = (batch, hw, hw, cin)
        groups = cin if kind == "dw" else 1
        w_shape = (cout, k, k, cin // groups)
    if x_dt == "uint8":
        x = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        zp_in = 90 + 5 * (i % 8)
        pad8 = zp_in - 128
        x8 = (x ^ 128).view(torch.int8)
    else:
        x = torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        zp_in = pad8 = -37 + 5 * (i % 8)
        x8 = x
    w = torch.randint(-127, 128, w_shape, generator=gen, device=dev, dtype=torch.int8)
    (pt, pb), (pl, pr) = pads
    x8p = F.pad(x8, (0, 0, pl, pr, pt, pb), value=pad8).contiguous() if pt + pb + pl + pr \
        else x8.contiguous()
    return dict(x=x, w=w, x8p=x8p, stride=stride, groups=groups, pads=pads, pad8=pad8,
                zp_in=zp_in, out_dtype=getattr(torch, out_dt), act=act, form=(x_dt, out_dt, act))


def int8_requant_consts(acc, rng, out_dtype, act):
    """Per-channel constants that spread a layer's requantized outputs
    over the whole output range: ``cb`` drawn within two of the channel's
    standard deviations (never 0), ``mult`` so that three of them span the
    range (times 0.7 .. 1.4; every other channel's rounded to a power of
    two, so that many products are exact halves), an odd output zero point
    off the middle (a half rounded after adding it would land elsewhere),
    and the fused activation's clamp.  bench.py's weights decay to one
    value, so they would not show a fault of the epilogue."""
    import numpy as np
    import torch

    O = acc.shape[-1]
    std = acc.to(torch.float64).reshape(-1, O).std(0).cpu().numpy() + 1.0
    info = np.iinfo(np.uint8 if out_dtype == torch.uint8 else np.int8)
    zp = int(info.min) + 61 + 2 * int(rng.integers(0, 15))
    lo, hi = int(info.min), int(info.max)
    if act in ("relu", "relu6"):
        lo = zp
    if act == "relu6":
        hi = min(hi, zp + 150)
    cb = rng.integers(-2 * std, 2 * std + 1).astype(np.int64)
    cb[cb == 0] = 1
    mult = rng.uniform(0.7, 1.4, O) * (hi - lo) / (3 * std)
    mult[::2] = 2.0 ** np.round(np.log2(mult[::2]))
    mult = mult.astype(np.float32)
    dev = acc.device
    return dict(cb=torch.from_numpy(cb.astype(np.int32)).to(dev),
                mult=torch.from_numpy(mult).to(dev), zp=zp, lo=lo, hi=hi)


def int8_library(c, acc, kind, k, flush):
    """The yardstick of one layer, checked bitwise against the int32 sums
    ``acc`` first and then timed: ``torch._int_mm`` for a 1x1 conv and the
    FC (its N padded to a multiple of 8 with zero rows), float32 cuDNN
    (TF32 off, channels_last, exact here: |acc| < 2^24) on the padded
    integers for the first conv and the depthwise layers.  Returns (name,
    ms), or (name, None) with the refusal."""
    import torch
    import torch.nn.functional as F

    x8p, w, s, groups = c["x8p"], c["w"], c["stride"], c["groups"]
    O = w.shape[0]
    if k == 1 and groups == 1:
        a = x8p.reshape(-1, w.shape[-1])
        n8 = -(-O // 8) * 8
        wb = w.reshape(O, -1)
        if n8 != O:
            wb = torch.cat([wb, wb.new_zeros((n8 - O, wb.shape[1]))])
        b = wb.t()
        name = "torch._int_mm" + (f" (N padded to {n8})" if n8 != O else "")
        try:
            got = torch._int_mm(a, b)
            torch.cuda.synchronize()
        except RuntimeError as e:
            return name, None, str(e).splitlines()[0][:160]
        check(torch.equal(got[:, :O].reshape(acc.shape), acc),
              f"{name} differs from the int32 sums")
        return name, timed_ms(lambda: torch._int_mm(a, b), flush)[0], None
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xf = x8p.to(torch.float32).permute(0, 3, 1, 2)  # channels_last views
        wf = w.to(torch.float32).permute(0, 3, 1, 2)
        fn = lambda: F.conv2d(xf, wf, stride=s, groups=groups)  # noqa: E731
        got = fn()
        torch.cuda.synchronize()
        check(torch.equal(got.permute(0, 2, 3, 1), acc.to(torch.float32)),
              "cuDNN's float32 conv differs from the int32 sums")
        return "F.conv2d f32 cuDNN", timed_ms(fn, flush)[0], None
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


#: layer shapes that MobileNet-v1 lacks, timed beside its own (0 launches
#: a forward): MobileNet-v2's 24-channel bottleneck feeds a 1x1 expansion,
#: and a 3x3 conv over 24 channels; 24 is not a multiple of 16, so both take
#: the GEMM's 4-byte copies
MF_EXTRA_SHAPES = (("pw 24->144 @56", "conv", 56, 24, 144, 1, 1),
                   ("conv 24->48 k3 s1 @56", "conv", 56, 24, 48, 3, 1))


def int8_conv_rows(dev, flush, bw, peak_int8, size=MF_SIZE, batch=MF_BATCH,
                   classes=MF_CLASSES):
    """``int8_conv`` at each distinct layer shape of the forward, and at
    ``MF_EXTRA_SHAPES``, on seeded operands in one of ``MF_FORMS``: the
    fused entry's output against its plain version, bitwise, with
    constants that spread it over the output range; ``int8_conv``'s int32
    sums (the same entry, int32 out) against ``int8_conv_reference``,
    bitwise; device ms (median of 20, L2 flushed) of the fused kernel, its
    plain version and the yardstick (``int8_library``); launches per
    forward; the bound (each input byte read once, one byte written an
    output)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.ops import int8_conv as i8

    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}
    extra = [(label, 0, shape) for label, *shape in MF_EXTRA_SHAPES]
    for label, per_forward, (kind, hw, cin, cout, k, stride) in [
            (label, 1, shape) for label, *shape in mobilenet_layers(size, classes)] + extra:
        if label in rows:
            rows[label]["per_forward"] += per_forward
            continue
        c = int8_layer_case(dev, gen, len(rows), kind, hw, cin, cout, k, stride, batch)
        x, w, s, groups = c["x"], c["w"], c["stride"], c["groups"]
        acc = i8.int8_conv(c["x8p"], w, s, 1, groups)
        want_acc = i8.int8_conv_reference(c["x8p"], w, s, 1, groups)
        torch.cuda.synchronize()
        acc_err = int((acc.to(torch.int64) - want_acc.to(torch.int64)).abs().max())
        check(acc_err == 0, f"int8_conv {label}: max |kernel - plain| {acc_err}")
        q = int8_requant_consts(want_acc, rng, c["out_dtype"], c["act"])
        args = (x, w, q["cb"], q["mult"], s, 1, groups, c["pads"], c["pad8"], q["zp"],
                q["lo"], q["hi"], c["out_dtype"])
        got = i8.int8_conv_requant(*args)
        want = i8.int8_conv_requant_reference(*args)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        distinct = int(torch.unique(want).numel())
        span = q["hi"] - q["lo"] + 1
        check(differ == 0, f"int8_conv_requant {label}: {differ} of {got.numel()} outputs "
                           "differ from the plain version")
        check(distinct * 2 >= span and int(want.min()) == q["lo"] and int(want.max()) == q["hi"],
              f"int8_conv_requant {label}: outputs take {distinct} of {span} values")
        ms, _ = timed_ms(lambda: i8.int8_conv_requant(*args), flush)
        plain_ms, _ = timed_ms(lambda: i8.int8_conv_requant_reference(*args), flush)
        lib_name, lib_ms, lib_why = int8_library(c, want_acc, kind, k, flush)
        ops = 2 * got.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        nbytes = x.numel() + w.numel() + got.numel() + 8 * w.shape[0]
        rows[label] = dict(
            label=label, kind=kind, form=c["form"], zp_in=c["zp_in"],
            kernel=i8.int8_conv_kernel(cin, cout, groups, k, k, stride),
            x=list(x.shape), w=list(w.shape), stride=s, groups=groups,
            per_forward=per_forward, max_abs_err=differ, int32_max_abs_err=acc_err,
            distinct=distinct, span=span, ms=ms, plain_ms=plain_ms,
            library=lib_name, library_ms=lib_ms, library_refused=lib_why,
            bound_ms=max(nbytes / bw, ops / peak_int8) * 1e3,
            bound_by="bytes" if nbytes / bw > ops / peak_int8 else "operations",
            bytes=nbytes, ops=ops)
        del c, x, w, got, want, acc, want_acc
    return list(rows.values())


def int8_edge_cases(dev):
    """The fused entry against its plain version, bitwise, where the
    forward does not go: a ragged M and a ragged N (byte stores) on the
    GEMM, a 3x3 conv and a strided 1x1 on the GEMM's window path (pads
    through the pad word), the same over 12 and 24 channels (the GEMM's
    4-byte copies), a depthwise multiplier of 2 and 12 channels (the
    direct kernel), the dense kernel on int8 with pads on every side, an
    FC of 1001 outputs over 40 rows -> [(case, kernel, outputs)]."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.tflite import _same_pads
    from nnstreamer_tpu_torch.ops import int8_conv as i8

    cases = (  # name, B, H, W, Cin, O, k, stride, groups, x dtype, out dtype, act
        ("ragged M and N 1x1", 3, 13, 11, 48, 40, 1, 1, 1, "uint8", "uint8", "none"),
        ("3x3 conv, 32 channels", 2, 9, 10, 32, 64, 3, 1, 1, "int8", "uint8", "relu6"),
        ("1x1 stride 2", 2, 15, 15, 64, 96, 1, 2, 1, "uint8", "int8", "relu"),
        ("ragged 1x1, 12 channels", 3, 13, 11, 12, 40, 1, 1, 1, "uint8", "uint8", "none"),
        ("3x3 s2 conv, 24 channels", 2, 9, 10, 24, 72, 3, 2, 1, "int8", "uint8", "relu"),
        ("depthwise x2", 2, 10, 9, 12, 24, 3, 2, 12, "uint8", "uint8", "none"),
        ("dense int8 in", 2, 17, 16, 3, 16, 3, 1, 1, "int8", "int8", "none"),
        ("fc 1001 x 40", 40, 1, 1, 256, 1001, 1, 1, 1, "uint8", "uint8", "none"),
    )
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)
    out = []
    for name, B, H, W, cin, O, k, s, groups, x_dt, out_dt, act in cases:
        if x_dt == "uint8":
            x = torch.randint(0, 256, (B, H, W, cin), generator=gen, device=dev,
                              dtype=torch.uint8)
            pad8 = 97 - 128
        else:
            x = torch.randint(-128, 128, (B, H, W, cin), generator=gen, device=dev,
                              dtype=torch.int8)
            pad8 = -11
        w = torch.randint(-127, 128, (O, k, k, cin // groups), generator=gen, device=dev,
                          dtype=torch.int8)
        pads = _same_pads((H, W), (k, k), (s, s), (1, 1))
        ref = i8.int8_conv_requant_reference(
            x, w, None, torch.ones(O, device=dev), s, 1, groups, pads, pad8, 0,
            -(2 ** 31), 2 ** 31 - 1, torch.float64)
        q = int8_requant_consts(ref, rng, getattr(torch, out_dt), act)
        args = (x, w, q["cb"], q["mult"], s, 1, groups, pads, pad8, q["zp"], q["lo"], q["hi"],
                getattr(torch, out_dt))
        got = i8.int8_conv_requant(*args)
        want = i8.int8_conv_requant_reference(*args)
        differ = int((got != want).sum())
        check(differ == 0, f"int8_conv_requant {name}: {differ} of {got.numel()} differ")
        out.append((name, i8.int8_conv_kernel(cin, O, groups, k, k, s), int(got.numel())))
    return out


def int_forward_kernels(bundle, x, tries=3):
    """The card kernels of one eager forward of an integer bundle, in
    launch order (torch.profiler), and the ``int8_conv`` launches the
    wrapper counted in it.  A trace that holds fewer ``int8_conv`` kernels
    than were launched lost events (seen after many earlier profiler
    sessions in one process) and is taken again, ``tries`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.ops import int8_conv as i8

    bundle.apply_fn(bundle.params, x)
    torch.cuda.synchronize()
    for _ in range(tries):
        before = i8.LAUNCHES.value
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bundle.apply_fn(bundle.params, x)
            torch.cuda.synchronize()
        launched = i8.LAUNCHES.value - before
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
        kern.sort(key=lambda e: e.time_range.start)
        names = [e.name for e in kern]
        if sum("int8_conv" in n for n in names) >= launched:
            break
    return names, launched


def int8_zero_point_case(dev, tmpdir, hw=14, cin=512, cout=512, batch=MF_BATCH):
    """One CONV_2D with uint8 weights and per-axis zero points drawn in
    100..155 (so the box sum ``sum_x`` runs through the kernel with a ones
    weight), a file of its own: its uint8 output on the card against the
    CPU's plain path, bitwise, and the kernel's launches per call (2)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import tflite, tflite_build
    from nnstreamer_tpu_torch.ops import int8_conv as i8

    rng = np.random.default_rng(3)
    s_in, z_in = MF_ACT
    sw = rng.uniform(0.001, 0.003, cout).astype(np.float32)
    wzp = rng.integers(100, 156, cout)
    m = tflite_build.ModelWriter()
    x = m.add_input([batch, hw, hw, cin], dtype=np.uint8, quant_scale=[s_in],
                    quant_zero_point=[z_in])
    wi = m.add_const(rng.integers(0, 256, (cout, 3, 3, cin)).astype(np.uint8), "w",
                     quant_scale=list(sw), quant_zero_point=list(wzp), quant_axis=0)
    bi = m.add_const(rng.integers(-2000, 2000, (cout,)).astype(np.int32), "b",
                     quant_scale=list(s_in * sw), quant_zero_point=[0] * cout, quant_axis=0)
    y = m.add_op("CONV_2D", [x, wi, bi], [batch, hw, hw, cout], out_dtype=np.uint8,
                 options={"stride": (1, 1), "padding": "SAME", "act": "relu6"},
                 quant_scale=[0.05], quant_zero_point=[128])
    path = os.path.join(tmpdir, "conv_zero_points.tflite")
    with open(path, "wb") as fh:
        fh.write(m.finish(outputs=[y]))
    xq = rng.integers(0, 256, (batch, hw, hw, cin), dtype=np.uint8)
    card = tflite.load_bundle(path, device=dev)
    cpu = tflite.load_bundle(path, device="cpu")
    before = i8.LAUNCHES.value
    got = card.apply_fn(card.params, torch.from_numpy(xq).to(dev)).cpu()
    launches = i8.LAUNCHES.value - before
    want = cpu.apply_fn(cpu.params, torch.from_numpy(xq))
    differ = int((got != want).sum())
    check(differ == 0, f"zero-point conv: {differ} outputs differ from the CPU's")
    check(dev.type != "cuda" or launches == 2,
          f"zero-point conv: {launches} int8_conv launches, want 2 (the box sum, then the "
          "fused conv reading it)")
    return dict(shape=f"conv {cin}->{cout} k3 @{hw}, uint8 weights, per-axis zero points",
                launches=launches, differ=differ, outputs=int(got.numel()))


def mobilenet_v1_module(classes=MF_CLASSES):
    """A MobileNet-v1 ``nn.Module`` (NCHW): conv-BatchNorm-ReLU6 stem,
    13 depthwise-separable blocks, global average pool, a Linear head and
    a softmax; seeded weights and non-trivial BatchNorm statistics."""
    import torch
    from torch import nn

    torch.manual_seed(0)

    def cbr(cin, cout, k, stride, groups=1):
        return [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False),
                nn.BatchNorm2d(cout), nn.ReLU6()]

    layers = cbr(3, 32, 3, 2)
    cin = 32
    for cout, stride in MF_BLOCKS:
        layers += cbr(cin, cin, 3, stride, groups=cin) + cbr(cin, cout, 1, 1)
        cin = cout
    m = nn.Sequential(*layers, nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                      nn.Linear(cin, classes), nn.Softmax(dim=1))
    for mod in m.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.uniform_(-0.1, 0.1)
            mod.running_var.uniform_(0.5, 1.5)
    return m.eval()


@contextlib.contextmanager
def onnx_exporter():
    """Inside the block, torch's TorchScript ONNX exporter skips its
    optional onnxscript post-step (it wants the ``onnx`` package, which
    neither machine has; the serialized ModelProto is complete without
    it), wherever this torch keeps it: the module is found by walking
    ``torch.onnx``, never skipped.  Yields the module's name."""
    import importlib
    import pkgutil

    import torch.onnx

    for info in pkgutil.walk_packages(torch.onnx.__path__, "torch.onnx."):
        if not info.name.endswith("onnx_proto_utils"):
            continue
        mod = importlib.import_module(info.name)
        if hasattr(mod, "_add_onnxscript_fn"):
            orig = mod._add_onnxscript_fn
            mod._add_onnxscript_fn = lambda model_bytes, custom: model_bytes
            try:
                yield info.name
            finally:
                mod._add_onnxscript_fn = orig
            return
    raise RuntimeError("torch's ONNX exporter: no onnx_proto_utils._add_onnxscript_fn "
                       "found under torch.onnx")


def int_taps(bundle, x):
    """An integer bundle called eagerly on ``x``, every op's output kept
    (on the host) -> (outputs in graph order, the logits)."""
    from nnstreamer_tpu_torch.models import tflite

    taps, run = [], tflite._run_op_int

    def tap(*args, **kw):
        y = run(*args, **kw)
        taps.append(y.cpu())
        return y

    tflite._run_op_int = tap
    try:
        y = bundle.apply_fn(bundle.params, x).cpu()
    finally:
        tflite._run_op_int = run
    return taps, y


def phase_modelfiles(dev, size=MF_SIZE, batch=MF_BATCH, classes=MF_CLASSES, acc="",
                     timed=MF_TIMED, checked=MF_CHECKED, onnx_batch=MF_ONNX_BATCH,
                     onnx_batches=MF_ONNX_BATCHES, kernel_rows=True, files_dir=None,
                     profile=False):
    """The model-file path on ``dev``: (a) ``int8_conv`` against its plain
    version at the forward's shapes (card only), (b) the fully-quantized
    MobileNet-v1 through bench.py's pipeline, (c) its float twin, (d) an
    .onnx MobileNet-v1 exported by torch (``acc``: the filters'
    accelerator= property, empty on the card).  The files go under
    ``files_dir`` (default ``build/files/``), removed after.  ``profile``
    writes the quantized stage's kernels to
    chiprun_out/profile_modelfiles.txt."""
    import shutil

    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.elements.source import VideoTestSrc
    from nnstreamer_tpu_torch.models import tflite
    from nnstreamer_tpu_torch.ops import int8_conv as i8

    on_card = dev.type == "cuda"
    out = dict(size=size, batch=batch, classes=classes)
    tmpdir = os.path.join(files_dir or os.path.join(ROOT, "build", "files"), "modelfiles")
    os.makedirs(tmpdir, exist_ok=True)
    try:
        t0 = time.perf_counter()
        if on_card and kernel_rows:
            flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
            card = card_line().lower()
            bw, _ = RATES["pcie" if "pcie" in card else "sxm"]
            out["int8_conv"] = int8_conv_rows(
                dev, flush_buf.zero_, bw, INT8_RATES["pcie" if "pcie" in card else "sxm"],
                size, batch, classes)
            del flush_buf
            torch.cuda.empty_cache()
            out["edge_cases"] = int8_edge_cases(dev)
        out["zero_point_case"] = int8_zero_point_case(dev, tmpdir, batch=batch)
        out["kernels_s"] = time.perf_counter() - t0

        # (b) the quantized file through the stock pipeline
        t0 = parts = time.perf_counter()
        qpath = os.path.join(tmpdir, f"mobilenet_v1_{size}_quant.tflite")
        with open(qpath, "wb") as fh:
            fh.write(mobilenet_tflite(size, classes, batch, quantized=True))
        out["write_s"] = time.perf_counter() - t0
        per_forward = sum(1 for _ in mobilenet_layers(size, classes))
        n = VISION_WARM + timed
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        i8.LAUNCHES.reset()
        outs, q = vision_pulled(MF_QUANT.format(batch=batch, frames=n * batch, size=size,
                                                model=qpath, acc=acc), n, 1, batch)
        launches = i8.LAUNCHES.value
        if on_card:
            q["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            q["card_busy_share"] = q["card_ms_per_batch"] * q["frames_per_s"] / batch / 1e3
        stage = q.pop("stage")
        if profile and on_card:
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, "profile_modelfiles.txt"), "w") as fh:
                q["top_kernels_ms"] = stage_profile(stage, "quantized mobilenet_v1", fh)
        check(len(q["stages"]) == 2 and q["stages"][0].startswith("src+")
              and "+f+deq+" in q["stages"][0],
              f"the quantized cell is not one fused stage: {q['stages']}")
        replays = stage.census.replays
        q["launches"] = launches
        q["launches_per_forward"] = per_forward
        check(not on_card or launches == per_forward * replays,
              f"int8_conv launches {launches} != {per_forward} x {replays} replays")
        check(not on_card or launches > 0, "the quantized cell launched no int8_conv")
        out["quant"] = q
        out["quant_s"], parts = time.perf_counter() - parts, time.perf_counter()

        # its uint8 logits on the card against the CPU's plain path, bitwise
        src = VideoTestSrc({"width": size, "height": size})
        frames = src.device_batch(0, batch, "cpu")
        chk = ntt.Pipeline(
            f"videotestsrc device=true batch={batch} num-buffers={batch} width={size} "
            f"height={size} name=src ! other/tensors,num_tensors=1,"
            f"dimensions=3:{size}:{size}:{batch},types=uint8,format=static ! "
            f"tensor_filter framework=jax model={qpath} {acc} ! tensor_sink name=out")
        with chk:
            card_logits = torch.as_tensor(np.asarray(chk.pull("out", timeout=WAIT_S)
                                                     .tensors[0]))
            chk.wait(timeout=WAIT_S)
        t1 = time.perf_counter()
        cpu_taps, cpu_logits = int_taps(tflite.load_bundle(qpath, device="cpu"),
                                        frames[:checked])
        out["cpu_plain_s"] = time.perf_counter() - t1
        card_bundle = tflite.load_bundle(qpath, device=dev)
        card_taps, _ = int_taps(card_bundle, frames[:checked].to(dev))
        if on_card:
            # one eager forward's kernels: the conv layers are one fused
            # launch each, nothing between them (no int32 sum leaves a kernel)
            names, launched = int_forward_kernels(card_bundle, frames.to(dev))
            at = [i for i, n in enumerate(names) if "int8_conv" in n]
            run = at[:per_forward - 1]
            out["forward_kernels"] = dict(
                kernels=len(names), int8_conv=len(at), launched=launched,
                others=sorted({n[:60] for n in names if "int8_conv" not in n}))
            check(launched == len(at) == per_forward
                  and run == list(range(run[0], run[0] + len(run))),
                  f"the eager forward's kernels: int8_conv at {at} of {len(names)}, "
                  f"{launched} launched")
        del card_bundle
        check(card_logits.dtype == torch.uint8 and tuple(card_logits.shape) == (batch, classes),
              f"quantized logits {card_logits.dtype} {tuple(card_logits.shape)}")
        differ = int((card_logits[:checked] != cpu_logits).sum())
        labels = np.asarray(outs[0].meta["label_index"])[:checked]
        want_labels = cpu_logits.to(torch.int32).argmax(dim=1).numpy()
        # every op's integer output too, eagerly on the card against the CPU
        taps_differ = [int((a.cpu() != b).sum()) for a, b in zip(card_taps, cpu_taps)]
        out["quant_check"] = dict(
            frames=checked, logits=int(cpu_logits.numel()), differ=differ,
            distinct_logits=int(torch.unique(cpu_logits).numel()),
            labels_equal=int((labels == want_labels).sum()),
            ops=len(cpu_taps), op_outputs=sum(int(t.numel()) for t in cpu_taps),
            op_outputs_differ=sum(taps_differ),
            distinct_by_op=[int(torch.unique(t).numel()) for t in cpu_taps])
        check(differ == 0, f"quantized logits: {differ} of {cpu_logits.numel()} differ "
                           "from the CPU's plain path")
        check(sum(taps_differ) == 0, f"quantized op outputs differ from the CPU's: "
                                     f"{taps_differ}")
        check(bool((labels == want_labels).all()),
              "the stock pipeline's labels differ from the CPU logits' argmax")
        if on_card:
            torch.cuda.empty_cache()
        out["check_s"], parts = time.perf_counter() - parts, time.perf_counter()

        # (c) the float twin, through the same pipeline with the float scale
        fpath = os.path.join(tmpdir, f"mobilenet_v1_{size}_float.tflite")
        with open(fpath, "wb") as fh:
            fh.write(mobilenet_tflite(size, classes, batch, quantized=False))
        nf = VISION_WARM + max(1, timed // 2)
        _, f = vision_pulled(MF_FLOAT.format(batch=batch, frames=nf * batch, size=size,
                                             model=fpath, acc=acc), nf, 0, batch)
        f.pop("stage")
        if on_card:
            f["card_busy_share"] = f["card_ms_per_batch"] * f["frames_per_s"] / batch / 1e3
        chk = ntt.Pipeline(
            f"videotestsrc device=true batch={batch} num-buffers={batch} width={size} "
            f"height={size} name=src ! {MF_FLOAT_NORM} ! tensor_filter framework=jax "
            f"model={fpath} {acc} ! tensor_sink name=out")
        with chk:
            card_f = torch.as_tensor(np.asarray(chk.pull("out", timeout=WAIT_S).tensors[0]))
            chk.wait(timeout=WAIT_S)
        cpu = tflite.load_bundle(fpath, device="cpu")
        want_f = cpu.apply_fn(cpu.params, (frames[:checked].to(torch.float32) - 128.0) * 0.05)
        err = ((card_f[:checked] - want_f).abs().amax(dim=1)
               / want_f.abs().amax(dim=1)).max().item()
        f["cpu_check"] = dict(frames=checked, max_err_share=err, tol_share=MF_FLOAT_TOL)
        check(err <= MF_FLOAT_TOL, f"float twin against the CPU: {err} > {MF_FLOAT_TOL}")
        out["float"] = f
        del cpu
        out["float_s"] = time.perf_counter() - parts

        # (d) an .onnx MobileNet-v1 exported by torch's own exporter
        t1 = time.perf_counter()
        module = mobilenet_v1_module(classes)
        opath = os.path.join(tmpdir, "mobilenet_v1.onnx")
        xs = [torch.from_numpy(np.random.default_rng(i).standard_normal(
            (onnx_batch, 3, size, size)).astype(np.float32)) for i in range(onnx_batches)]
        with onnx_exporter() as out["onnx_exporter"], torch.no_grad():
            torch.onnx.export(module, xs[0], opath, opset_version=13, dynamo=False)
        export_s = time.perf_counter() - t1
        module = module.to(dev)
        pipe = ntt.Pipeline(
            f"appsrc name=src caps=other/tensors,num_tensors=1,"
            f"dimensions={size}:{size}:3:{onnx_batch},types=float32 ! "
            f"tensor_filter framework=jax model={opath} {acc} ! tensor_sink name=out")
        errs = []
        with pipe:
            for x in xs:
                pipe.push("src", x.numpy())
                got = torch.as_tensor(np.asarray(pipe.pull("out", timeout=WAIT_S).tensors[0]))
                with torch.no_grad():
                    want = module(x.to(dev)).cpu()
                errs.append(((got - want).abs().amax(dim=1)
                             / want.abs().amax(dim=1)).max().item())
            pipe.eos("src")
            pipe.wait(timeout=WAIT_S)
        out["onnx"] = dict(onnx_s=time.perf_counter() - t1, batch=onnx_batch,
                           batches=onnx_batches, max_err_share=max(errs),
                           tol_share=MF_ONNX_TOL, export_s=export_s,
                           file_mb=os.path.getsize(opath) / 2**20)
        check(max(errs) <= MF_ONNX_TOL,
              f".onnx MobileNet against its module: {max(errs)} > {MF_ONNX_TOL}")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def int8_summary(mf):
    """The ``kernels`` line's int8_conv entry, per forward of the
    quantized MobileNet-v1 at batch 64: each shape's fused ms, plain ms,
    bound and yardstick times its launches per forward, summed;
    launches from the quantized cell's run (counted from 0
    just before it); and whether each shape meets its yardstick."""
    rows = mf["int8_conv"]

    def per_forward(key, only=None):
        return sum(r[key] * r["per_forward"] for r in rows if only is None or only(r))

    by = {b: per_forward("bound_ms", lambda r, b=b: r["bound_by"] == b)
          for b in ("bytes", "operations")}
    gemm = [r for r in rows if r["library"].startswith("torch._int_mm")]
    timed = [r for r in rows if r["library_ms"] is not None]
    return dict(
        name="int8_conv", route="cuda", source="nnstreamer_tpu_torch/csrc/int8_conv.cu",
        replaces="nnstreamer_tpu/models/tflite.py:685",
        replaces_note="XLA's integer conv and dot and _requant_acc (tflite.py:685, :742, "
                      ":628), no Pallas kernel",
        launches=mf.get("quant", {}).get("launches"),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"), bound_by=max(by, key=by.get),
        library_ms=(per_forward("library_ms") if len(timed) == len(rows) else None),
        library="torch._int_mm (1x1, FC) + F.conv2d f32 cuDNN (first conv, depthwise)",
        per="forward of mobilenet_v1 224 at batch 64 (28 launches)",
        int_mm_ms_1x1=sum(r["library_ms"] * r["per_forward"] for r in gemm
                          if r["library_ms"] is not None),
        kernel_ms_1x1=sum(r["ms"] * r["per_forward"] for r in gemm),
        slower_than_library=[r["label"] for r in timed if r["ms"] > r["library_ms"]],
        per_shape={r["label"]: {k: r[k] for k in ("kernel", "ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by", "per_forward")}
                   for r in rows})


def print_modelfiles(mf):
    for r in mf.get("int8_conv", []):
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "refused (" + r["library_refused"] + ")")
        print(f"modelfiles: int8_conv {r['label']} ({r['kernel']}, {'/'.join(r['form'])}, "
              f"zp {r['zp_in']}) x {r['x']} w {r['w']} launches/forward {r['per_forward']} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"{r['library']}={lib} bound={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"bitwise={r['max_abs_err'] == 0} "
              f"int32_bitwise={r['int32_max_abs_err'] == 0} values {r['distinct']}/{r['span']}"
              f"{' [named]' if r['label'] in MF_NAMED else ''}", flush=True)
    if "int8_conv" in mf:
        s = int8_summary(mf)
        print(f"modelfiles: int8_conv a forward: fused {s['ms']:.4f} ms, bound "
              f"{s['bound_ms']:.4f} ({s['bound_by']}), plain {s['plain_ms']:.4f}, library "
              f"{s['library_ms']}; 1x1 layers and FC {s['kernel_ms_1x1']:.4f} "
              f"against torch._int_mm's {s['int_mm_ms_1x1']:.4f}; slower than the "
              f"yardstick: {s['slower_than_library'] or 'none'}", flush=True)
    for name, kernel, n in mf.get("edge_cases", []):
        print(f"modelfiles: int8_conv_requant {name} ({kernel}): {n} outputs bitwise",
              flush=True)
    if "forward_kernels" in mf:
        fk = mf["forward_kernels"]
        print(f"modelfiles: one eager forward: {fk['kernels']} kernels, {fk['int8_conv']} "
              f"int8_conv in an unbroken run of the conv layers; the others {fk['others']}",
              flush=True)
    z = mf["zero_point_case"]
    print(f"modelfiles: int8_conv {z['shape']}: {z['launches']} launches a call, "
          f"{z['differ']} of {z['outputs']} outputs differ from the CPU's", flush=True)
    q = mf["quant"]
    busy = ("not measured" if q.get("card_busy_share") is None
            else f"{q['card_busy_share']:.3f}")
    card_ms = ("not measured" if q.get("card_ms_per_batch") is None
               else f"{q['card_ms_per_batch']:.3f} ms")
    print(f"modelfiles: mobilenet_v1 {mf['size']} quantized .tflite (integer execution, "
          f"batch {mf['batch']}) {q['frames_per_s']:.1f} frames/s, card {card_ms} a batch, "
          f"busy {busy}, peak {q.get('peak_mem_gb', 0.0):.2f} GB, int8_conv launches "
          f"{q['launches']} ({q['launches_per_forward']} a forward); stages {q['stages']}",
          flush=True)
    print(f"census: modelfiles quant {q['census']}", flush=True)
    if "top_kernels_ms" in q:
        print(f"profile: modelfiles quantized top kernels, ms per batch "
              f"{q['top_kernels_ms']}", flush=True)
    c = mf["quant_check"]
    print(f"modelfiles: quantized logits of {c['frames']} frames against the CPU's plain "
          f"path: {c['differ']} of {c['logits']} differ ({c['distinct_logits']} distinct "
          f"values); labels equal {c['labels_equal']}; the {c['ops']} ops' outputs, eager "
          f"on the card: {c['op_outputs_differ']} of {c['op_outputs']} differ (distinct "
          f"values by op {c['distinct_by_op']}); CPU {mf['cpu_plain_s']:.1f} s", flush=True)
    f = mf["float"]
    busy = ("not measured" if f.get("card_busy_share") is None
            else f"{f['card_busy_share']:.3f}")
    card_ms = ("not measured" if f.get("card_ms_per_batch") is None
               else f"{f['card_ms_per_batch']:.3f} ms")
    print(f"modelfiles: float twin .tflite {f['frames_per_s']:.1f} frames/s, card {card_ms} "
          f"a batch, busy {busy}; against the CPU {f['cpu_check']}; stages {f['stages']}",
          flush=True)
    print(f"census: modelfiles float {f['census']}", flush=True)
    o = mf["onnx"]
    print(f"modelfiles: .onnx mobilenet_v1 ({o['file_mb']:.1f} MiB, exported in "
          f"{o['export_s']:.1f} s by {mf['onnx_exporter']}) against its module on the card: "
          f"max share {o['max_err_share']:.3g} (tol {o['tol_share']}) over {o['batches']} "
          f"batches of {o['batch']}", flush=True)
    print(f"modelfiles: parts kernels {mf['kernels_s']:.1f} s, file write {mf['write_s']:.1f} s, "
          f"quantized cell {mf['quant_s']:.1f} s, its checks {mf['check_s']:.1f} s, float twin "
          f"{mf['float_s']:.1f} s, .onnx {mf['onnx']['onnx_s']:.1f} s", flush=True)


#: the capi phase: the C program's single-shot calls of each card model
#: (the first timed alone), the pipeline's warm-up batches, its timed
#: batches, the batches in flight while timed, and the blocks of the cut
#: file whose logits spread
CAPI_INVOKES = 6
CAPI_WARM = 2
CAPI_TIMED = 4
CAPI_WINDOW = 4
CAPI_CHECK_BLOCKS = 4
#: the sources the build phase compiles for it
CAPI_FILTER = os.path.join(ROOT, "examples", "torch_channel_swap.cc")
CAPI_PROGRAM = os.path.join(ROOT, "examples", "torch_capi_classify.c")
#: the C program's pipeline, written the same way there
CAPI_PIPE = ("appsrc name=src caps=other/tensors,num_tensors=1,"
             "dimensions=3:{size}:{size}:{batch},types=uint8 ! tensor_filter "
             "framework=custom model={so} custom=size:{size},batch:{batch} ! "
             "tensor_filter framework=jax model={model}{acc} ! tensor_transform "
             "mode=arithmetic option=typecast:float32,add:-128.0,mul:0.1 ! "
             "tensor_sink name=out")


def build_native():
    """The port's native libraries, then the capi phase's filter and
    program (which links ``libnnstpu_capi``): (seconds, filter path,
    program path)."""
    from nnstreamer_tpu_torch import native

    t0 = time.perf_counter()
    native.build()
    jobs = [native.filter_job(CAPI_FILTER), native.program_job(CAPI_PROGRAM)]
    native.compile_all(jobs)
    return time.perf_counter() - t0, str(jobs[0][0]), str(jobs[1][0])


def capi_bytes(seed, first, n):
    """Bytes ``first .. first + n`` of the C program's input stream
    ``seed`` (its ``frame_byte``: a counter hash in uint32 arithmetic)."""
    import numpy as np

    i = np.arange(first, first + n, dtype=np.uint64).astype(np.uint32)
    h = (i * np.uint32(2654435761)) ^ np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return (h & np.uint32(0xFF)).astype(np.uint8)


def windowed_pipeline(push, pull, n, warm, window):
    """The C program's pipeline loop: ``push(b)`` for batch ``b`` of
    ``n``, ``pull()`` an output; ``warm`` batches one at a time, then the
    rest with up to ``window`` in flight; (outputs, seconds of the timed
    part)."""
    outs, t0 = [], time.perf_counter()
    for b in range(n):
        if b == warm:
            t0 = time.perf_counter()
        push(b)
        while len(outs) <= b and (b < warm or b - len(outs) + 1 >= window or b == n - 1):
            outs.append(pull())
    return outs, time.perf_counter() - t0


def phase_capi(dev, so, program, size=MF_SIZE, batch=MF_BATCH, invokes=CAPI_INVOKES,
               warm=CAPI_WARM, timed=CAPI_TIMED, window=CAPI_WINDOW, files_dir=None):
    """The C side on ``dev``: the C program ``program`` (with the filter
    ``so``) in a child process, then the same models, inputs and
    pipelines in this process, outputs compared.  On the CPU the program
    leaves out its single-shot card models and its pipelines name
    ``accelerator=true:cpu``.  The files have ``MF_CLASSES`` classes, as
    the program's output size assumes."""
    import shutil

    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch import capi, native

    on_card = dev.type == "cuda"
    acc = "" if on_card else " accelerator=true:cpu"
    tmpdir = os.path.join(files_dir or os.path.join(ROOT, "build", "files"), "capi")
    outdir = os.path.join(tmpdir, "out")
    os.makedirs(outdir, exist_ok=True)
    out = dict(size=size, batch=batch, invokes=invokes, warm=warm, timed=timed,
               window=window)
    try:
        model = os.path.join(tmpdir, "mobilenet_v1_quant.tflite")
        check_model = os.path.join(tmpdir, f"mobilenet_v1_quant_{CAPI_CHECK_BLOCKS}.tflite")
        with open(model, "wb") as fh:
            fh.write(mobilenet_tflite(size, MF_CLASSES, batch))
        with open(check_model, "wb") as fh:
            fh.write(mobilenet_tflite(size, MF_CLASSES, batch,
                                      blocks=MF_BLOCKS[:CAPI_CHECK_BLOCKS]))
        args = [program, outdir, str(size), str(batch), so, model, check_model,
                "card" if on_card else "cpu", str(invokes), str(warm), str(timed),
                str(window)]
        t0 = time.perf_counter()
        proc = subprocess.Popen(args, env=native.program_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(timeout=WAIT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=WAIT_S)
        out["child_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"the C program exited {proc.returncode}: "
                                    f"{stdout[-1000:]} {stderr[-3000:]}")
        last = stdout.strip().splitlines()[-1].split()
        check(last[0] == "capi-c-result", f"the C program's last line: {last}")
        c = out["c"] = {k: float(v) for k, v in (kv.split("=") for kv in last[1:])}
        out["c_lines"] = [ln for ln in stdout.splitlines() if ln.startswith("capi-c:")]
        if on_card:
            check(c["card_handles"] > 0, "the C program holds no handle on the card")

        def saved(tag, dtype, shape):
            return np.fromfile(os.path.join(outdir, f"{tag}.bin"), dtype).reshape(shape)

        frame = batch * size * size * 3
        xq = capi_bytes(2, 0, frame).reshape(batch, size, size, 3)
        # single shot: the same models and inputs in this process
        if on_card:
            xf = ((capi_bytes(1, 0, frame).astype(np.float32) - np.float32(128))
                  * np.float32(0.0078125)).reshape(batch, size, size, 3)
            with ntt.SingleShot(framework="jax", model="mobilenet_v1",
                                custom=f"size:{size},batch:{batch}") as s:
                want = s.invoke(xf)[0]
            got = saved("bf16", np.float32, want.shape)
            err = float((np.abs(got - want).max(axis=1)
                         / np.abs(want).max(axis=1)).max())
            out["bf16"] = dict(max_err_share=err, tol_share=VISION_TOL,
                               bitwise_frames=int((got == want).all(axis=1).sum()),
                               frames=batch)
            check(np.isfinite(got).all() and err <= VISION_TOL,
                  f"C-side bf16 mobilenet_v1 against this process: {err} > {VISION_TOL}")
            for tag, path in (("quant", model), ("check", check_model)):
                with ntt.SingleShot(framework="jax", model=path) as s:
                    want = s.invoke(xq)[0]
                got = saved(tag, np.uint8, want.shape)
                out[tag] = dict(differ=int((got != want).sum()), outputs=int(want.size),
                                distinct=int(np.unique(want).size))
                check(out[tag]["differ"] == 0, f"C-side {tag} .tflite: "
                                               f"{out[tag]['differ']} outputs differ")
        got = saved("swap", np.uint8, xq.shape)
        out["swap"] = dict(differ=int((got != xq[..., ::-1]).sum()), outputs=int(xq.size))
        check(out["swap"]["differ"] == 0, "the C side's .so output is not the channel flip")

        # the pipelines: the same description and frames in this process
        frames = [capi_bytes(3, b * frame, frame).reshape(batch, size, size, 3)
                  for b in range(warm + timed)]
        for tag, path, n, w, win in (("pipe", model, warm + timed, warm, window),
                                     ("pipe_check", check_model, 2, 0, 1)):
            pipe = ntt.Pipeline(CAPI_PIPE.format(size=size, batch=batch, so=so, model=path,
                                                 acc=acc))
            stage, names = vision_stage(pipe)
            check(stage.device.type == dev.type, f"the card stage runs on {stage.device}")
            with pipe:
                want, secs = windowed_pipeline(
                    lambda b: pipe.push("src", frames[b]),
                    lambda: np.asarray(pipe.pull("out", timeout=WAIT_S).tensors[0]), n, w, win)
                pipe.eos("src")
                pipe.wait(timeout=WAIT_S)
            got = saved(tag, np.float32, (n, batch, MF_CLASSES))
            out[tag] = dict(stages=names, device=str(stage.device), batches=n,
                            census=census_of(stage.census, len(stage.census.signatures)),
                            differ=int(sum((g != x).sum() for g, x in zip(got, want))),
                            distinct=int(np.unique(np.stack(want)).size),
                            frames_per_s=(n - w) * batch / secs)
            check(out[tag]["differ"] == 0, f"C-side {tag}: {out[tag]['differ']} outputs "
                                           "differ from this process's run")
            check(out[tag]["census"]["captures_after_warmup"] == 0,
                  f"{tag}: the card stage captured after its first batch")
        # the timed pipeline once more through the C API's Python half (bytes
        # in and out, as the C program hands them over): the bridge's cost
        # without the C program and its interpreter lock hand-offs
        blobs = [f.tobytes() for f in frames]
        h = capi.pipeline_open(CAPI_PIPE.format(size=size, batch=batch, so=so, model=model,
                                                acc=acc))
        try:
            bridged, secs = windowed_pipeline(
                lambda b: capi.pipeline_push(h, "src", [blobs[b]]),
                lambda: capi.pipeline_pull(h, "out", WAIT_S)[0][0], warm + timed, warm,
                window)
            capi.pipeline_eos(h, "src")
        finally:
            capi.pipeline_close(h)
        got = saved("pipe", np.float32, (warm + timed, batch * MF_CLASSES))
        out["bridge"] = dict(frames_per_s=timed * batch / secs,
                             differ=int(sum((np.frombuffer(x, np.float32) != g).sum()
                                            for x, g in zip(bridged, got))))
        check(out["bridge"]["differ"] == 0, "the bridge's outputs differ from the C side's")
        check(out["pipe_check"]["distinct"] > 1, "the cut file's logits do not spread")
        out["c_frames_per_s"] = c["pipe_frames"] / c["pipe_s"]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def print_capi(r, mf_fps, card):
    c = r["c"]
    for line in r["c_lines"]:
        print(f"capi: {line[len('capi-c: '):]}", flush=True)
    if "bf16" in r:
        b, q, k = r["bf16"], r["quant"], r["check"]
        print(f"capi: single-shot mobilenet_v1 {r['size']} bf16 batch {r['batch']} from C: "
              f"open {c['bf16_open_s']:.2f} s, first invoke {c['bf16_first_ms']:.1f} ms, then "
              f"{c['bf16_ms']:.2f} ms an invoke; against this process's SingleShot max share "
              f"{b['max_err_share']:.3g} (tol {b['tol_share']}), {b['bitwise_frames']} of "
              f"{b['frames']} frames bitwise", flush=True)
        print(f"capi: single-shot quantized .tflite from C: open {c['quant_open_s']:.2f} s, "
              f"first invoke {c['quant_first_ms']:.1f} ms, then {c['quant_ms']:.2f} ms; "
              f"{q['differ']} of {q['outputs']} outputs differ ({q['distinct']} distinct); "
              f"its first {CAPI_CHECK_BLOCKS} blocks: {k['differ']} of {k['outputs']} differ "
              f"({k['distinct']} distinct)", flush=True)
    p, k = r["pipe"], r["pipe_check"]
    print(f"capi: pipeline from C {r['c_frames_per_s']:.1f} frames/s over "
          f"{int(c['pipe_frames'])} frames ({r['window']} batches of {r['batch']} in flight, "
          f"after {r['warm']} warm-up); the same pipeline in process "
          f"{p['frames_per_s']:.1f} frames/s, and through the C API's Python half "
          f"{r['bridge']['frames_per_s']:.1f}; C inside push {c['push_s']:.3f} s, pull "
          f"{c['pull_s']:.3f} s of {c['pipe_s']:.3f}; {p['differ']} outputs differ, cut file "
          f"{k['differ']} ({k['distinct']} distinct); stages {p['stages']} on {p['device']}, "
          f"census {p['census']}; "
          f".so {r['swap']['differ']} of {r['swap']['outputs']} bytes differ", flush=True)
    print(f"capi: C client {r['c_frames_per_s']:.1f} frames/s (modelfiles cell "
          f"{mf_fps if mf_fps is None else round(mf_fps, 1)} frames/s), single invoke "
          f"{c['quant_ms']:.2f} ms quantized / {c['bf16_ms']:.2f} ms bf16, start-up "
          f"{c['init_s']:.2f} s embed + import torch + {c['bf16_open_s']:.2f} s first open "
          f"(CUDA context, weights), child {r['child_s']:.1f} s; card {card}", flush=True)


#: the learn phase: mobilenet_v1 at full width (224 x 224, 1001 classes,
#: bf16 compute over float32 master parameters) trained with Adam through a
#: window of 32 samples on the card.  The straight run trains two epochs of
#: 64 training and 16 validation samples, then 20 samples more, which train
#: at EOS as a partial window (a masked replay of the same captured step);
#: the dataset holds the 80 samples of an epoch twice, then the 20, so the
#: resume run replays epoch 2 alone
LEARN_BATCH = 32
LEARN_TRAIN, LEARN_VALID, LEARN_TAIL = 64, 16, 20
LEARN_LR = 1e-3
LEARN_TIMED = 20
#: a captured replay against an eager call of the same step function from
#: the same state: the same kernels in the same order, so bitwise
LEARN_STEP_TOL = 0.0
LEARN_DESC = ("datareposrc location={data} json={meta}{window} ! "
              "tensor_trainer framework=jax model=mobilenet_v1 name=learn "
              "{model}optimizer=adam learning-rate={lr} batch-size={batch} "
              "num-training-samples={train} num-validation-samples={valid} "
              "epochs={epochs} checkpoint-every=1 model-save-path={save}{load} {acc}! "
              "tensor_sink name=stats")
#: train-while-serve: one stream tee'd into a serving filter (unfused,
#: batch_max 1) and a trainer that copies its parameters into it after
#: each epoch of one window
LEARN_SERVE = ("appsrc name=in ! other/tensors,dimensions=3:{size}:{size}:1.1,"
               "types=float32.int32 ! tee name=t "
               "t. ! tensor_filter framework=jax model=mobilenet_v1 name=serve "
               "input-combination=0 {custom}{acc}! tensor_sink name=out "
               "t. ! tensor_trainer framework=jax model=mobilenet_v1 name=learn "
               "{model}optimizer=adam learning-rate={lr} batch-size={batch} "
               "num-training-samples={batch} epochs=2 swap-to=serve {acc}! "
               "tensor_sink name=stats")


def learn_tensors(tr):
    """A trainer's parameters and optimizer state tensors, in leaf order."""
    return [t for p in tr._leaves
            for t in [p] + [tr._opt.state[p][k] for k in sorted(tr._opt.state[p])]]


def calls_ms(fn, reps):
    """Median device ms of ``fn`` from CUDA events around each call (an
    eager call's includes the card's waits for the host)."""
    import torch

    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def learn_step_check(dev, props, xs, ys, timed):
    """A trainer driven directly: its first window's step is the capture's
    warm-up; from the state before the second window, the first replay and
    an eager call of the same step function must give the same parameters
    and Adam moments (``LEARN_STEP_TOL``).  On the card the replay and the
    eager step are then timed."""
    import torch

    from nnstreamer_tpu_torch.trainer.subplugin import Trainer

    tr = Trainer()
    tr.open(dict(props))
    bs = tr.batch_size
    for i in range(bs):
        tr.push_data([xs[i]], [ys[i]], False)
    before = [t.detach().clone() for t in learn_tensors(tr)]
    for i in range(bs, 2 * bs):
        tr.push_data([xs[i]], [ys[i]], False)
    replayed = [t.detach().clone() for t in learn_tensors(tr)]
    with torch.no_grad():
        for t, v in zip(learn_tensors(tr), before):
            t.copy_(v)
    tr._step_fn()
    eager = learn_tensors(tr)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(replayed, eager))
    check(diff <= LEARN_STEP_TOL, f"the first replay is {diff} from an eager step")
    check(tr.compile_counts() == {"step": 1}, f"census {tr.compile_counts()}")
    out = dict(replay_vs_eager_max_abs=diff,
               bitwise=all(torch.equal(a, b) for a, b in zip(replayed, eager)))
    if dev.type == "cuda":
        out["step_ms"] = calls_ms(tr._step.replay, timed)
        out["eager_step_ms"] = calls_ms(tr._step_fn, max(2, timed // 2))
    tr.close()
    return out


#: the trainer's mesh: mesh=data:LEARN_MESH_SLOTS over as many slots of
#: the card against the mesh-less trainer, float32, LEARN_MESH_EPOCHS
#: epochs of the phase's training samples.  Held: data:1 bitwise
#: mesh-less (losses and parameters), the census, and the first window's
#: summed gradient within LEARN_MESH_GRAD_TOL of the mesh-less step's
#: (the norm of the difference over the norm of the mesh-less tree): the
#: same sums in another association, read before Adam, whose early
#: steps are +-lr wherever a gradient stands above eps, turns a sign
#: flip at round-off into a parameter gap.  A slot's part dropped or
#: counted twice is computed from the slots' own buffers and printed
#: beside it.  The loss trajectory is printed against the JAX test's
#: rtol / atol, not held.
LEARN_MESH_SLOTS = 2
LEARN_MESH_EPOCHS = 2
LEARN_MESH_RTOL, LEARN_MESH_ATOL = 1e-5, 1e-7
LEARN_MESH_GRAD_TOL = 1e-4


def tree_gap(a, b):
    """The norm of ``a - b`` over the norm of ``b``, each over every leaf."""
    num = sum(float((x.double() - y.double()).pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return (num / den) ** 0.5


def learn_mesh(dev, props, xs, ys, n_train, epochs=LEARN_MESH_EPOCHS):
    """The trainer driven directly at float32, mesh-less, at
    ``mesh=data:1`` and at ``mesh=data:LEARN_MESH_SLOTS`` over slots of
    ``dev``: each epoch's training loss, data:1 bitwise mesh-less (losses
    and parameters), the split mesh's first summed gradient within
    LEARN_MESH_GRAD_TOL of the mesh-less one (and the two faults' gaps),
    its census one step program (a capture per slot and the update)
    replayed every later window.  cuDNN runs its deterministic kernels
    here."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.trainer.subplugin import Trainer

    def run(mesh):
        tr = Trainer()
        tr.open(dict(props, dtype="float32", **({"mesh": mesh} if mesh else {})))
        t0 = time.perf_counter()
        losses, first = [], None
        for _ in range(epochs):
            for i in range(n_train):
                tr.push_data([xs[i]], [ys[i]], False)
                if first is None and tr.step == 1:
                    first = ([p.grad.detach().clone() for p in tr._leaves],
                             [[g.clone() for g in s] for s in tr._slot_grads or ()])
            losses.append(tr.train_epoch()["training_loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        leaves = [t.detach().clone() for t in tr._leaves]
        census = dict(tr.compile_counts(), captures=tr.census.captures,
                      replays=tr.census.replays, steps=tr.step)
        tr.close()
        return losses, leaves, census, wall, first

    # cuDNN's default weight-gradient kernels may add in any order (two
    # mesh-less runs part in epoch 2 on the card); its deterministic ones
    # make "data:1 is the mesh-less computation" a bitwise check
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with device_slots(LEARN_MESH_SLOTS):
            l0, p0, c0, w0, (g0, _) = run(None)
            l1, p1, c1, _, _ = run("data:1")
            l2, p2, c2, w2, (g2, parts) = run(f"data:{LEARN_MESH_SLOTS}")
    finally:
        torch.backends.cudnn.deterministic = was
    steps = c2["steps"]
    check(l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1)),
          f"data:1 is not the mesh-less trainer, bitwise: {l0} against {l1}")
    gap = tree_gap(g2, g0)
    faults = dict(
        dropped=tree_gap(parts[0], g0),
        doubled=tree_gap([LEARN_MESH_SLOTS * x for x in parts[0]], g0))
    check(gap <= LEARN_MESH_GRAD_TOL,
          f"data:{LEARN_MESH_SLOTS}'s first summed gradient {gap} off mesh-less")
    check(min(faults.values()) > LEARN_MESH_GRAD_TOL,
          f"a faulty sum would pass the gradient check: {faults}")
    want = dict(step=1, captures=LEARN_MESH_SLOTS + 1,
                replays=(steps - 1) * (LEARN_MESH_SLOTS + 1), steps=steps)
    check(c2 == want, f"data:{LEARN_MESH_SLOTS} census {c2}, want {want}")
    return dict(losses=l0, mesh_losses=l2, census=c2, slots=LEARN_MESH_SLOTS,
                grad_gap=gap, faults=faults,
                max_rel=float(np.max(np.abs(np.asarray(l2) - l0) / np.abs(l0))),
                within_rtol=bool(np.allclose(l0, l2, rtol=LEARN_MESH_RTOL,
                                             atol=LEARN_MESH_ATOL)),
                max_param_abs=max(float((a - b).abs().max()) for a, b in zip(p0, p2)),
                wall_s=w0, mesh_wall_s=w2)


def learn_serve(dev, fmt, frames, labels):
    """Train-while-serve: a no-op swap (the trainer's initial tree, the
    filter's own draws) leaves the served logits bitwise; after each of the
    trainer's two epochs its swap has landed, and the probe's served logits
    equal bitwise those of a fresh bundle built from the trainer's exported
    tree, and differ from the epoch before."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.filters.base import tree_map
    from nnstreamer_tpu_torch.models import mobilenet

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    size, batch = fmt["size"], fmt["batch"]
    probe = frames[0].reshape(1, size, size, 3)
    label = np.asarray([0], np.int32)
    pipe = ntt.Pipeline(LEARN_SERVE.format(**fmt))
    check(any(r.element is pipe.element("serve") for r in pipe._unique_runners()),
          "the serving filter is fused")
    served, fresh = [], []
    with pipe:
        tr = pipe.element("learn").trainer

        def serve_probe():
            pipe.push("in", [probe, label])
            served.append(host(pipe.pull("out", timeout=WAIT_S).tensors[0]))

        serve_probe()
        check(pipe.swap_params("serve", tr.export_params()) == 1, "no-op swap version")
        serve_probe()
        check(np.array_equal(served[0], served[1]), "a no-op swap changed the served logits")
        fed = 2  # the probes the tee gave the trainer
        for epoch in range(2):
            n = batch - fed
            for i in range(n):
                pipe.push("in", [frames[i].reshape(1, size, size, 3), labels[i]])
            stats = host(pipe.pull("stats", timeout=WAIT_S).tensors[0])
            check(np.isfinite(stats[0]), f"train-while-serve epoch {epoch}: loss {stats[0]}")
            for _ in range(n):
                pipe.pull("out", timeout=WAIT_S)
            serve_probe()
            fed = 1
            tree = tree_map(lambda t: t.detach(), tr.export_params())
            bundle = mobilenet.build_bundle(tree, fmt["opts"], "fresh")
            with torch.no_grad():
                want = bundle.apply_fn(bundle.params, torch.from_numpy(probe).to(dev))
            fresh.append(host(want))
            check(np.array_equal(served[-1], fresh[-1]),
                  f"epoch {epoch}: the served logits are not the fresh bundle's")
            check(not np.array_equal(served[-1], served[-2]),
                  f"epoch {epoch}: the swap did not change the served logits")
        pipe.eos("in")
        pipe.wait(timeout=WAIT_S)
        version = pipe.element("serve")._param_version
    check(version == 3, f"served param version {version}, want 3 (a no-op and 2 epochs)")
    return dict(swaps=version, probes_bitwise=len(served), epochs=2)


def phase_learn(dev, size=224, classes=1001, batch=LEARN_BATCH, n_train=LEARN_TRAIN,
                n_valid=LEARN_VALID, tail=LEARN_TAIL, acc="", model_opts=None,
                files_dir=FILES_DIR, timed=LEARN_TIMED):
    """Training on the card through ``datareposrc ! tensor_trainer``: the
    straight run (two epochs, then the partial window at EOS, checkpoints
    after each epoch), every loss finite, the census one step and one eval
    capture; the resume run (a new trainer from the checkpoint after epoch 1
    trains epoch 2 again) bitwise the straight run's checkpoint after epoch
    2 (params, Adam moments, step); the first replay against an eager step
    (``learn_step_check``); train-while-serve (``learn_serve``).
    ``model_opts`` (e.g. ``{"width": "0.25", "dtype": "float32"}``) cut the
    model for a rehearsal on the CPU."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.filters.base import tree_flatten
    from nnstreamer_tpu_torch.trainer.checkpoint import load_checkpoint
    from nnstreamer_tpu_torch.trainer.subplugin import TRAINER_PROGRAMS

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opts = dict(model_opts or {}, size=str(size), classes=str(classes))
    epoch = n_train + n_valid
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((epoch + tail, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, classes, (epoch + tail, 1)).astype(np.int32)
    records = list(range(epoch)) * 2 + list(range(epoch, epoch + tail))
    os.makedirs(files_dir, exist_ok=True)
    data = os.path.join(files_dir, "learn.bin")
    meta = os.path.join(files_dir, "learn.json")
    ck = os.path.join(files_dir, "learn.ckpt")
    fmt = dict(data=data, meta=meta, lr=LEARN_LR, batch=batch, train=n_train,
               valid=n_valid, acc=f"{acc} " if acc else "", size=size, opts=opts,
               model="".join(f"{k}={v} " for k, v in opts.items()),
               custom="custom=" + ",".join(f"{k}:{v}" for k, v in opts.items()) + " ")
    out = {}
    try:
        t0 = time.perf_counter()
        with ntt.Pipeline(f"appsrc name=src ! datareposink location={data} "
                          f"json={meta}") as sink:
            for i in records:
                sink.push("src", [frames[i], labels[i]])
            sink.eos("src")
            sink.wait(timeout=WAIT_S)
        out["write_s"] = time.perf_counter() - t0

        # the straight run
        t0 = time.perf_counter()
        pipe = ntt.Pipeline(LEARN_DESC.format(window="", epochs=3, save=ck, load="", **fmt))
        with pipe:
            tr = pipe.element("learn").trainer
            stats, at = [], []
            for _ in range(3):
                stats.append(pipe.pull("stats", timeout=WAIT_S).tensors[0].tolist())
                at.append(time.perf_counter())
            pipe.wait(timeout=WAIT_S)
            census = dict(tr.compile_counts(), captures=tr.census.captures,
                          replays=tr.census.replays, steps=tr.step)
        out["straight_s"] = time.perf_counter() - t0
        per_epoch = -(-n_train // batch)
        steps = 2 * per_epoch + -(-tail // batch)
        evals = 2 * -(-n_valid // batch)
        check(census == dict(step=1, eval=1, captures=TRAINER_PROGRAMS,
                             replays=steps - 1 + evals - 1, steps=steps),
              f"learn census {census}")
        check(all(np.isfinite(s[0]) and np.isfinite(s[1]) for s in stats)
              and all(np.isfinite(s[2]) for s in stats[:2]), f"learn stats {stats}")
        out.update(stats=stats, census=census, first_epoch_s=at[0] - t0,
                   samples_per_s=epoch / (at[1] - at[0]))

        # the resume run: epoch 2 again from the checkpoint after epoch 1
        resumed = f"{ck}.resumed"
        pipe = ntt.Pipeline(LEARN_DESC.format(
            window=f" start-sample-index={epoch} stop-sample-index={2 * epoch - 1}",
            epochs=1, save=resumed, load=f" model-load-path={ck}.step{per_epoch}", **fmt))
        with pipe:
            pipe.pull("stats", timeout=WAIT_S)
            pipe.wait(timeout=WAIT_S)
        a = load_checkpoint(f"{ck}.step{2 * per_epoch}")
        b = load_checkpoint(resumed)
        la, lb = (tree_flatten(x[:2])[0] for x in (a, b))
        same = a[2] == b[2] and len(la) == len(lb) and all(
            np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))
        check(same, "the resumed epoch 2 is not the straight run's, bitwise")
        out["resume_bitwise"] = same

        xs = frames.reshape(-1, size, size, 3)
        out["step_check"] = learn_step_check(
            dev, dict(opts, model="mobilenet_v1", optimizer="adam", learning_rate=LEARN_LR,
                      batch_size=batch, accelerator=acc.split("=", 1)[1] if acc else ""),
            xs, labels, timed)
        out["mesh"] = learn_mesh(
            dev, dict(opts, model="mobilenet_v1", optimizer="adam", learning_rate=LEARN_LR,
                      batch_size=batch,
                      accelerator=acc.split("=", 1)[1] if acc else ""),
            xs, labels, n_train)
        out["serve"] = learn_serve(dev, fmt, frames, labels)
    finally:
        for f in os.listdir(files_dir):
            if f.startswith("learn."):
                os.remove(os.path.join(files_dir, f))
    if dev.type == "cuda":
        out["step_samples_per_s"] = batch / out["step_check"]["step_ms"] * 1e3
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def print_learn(r):
    sc = r["step_check"]
    print(f"learn: mobilenet_v1 224, Adam, batch {LEARN_BATCH}: stats (train loss, acc, "
          f"valid loss, acc) by epoch {[[round(v, 4) for v in s] for s in r['stats']]}; "
          f"census {r['census']}; resume bitwise {r['resume_bitwise']}; first replay "
          f"against an eager step: max abs {sc['replay_vs_eager_max_abs']}, bitwise "
          f"{sc['bitwise']}", flush=True)
    if "step_ms" in sc:
        print(f"learn: captured step {sc['step_ms']:.3f} ms, eager step "
              f"{sc['eager_step_ms']:.3f} ms (CUDA events, median); "
              f"{r['step_samples_per_s']:.1f} samples/s in the step, "
              f"{r['samples_per_s']:.1f} samples/s over epoch 2 (samples in, a "
              f"validation pass and two checkpoints included); peak "
              f"{r['peak_mem_gb']:.2f} GB; dataset written in {r['write_s']:.1f} s, "
              f"straight run {r['straight_s']:.1f} s (its first epoch, the first "
              f"backward's kernel loads included, {r['first_epoch_s']:.1f} s)", flush=True)
    m = r["mesh"]
    print(f"learn: mesh=data:{m['slots']} over {m['slots']} slots of the card, float32: "
          f"the first summed gradient {m['grad_gap']:.3e} of the mesh-less one's norm "
          f"off (tolerance {LEARN_MESH_GRAD_TOL}; a slot's part dropped "
          f"{m['faults']['dropped']:.3e}, counted twice {m['faults']['doubled']:.3e}); "
          f"data:1 bitwise; census {m['census']}; losses (not held) "
          f"{m['mesh_losses']} against mesh-less {m['losses']}, largest relative "
          f"difference {m['max_rel']:.3e}, within rtol {LEARN_MESH_RTOL} / atol "
          f"{LEARN_MESH_ATOL}: {m['within_rtol']}; parameters within "
          f"{m['max_param_abs']:.3e}; {m['mesh_wall_s']:.2f} s against "
          f"{m['wall_s']:.2f} s mesh-less", flush=True)
    print(f"learn: train-while-serve {r['serve']}", flush=True)


YOLO_BUCKET = 8
YOLO_BUCKET_DESC = ("appsrc name=src caps=other/tensors,dimensions=3:{size}:{size}:1,"
                    "types=uint8 ! " + DIV + " ! tensor_filter framework=jax model=yolov5s "
                    "custom=size:{size},batch:1 {acc} ! tensor_sink name=out")


def yolo_bucket_ms(dev, size=640, bucket=YOLO_BUCKET, acc="", times=5):
    """yolov5s' per-frame fused stage driven straight into its
    bucket-``bucket`` vmapped step (seeded frames, no threads): the step's
    card ms per replay (``step_card_ms``), ``times`` readings, and its
    first row's outputs' checksum."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.elements.base import SINK

    pipe = ntt.Pipeline(YOLO_BUCKET_DESC.format(size=size, acc=acc), batch_max=bucket)
    [stage] = [s.element for s in pipe.stages if s.element.kind == "fused"]
    rng = np.random.default_rng(0)
    bufs = [ntt.Buffer([rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)])
            for _ in range(bucket)]
    outs = stage.process_batch(SINK, bufs)
    [st] = stage._batcher._sets.values()
    ms = [step_card_ms(st.step) for _ in range(times)] if dev.type == "cuda" else []
    first = np.asarray(outs[0][1].to_host().tensors[0], np.float64)
    return dict(ms=ms, checksum=float(np.abs(first).sum()), package=ntt.__file__)


def yolo_bucket_trees(trees):
    """One process per tree, in the order given: that tree's port at
    yolov5s' bucket-8 step."""
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--yolo-bucket-one", os.path.abspath(tree)],
                             capture_output=True, text=True, timeout=WAIT_S)
        check(out.returncode == 0, f"{tree}: {out.stderr[-4000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"yolo bucket: {tree} bucket {YOLO_BUCKET} step {row['ms']} ms "
              f"(checksum {row['checksum']:.6f}, {row['package']})", flush=True)
        rows.append(dict(tree=tree, **row))
    return rows


def yolo_bucket_one(tree):
    sys.path.insert(0, tree)
    import torch

    check(torch.cuda.is_available(), "no CUDA device available")
    torch.backends.cudnn.allow_tf32 = False
    row = yolo_bucket_ms(torch.device("cuda", 0))
    check(row["package"].startswith(tree), f"imported {row['package']}, not {tree}'s port")
    print(json.dumps(row))
    return 0


#: the mesh phase: a (data x model) mesh of MESH_SLOTS slots that all lie
#: on cuda:0 (``NNS_TPU_DEVICE_SLOTS``), so the whole sharded code runs on
#: CUDA: llama2_7b int4 tensor-parallel at model=2 in the continuous cell
#: (the cell's first two prompts, 32 and 200 ids, MESH_NEW tokens each)
#: against the same traffic unsharded, one static request through
#: custom=tp:2, the kernels at the shard shapes, the per-frame quick-start
#: at data=2 and a mesh=data:2 filter behind the query pair
MESH_SLOTS = 2
MESH_TP = 2
MESH_DP = 2
MESH_STREAMS = (0, 1)
MESH_NEW = 32
MESH_DESC = CONT_DESC.replace(f"max_new:{MAX_NEW}", f"max_new:{MESH_NEW}")
MESH_STATIC_DESC = ("appsrc name=src ! tensor_filter name=llm framework=llm "
                    "model=llama2_7b custom=quant:int4,param_dtype:bfloat16,"
                    "max_seq:1024,max_new:{new},stream_chunk:{new},tp:2 "
                    "! tensor_sink name=out")
MESH_STATIC_NEW = 32
#: teacher-forced logits, tensor-parallel against the unsharded step on the
#: same tokens: max |tp - full| over a step <= this share of the step's max
#: |full logit| (two bf16 evaluations that add the o and down partials in
#: another order; the share the card-against-CPU bf16 check holds), and the
#: served tokens equal the unsharded argmax wherever its top-1/top-2 gap
#: is wider than the same share
MESH_TIE = BF16_REF_TOL
#: one slot's int4 mats at model=2 (packed rows, out F, launches per slot
#: and decode step, output dtype: the tensor-parallel step's, bfloat16 for
#: the column cuts, float32 for the row cuts' partials and the lm_head's
#: vocabulary cut), held at the continuous step's 8 rows;
#: flash at one slot's 16 heads (a prefill chunk of 32 on 704 keys, the
#: static path's 1023-row bucket); the paged kernel at 16 of the 32 kv
#: heads
MESH_INT4 = {"wqkv/2": (2048, 6144, 32, "bf16"), "wo/2": (1024, 4096, 32, "f32"),
             "wgu/2": (2048, 11008, 32, "bf16"), "w_down/2": (2752, 4096, 32, "f32"),
             "lm_head/2": (2048, 16000, 1, "f32")}
MESH_INT4_ROWS = 8
MESH_FLASH = [(1, 32, 704, 16, 16, 128, True), (1, 1023, 1023, 16, 16, 128, True)]
MESH_PAGED = ("7b_tp2", 8, 1, 16, 16, 128, PAGED_LENS, 64)
#: the data-parallel cell: the per-frame quick-start, a backlog of
#: MESH_FRAMES frames drained MESH_BATCH_MAX at a time, data=2 against one
#: slot, every frame's logits bitwise the one-slot run's (each slot's step
#: runs at the one-slot bucket's rows)
MESH_FRAMES = 64
MESH_BATCH_MAX = 64
#: ring attention on MESH_RING slots of the card at llama2_7b's attention
#: shape (B, T, H, D; bf16, causal) against the flash kernel over the
#: whole sequence: max |ring - flash| <= RING_TOL of max |flash| (two
#: float32 accumulations of the same bf16 products, the probabilities
#: rounded to bf16 before the value product in both)
MESH_RING = 4
RING_SHAPE = (1, 4096, 32, 128)
RING_TOL = 2e-2
#: the sequence-parallel forward at llama2_7b's full width and depth,
#: SEQ_T tokens over MESH_RING slots, against the dense forward on the
#: same int4 tree, both at float32 compute (at bf16 two evaluations of 32
#: random layers part by ~8% of max |logit| whatever attends, the tie gap
#: of BF16_REF_TOL: the check could not tell a fault from rounding): max
#: |sp - dense| <= SEQ_TOL of max |dense logit| (the JAX test's 2e-3), and
#: the argmax equal wherever the dense top-1/top-2 gap is wider than that
SEQ_T = 2048
SEQ_TOL = 2e-3
MESH_QUERY = ("tensor_query_serversrc name=ssrc port=0 id=91 ! "
              "tensor_filter framework=jax model=scaler custom=scale:4.0,dims:8:8 "
              "mesh=data:2 {acc} ! tensor_query_serversink id=91")


@contextlib.contextmanager
def device_slots(k):
    """``NNS_TPU_DEVICE_SLOTS=k`` for the block (the mesh's slots per device)."""
    old = os.environ.get("NNS_TPU_DEVICE_SLOTS")
    os.environ["NNS_TPU_DEVICE_SLOTS"] = str(k)
    try:
        yield
    finally:
        if old is None:
            del os.environ["NNS_TPU_DEVICE_SLOTS"]
        else:
            os.environ["NNS_TPU_DEVICE_SLOTS"] = old


def mesh_teacher_forced(tp, full, cfg, prompt, ids, dev, dtype, chunk=32, bs=16):
    """The tokens ``ids`` a stream served after ``prompt``, fed back through
    ``forward_paged`` over the tensor-parallel params ``tp`` and over the
    unsharded ``full`` ones (pools of their own, the prompt in ``chunk``
    chunks, then one decode step a token): each step's logits, tensor-
    parallel against unsharded (max |diff| over max |full|), and each
    served token against the unsharded argmax where its top-1/top-2 gap is
    wider than MESH_TIE of the step's max |logit|."""
    import math

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    padded = math.ceil(len(prompt) / chunk) * chunk
    blocks = math.ceil(max(len(prompt) + len(ids), padded) / bs) + 1
    tables = torch.arange(blocks, dtype=torch.int32, device=dev)[None]
    toks = np.zeros(padded, np.int32)
    toks[:len(prompt)] = prompt
    last = len(prompt) - 1
    logits = {}
    with torch.inference_mode():
        for name, params in (("tp", tp), ("full", full)):
            pool = llama.init_paged_cache(cfg, blocks, bs, dtype, device=dev,
                                          tp=tp if name == "tp" else None)
            rows = []
            for start in range(0, last + 1, chunk):
                off = min(chunk - 1, last - start)
                lg, _ = llama.forward_paged(
                    params, torch.from_numpy(toks[start:start + chunk][None]).to(dev),
                    pool, tables, np.array([start], np.int64), cfg, dtype,
                    logit_off=off)
            rows.append(lg[0, -1])
            for j, t in enumerate(ids[:-1]):
                lg, _ = llama.forward_paged(
                    params, torch.tensor([[t]], dtype=torch.int32, device=dev), pool,
                    tables, np.array([len(prompt) + j], np.int64), cfg, dtype)
                rows.append(lg[0, -1])
            logits[name] = torch.stack(rows).float()
            del pool
    tp_l, full_l = logits["tp"], logits["full"]
    scale = full_l.abs().amax(-1)
    share = ((tp_l - full_l).abs().amax(-1) / scale).cpu().numpy()
    top = full_l.topk(2, dim=-1)
    gap = ((top.values[:, 0] - top.values[:, 1]) / scale).cpu().numpy()
    want = top.indices[:, 0].cpu().numpy()
    held = gap > MESH_TIE
    got = np.asarray(ids)
    return dict(steps=len(ids), max_logit_share=float(share.max()),
                held=int(held.sum()), equal_held=int((got[held] == want[held]).sum()),
                equal=int((got == want).sum()), near_ties=int((~held).sum()))


def first_step_logits(params, cfg, prompt, tok, dev, dtype, chunk=32, bs=16):
    """``forward_paged`` over ``params`` (tensor-parallel or not): the
    prompt in ``chunk`` chunks into a pool of its own, then one decode step
    of ``tok``; that step's logits on the host (the dist phase's bitwise
    check against the in-process tensor-parallel run)."""
    import math

    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models import llama

    tp = params if isinstance(params, llama.TPParams) else None
    padded = math.ceil(len(prompt) / chunk) * chunk
    blocks = math.ceil((padded + 1) / bs) + 1
    tables = torch.arange(blocks, dtype=torch.int32, device=dev)[None]
    toks = np.zeros(padded, np.int32)
    toks[:len(prompt)] = prompt
    with torch.inference_mode():
        pool = llama.init_paged_cache(cfg, blocks, bs, dtype, device=dev, tp=tp)
        for start in range(0, len(prompt), chunk):
            llama.forward_paged(
                params, torch.from_numpy(toks[start:start + chunk][None]).to(dev), pool,
                tables, np.array([start], np.int64), cfg, dtype,
                logit_off=min(chunk - 1, len(prompt) - 1 - start))
        lg, _ = llama.forward_paged(
            params, torch.tensor([[int(tok)]], dtype=torch.int32, device=dev), pool,
            tables, np.array([len(prompt)], np.int64), cfg, dtype)
        return lg[0, -1].float().cpu()


def mesh_tp(dev, base=MESH_DESC, new=MESH_NEW, static_desc=MESH_STATIC_DESC,
            static_new=MESH_STATIC_NEW, layers=N_LAYERS):
    """Tensor parallelism on two slots of one card: the continuous cell's
    first two prompts served unsharded, then at ``model_parallel=2`` (its
    weights, pool and steps cut over the slots), each served token held
    teacher-forced against the unsharded step; the census at
    SERVE_PROGRAMS with no capture after the warm-up and each step's
    launches those of two slots; then one static request through
    ``custom=tp:2``, promoted to the pipeline's model axis."""
    import numpy as np
    import torch

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.filters.llm import SERVE_PROGRAMS
    from nnstreamer_tpu_torch.ops import attention, int4_matmul as i4

    prompts = [continuous_prompts()[i] for i in MESH_STREAMS]
    groups = [(tuple(range(len(prompts))), "all")]
    keep = {}

    def grab(fw, loop, res):
        keep.update(full=fw.bundle.params, dtype=fw.dtype)

    full = serve_traffic(base, prompts, groups, new, dev, inside=grab)

    def tp_inside(fw, loop, res):
        check(fw.tp is not None and fw.tp.ways == MESH_TP and fw.tp.one_device,
              f"the filter is not tensor-parallel over {MESH_TP} slots of one device")
        check(loop._pool_sharding is not None
              and "model" in str(loop._pool_sharding.spec), "the pool is not cut by head")
        pools = loop._pool
        check(isinstance(pools, list) and len(pools) == MESH_TP
              and len({p["k"].data_ptr() for p in pools}) == MESH_TP,
              "the pool is not one tensor per slot")
        res["pool_heads_per_slot"] = int(pools[0]["k"].shape[3])
        res["teacher"] = [mesh_teacher_forced(fw.tp, keep["full"], fw.cfg, p, ids, dev,
                                              keep["dtype"])
                          for p, ids in zip(prompts, res["ids"])]
        # the dist phase's reference: this in-process group's first decode
        # step of stream 0 (kept out of the json)
        keep["first_logits"] = first_step_logits(fw.tp, fw.cfg, prompts[0],
                                                 res["ids"][0][0], dev, keep["dtype"])
        keep["cfg"] = fw.cfg

    tp = serve_traffic(base, prompts, groups, new, dev, inside=tp_inside,
                       pipe_kw=dict(model_parallel=MESH_TP))
    census = tp["census"]
    check(len(census["signatures"]) == SERVE_PROGRAMS,
          f"tensor-parallel census {census['signatures']}")
    for r in tp["teacher"]:
        check(r["max_logit_share"] <= MESH_TIE,
              f"tensor-parallel logits {r['max_logit_share']} of max |logit| off")
        check(r["equal_held"] == r["held"],
              f"tensor-parallel tokens: {r['held'] - r['equal_held']} of {r['held']} "
              "off the unsharded argmax past the tie gap")
    if dev.type == "cuda":
        # every replay of the decode step: both slots' int4 projections
        # and lm_head, both slots' paged attention
        steps = tp["stats"]["decode_steps"]
        [step] = [v for k, v in tp["step_launches"].items() if "continuous" in k]
        check(step.get("matmul_int4", 0) == steps * MESH_TP * (4 * layers + 1),
              f"int4 launches {step} over {steps} tensor-parallel decode steps")
        check(step.get("paged_attention", 0) == steps * MESH_TP * layers,
              f"paged launches {step} over {steps} tensor-parallel decode steps")
    # one static request through custom=tp:2
    prompt = _serve_prompts()[0]
    pipe = ntt.Pipeline(static_desc.format(new=static_new))
    check(pipe.model_parallel == MESH_TP, "custom=tp:2 not promoted to model_parallel")
    launches0 = {k: c.value for k, c in (("matmul_int4", i4.LAUNCHES),
                                          ("flash_attention", attention.LAUNCHES))}
    with pipe:
        check(pipe.mesh_shape == (1, MESH_TP), f"mesh shape {pipe.mesh_shape}")
        fw = pipe.element("llm").fw
        t0 = time.perf_counter()
        pipe.push("src", prompt)
        ids = [int(pipe.pull("out", timeout=WAIT_S).tensors[0][0]) for _ in range(static_new)]
        static_s = time.perf_counter() - t0
        launches = {"matmul_int4": i4.LAUNCHES.value - launches0["matmul_int4"],
                    "flash_attention": attention.LAUNCHES.value
                    - launches0["flash_attention"]}
        teacher = mesh_teacher_forced(fw.tp, keep["full"], fw.cfg, prompt, ids, dev,
                                      keep["dtype"])
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    check(teacher["max_logit_share"] <= MESH_TIE and teacher["equal_held"] == teacher["held"],
          f"static tensor-parallel request off the unsharded step: {teacher}")
    check(teacher["held"] > 0, f"static tensor-parallel request: no token past the tie "
          f"gap, so none held: {teacher}")
    return keep, dict(full=full, tp=tp, static=dict(
        prompt_len=len(prompt), ids=ids, request_s=static_s, launches=launches,
        teacher=teacher, census=census_of(fw.census, fw.census.captures)))


def mesh_kernel_rows(dev, bw, peak, flush):
    """matmul_int4 at one slot's five mats at model=2 and the continuous
    step's 8 rows, flash_attention at one slot's 16 heads and
    paged_attention at 16 kv heads, each against its plain version
    (``int4_row`` / ``flash_row`` / ``paged_row``: the same checks, bitwise
    repeat and row-0 independence included)."""
    import torch

    from nnstreamer_tpu_torch.ops import int4_matmul as i4

    gen = torch.Generator(device=dev).manual_seed(26)
    rows = []
    for name, (d2, f, per_token, odt_name) in MESH_INT4.items():
        packed = torch.randint(-128, 128, (d2, f), generator=gen, device=dev,
                               dtype=torch.int8)
        scale = torch.rand((1, f), generator=gen, device=dev) * 1e-2 + 1e-3
        w = (i4.unpack_int4(packed).float() * scale).to(torch.bfloat16)
        rows.append(int4_row(dev, gen, bw, peak, flush, name, packed, scale, w,
                             MESH_INT4_ROWS, per_token, odt_name))
        print_row(rows[-1])
        del packed, scale, w
    for shape in MESH_FLASH:
        rows.append(flash_row(dev, gen, bw, peak, flush, *shape))
        print_row(rows[-1])
    rows.append(paged_row(dev, gen, bw, peak, flush, *MESH_PAGED))
    print_row(rows[-1])
    return rows


def mesh_dp_run(dev, frames, dp, size, acc):
    """The per-frame quick-start's logits over a backlog of ``frames``
    (the first held, the rest queued, then released: drains of
    MESH_BATCH_MAX) at ``data_parallel=dp``; (logits, stats)."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt
    from nnstreamer_tpu_torch.core.log import metrics

    cap = len(frames) + 8
    pipe = ntt.Pipeline(PER_FRAME.format(size=size, cap=cap, acc=acc, tail=""),
                        batch_max=MESH_BATCH_MAX, queue_capacity=cap,
                        data_parallel=dp)
    [st] = [s for s in pipe.stages if s.element.kind == "fused"]
    stage = st.element
    check(st.shardable, f"the per-frame stage {stage.name} is not shardable")
    with pipe:
        check(pipe.mesh_shape == (dp, 1), f"mesh shape {pipe.mesh_shape}")
        pipe.push("src", frames[0])
        outs = [pipe.pull("out", timeout=WAIT_S)]
        warm_buckets(stage, frames[0], MESH_BATCH_MAX)
        warm = stage.census.captures
        metrics.reset()
        started, release = hold_first(stage)
        pipe.push("src", frames[1])
        check(started.wait(WAIT_S), "the held stage never started")
        for f in frames[2:]:
            pipe.push("src", f)
        runner = [r for r in pipe._unique_runners() if r.element is stage][0]
        deadline = time.monotonic() + WAIT_S
        while len(runner.queue._dq) < len(frames) - 2:
            check(time.monotonic() < deadline, "backlog never queued")
            time.sleep(0.001)
        t0 = time.perf_counter()
        release.set()
        outs.extend(pipe.pull("out", timeout=WAIT_S) for _ in frames[1:])
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        census = census_of(stage.census, warm)
        # each slot's captured step at the drain's one-slot bucket and at
        # half of it (the rows a slot's step ran before every slot ran
        # the one-slot bucket): device ms a replay, CUDA events
        slot_ms = {}
        if dev.type == "cuda" and dp > 1:
            for key, bs in stage._batcher._sets.items():
                if key[1] in (MESH_BATCH_MAX // 2, MESH_BATCH_MAX):
                    slot_ms[f"{key[1]} rows, slot {key[-1]}"] = step_card_ms(bs.step)
        pipe.eos("src")
        pipe.wait(timeout=WAIT_S)
    rows = {k: v for k, v in snap.items() if k.startswith(f"{stage.name}.shard_rows.")}
    logits = [np.asarray(o.tensors[0], np.float32).reshape(-1) for o in outs]
    return logits, dict(frames_per_s=(len(frames) - 1) / wall, wall_s=wall,
                        shard_rows=rows, shard_dispatch=snap.get(
                            f"{stage.name}.shard_dispatch", 0.0),
                        census=census, slot_step_ms=slot_ms)


def mesh_dp(dev, size=224, frames_n=MESH_FRAMES, acc=""):
    """The per-frame quick-start at ``data_parallel=2`` against one slot
    over the same backlog: every frame's logits bitwise the one-slot
    run's, both replicas' row counters non-zero."""
    import numpy as np

    rng = np.random.default_rng(26)
    frames = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
              for _ in range(frames_n)]
    one, st1 = mesh_dp_run(dev, frames, 1, size, acc)
    two, st2 = mesh_dp_run(dev, frames, MESH_DP, size, acc)
    share = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(two, one))
    bitwise = sum(a.tobytes() == b.tobytes() for a, b in zip(two, one))
    check(bitwise == frames_n,
          f"data-parallel logits: {bitwise} of {frames_n} frames bitwise, "
          f"{share} of max |logit| off")
    rows = st2["shard_rows"]
    check(len(rows) == MESH_DP and all(v > 0 for v in rows.values()),
          f"per-replica rows {rows}")
    check(not st1["shard_rows"], f"one slot counted shard rows {st1['shard_rows']}")
    return dict(frames=frames_n, one=st1, dp=st2, max_logit_share=share,
                bitwise=bitwise)


def mesh_query(dev, acc=""):
    """A ``mesh=data:2`` filter behind ``tensor_query_serversrc`` answers
    one client: the batch of 8 rows split over the two slots."""
    import numpy as np

    import nnstreamer_tpu_torch as ntt

    srv = ntt.Pipeline(MESH_QUERY.format(acc=acc), fuse=False)
    with srv:
        fw = [e for e in srv.elements.values() if e.kind == "tensor_filter"][0].fw
        check(fw.mesh is not None and fw.mesh.shape["data"] == MESH_DP,
              f"the filter's mesh {fw.mesh}")
        port = srv.element("ssrc").bound_port
        cli = ntt.Pipeline(f"appsrc name=src ! tensor_query_client port={port} "
                           "timeout=15 ! tensor_sink name=out")
        with cli:
            x = np.arange(64, dtype=np.float32).reshape(8, 8)
            cli.push("src", x)
            got = np.asarray(cli.pull("out", timeout=WAIT_S).tensors[0])
            cli.eos("src")
            cli.wait(timeout=WAIT_S)
    check(got.tobytes() == (4.0 * x).tobytes(), "mesh=data:2 over the wire: wrong rows")
    return dict(rows=8, slots=MESH_DP, bitwise=True)


def phase_mesh(dev, bw=None, peak=None, flush=None, base=MESH_DESC, new=MESH_NEW,
               static_desc=MESH_STATIC_DESC, static_new=MESH_STATIC_NEW,
               layers=N_LAYERS, size=224, frames_n=MESH_FRAMES, acc="",
               kernel_rows=True, ring=None):
    """The in-process mesh on MESH_SLOTS slots of ``dev``: tensor-parallel
    serving (``mesh_tp``), ring attention and the sequence-parallel
    forward on MESH_RING slots over the same int4 tree (``mesh_ring``;
    ``ring``: its keyword arguments, to cut it on the CPU), the kernels at
    the shard shapes (``mesh_kernel_rows``), data-parallel micro-batching
    (``mesh_dp``) and ``mesh=data:2`` behind the query pair
    (``mesh_query``).  Returns the results and the tensor-parallel first
    decode step's logits of stream 0 (the dist phase's reference)."""
    from nnstreamer_tpu_torch.parallel.mesh import local_devices

    with device_slots(MESH_SLOTS):
        slots = local_devices(dev.type)
        check(len(slots) == MESH_SLOTS and all(s.device.type == dev.type for s in slots),
              f"mesh slots {slots}")
        out = dict(slots=[str(s.device) for s in slots])
        keep, out["tp"] = mesh_tp(dev, base=base, new=new, static_desc=static_desc,
                                  static_new=static_new, layers=layers)
        first_logits = keep.pop("first_logits")
        out["ring"] = mesh_ring(dev, keep["full"], keep["cfg"], **(ring or {}))
        del keep
        out["kernels"] = mesh_kernel_rows(dev, bw, peak, flush) if kernel_rows else []
        out["dp"] = mesh_dp(dev, size=size, frames_n=frames_n, acc=acc)
        out["query"] = mesh_query(dev, acc=acc)
    return out, first_logits


def mesh_ring(dev, full, cfg, shape=RING_SHAPE, seq_t=SEQ_T, seq_dtype="float32"):
    """Ring attention over MESH_RING slots of ``dev`` against the flash
    kernel on the whole sequence, and ``forward_seq_parallel`` over the
    same slots against the dense ``forward`` on the int4 tree ``full``
    (the mesh phase's, no second build), with their times."""
    import torch

    from nnstreamer_tpu_torch.models import llama
    from nnstreamer_tpu_torch.ops.attention import flash_attention
    from nnstreamer_tpu_torch.parallel import make_mesh, ring_attention
    from nnstreamer_tpu_torch.parallel.mesh import local_devices

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with device_slots(MESH_RING):
        mesh = make_mesh(seq=MESH_RING, data=1, devices=local_devices(dev.type)[:MESH_RING])
    gen = torch.Generator(device=dev).manual_seed(27)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    out = {}
    with torch.inference_mode():
        ring_attention(mesh, q, k, v)  # first-use costs
        sync()
        t0 = time.perf_counter()
        got = ring_attention(mesh, q, k, v, causal=True)
        sync()
        out["ring_ms"] = (time.perf_counter() - t0) * 1e3
        want = flash_attention(q, k, v, causal=True)
        share = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        check(got.dtype == torch.bfloat16 and got.shape == want.shape,
              f"ring output {got.dtype} {tuple(got.shape)}")
        check(share <= RING_TOL, f"ring attention {share} of max |flash| off")
        out.update(shape=list(shape), slots=MESH_RING, max_share=share)
        del q, k, v, got, want

        toks = torch.randint(3, cfg.vocab, (1, seq_t), generator=torch.Generator()
                             .manual_seed(27), dtype=torch.int64)
        sync()
        t0 = time.perf_counter()
        dense = llama.forward(full, toks.to(dev), cfg, seq_dtype)
        sync()
        out["dense_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sp = llama.forward_seq_parallel(mesh, full, toks, cfg, seq_dtype)
        sync()
        out["seq_parallel_s"] = time.perf_counter() - t0
        check(sp.shape == dense.shape and bool(torch.isfinite(sp).all()),
              f"seq-parallel logits {tuple(sp.shape)}, finite {bool(torch.isfinite(sp).all())}")
        scale = dense.abs().max()
        share = float((sp - dense).abs().max() / scale)
        top = dense[0].topk(2, dim=-1).values
        held = ((top[:, 0] - top[:, 1]) / scale) > share
        agree = (sp[0].argmax(-1) == dense[0].argmax(-1))
        n_held = int(held.sum())
        out.update(tokens=seq_t, max_logit_share=share, held=n_held,
                   held_agree=float(agree[held].float().mean()) if n_held else 1.0,
                   agree_all=float(agree.float().mean()))
        del dense, sp
    check(out["max_logit_share"] <= SEQ_TOL,
          f"seq-parallel logits {out['max_logit_share']} of max |logit| off")
    check(out["held_agree"] == 1.0,
          f"seq-parallel argmax off the dense one past the gap: {out}")
    return out


#: the dist phase: two ranks on the card in one gloo group (a ``file://``
#: rendezvous under OUT_DIR), each running MESH_DESC at
#: model_parallel=2 on the mesh phase's first two prompts (MESH_NEW
#: tokens each), the first decode step of stream 0 teacher-forced, the
#: cross-rank sums of one 8-slot decode step timed (DIST_SUM_REPS), and a
#: seq=2 ring (one slot a rank) at RING_SHAPE with DIST_RING_T positions
DIST_RANKS = 2
DIST_RING_T = 2048
DIST_SUM_REPS = 3


def dist_rank(rank, rdv, out_dir):
    """One rank of the dist phase (``--dist-rank``), run in a child
    process: writes ``dist<rank>.json`` and ``dist<rank>.pt`` (the first
    decode step's logits, the ring's output) under ``out_dir``."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nnstreamer_tpu_torch.models import llama
    from nnstreamer_tpu_torch.parallel import distributed as dist
    from nnstreamer_tpu_torch.parallel import global_mesh, make_mesh, ring_attention
    from nnstreamer_tpu_torch.parallel.mesh import Slot
    from nnstreamer_tpu_torch.parallel.sharding import cross_rank_cat, cross_rank_sum

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    with open(os.path.join(out_dir, "config.json")) as fh:
        cfg = json.load(fh)
    t0 = time.perf_counter()
    check(dist.initialize(f"file://{rdv}", DIST_RANKS, rank, timeout_s=WAIT_S),
          "no process group")
    res = dict(rank=rank, join_s=time.perf_counter() - t0, device=str(dev))
    tensors = {}
    try:
        prompts = [continuous_prompts()[i] for i in MESH_STREAMS]

        def inside(fw, loop, r):
            check(fw.tp is not None and fw.tp.group is not None and fw.tp.ways == DIST_RANKS
                  and len(fw.tp.shards) == 1 and fw.census.eager,
                  f"rank {rank}: not tensor-parallel across the ranks")
            r["pool_heads"] = int(loop._pool[0]["k"].shape[3])
            tensors["first_logits"] = first_step_logits(
                fw.tp, fw.cfg, prompts[0], r["ids"][0][0], dev, fw.dtype)
            # the cross-rank sums of one 8-slot decode step: two a layer
            # of [8, 1, dim] float32 partials and the lm_head's gather
            part = [torch.randn((fw.slots, 1, fw.cfg.dim), device=dev)]
            cols = torch.randn((fw.slots, 1, fw.cfg.vocab // DIST_RANKS), device=dev)
            times = []
            for _ in range(DIST_SUM_REPS):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                for _ in range(2 * fw.cfg.n_layers):
                    cross_rank_sum(part, dev, fw.tp.group)
                cross_rank_cat(cols, -1, fw.tp.group)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t1) * 1e3)
            r["sum_ms_per_step"] = float(np.median(times))

        tp = serve_traffic(cfg["base"], prompts, [(tuple(range(len(prompts))), "all")],
                           cfg["new"], dev, inside=inside,
                           pipe_kw=dict(model_parallel=DIST_RANKS))
        res.update({k: tp[k] for k in ("ids", "launches", "aggregate_tok_s", "decode_tok_s",
                                       "census", "stats", "setup_s", "sum_ms_per_step",
                                       "pool_heads", "peak_mem_gb", "window_s")})
        # a seq=2 ring, one slot a rank, against the in-process ring on rank 0
        gen = torch.Generator(device=dev).manual_seed(28)
        q, k, v = (torch.randn(cfg["ring_shape"], generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        mesh = global_mesh(seq=DIST_RANKS, data=1)
        check(mesh.spans_ranks() and len(mesh.local) == 1, f"ring mesh {mesh}")
        with torch.inference_mode():
            got = ring_attention(mesh, q, k, v, causal=True)
            if rank == 0:
                local = make_mesh(seq=DIST_RANKS, data=1,
                                  devices=[Slot(i, dev, i) for i in range(DIST_RANKS)])
                res["ring_bitwise_in_process"] = bool(torch.equal(
                    got, ring_attention(local, q, k, v, causal=True)))
        tensors["ring"] = got.cpu()
    finally:
        dist.shutdown()
    torch.save(tensors, os.path.join(out_dir, f"dist{rank}.pt"))
    with open(os.path.join(out_dir, f"dist{rank}.json"), "w") as fh:
        json.dump(res, fh)
    return 0


def phase_dist(dev, mesh, first_logits, base=MESH_DESC, new=MESH_NEW,
               ring_shape=(RING_SHAPE[0], DIST_RING_T) + RING_SHAPE[2:], out_dir=None):
    """Two ranks on ``dev`` in one gloo group (``dist_rank`` in two child
    processes, started together, each waited for at most WAIT_S and
    killed in a ``finally``): both ranks' tokens equal to each other and
    to the mesh phase's in-process tensor-parallel tokens, the first
    decode step's logits bitwise the in-process group's, the seq=2 ring
    across the ranks bitwise the in-process one, launches per rank.
    ``out_dir``: the ranks' rendezvous and results (``OUT_DIR/dist`` by
    default)."""
    import torch

    out_dir = out_dir or os.path.join(OUT_DIR, "dist")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    rdv = os.path.join(out_dir, "rendezvous")
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(dict(base=base, new=new, ring_shape=list(ring_shape)), fh)
    env = cli_env()
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    got = run_children([[sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dist-rank",
                         str(r), rdv, out_dir] for r in range(DIST_RANKS)], env)
    wall = time.perf_counter() - t0
    for r, (rc, so, se) in enumerate(got):
        check(rc == 0, f"dist rank {r} exited {rc}:\n{so[-2000:]}\n{se[-4000:]}")
    ranks = [json.load(open(os.path.join(out_dir, f"dist{r}.json"))) for r in range(DIST_RANKS)]
    tens = [torch.load(os.path.join(out_dir, f"dist{r}.pt")) for r in range(DIST_RANKS)]
    ref = mesh["tp"]["tp"]["ids"]
    check(ranks[0]["ids"] == ranks[1]["ids"], "the ranks' tokens differ")
    check(ranks[0]["ids"] == ref, "the ranks' tokens differ from the in-process TP's")
    a, b = (t["first_logits"] for t in tens)
    check(torch.equal(a, b), "the ranks' first decode-step logits differ")
    bitwise = bool(torch.equal(a, first_logits))
    share = float((a - first_logits).abs().max() / first_logits.abs().max())
    check(bitwise, f"first decode-step logits not bitwise the in-process TP's "
          f"({share} of max |logit|)")
    check(torch.equal(tens[0]["ring"], tens[1]["ring"]), "the ranks' ring outputs differ")
    check(ranks[0]["ring_bitwise_in_process"], "the cross-rank ring is not bitwise "
          "the in-process one")
    for r in ranks:
        steps = r["stats"]["decode_steps"]
        check(r["census"]["captures_after_warmup"] == 0, f"rank {r['rank']} census")
        # each decode step: the rank's kv heads through the paged kernel in
        # every layer, its int4 mats and lm_head columns (launches per rank)
        check(steps > 0 and (dev.type != "cuda" or (
            r["launches"].get("paged_attention", 0) >= steps * N_LAYERS
            and r["launches"].get("matmul_int4", 0) >= steps * (4 * N_LAYERS + 1))),
              f"rank {r['rank']}: launches {r['launches']} over {steps} decode steps")
    return dict(ranks=ranks, wall_s=wall, first_logits_bitwise=bitwise,
                first_logits_share=share, tokens_equal=True, ring_shape=list(ring_shape),
                ring_bitwise=ranks[0]["ring_bitwise_in_process"])


def print_dist(d, m, card):
    r0, r1 = d["ranks"]
    t = m["tp"]
    print(f"dist: {DIST_RANKS} ranks on one card in a gloo group ({card}); join "
          f"{r0['join_s']:.1f} s, load {r0['setup_s']:.1f} s, children {d['wall_s']:.1f} s",
          flush=True)
    print(f"dist: model_parallel=2 across the ranks, {len(r0['ids'])} streams x "
          f"{len(r0['ids'][0])} tokens: {r0['aggregate_tok_s']:.2f} tok/s against "
          f"{t['tp']['aggregate_tok_s']:.2f} in-process model=2 and "
          f"{t['full']['aggregate_tok_s']:.2f} unsharded; tokens equal on both ranks and "
          f"to the in-process TP's: {d['tokens_equal']}; first decode step bitwise the "
          f"in-process TP's: {d['first_logits_bitwise']}", flush=True)
    print(f"dist: cross-rank sums of one 8-slot decode step (64 sums, the lm_head "
          f"gather): {r0['sum_ms_per_step']:.2f} ms (rank 1 "
          f"{r1['sum_ms_per_step']:.2f}); "
          f"decode steps {r0['stats']['decode_steps']}, prefill chunks "
          f"{r0['stats']['prefill_chunks']}; launches rank 0 {r0['launches']}, rank 1 "
          f"{r1['launches']}; {r0['pool_heads']} kv heads a rank's pool; census "
          f"{r0['census']}", flush=True)
    print(f"dist: seq=2 ring across the ranks at {d['ring_shape']} bf16 causal: bitwise "
          f"the in-process ring {d['ring_bitwise']}", flush=True)


def print_mesh(m, card):
    def gb(v):
        return "(CPU: no peak)" if v is None else f"{v:.2f}"

    t = m["tp"]
    print(f"mesh: slots {m['slots']} ({card}: one card, two slots)", flush=True)
    print(f"mesh: tensor-parallel model=2, {len(t['tp']['ids'])} streams x "
          f"{len(t['tp']['ids'][0])} tokens: {t['tp']['aggregate_tok_s']:.2f} tok/s "
          f"against {t['full']['aggregate_tok_s']:.2f} unsharded (one card, two slots); "
          f"decode {[round(x, 2) for x in t['tp']['decode_tok_s']]} against "
          f"{[round(x, 2) for x in t['full']['decode_tok_s']]} tok/s a stream; "
          f"load {t['tp']['setup_s']:.1f} s (unsharded {t['full']['setup_s']:.1f}), "
          f"peak {gb(t['tp']['peak_mem_gb'])} GB (unsharded "
          f"{gb(t['full']['peak_mem_gb'])}), {t['tp']['pool_heads_per_slot']} kv heads "
          f"a slot's pool", flush=True)
    for i, r in enumerate(t["tp"]["teacher"]):
        print(f"mesh: stream {i} teacher-forced against the unsharded step: logits "
              f"{r['max_logit_share']:.4f} of max |logit| (tolerance {MESH_TIE}), tokens "
              f"{r['equal_held']} of {r['held']} held equal, {r['equal']} of "
              f"{r['steps']} in all, {r['near_ties']} near ties", flush=True)
    print(f"census: mesh {t['tp']['census']}; launches {t['tp']['launches']}, "
          f"by step {t['tp']['step_launches']}", flush=True)
    s = t["static"]
    print(f"mesh: static custom=tp:2, prompt {s['prompt_len']}, {len(s['ids'])} tokens in "
          f"{s['request_s']:.2f} s, launches {s['launches']}, teacher-forced logits "
          f"{s['teacher']['max_logit_share']:.4f}, tokens {s['teacher']['equal_held']} of "
          f"{s['teacher']['held']} held", flush=True)
    d = m["dp"]
    print(f"mesh: data-parallel quick-start, {d['frames']} frames at batch_max "
          f"{MESH_BATCH_MAX}: {d['dp']['frames_per_s']:.1f} frames/s at data=2 against "
          f"{d['one']['frames_per_s']:.1f} on one slot (one card, two slots); logits "
          f"{d['max_logit_share']:.5f} of max |logit| off, {d['bitwise']} of "
          f"{d['frames']} bitwise; rows {d['dp']['shard_rows']}, census "
          f"{d['dp']['census']}", flush=True)
    if d["dp"]["slot_step_ms"]:
        print(f"mesh: data=2 slot steps, device ms a replay (CUDA events): "
              f"{d['dp']['slot_step_ms']}", flush=True)
    print(f"mesh: mesh=data:2 behind the query pair {m['query']}", flush=True)
    r = m["ring"]
    print(f"mesh: ring attention seq={r['slots']} at {r['shape']} bf16 causal: "
          f"{r['max_share']:.5f} of max |flash| off (tolerance {RING_TOL}), "
          f"{r['ring_ms']:.1f} ms", flush=True)
    print(f"mesh: forward_seq_parallel seq={r['slots']}, T={r['tokens']}, llama2_7b int4 "
          f"32 layers, float32 compute: logits {r['max_logit_share']:.2e} of max |logit| off "
          f"the dense forward (tolerance {SEQ_TOL}), argmax equal at {r['held_agree']:.4f} of "
          f"the {r['held']} positions past that gap ({r['agree_all']:.4f} of all); "
          f"{r['seq_parallel_s']:.2f} s against {r['dense_s']:.2f} s dense", flush=True)


def main():
    import torch

    if "--yolo-bucket-one" in sys.argv[1:]:
        return yolo_bucket_one(sys.argv[sys.argv.index("--yolo-bucket-one") + 1])
    if "--weave-client" in sys.argv[1:]:
        port, prompts, ring, new = sys.argv[sys.argv.index("--weave-client") + 1:][:4]
        return weave_client(int(port), prompts, ring, int(new))
    if "--dist-rank" in sys.argv[1:]:
        rank, rdv, out_dir = sys.argv[sys.argv.index("--dist-rank") + 1:][:3]
        return dist_rank(int(rank), rdv, out_dir)
    if "--shm-producer" in sys.argv[1:]:
        name, frames_n, size, device = sys.argv[sys.argv.index("--shm-producer") + 1:][:4]
        return shm_producer(name, int(frames_n), int(size), device)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from nnstreamer_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    if "--yolo-bucket" in sys.argv[1:]:
        print(card)
        os.makedirs(OUT_DIR, exist_ok=True)
        rows = yolo_bucket_trees(sys.argv[sys.argv.index("--yolo-bucket") + 1:])
        with open(os.path.join(OUT_DIR, "yolo_bucket.json"), "w") as fh:
            json.dump(dict(card=card, rows=rows), fh, indent=1)
        return 0
    bw, peak = RATES["pcie" if "pcie" in card.lower() else "sxm"]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  rates=dict(bytes_per_s=bw, bf16_flops=peak))

    def save():
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
            json.dump(detail, fh, indent=1)

    profile = "--profile" in sys.argv[1:]
    phase = PhaseClock(slack=4 if profile else 1)
    with phase("build"):
        # g++ (the native libraries, then the capi phase's filter and
        # program) beside nvcc, all started together
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            native_build = pool.submit(build_native)
            detail["build_s"] = kernels.build()
            detail["native_build_s"], capi_so, capi_program = native_build.result(
                timeout=PHASE_DEADLINE_S["build"])
        print(f"build: {detail['build_s']:.1f} s; g++ (libnnstpu, libnnstpu_capi, "
              f"the capi filter and program) {detail['native_build_s']:.1f} s beside it",
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
        print(f"build: int8 conv SASS {evidence['int8_sass']}, kernels (gemm x 12, "
              f"depthwise x 2, dense, direct) {evidence['int8_kernels']}", flush=True)

    with phase("kernels"):
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        rows, streams = phase_kernels(dev, bw, peak, flush_buf.zero_)
        del flush_buf
        detail.update(kernels=rows, int4_two_streams=streams)
        save()
        torch.cuda.empty_cache()

    with phase("serve"):
        torch.cuda.reset_peak_memory_stats(dev)
        serve = detail["serve"] = phase_serve(dev, profile=profile)
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

    with phase("continuous"):
        cont = detail["continuous"] = phase_continuous(dev, profile=profile)
        for r in cont["streams"]:
            print(f"continuous: prompt {r['prompt_len']}"
                  f"{' (late)' if r['late_joiner'] else ''} ttft at sink "
                  f"{r['ttft_ms']:.1f} ms (in the loop {r['loop_ttft_ms']:.1f}), decode "
                  f"{r['decode_tok_s']:.2f} tok/s", flush=True)
        print(f"continuous: loop timeline (ms) {cont['timeline']}", flush=True)
        print(f"continuous: {cont['aggregate_tok_s']:.2f} tok/s over "
              f"{cont['window_s']:.2f} s, {cont['decode_steps']} decode steps, "
              f"{cont['prefill_chunks']} prefill chunks, launches {cont['launches']}, "
              f"peak {cont['peak_mem_gb']:.2f} GB, warm-up {cont['warmup_s']:.1f} s",
              flush=True)
        print(f"continuous: tokens against forward_paged {cont['replayed']}", flush=True)
        sw = cont["swaps"]
        print(f"continuous: swaps (no-op {sw['noop_swap_ms']:.1f} ms, to B "
              f"{sw['swap_ms']:.1f} ms, back {sw['swap_back_ms']:.1f} ms; B built in "
              f"{sw['tree_b_s']:.1f} s): no-op and back bitwise, B's stream against "
              f"an eager forward over B {sw['b_against_eager']}, logits from A's by "
              f"{sw['first_step_diff_from_a']}, captures {sw['captures']}, version "
              f"{sw['param_version']}", flush=True)
        print(f"census: continuous {cont['census']}", flush=True)
        print(f"continuous: host {cont['host_us_per_step']:.1f} us per decode step "
              f"(issuing it){'' if cont['busy'] is None else ', traced: ' + str(cont['busy'])}",
              flush=True)
        for name, r in cont["graph_vs_eager"].items():
            print(f"census: graph against eager at the 7B 8-slot step, {name}, "
                  f"{r['steps']} steps: tokens {r['tokens_equal']}, positions "
                  f"{r['positions_equal']}, pool {r['pool_equal']}; replay "
                  f"{r['graph_ms']:.3f} ms on the card, "
                  f"{r['graph_host_ms'] * 1e3:.1f} us host; eager {r['eager_ms']:.3f} ms, "
                  f"{r['eager_host_ms'] * 1e3:.1f} us host", flush=True)
        torch.cuda.empty_cache()

    with phase("xray"):
        detail["xray"] = phase_xray(dev, cont)
        print_xray(detail["xray"], card)
        save()
        torch.cuda.empty_cache()

    with phase("query"):
        query, live = phase_query(dev, serve, cont)
        detail["query"] = query
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

    with phase("weave"):
        try:
            prompts = continuous_prompts()
            weave = detail["weave"] = phase_weave(
                dev, live, [prompts[i] for i in WEAVE_STREAMS],
                [query["streams"][i]["ids"] for i in WEAVE_STREAMS])
        finally:
            live.stop()
            del live
        print_weave(weave)
        save()
        torch.cuda.empty_cache()

    with phase("prefix"):
        prefix = detail["prefix"] = phase_prefix(dev)
        print_prefix(prefix)
        save()
        torch.cuda.empty_cache()

    with phase("spec"):
        spec = detail["spec"] = phase_spec(dev, cont)
        print_spec(spec)
        save()
        torch.cuda.empty_cache()

    with phase("files"):
        files = detail["files"] = phase_files(dev, cont)
        print_files(files)
        save()
        torch.cuda.empty_cache()

    with phase("elastic"):
        elastic = detail["elastic"] = phase_elastic(dev, cont)
        print_elastic(elastic, cont)
        save()
        torch.cuda.empty_cache()

    with phase("mesh"):
        flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        mesh, first_logits = phase_mesh(dev, bw, peak, flush_buf.zero_)
        detail["mesh"] = mesh
        del flush_buf
        print_mesh(mesh, card)
        save()
        torch.cuda.empty_cache()

    with phase("dist"):
        dist = detail["dist"] = phase_dist(dev, mesh, first_logits)
        print_dist(dist, mesh, card)
        save()

    with phase("reference"):
        detail["reference"] = []
        for ref in (phase_reference, phase_reference_paged, phase_reference_bf16):
            detail["reference"].append(ref(dev))
            print(f"reference: {detail['reference'][-1]}", flush=True)
        save()
        torch.cuda.empty_cache()

    with phase("vision"):
        vision = detail["vision"] = phase_vision(dev, profile=profile)
        print_vision(vision)
        save()
        torch.cuda.empty_cache()

    with phase("models"):
        detail["models"] = phase_models(dev, profile=profile)
        print_models(detail["models"])
        save()
        torch.cuda.empty_cache()

    with phase("batching"):
        detail["batching"] = phase_batching(dev, profile=profile)
        print_batching(detail["batching"])
        save()
        torch.cuda.empty_cache()

    with phase("camera"):
        detail["camera"] = phase_camera(dev)
        print_camera(detail["camera"])
        save()
        torch.cuda.empty_cache()

    with phase("asr"):
        detail["asr"] = phase_asr(dev)
        print_asr(detail["asr"])
        save()
        torch.cuda.empty_cache()

    with phase("v4l2"):
        detail["v4l2"] = phase_v4l2(dev)
        print_v4l2(detail["v4l2"])
        save()
        torch.cuda.empty_cache()

    with phase("transport"):
        detail["transport"] = phase_transport(dev)
        print_transport(detail["transport"])
        save()
        torch.cuda.empty_cache()

    with phase("modelfiles"):
        mf = detail["modelfiles"] = phase_modelfiles(dev, profile=profile)
        print_modelfiles(mf)
        save()
        torch.cuda.empty_cache()

    with phase("capi"):
        detail["capi"] = phase_capi(dev, capi_so, capi_program)
        print_capi(detail["capi"], mf["quant"]["frames_per_s"], card)
        save()
        torch.cuda.empty_cache()

    with phase("learn"):
        detail["learn"] = phase_learn(dev)
        print_learn(detail["learn"])

    # one line per kernel: int4 per decoded token (129 launches at B=1),
    # with the same 129 launches at B=8 (a continuous decode step) and
    # B=32 (a prefill chunk or an [8, 4] verify step) beside it; flash per
    # request at the 1023-row prompt bucket (32 launches) and per
    # continuous prefill chunk (32 launches at Sq = 32, by Skv), paged per
    # continuous decode step at the 7B 8-slot shape (32 launches), with
    # the verify step's 32 and the draft's propose launches beside it;
    # launches are those of every LLM phase (serve, continuous, prefix,
    # spec, files, elastic, mesh, and dist's two ranks, each rank's counted
    # in its own process), each counted from 0 after its warm-up (the files
    # phase's static text request from its push), by phase in
    # launches_by_phase; spec_launches, the spec phase's greedy run's
    # launches of the new shapes, counted by captured step (verify,
    # propose) and around the draft's eager prefill calls
    int4_rows = [r for r in rows if r["kernel"] == "matmul_int4"]
    mesh_int4 = [r for r in mesh["kernels"] if r["kernel"] == "matmul_int4"]
    mesh_flash = {r["shape"]["Sq"]: r for r in mesh["kernels"]
                  if r["kernel"] == "flash_attention"}
    [mesh_paged] = [r for r in mesh["kernels"] if r["kernel"] == "paged_attention"]

    def per_step(B, key):
        return sum(r[key] * r["per_token"] for r in int4_rows if r["B"] == B)

    fl = [r for r in rows if r["kernel"] == "flash_attention"
          and r["shape"]["Sq"] == 1023][0]
    chunk = {r["shape"]["Skv"]: r for r in rows if r["kernel"] == "flash_attention"
             and r["shape"]["Sq"] == 32 and r["shape"]["D"] == 128
             and r["shape"]["Skv"] in FLASH_CHUNK_SKV}
    paged_rows = [r for r in rows if r["kernel"] == "paged_attention"
                  and r["route"] == "kernel"]
    pg = [r for r in paged_rows if r["shape"]["name"] == "7b"][0]
    runs = dict(serve=[serve], continuous=[cont], weave=[weave],
                prefix=[prefix[k] for k in ("on", "off", "fork_on", "fork_off", "ring")],
                spec=[spec["greedy"], *spec["sampled"], spec["accept"],
                      spec["accept_plain"]],
                files=[files["int4"], files["int8"], files["text"]],
                elastic=[elastic["greedy"], elastic["sampled"]],
                mesh=[mesh["tp"]["full"], mesh["tp"]["tp"], mesh["tp"]["static"]],
                dist=dist["ranks"])
    by_phase = {k: {ph: sum(r["launches"].get(k, 0) for r in rs)
                    for ph, rs in runs.items()}
                for k in ("matmul_int4", "flash_attention", "paged_attention")}
    both = {k: sum(v.values()) for k, v in by_phase.items()}
    spec_shapes = spec["spec_launches"]
    vr = [r for r in paged_rows if r["shape"]["name"] == "7b_verify"][0]
    summary = [
        dict(name="matmul_int4", route="cuda",
             source="nnstreamer_tpu_torch/csrc/int4_matmul.cu",
             replaces="nnstreamer_tpu/ops/int4_matmul.py:193",
             launches=both["matmul_int4"],
             max_abs_err=max(r["max_abs_err"] for r in int4_rows + mesh_int4),
             max_row_err=max(r["max_row_err"] for r in int4_rows + mesh_int4),
             **{k: per_step(1, k) for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes",
             **{f"{what}_{k}": per_step(B, k) for what, B in (("step8", 8), ("chunk32", 32))
                for k in ("ms", "bound_ms", "library_ms")},
             launches_by_phase=by_phase["matmul_int4"],
             spec_launches=spec_shapes["matmul_int4"],
             # one slot's share of a tensor-parallel decode step (model=2,
             # 8 rows), the five shard mats; max errors include them
             **{f"tp2_step8_{k}": sum(r[k] * r["per_token"] for r in mesh_int4)
                for k in ("ms", "bound_ms", "library_ms")},
             tp2_max_row_err=max(r["max_row_err"] for r in mesh_int4)),
        dict(name="flash_attention", route="cuda",
             source="nnstreamer_tpu_torch/csrc/flash_attention.cu",
             replaces="nnstreamer_tpu/ops/attention.py:210",
             launches=both["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in rows + mesh["kernels"]
                             if r["kernel"] == "flash_attention"),
             max_row_err=max(r["max_row_err"] for r in rows + mesh["kernels"]
                             if r["kernel"] == "flash_attention"),
             **{k: 32 * fl[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by=fl["bound_by"],
             chunk_ms={str(n): N_LAYERS * r["ms"] for n, r in sorted(chunk.items())},
             launches_by_phase=by_phase["flash_attention"],
             spec_launches=spec_shapes["flash_attention"],
             # one slot's 16 heads at model=2: a request's 1023-row bucket
             # and a 32-row chunk on 704 keys, 32 launches each
             **{f"tp2_{k}": N_LAYERS * mesh_flash[1023][k]
                for k in ("ms", "bound_ms", "library_ms")},
             tp2_chunk704_ms=N_LAYERS * mesh_flash[32]["ms"],
             tp2_max_row_err=max(r["max_row_err"] for r in mesh_flash.values())),
        dict(name="paged_attention", route="cuda",
             source="nnstreamer_tpu_torch/csrc/paged_attention.cu",
             replaces="nnstreamer_tpu/ops/attention.py:429",
             launches=both["paged_attention"],
             max_abs_err=max(r["max_abs_err"] for r in paged_rows + [mesh_paged]),
             max_row_err=max(r["max_row_err"] for r in paged_rows + [mesh_paged]),
             **{k: N_LAYERS * pg[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "library_ms")},
             bound_by=pg["bound_by"],
             **{f"verify_{k}": N_LAYERS * vr[k] for k in ("ms", "bound_ms",
                                                          "library_ms")},
             launches_by_phase=by_phase["paged_attention"],
             spec_launches=spec_shapes["paged_attention"],
             # one slot's pool at model=2: 16 kv heads, 32 launches a step
             **{f"tp2_{k}": N_LAYERS * mesh_paged[k] for k in ("ms", "bound_ms",
                                                              "library_ms")},
             tp2_max_row_err=mesh_paged["max_row_err"]),
        int8_summary(mf),
    ]
    detail["summary"] = summary
    detail["phase_s"] = phase.seconds
    save()
    phase.total()
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
