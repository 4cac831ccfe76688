"""LLM token-streaming framework for tensor_filter.

Port of the static stream path and the continuous serving loop of
``nnstreamer_tpu/filters/llm.py`` (reference analog: the llama.cpp
sub-plugin — prompt in, generated tokens streamed out as flexible
tensors).  The static path (``serve`` unset):

* one prefill over the (bucketed) prompt, then decode one token per
  step against a KV cache that stays on the device;
* a decode step is one captured graph per batch size (the census of
  :mod:`..pipeline.graphs`; eager on the CPU), over a cache, a
  generator, a token and a position on the card that one request holds
  from its prefill to its last token;
* tokens are produced in bursts of ``stream_chunk``: each burst is
  that many replays of the step with ONE host sync at its end, and the
  burst's tokens then stream downstream one buffer each;
* ``llm.prefill`` (prompt in to first token on the host) and
  ``llm.decode_token`` (burst time per token) are recorded as latency
  series in :data:`~..core.log.metrics`.

``custom=serve:continuous`` runs :class:`_ContinuousLoop` instead: a
standing decode loop over a block-paged KV pool that several requests
share, each admitted into a free slot while the others decode, with
prefix sharing (on by default) and, with ``draft:<preset>``, speculative
decoding.

Pipeline usage::

    appsrc name=prompt ! tensor_filter framework=llm model=llama_tiny
        custom=max_new:32,temperature:0.0 ! tensor_sink name=tokens

Input: one uint8 tensor (UTF-8 prompt bytes, encoded by the filter's
tokenizer: byte-level ids, or the SentencePiece vocab of the model file or
of ``tokenizer:``) or int32 token ids ``[T]`` / ``[B, T]``.  Output per
token: ``[B]`` int32 ids, plus the uint8 piece bytes at batch 1.
``model=`` is a zoo name or a Llama-family model file (``.gguf``,
``.safetensors``, a HF checkpoint directory, ``.npz``).  The filter runs
on the CUDA card unless the element sets ``accelerator=true:cpu``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import math
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.buffer import Buffer, start_fetch, upload
from ..core.config import get_config
from ..core.log import logger, metrics
from ..core.meta_keys import (META_ABORT_REASON, META_EMIT_T,
                              META_ENQUEUE_NS, META_QUERY_CONN,
                              META_STREAM_ABORTED, META_STREAM_ID,
                              META_STREAM_INDEX, META_STREAM_LAST, META_TENANT)
from ..core.registry import register_filter
from ..core.types import TensorFormat, TensorsSpec
from ..models import llama
from ..models.tokenizer import load_gguf_tokenizer
from ..models.zoo import build as build_model
from ..ops.attention import PAGED_MAX_ROWS, paged_route
from ..pipeline.graphs import Census
from ..trainer.checkpoint import host_tensor
from ..utils import elastic
from .base import (Framework, FrameworkError, parse_custom_options,
                   place_swapped_params, resolve_device)

log = logger(__name__)

#: buffer-meta keys that must NOT ride a drain snapshot: the queue-stamp
#: map is the source pipeline's tracer plumbing, and the query connection
#: id routes sends on the SOURCE pipeline's server core (a stale id on the
#: adopting side would deliver the stream's tokens to whatever client
#: holds that id there; callers may re-stamp ``snapshot["meta"]`` before
#: ``adopt_stream``)
_SNAPSHOT_META_DROP = (META_ENQUEUE_NS, META_QUERY_CONN)


def _next_bucket(t: int) -> int:
    """Smallest power-of-two >= t (min 32): bounds the distinct prefill
    shapes at log2(max_seq) for arbitrary prompt mixes."""
    b = 32
    while b < t:
        b <<= 1
    return b


class ByteTokenizer:
    """Byte-level tokenizer: id = byte + n_special.  Deterministic, no vocab
    file.  ids 0..n_special-1 are special (0=pad, 1=bos, 2=eos)."""

    n_special = 3
    bos = 1
    eos = 2

    def encode(self, text_bytes: bytes) -> List[int]:
        return [self.bos] + [b + self.n_special for b in text_bytes]

    def decode_piece(self, token_id: int) -> bytes:
        if token_id < self.n_special:
            return b""
        b = token_id - self.n_special
        return bytes([b]) if b < 256 else b""


#: captured steps of the continuous loop for its life: the ``[slots]``-row
#: paged decode step; with a draft, the propose and the verify step in its
#: place.  The JAX package's census has 3 / 5 programs: its prefill step
#: and slot-token setter are programs there, while here the prefill chunks
#: run eagerly (ROADMAP Queue B 2) and a slot's token goes in by a copy.
SERVE_PROGRAMS = 1
SPEC_SERVE_PROGRAMS = 2


def serving_plan(cfg, *, slots: int, block_size: int = 16,
                 kv_blocks: int = 0, prefill_chunk: int = 32,
                 dtype: str = "bfloat16", draft_cfg=None,
                 spec_k: int = 4, temperature: float = 0.0) -> Dict[str, int]:
    """Static sizing of the paged-KV serving state, without building
    anything: the one home of the arithmetic the loop and the deep lint
    (``analysis/tracecheck.py``) share, the JAX package's ``serving_plan``
    with the same integers under the same names, but ``programs``:

    * ``max_blocks`` — block-table width per slot.  Prefill pads prompts
      to ``prefill_chunk`` multiples, so the table spans the largest
      padded prompt's final chunk, not just ``max_seq``; with a draft it
      also spans the ``spec_k`` positions past ``max_seq`` that a
      stream's last ``[slots, spec_k + 1]`` verify step writes (a prefix
      hit starts its suffix on the same chunk grid, so neither bound
      moves).  The extra entries stay sentinel.
    * ``n_blocks`` — pool size.  ``kv_blocks`` 0 = worst case
      (``slots * ceil(max_seq / block_size)``: admission never defers on
      blocks); larger is clamped to it.
    * ``pool_bytes`` / ``draft_pool_bytes`` — the ``n_blocks`` blocks of
      the target's pool and of the draft's (same blocks and tables at the
      draft's layers and heads; 0 without a draft), k + v.
    * ``decode_bytes_per_ctx_token`` — K + V bytes the paged kernel reads
      per live context position and decode step, every layer, at
      ``n_kv_heads`` (the kernel reads a block once per query-head group);
      ``kv_groups`` — ``n_heads // n_kv_heads``.
    * ``prng_state_bytes`` — the per-slot sampler keys (a Philox key, two
      uint32, per slot) when ``temperature > 0``; 0 for greedy loops.
    * ``programs`` — the loop's captured steps: :data:`SERVE_PROGRAMS`, or
      :data:`SPEC_SERVE_PROGRAMS` with a draft (the JAX package's 3 / 5
      count its prefill step and token setter, which are not captured
      steps here).
    """
    bs = max(1, int(block_size))
    C = max(1, int(prefill_chunk))
    k = max(1, int(spec_k))
    pad_max = math.ceil((cfg.max_seq - 1) / C) * C
    seq_span = cfg.max_seq + (k if draft_cfg is not None else 0)
    max_blocks = math.ceil(max(seq_span, pad_max) / bs)
    worst = int(slots) * math.ceil(cfg.max_seq / bs)
    n_blocks = min(int(kv_blocks), worst) if kv_blocks else worst
    return {
        "max_blocks": max_blocks,
        "n_blocks": n_blocks,
        "pool_bytes": llama.paged_cache_bytes(cfg, n_blocks, bs, dtype=dtype),
        "draft_pool_bytes": (
            llama.paged_cache_bytes(draft_cfg, n_blocks, bs, dtype=dtype)
            if draft_cfg is not None else 0),
        "decode_bytes_per_ctx_token": (
            2 * cfg.n_layers * cfg.n_kv_heads * (cfg.dim // cfg.n_heads)
            * (2 if str(dtype) in ("bfloat16", "float16") else 4)),
        "kv_groups": cfg.n_heads // cfg.n_kv_heads,
        "prng_state_bytes": (int(slots) * 2 * 4
                             if float(temperature) > 0.0 else 0),
        "programs": (SPEC_SERVE_PROGRAMS if draft_cfg is not None
                     else SERVE_PROGRAMS),
    }


@register_filter("llm", aliases=("llamacpp", "llama.cpp"))
class LLMFramework(Framework):
    """Streaming generation.  ``custom=`` options:

    ``max_new:N`` (default 32), ``temperature:F`` (0 = greedy), ``seed:N``
    (sampling seed), ``top_k:N`` / ``top_p:F`` (sampler truncation),
    ``stream_chunk:N`` (tokens decoded per host sync, default 8),
    ``tokenizer:<file.gguf>`` (the text tokenizer of that file's
    ``tokenizer.ggml.*`` vocab; default: the model file's own vocab, else
    byte-level ids), ``stop_eos:0|1`` (stop at the tokenizer's EOS id,
    default on with a real vocab and off for the byte-level tokenizer),
    ``quant:int4`` (nibble-packed weights, decoded through the CUDA kernel
    of ``csrc/int4_matmul.cu``) or ``quant:int8`` (per-channel int8,
    scale after the product), ``dtype:bfloat16|float32`` (compute),
    ``param_dtype:...`` (weights), plus model geometry overrides
    (``dim:…``, ``n_layers:…``, ``max_seq:…``) forwarded to the zoo.
    ``model=`` takes a zoo name or a Llama-family model file (``.gguf``,
    ``.safetensors``, a HF checkpoint directory, ``.npz``).

    ``serve:continuous`` + ``slots:N`` (default 4) runs the standing
    decode loop (:class:`_ContinuousLoop`) with ``block_size:N`` (KV pool
    granularity, default 16), ``kv_blocks:N`` (pool size in blocks,
    default 0 = worst case), ``prefill_chunk:N`` (tokens per prefill
    step, default 32), ``prefill_budget:N`` (prefill tokens per loop
    iteration while streams decode, default one chunk) and
    ``admit_timeout:S`` (seconds a prompt may wait at the head of the
    queue, default 30, 0 = forever) and ``stream_idle_timeout:S`` (the
    grace between a stream being cancelled through
    :func:`~..utils.elastic.cancel_stream`, as the query serversink does
    when its client's connection died, and its slot and KV blocks being
    reaped, default 5); ``stream_chunk`` is then the decode steps per
    host sync.  The loop also takes ``prefix_cache:0|1`` (share the KV
    blocks of a common prompt prefix, default 1), ``nan_guard:0|1``
    (answer a prompt whose prefill logits are not finite with
    ``abort_reason=poison`` and quarantine it through the pipeline's
    armor, default 0) and ``draft:<preset>`` (speculative decoding: a
    ``llama.PRESETS`` model at the target's vocab and ``max_seq``, weights
    from ``draft_seed:N`` at ``param_dtype``, proposes ``spec_k:N``
    tokens a round, default 4, and the target verifies them in one
    ``[slots, spec_k + 1]`` step).

    A continuous stream moves between loops at a chunk boundary:
    :meth:`drain_stream` takes it off this loop as a host snapshot (its KV
    blocks, positions, tokens, sampler state and request meta) and
    :meth:`adopt_stream` continues it on another loop of the same model,
    block size and compute dtype, token for token.

    :meth:`swap_params` copies a new tree into the live weights
    (train-while-serve): between static requests, or at the loop's next
    chunk boundary.

    **Tensor parallelism.**  Inside a pipeline with a ``model`` axis
    (``Pipeline(model_parallel=M)``; ``custom=tp:M`` is promoted to it)
    the filter opens on the pipeline's mesh (``_mesh_provider``); outside
    one, ``custom=tp:M`` builds a ``(data=1, model=M)`` mesh of its own
    over the local slots of its device.  The weights (and a draft's) are
    cut over the model group's slots (``llama.place_tp``), the static
    cache and the continuous loop's pools by kv head, one tensor per
    slot; the tokens, positions, tables and sampler state stay on the
    root slot.  Every step runs the same kernels per slot at the shard's
    shapes, chosen per call.  With every slot on one device a step
    (decode, propose, verify) is one captured graph; over distinct cards
    the census runs the steps eagerly (``Census.eager``, not yet run on
    such a machine).  A geometry that does not divide, or more slots than
    there are, raises.  Weight swaps are refused under tensor
    parallelism.

    Under a process group (``parallel/distributed.py``) the pipeline's
    mesh spans every rank's slots, and a model group may span ranks: each
    rank runs the same pipeline on the same prompts (the JAX package's
    multi-controller model), keeps only its own shards, computes the
    residual, norms, embedding and sampler itself, and sums across the
    ranks (``parallel/sharding.cross_rank_sum``), so every rank's sink
    yields the same tokens.  Its steps run eagerly (a gloo collective is
    host code), the loop admits a prompt once every rank has it and
    leaves ``admit_timeout`` off, and drains, adoptions and swaps are
    refused.
    """

    name = "llm"
    streaming = True

    def __init__(self):
        super().__init__()
        self.bundle = None
        self.cfg: Optional[llama.LlamaConfig] = None
        self.tokenizer = ByteTokenizer()
        self.device = torch.device("cpu")
        self.continuous = False
        #: the speculative loop's draft model (``draft:``), else None
        self.draft_bundle = None
        self.draft_cfg: Optional[llama.LlamaConfig] = None
        #: the pipeline's armor (``Pipeline(quarantine=...)``), handed over
        #: by the tensor_filter element; ``nan_guard:1`` quarantines through it
        self._armor = None
        self._serve: Optional[_ContinuousLoop] = None
        self._serve_lock = threading.Lock()
        #: the captured decode steps of this filter (static sets or the
        #: continuous loop's one step)
        self.census: Optional[Census] = None
        #: idle static decode sets, at most one per batch size
        self._free_sets: Dict[int, _StaticDecode] = {}
        self._sets_lock = threading.Lock()
        #: static requests in flight, and whether a swap waits for them to
        #: end (new requests wait for the swap)
        self._requests = 0
        self._swapping = False
        self._requests_cv = threading.Condition()
        #: tensor parallelism: the mesh the filter runs on and the cut
        #: weights (``llama.TPParams``), else None
        self.mesh = None
        self.tp = None

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        model = str(props.get("model") or "llama_tiny")
        opts = parse_custom_options(str(props.get("custom", "")))
        try:
            tp = int(opts.pop("tp", 1))
        except ValueError:
            raise FrameworkError("custom=tp: expects an int") from None
        serve = str(opts.pop("serve", "")).lower()
        if serve not in ("", "continuous"):
            raise FrameworkError(f"custom=serve:{serve}: unknown serve mode "
                                 "(continuous)")
        self.continuous = serve == "continuous"
        self.slots = max(1, int(opts.pop("slots", 4)))
        self.block_size = max(1, int(opts.pop("block_size", 16)))
        self.kv_blocks = max(0, int(opts.pop("kv_blocks", 0)))
        self.prefill_chunk = max(1, int(opts.pop("prefill_chunk", 32)))
        self.prefill_budget = max(
            1, int(opts.pop("prefill_budget", self.prefill_chunk)))
        self.admit_timeout = max(0.0, float(opts.pop("admit_timeout", 30.0)))
        self.stream_idle_timeout = max(
            0.0, float(opts.pop("stream_idle_timeout", 5.0)))
        self.prefix_cache = str(opts.pop("prefix_cache", "1")).lower() \
            not in ("0", "false", "no")
        self.nan_guard = str(opts.pop("nan_guard", "0")).lower() \
            in ("1", "true", "yes")
        draft = str(opts.pop("draft", "") or "")
        self.spec_k = max(1, int(opts.pop("spec_k", 4)))
        draft_seed = int(opts.pop("draft_seed", 0))
        quant = str(opts.get("quant", "")).lower()
        if quant not in ("", "int4", "int8"):
            raise FrameworkError(f"custom=quant:{quant}: unsupported quant "
                                 "(int8, int4)")
        tok_path = opts.pop("tokenizer", None)
        stop_opt = opts.pop("stop_eos", None)
        self.device = resolve_device(str(props.get("accelerator", "")))
        self.max_new = int(opts.pop("max_new", 32))
        self.temperature = float(opts.pop("temperature", 0.0))
        self.top_k = int(opts.pop("top_k", 0))
        self.top_p = float(opts.pop("top_p", 1.0))
        self.seed = int(opts.pop("seed", 0))
        self.chunk = max(1, int(opts.pop("stream_chunk", 8)))
        self.dtype = opts.get("dtype", "bfloat16")
        try:
            self.bundle = build_model(model, opts, device=self.device)
        except KeyError as e:
            raise FrameworkError(str(e)) from e
        self.cfg = self.bundle.config
        if self.cfg is None:
            raise FrameworkError(
                f"model {model!r} has no LlamaConfig; the llm framework needs "
                "a decoder-LM bundle (models/llama.py)")
        if draft:
            self._open_draft(draft, draft_seed, opts)
        self._open_tokenizer(tok_path, stop_opt)
        self.census = Census(self.device)
        self._setup_tp(tp)

    def _setup_tp(self, tp: int) -> None:
        """Open on the pipeline's mesh when it has a ``model`` axis, else
        on a ``(data=1, model=tp)`` mesh of the filter's own for ``tp``
        over 1; cut the weights (and the draft's) over the model group."""
        from ..parallel.mesh import local_devices, make_mesh, mesh_axis_size

        mesh = None
        provider = getattr(self, "_mesh_provider", None)
        if provider is not None:
            try:
                mesh = provider(self.device)
            except Exception as e:
                from ..pipeline.runtime import PipelineError

                if isinstance(e, PipelineError):
                    # a placement error of the pipeline (an over-ask, a
                    # plan that does not divide) goes up as it is
                    raise
                raise FrameworkError(str(e)) from e
            if mesh is not None and mesh_axis_size(mesh, "model") <= 1:
                mesh = None
        if mesh is None and tp > 1:
            if self.device.type == "meta":
                return  # abstract build: nothing to place
            slots = local_devices(self.device.type)
            if len(slots) < tp:
                raise FrameworkError(
                    f"tp:{tp} needs {tp} devices, have {len(slots)}")
            mesh = make_mesh(model=tp, data=1, devices=slots[:tp])
        if mesh is None:
            return
        ways = mesh_axis_size(mesh, "model")
        problems = llama.tp_divisibility_problems(self.cfg, ways)
        if self.draft_cfg is not None:
            problems += [f"draft {p}" for p in
                         llama.tp_divisibility_problems(self.draft_cfg, ways)]
        if problems:
            raise FrameworkError(
                f"model geometry does not divide model_parallel={ways}: "
                + "; ".join(problems))
        if mesh.kind != self.device.type:
            raise FrameworkError(
                f"the pipeline mesh is on {mesh.kind}, the filter on "
                f"{self.device.type} (accelerator=)")
        group = mesh.model_group(0)
        own = [i for i, s in enumerate(group) if s.addressable]
        if not own or own != list(range(own[0], own[0] + len(own))):
            raise FrameworkError(
                f"this process's slots {own} of the model group are not one run")
        devs = [group[i].device for i in own]
        if devs[0] != self.device:
            raise FrameworkError(
                f"the mesh's root slot is on {devs[0]}, the filter on "
                f"{self.device}")
        from ..parallel.distributed import group_of

        try:
            pg = group_of(group)
        except ValueError as e:
            raise FrameworkError(str(e)) from e
        self.mesh = mesh
        kw = dict(ways=len(group), first=own[0], group=pg)
        self.bundle.params = llama.place_tp(self.bundle.params, self.cfg, devs, **kw)
        self.tp = self.bundle.params
        if self.draft_bundle is not None:
            self.draft_bundle.params = llama.place_tp(
                self.draft_bundle.params, self.draft_cfg, devs, **kw)
        if pg is not None:
            # a cross-rank sum is host code (gloo), which no CUDA graph
            # can hold: the steps run eagerly, in the same order on every
            # rank (the loop admits only what every rank has)
            self.census.eager = True
            log.warning("llm filter: tensor-parallel over %d slots of %d "
                        "processes runs its steps eagerly", ways,
                        len({s.rank for s in group}))
        elif not self.tp.one_device:
            # one stream cannot capture a step over several cards: the
            # steps run eagerly (not yet run on such a machine)
            self.census.eager = True
            log.warning("llm filter: tensor-parallel over %d distinct "
                        "devices runs its decode steps eagerly", ways)

    def _open_tokenizer(self, tok_path, stop_opt) -> None:
        """The JAX filter's tokenizer choice: an explicit
        ``tokenizer:<file>`` first, then the model file's own vocab, then
        byte-level ids.  A vocab larger than the model's is refused here:
        on the card an out-of-range id in the embedding gather is a
        device-side assert that poisons the process's CUDA context, so
        this check is the only guard.  ``stop_eos`` defaults to on with a
        real vocab (the llama.cpp contract) and off for byte-level ids."""
        if tok_path is not None:
            tok = load_gguf_tokenizer(str(tok_path))
            if tok is None:
                raise FrameworkError(
                    f"tokenizer file {tok_path!r} carries no "
                    "tokenizer.ggml.tokens vocab")
            self.tokenizer = tok
        elif self.bundle.tokenizer is not None:
            self.tokenizer = self.bundle.tokenizer
        n_tok = getattr(self.tokenizer, "n_vocab", 0)
        if n_tok > self.cfg.vocab:
            raise FrameworkError(
                f"tokenizer vocab ({n_tok}) exceeds model vocab "
                f"({self.cfg.vocab}); wrong tokenizer for this model")
        if stop_opt is None:
            self.stop_eos = not isinstance(self.tokenizer, ByteTokenizer)
        else:
            self.stop_eos = str(stop_opt).lower() not in ("0", "false", "no")

    def _open_draft(self, name: str, seed: int, opts: Dict[str, str]) -> None:
        """Build the speculative loop's draft (the JAX package's checks):
        a ``llama.PRESETS`` model at the target's vocab and ``max_seq``,
        so that its proposals are target ids at target positions, built
        on the target's device.  The verify step must take the paged
        kernel on the card: ``open`` refuses a ``[slots, spec_k + 1]``
        shape that :func:`~..ops.attention.paged_route` sends row by row
        through gathered flash (that route sizes its gathers on the host,
        which a captured step cannot)."""
        if not self.continuous:
            raise FrameworkError(
                "draft: (speculative decoding) requires serve:continuous: "
                "the per-request stream path has no standing verify loop")
        if name not in llama.PRESETS:
            raise FrameworkError(
                f"draft model {name!r} must be a preset zoo name "
                f"({sorted(llama.PRESETS)})")
        cfg, T = self.cfg, self.spec_k + 1
        group = cfg.n_heads // cfg.n_kv_heads
        try:
            route = paged_route(self.slots, T, group)
        except ValueError as e:
            raise FrameworkError(f"draft: verify step: {e}") from e
        if route != "kernel":
            raise FrameworkError(
                f"draft: the [slots, spec_k + 1] = [{self.slots}, {T}] verify "
                f"step takes the paged kernel only with slots > 1 and "
                f"(n_heads / n_kv_heads) * (spec_k + 1) = {group * T} <= "
                f"{PAGED_MAX_ROWS} query rows")
        self.draft_bundle = build_model(name, {
            "vocab": str(cfg.vocab), "max_seq": str(cfg.max_seq),
            "seed": str(seed),
            "param_dtype": str(opts.get("param_dtype", "float32"))},
            device=self.device)
        self.draft_cfg = self.draft_bundle.config

    def close(self) -> None:
        if self._serve is not None:
            self._serve.shutdown()
            self._serve = None
        with self._sets_lock:
            self._free_sets = {}
        self.bundle = self.draft_bundle = None

    # -- continuous serving ------------------------------------------------
    def _loop(self) -> "_ContinuousLoop":
        if not self.continuous:
            raise FrameworkError("not a serve:continuous filter")
        with self._serve_lock:
            if self._serve is None:
                self._serve = _ContinuousLoop(self)
            return self._serve

    def serve_loop(self, timeout: float = 600.0) -> "_ContinuousLoop":
        """Start the continuous loop if it is not running and wait until
        its warm-up has run; returns the loop, whose ``stats`` count the
        decode steps and prefill chunks dispatched since warm-up."""
        loop = self._loop()
        if not loop.warmed.wait(timeout):
            raise FrameworkError(f"serve loop warm-up took over {timeout} s")
        loop.check()
        return loop

    def submit(self, inputs: Sequence, meta: Dict, emit) -> int:
        """Queue one prompt into the standing decode loop.  ``emit(tensors,
        meta)`` is called from the serve thread once per generated token
        with the request's meta plus stream_id/stream_index/emit_t (and
        stream_last on the final one).  Returns the minted stream id."""
        prompt = self._to_tokens(inputs[0])
        if prompt.shape[0] != 1:
            raise FrameworkError(
                f"serve:continuous takes one prompt per request, got "
                f"{prompt.shape[0]} rows")
        return self._loop().submit(prompt, meta, emit)

    def drain(self, timeout: float = 600.0) -> bool:
        """Block until every submitted stream has finished (EOS path)."""
        return self._serve is None or self._serve.drain(timeout)

    # -- elastic serving: drain / adopt -------------------------------------
    def serve_streams(self) -> Dict[int, Dict]:
        """Live, mid-prefill and queued streams of this filter's loop:
        ``stream_id -> {"state", "tenant", "slot", "blocks"}``."""
        if self._serve is None:
            return {}
        return self._serve.stream_table()

    def drain_stream(self, stream_id: int, timeout: float = 30.0) -> Dict:
        """Take one live (or still queued) stream off the standing loop at
        its next chunk boundary: its used KV blocks (copied to the host,
        shared ones included), positions, last two tokens, request meta
        and prompt become a snapshot, and its slot and blocks go back to
        the pool.  A stream still in prefill is taken once it is live.
        Greedy continuation after :meth:`adopt_stream` is bit-identical
        to an undrained run; a sampled stream carries its slot's
        generator state (``gen_state``, ``generator`` the device kind it
        belongs to), so a continuation is bit-identical too."""
        if self._serve is None:
            raise FrameworkError("no continuous serve loop is running")
        return self._serve.drain_stream(int(stream_id), timeout)

    def snapshot_problems(self, snapshot: Dict) -> List[str]:
        """Why ``snapshot`` cannot be adopted here (empty: adoptable).  The
        contract: the same model geometry, compute dtype and block size;
        slots, pool size and prefill settings may differ.  A sampled
        snapshot's generator state belongs to one kind of generator (a CPU
        one's MT19937 state or a CUDA one's Philox seed and offset): on a
        filter of the other kind it is refused, never re-seeded."""
        problems: List[str] = []
        if not isinstance(snapshot, dict):
            return ["snapshot must be a dict (drain_stream's return)"]
        if snapshot.get("version") not in (1, 2):
            problems.append(
                f"snapshot version {snapshot.get('version')!r} "
                "unsupported (expected 1 or 2)")
            return problems
        if self.draft_bundle is not None and snapshot.get("kind") == "live" \
                and "tok_prev" not in snapshot:
            # the speculative refresh step re-feeds the second-to-last
            # committed token, which a pre-speculation (v1) snapshot lacks
            problems.append(
                "snapshot predates speculative decoding (no tok_prev); "
                "adopt it on a loop without draft:, or re-drain from a "
                "current pipeline")
        if snapshot.get("cfg") != dataclasses.asdict(self.cfg):
            problems.append("model geometry differs from the snapshot's")
        if snapshot.get("kind") == "live":
            if str(snapshot.get("dtype")) != str(self.dtype):
                problems.append(
                    f"compute dtype {snapshot.get('dtype')!r} != "
                    f"{self.dtype!r} (KV block contents are dtype-exact)")
            if int(snapshot.get("block_size", -1)) != self.block_size:
                problems.append(
                    f"block_size {snapshot.get('block_size')!r} != "
                    f"{self.block_size} (block contents do not re-chunk)")
            kind = snapshot.get("generator")
            if snapshot.get("gen_state") is not None \
                    and kind != self.device.type:
                problems.append(
                    f"the snapshot's sampler state is a {kind} generator's; "
                    f"this filter draws with {self.device.type} generators")
        return problems

    def adopt_stream(self, snapshot: Dict, emit, timeout: float = 30.0) -> int:
        """Re-admit a drained stream into this filter's standing loop
        (started on first use, as :meth:`submit` does): its KV blocks are
        copied into the pool, its slot state restored, and
        ``emit(tensors, meta)`` receives the remaining tokens with
        ``stream_index`` going on where the drained loop stopped.  Returns
        the stream id (the snapshot's unless a live local id has it)."""
        problems = self.snapshot_problems(snapshot)
        if problems:
            raise FrameworkError(
                "cannot adopt stream snapshot: " + "; ".join(problems))
        return self._loop().adopt_stream(snapshot, emit, timeout)

    # -- train-while-serve: param hot-swap ----------------------------------
    def swap_params(self, tree, timeout: float = 30.0) -> Optional[int]:
        """Copy ``tree`` (the structure, shapes and dtypes of
        ``bundle.params``) into the live weights (refused under tensor
        parallelism: the weights are cut over slots).  Every captured step
        reads those tensors at fixed addresses (the int4 and paged kernels
        bake TMA maps into the graphs), so they are written in place,
        never rebound.  With a standing serve loop the copy is a control
        command run at its next chunk boundary, like drain and adopt, and
        the loop's new param version is returned.  Otherwise it waits
        until no static request is in flight (new ones wait for it) and
        returns None: a static request never sees half its weights
        swapped, and each decode set's captured step reads the new ones."""
        if self.bundle is None:
            raise FrameworkError("framework is not open")
        if self.tp is not None:
            raise FrameworkError(
                "swap_params: the weights are cut over a tensor-parallel mesh; "
                "a swap into the shards is not ported")
        if self._serve is not None:
            return self._serve.swap_params(tree, timeout)
        with self._requests_cv:
            if not self._requests_cv.wait_for(lambda: not self._swapping, timeout):
                raise FrameworkError(f"swap_params: another swap ran past {timeout} s")
            self._swapping = True
            try:
                if not self._requests_cv.wait_for(
                        lambda: self._requests == 0, timeout):
                    raise FrameworkError(
                        f"swap_params: static requests still running after "
                        f"{timeout} s")
                place_swapped_params(self.bundle.params, tree)
            finally:
                self._swapping = False
                self._requests_cv.notify_all()
        return None

    def param_bytes(self) -> int:
        """Live parameter bytes, the draft's included (int4 leaves count
        their packed bytes): the deep pass's estimate and xray's ledger.
        Under tensor parallelism every slot's shards count, a tensor that
        slots on one device share once."""
        from .base import tree_param_bytes

        total = 0
        for b in (self.bundle, self.draft_bundle):
            if b is None or b.params is None:
                continue
            if isinstance(b.params, llama.TPParams):
                seen = set()
                for _, ts in b.params.leaves():
                    for t in ts:
                        key = (str(t.device), t.data_ptr())
                        if key not in seen:
                            seen.add(key)
                            total += t.numel() * t.element_size()
            else:
                total += tree_param_bytes(b.params)
        return total

    def attach_xray(self, registry, stage: str, rec=None) -> None:
        """xray: the continuous loop's captured steps count under
        ``<stage>.serve`` against ``serving_plan()["programs"]`` (one
        expectation per step kind), its eager prefill chunks are noted;
        the static path's steps, one per batch size, register unbounded
        under ``stage``."""
        self._xray, self._xray_stage, self._xray_rec = registry, stage, rec
        if self.census is None:
            return
        if self.continuous:
            serve = f"{stage}.serve"
            kinds = (("propose", "verify") if self.draft_bundle is not None
                     else ("continuous",))
            for kind in kinds:
                registry.expect(serve, kind, budget=1,
                                note="serving_plan captured step")
            registry.note_eager(serve, "prefill chunks (uncaptured)")
            self.census.attach_xray(registry, serve, rec)
        else:
            self.census.attach_xray(registry, stage, rec)

    def get_model_info(self):
        flex_in = TensorsSpec.from_string("1", "uint8").replace(
            format=TensorFormat.FLEXIBLE)
        flex_out = TensorsSpec.from_string("1", "int32").replace(
            format=TensorFormat.FLEXIBLE)
        return flex_in, flex_out

    # -- tokenization ------------------------------------------------------
    def _to_tokens(self, arr) -> np.ndarray:
        arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        if arr.dtype == np.uint8:
            return np.asarray([self.tokenizer.encode(arr.tobytes())], np.int32)
        toks = arr.astype(np.int32)
        if toks.ndim == 1:
            toks = toks[None, :]
        if toks.ndim != 2:
            raise FrameworkError(f"prompt must be [T] or [B,T], got {arr.shape}")
        return toks

    # -- generation --------------------------------------------------------
    def _take_decode(self, B: int) -> "_StaticDecode":
        """The idle decode set of batch size B, or a new one, captured
        then: a request that overlaps another of the same B gets a set of
        its own.  Before a new set is made every idle set is dropped, so
        the sets held are at most those that were in use together when
        the last one was made: never more card memory than requests in
        flight at one time needed, as when each request freed its own
        cache."""
        with self._sets_lock:
            dec = self._free_sets.pop(B, None)
            if dec is None:
                self._free_sets.clear()
        return dec if dec is not None else _StaticDecode(self, B)

    def _give_back(self, dec: "_StaticDecode") -> None:
        """Keep ``dec`` idle unless its batch size has an idle set already
        (then it is dropped)."""
        with self._sets_lock:
            self._free_sets.setdefault(dec.B, dec)

    @torch.inference_mode()
    def _gen_tokens(self, prompt: np.ndarray) -> Iterator[np.ndarray]:
        cfg = self.cfg
        B, T = prompt.shape
        if T >= cfg.max_seq:
            raise FrameworkError(f"prompt length {T} >= max_seq {cfg.max_seq}")
        t0 = time.perf_counter()
        with self._requests_cv:
            self._requests_cv.wait_for(lambda: not self._swapping)
            self._requests += 1
        try:
            dec = self._take_decode(B)
            try:
                yield from self._decode(dec, prompt, t0)
            finally:
                self._give_back(dec)
        finally:
            with self._requests_cv:
                self._requests -= 1
                self._requests_cv.notify_all()

    def _decode(self, dec: "_StaticDecode", prompt: np.ndarray,
                t0: float) -> Iterator[np.ndarray]:
        cfg = self.cfg
        B, T = prompt.shape
        params = self.bundle.params
        # Prompt-length bucketing: right-pad to the next power of two so
        # mixed prompt lengths share a few prefill shapes.  Causal
        # attention keeps real tokens from seeing pad rows, decode
        # overwrites cache row `pos` before any later position attends it,
        # and the sampled logit is read at the REAL last position.  The
        # same holds for the rows an earlier request left in the set's
        # cache: prefill overwrites [0, P), decode row `pos` before any
        # position attends it.
        P = T
        if get_config().shape_bucketing:
            P = min(_next_bucket(T), cfg.max_seq - 1)
        if P > T:
            prompt = np.pad(prompt, ((0, 0), (0, P - T)))
        tokens = torch.from_numpy(prompt).to(self.device)
        logits, _ = llama.forward_cached(params, tokens, dec.cache, 0, cfg,
                                         compute_dtype=self.dtype)
        dec.gen.manual_seed(self.seed)
        # At least one token is always safe; later decode steps feed
        # positions T..T+n-2, each of which must stay < max_seq.
        n = max(1, min(self.max_new, cfg.max_seq - T))
        eos = self.tokenizer.eos if self.stop_eos else -1
        tok = llama.sample_token(logits[:, T - 1], dec.gen, self.temperature,
                                 self.top_k, self.top_p)
        dec.tok.copy_(tok[:, None])
        dec.pos.fill_(T)
        first = tok.cpu().numpy()
        # host clock around work that ends in a device sync (the copy)
        metrics.observe_latency("llm.prefill", time.perf_counter() - t0)
        yield first
        if B == 1 and int(first[0]) == eos:
            return
        done = 1
        while done < n:
            length = min(self.chunk, n - done)
            t0 = time.perf_counter()
            steps = []
            for _ in range(length):
                dec.step.replay()
                steps.append(dec.tok[:, 0].clone())
            host = torch.stack(steps, dim=1).cpu().numpy()  # ONE sync per chunk
            metrics.observe_latency("llm.decode_token",
                                    (time.perf_counter() - t0) / length)
            for j in range(length):
                yield host[:, j]
                if B == 1 and int(host[0, j]) == eos:
                    return
            done += length

    def invoke_stream(self, inputs: Sequence) -> Iterator[List[np.ndarray]]:
        """Yield one output list per generated token: [ids [B] int32,
        piece bytes uint8] at batch 1, [ids [B]] for batched prompts."""
        prompt = self._to_tokens(inputs[0])
        for ids in self._gen_tokens(prompt):
            metrics.count("llm.tokens", ids.shape[0])
            if ids.shape[0] != 1:
                yield [ids]
                continue
            piece = np.frombuffer(
                self.tokenizer.decode_piece(int(ids[0])), np.uint8)
            yield [ids, piece.copy()]

    def invoke(self, inputs: Sequence) -> List[np.ndarray]:
        """Non-streaming: all generated ids as one [B, N] tensor + the
        decoded bytes (batch 1)."""
        chunks = [outs[0] for outs in self.invoke_stream(inputs)]
        ids = np.stack(chunks, axis=1)
        text = b"".join(self.tokenizer.decode_piece(int(t)) for t in ids[0])
        return [ids, np.frombuffer(text, np.uint8).copy()]


class _StaticDecode:
    """One static-path decode set for batch size B: the KV cache, the
    sampling generator, the step's token ``[B, 1]`` and position (0-d)
    on the card, and the decode step captured over them, which reads the
    token and position and advances both in place (a chunk of any length
    is that many replays).  A request holds the set from its prefill to
    its last token, and re-seeds the generator."""

    def __init__(self, fw: LLMFramework, B: int):
        cfg, dev, params, dtype = fw.cfg, fw.device, fw.bundle.params, fw.dtype
        temperature, top_k, top_p = fw.temperature, fw.top_k, fw.top_p
        self.B = B
        cache = self.cache = llama.init_cache(cfg, B, dtype=dtype, device=dev,
                                              tp=fw.tp)
        gen = self.gen = torch.Generator(device=dev)
        tok = self.tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        pos = self.pos = torch.zeros((), dtype=torch.long, device=dev)

        # refers to neither the set nor the filter: no reference cycle, so
        # closing the filter frees the set, its graph and the weights at once
        def step() -> None:
            logits, _ = llama.forward_cached(params, tok, cache, pos, cfg, dtype)
            tok.copy_(llama.sample_token(
                logits[:, -1], gen, temperature, top_k, top_p)[:, None])
            pos.add_(1)

        self.step = fw.census.capture(
            ("static", B, str(dtype), temperature > 0), step,
            generators=(gen,) if temperature > 0 else ())


def _pool_parts(pool) -> List[Dict]:
    """A pool's per-slot dicts: a tensor-parallel pool is a list of them
    (``llama.init_paged_cache`` with ``tp=``), any other pool is one."""
    return pool if isinstance(pool, list) else [pool]


def paged_decode_step(params, cfg, dtype, pool: Dict, tok: torch.Tensor,
                      pos: torch.Tensor, tables: torch.Tensor,
                      live: torch.Tensor, gens: Sequence[torch.Generator],
                      temperature: float, top_k: int = 0,
                      top_p: float = 1.0) -> Callable[[], None]:
    """The continuous loop's decode step over its static tensors, the
    function its census captures: ``forward_paged`` of every slot's token
    ``tok`` [B] at its position ``pos`` [B] int64 through ``tables`` [B,
    max_blocks] int32, the per-slot sampler (``live`` [B] bool keeps the
    draws of live slots, one generator per slot), then ``tok`` takes the
    sampled tokens and ``pos`` advances by one, in place."""

    def step() -> None:
        logits, _ = llama.forward_paged(params, tok[:, None], pool, tables, pos,
                                        cfg, dtype)
        tok.copy_(llama.sample_token_per_slot(
            logits[:, -1], gens, temperature, top_k, top_p, live=live))
        pos.add_(1)

    return step


def spec_commit(pt, dprobs, props, u, gumbel, live):
    """Speculative rejection sampling as a function of its draws (the
    JAX package's ``spec_rejection_commit``, with the draws handed in).

    ``pt`` [B, k+1, V]: the target's filtered distributions after the last
    committed token and each of the k proposals; ``dprobs`` [B, k, V]: the
    draft distributions the proposals were drawn from; ``props`` [B, k]
    int32; ``u`` [B, k]: uniforms on [0, 1); ``gumbel`` [B, V]: standard
    Gumbel noise; ``live`` [B] bool (a parked row commits nothing).

    Proposal i is accepted iff ``u_i * q(x_i) < p(x_i)``; the longest
    accepted prefix is kept, and the token after it is drawn from the
    normalised residual ``max(p - q, 0)`` at the first rejection, or from
    ``pt[k]`` when all k are accepted (``pt`` itself where the residual
    has no mass), as ``argmax(log r + gumbel)``: how
    ``jax.random.categorical`` draws.  The emitted tokens are distributed
    as sampling the target one token at a time.

    Returns ``(em, acc)``: ``em`` [B, k+1] int32, the accepted proposals
    and then the drawn token at column ``acc``; ``acc`` [B] int64, the
    accept counts."""
    k = props.shape[1]
    idx = props.long()[:, :, None]
    q_x = dprobs.gather(2, idx)[:, :, 0]
    pt_x = pt[:, :k].gather(2, idx)[:, :, 0]
    ok = (u * q_x < pt_x).to(torch.int32)
    acc = torch.cumprod(ok, dim=1).sum(dim=1)
    acc = torch.where(live, acc, torch.zeros_like(acc))
    qpad = torch.cat([dprobs, torch.zeros_like(dprobs[:, :1])], dim=1)
    resid = torch.clamp(pt - qpad, min=0.0)
    at = acc[:, None, None].expand(-1, 1, pt.shape[-1])
    r_at = resid.gather(1, at)[:, 0]
    pt_at = pt.gather(1, at)[:, 0]
    r = torch.where(r_at.sum(dim=-1, keepdim=True) > 1e-20, r_at, pt_at)
    final = torch.argmax(torch.log(torch.clamp(r, min=1e-38)) + gumbel,
                         dim=-1).to(torch.int32)
    em = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    col = torch.arange(k + 1, device=props.device)[None, :]
    return torch.where(col == acc[:, None], final[:, None], em), acc


def spec_draws(gens: Sequence[torch.Generator], k: int, vocab: int,
               device) -> tuple:
    """A sampled verify step's draws, from each slot's own generator in
    this order: ``k`` accept uniforms [B, k], then one Gumbel row [B,
    vocab] (``-log`` of Exp(1) draws, kept finite) for the final token."""
    u, g = [], []
    for gen in gens:
        u.append(torch.rand(k, generator=gen, device=device))
        e = torch.empty(vocab, device=device).exponential_(generator=gen)
        g.append(-torch.log(e.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.stack(u), torch.stack(g)


def spec_propose_step(dparams, dcfg, dtype, dpool: Dict, tok: torch.Tensor,
                      tok_prev: torch.Tensor, pos: torch.Tensor,
                      tables: torch.Tensor, props: torch.Tensor,
                      dprobs: Optional[torch.Tensor],
                      gens: Sequence[torch.Generator], park: int,
                      temperature: float, top_k: int = 0,
                      top_p: float = 1.0) -> Callable[[], None]:
    """A speculative round's draft side over the loop's static tensors,
    the function its census captures: first the refresh step, the
    draft's ``forward_paged`` of ``tok_prev`` at ``pos - 1`` (after a
    round that accepted every proposal the draft pool lacks that
    position; a parked row stays at ``pos``, so it still reads nothing),
    then ``k = props.shape[1]`` draft steps from ``tok`` at ``pos``.
    Greedy takes each step's argmax; sampled draws each proposal from
    the filtered draft distribution with the slot's generator and keeps
    the distributions in ``dprobs`` [B, k, V].  Writes ``props`` [B, k]
    in place."""
    k = props.shape[1]

    def step() -> None:
        rpos = torch.where(pos >= park, pos, pos - 1)
        llama.forward_paged(dparams, tok_prev[:, None], dpool, tables, rpos,
                            dcfg, dtype, logit_off=0)
        t = tok
        for i in range(k):
            logits, _ = llama.forward_paged(dparams, t[:, None], dpool, tables,
                                            pos + i, dcfg, dtype)
            if temperature > 0.0:
                probs = torch.softmax(llama.filter_logits(
                    logits[:, -1], temperature, top_k, top_p), dim=-1)
                dprobs[:, i].copy_(probs)
                t = llama.draw_per_slot(probs, gens)
            else:
                t = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            props[:, i].copy_(t)

    return step


def spec_verify_step(params, cfg, dtype, pool: Dict, tok: torch.Tensor,
                     tok_prev: torch.Tensor, pos: torch.Tensor,
                     tables: torch.Tensor, props: torch.Tensor,
                     dprobs: Optional[torch.Tensor], out: torch.Tensor,
                     gens: Sequence[torch.Generator], park: int,
                     temperature: float, top_k: int = 0,
                     top_p: float = 1.0) -> Callable[[], None]:
    """A speculative round's target side, the function its census
    captures: one ``[B, k+1]`` ``forward_paged`` of the last committed
    token and the k proposals, then the accept and commit in the same
    step.  Greedy keeps the longest prefix of proposals equal to the
    target's argmax, plus the target's own next token; sampled runs
    :func:`spec_commit` on :func:`spec_draws`.  ``out`` [B, k+2] int32
    takes the accept counts (column 0) and the emitted rows; ``tok``,
    ``tok_prev`` and ``pos`` advance in place for live rows (``pos <
    park``) and stay for parked ones."""
    k = props.shape[1]

    def step() -> None:
        toks = torch.cat([tok[:, None], props], dim=1)
        logits, _ = llama.forward_paged(params, toks, pool, tables, pos, cfg,
                                        dtype)
        live = pos < park
        if temperature > 0.0:
            pt = torch.softmax(llama.filter_logits(
                logits, temperature, top_k, top_p), dim=-1)
            u, gumbel = spec_draws(gens, k, logits.shape[-1], logits.device)
            em, acc = spec_commit(pt, dprobs, props, u, gumbel, live)
        else:
            em = torch.argmax(logits, dim=-1).to(torch.int32)
            ok = (props == em[:, :k]).to(torch.int32)
            acc = torch.cumprod(ok, dim=1).sum(dim=1)
            acc = torch.where(live, acc, torch.zeros_like(acc))
        new_tok = em.gather(1, acc[:, None])[:, 0]
        prev = em.gather(1, (acc - 1).clamp(min=0)[:, None])[:, 0]
        out[:, 0].copy_(acc)
        out[:, 1:].copy_(em)
        tok_prev.copy_(torch.where(live, torch.where(acc > 0, prev, tok),
                                   tok_prev))
        tok.copy_(torch.where(live, new_tok, tok))
        pos.copy_(torch.where(live, pos + acc + 1, pos))

    return step


class BlockAllocator:
    """Host bookkeeping of the block pool with prefix sharing (the JAX
    loop's ``take_blocks``, ``release``, ``map_shared`` and
    ``chain_hashes``, ``nnstreamer_tpu/filters/llm.py:1600-1790``).

    ``free`` is the free list of block ids, taken from its head and
    released to its tail; ``ref`` [n_blocks] the reference counts (0: on
    the free list, 1: one owner, more: a prefix mapped into several
    streams' tables); ``prefix_index`` maps the chain hash of a full
    prompt block to the block that holds its K/V, ``block_hash`` the
    other way.  A cached block whose count drops to 0 rests in the free
    list with its content and index entry: the cache never costs
    admission capacity, and eviction is allocation."""

    def __init__(self, n_blocks: int, block_size: int):
        self.block_size = block_size
        self.free: List[int] = list(range(n_blocks))
        self.ref = np.zeros((n_blocks,), np.int64)
        self.prefix_index: Dict[bytes, int] = {}
        self.block_hash: Dict[int, bytes] = {}

    def take(self, need: int) -> List[int]:
        """``need`` private blocks (count 1) off the free list, blocks
        that hold no cached prefix first; then the oldest-released cached
        ones, whose index entries go (``llm.serve.prefix_evictions``).
        Cached blocks passed over keep their place at the head."""
        free = self.free
        got: List[int] = []
        cached: List[int] = []
        while free and len(got) < need:
            b = free.pop(0)
            (cached if b in self.block_hash else got).append(b)
        while cached and len(got) < need:
            b = cached.pop(0)
            del self.prefix_index[self.block_hash.pop(b)]
            metrics.count("llm.serve.prefix_evictions")
            got.append(b)
        free[0:0] = cached
        if len(got) < need:
            # admission checks capacity first: a shortfall is an allocator
            # bug, never a truncated table
            free[0:0] = got
            raise RuntimeError(f"KV allocator invariant violated: asked for "
                               f"{need} blocks, only {len(got)} allocatable")
        self.ref[got] = 1
        return got

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block goes back to the free
        list only at count 0 (a shared one stays for its other holders;
        a cached one keeps its content and index entry)."""
        for b in blocks:
            self.ref[b] -= 1
            if self.ref[b] <= 0:
                self.ref[b] = 0
                self.free.append(b)

    def map_shared(self, b: int) -> None:
        """One more reference on a cached block, taken off the free list
        if it rested there."""
        if self.ref[b] == 0:
            self.free.remove(b)
        self.ref[b] += 1

    def chain_hashes(self, row: np.ndarray, full: int) -> List[bytes]:
        """The chain hashes of the first ``full`` blocks of ``row``: hash j
        commits to every token of blocks 0..j, so two prompts share block
        j only when their whole prefixes match, which is when its K/V
        (position-dependent through RoPE) is valid for both."""
        bs = self.block_size
        h = b"nns-prefix-v1"
        out = []
        for j in range(full):
            h = hashlib.sha1(h + row[j * bs:(j + 1) * bs].tobytes()).digest()
            out.append(h)
        return out

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """The indexed blocks of the longest indexed prefix of ``hashes``."""
        got = []
        for h in hashes:
            b = self.prefix_index.get(h)
            if b is None:
                break
            got.append(b)
        return got

    def register(self, hashes: Sequence[bytes], blocks: Sequence[int]) -> None:
        """Index a prefilled prompt's full blocks; hashes already indexed
        (its shared and forked blocks) keep their block."""
        for h, b in zip(hashes, blocks):
            if h not in self.prefix_index:
                self.prefix_index[h] = b
                self.block_hash[b] = h


class _ContinuousLoop:
    """Standing decode loop for ``custom=serve:continuous`` over a
    block-paged KV pool (port of the JAX package's ``_ContinuousLoop``).

    **The pool.**  One thread owns the pool ``[L, n_blocks + 1, bs, Hkv,
    hd]`` (:func:`~..models.llama.init_paged_cache`; the extra block takes
    dropped writes), the allocator's host state (:class:`BlockAllocator`:
    free list, reference counts, prefix index) and a per-slot block
    table ``[slots, max_blocks]`` whose entries map a stream's logical
    block j to a pool block (``n_blocks`` = sentinel).  A decode step
    reads only each stream's live blocks (the paged kernel).

    **Admission = reservation.**  A prompt of T tokens is admitted, in
    FIFO order, when a slot and the blocks of ``ceil((T + n) /
    block_size)`` positions that it does not share exist (n = tokens to
    generate): a live stream never stalls on an empty free list.  A
    prompt of ``max_seq`` tokens or more is rejected (``prompt-oversize``),
    so is one whose reservation exceeds the whole pool
    (``reservation-impossible``), and one that waited at the head of the
    queue past ``admit_timeout`` (``admit-timeout``): each with a
    ``stream_aborted`` terminator carrying ``abort_reason``.  A tenant
    (the ``_tenant`` meta key) capped by :meth:`set_tenant_quota` is
    skipped while its streams' logical blocks plus the prompt's would pass
    the cap (a shared prefix is no discount), so it never holds up the
    tenants queued behind it (``llm.serve.quota_deferred``).

    **Prefix sharing** (``prefix_cache``, on by default).  After its
    prefill, a prompt's full blocks are indexed by their token chain
    hashes.  A new prompt looks the index up before the capacity check:
    the matched blocks up to ``p0``, the largest ``prefill_chunk``
    multiple within the match and before the last real token, map into
    its table with one more reference each instead of a reservation, and
    only ``[p0, P)`` is prefilled, on the cold path's chunk grid.  A
    matched block that straddles ``p0`` is copied into a fresh block
    first (the copy-on-write fork, target and draft pools, rows copied in
    place: the pools keep their addresses).  Blocks free at count 0;
    cached ones rest in the free list and are evicted by allocation.

    **Chunked prefill.**  An admitted prompt pads to a multiple of
    ``prefill_chunk`` and prefills chunk by chunk into its blocks, at most
    ``prefill_budget`` tokens per iteration while other streams decode.
    With ``nan_guard:1`` the final chunk's logits are read once on the
    host: a prompt whose logits are not all finite is quarantined through
    the pipeline's armor and answered ``abort_reason=poison``.

    **Decode.**  Each iteration replays ``stream_chunk`` times the one
    decode step its warm-up captured (:func:`paged_decode_step`, one
    signature in the filter's census), every slot at its own position
    (idle slots parked at ``max_blocks * block_size``: they write only
    the sink block and attend nothing), with ONE card-to-host copy of the
    chunk's tokens.  The step reads the token, positions, tables and live
    mask in place; the host copies its own positions, tables and live
    mask into them once per chunk, and a stream's join, leave or
    completion changes only those values, never the step.

    **Speculative decoding** (``draft:<preset>``).  The draft has a pool
    of its own with the same blocks and tables; its prefill twin runs
    eagerly on each prefill chunk.  Each iteration runs one round in
    place of the decode chunk: the captured propose step
    (:func:`spec_propose_step`) and the captured verify step
    (:func:`spec_verify_step`, one ``[slots, spec_k + 1]`` target step
    that accepts and commits), two census signatures.  Tokens, their
    predecessors and positions advance on the card; the host reads the
    accept counts and emitted rows once a round, stamps ``spec_draft``
    (1: an accepted proposal, 0: the target's token) on each buffer, and
    copies its positions over the card's only when a stream joins or
    leaves.

    **Sampling.**  Greedy at temperature 0.  Otherwise each slot keeps one
    ``torch.Generator``, re-seeded from (seed, admission number) when a
    stream is admitted to it, drawn once for the first token and once per
    decode step (an idle slot's draws are thrown away); a speculative
    round draws k proposals, k accept uniforms and one Gumbel row, in that
    order.  A stream's tokens are a function of the seed, its admission
    number and its positions, whichever streams share the batch.

    **Timeline and spans.**  Each slot keeps host ``time.monotonic()``
    stamps (enqueue, admission, first token, last token): the first
    emitted token observes ``llm.serve.ttft_ms`` (enqueue to first
    token), each later one ``llm.serve.itl_ms``, and retirement
    ``llm.serve.queue_ms``, ``prefill_ms`` and ``decode_ms``, all
    tenant-labelled.  With the pipeline's ``trace_mode`` on, the loop
    records ``serve.admit``, ``serve.prefix_hit``, ``serve.prefill_chunk``,
    ``serve.decode`` (closed when the chunk's tokens reach the host),
    ``serve.spec_verify``, ``serve.cow_fork`` and ``serve.reap`` spans.
    Neither reads the card.

    **Drain and adopt.**  :meth:`drain_stream` and :meth:`adopt_stream`
    are control commands that the serve thread runs at the top of an
    iteration, where every slot's host state is consistent and the last
    chunk's tokens are on the host.  A drain copies a live stream's used
    blocks (shared ones included: a snapshot never aliases the pool) to
    the host through pinned memory and retires the slot; a queued stream
    leaves the queue; a stream in prefill is taken once it is live.  An
    adopt copies the blocks into freshly reserved pool blocks in place
    (the captured steps keep their addresses; a draft pool's rows stay
    unwritten), restores the slot's position, token and generator state,
    and goes on.  Neither touches a captured step.  The host mirrors the
    slot's last two tokens (``tok``, ``tok_prev``) from the tokens it
    reads each chunk.  An adopted stream has no local enqueue stamp: the
    timeline skips it.  Spans: ``elastic.drain``, ``elastic.adopt``.

    **Swap.**  :meth:`swap_params` is a third control command: the new
    weights are copied into the tensors every step reads, the prefix index
    (K/V of the old weights) is dropped, and ``param_version`` goes up
    (``llm.serve.param_swaps``, the ``llm.serve.param_version`` gauge, a
    ``learn.swap`` span).  No step is recaptured.

    **Cancel.**  Every stream registers its id with
    :mod:`~..utils.elastic` at submit and unregisters when it completes
    or is aborted.  A cancel (:meth:`_mark_cancel`, e.g. the query
    serversink on a dead connection) marks it with a deadline
    ``stream_idle_timeout`` ahead; the first chunk boundary past it reaps
    the stream, queued, mid-prefill or live: its blocks are released, its
    slot parks, and a typed terminator goes downstream.  Like a
    completion, a reap changes only the host's tables, positions and
    live mask, which reach the captured steps by copies.
    """

    def __init__(self, fw: LLMFramework):
        self.fw = fw
        plan = serving_plan(fw.cfg, slots=fw.slots, block_size=fw.block_size,
                            kv_blocks=fw.kv_blocks,
                            prefill_chunk=fw.prefill_chunk, dtype=fw.dtype,
                            draft_cfg=fw.draft_cfg, spec_k=fw.spec_k,
                            temperature=fw.temperature)
        self.max_blocks = plan["max_blocks"]
        self.n_blocks = plan["n_blocks"]
        #: xray's ledger: the pools' bytes once allocated, the sampler keys
        self._pool_nbytes = 0
        self._prng_nbytes = plan["prng_state_bytes"]
        self._kv_per_pos = plan["decode_bytes_per_ctx_token"]
        self.sentinel = self.n_blocks  # unallocated table entry
        self.park = self.max_blocks * fw.block_size  # idle-slot position
        self._pending: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        # Guards the idle decision: without it, submit() could clear _idle
        # and THEN enqueue while the loop, between those two steps, sees an
        # empty queue and sets _idle — drain() would return with a request
        # pending and EOS would cut it off.
        self._idle_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        #: admission-order queue (entries ``(prompt, meta, emit, t_enq)``)
        #: and prefill-in-progress states: both crash-visible
        self._waiting: list = []
        self._admitting: list = []
        #: under tensor parallelism across processes: prompts this rank
        #: has that not every rank has yet (admitted in agreement only)
        self._arrived: list = []
        self._live_slots: list = [None] * fw.slots  # (meta, emit) per slot
        #: stream id -> (reason, reap deadline), set by _mark_cancel from
        #: any thread, consumed by the serve thread at chunk boundaries
        self._cancelled: Dict[int, tuple] = {}
        #: registered stream ids not yet unregistered (shutdown clears
        #: what completion and abort did not)
        self._owned_sids: set = set()
        #: per-tenant cap on the logical KV blocks of its streams (absent:
        #: uncapped), moved at run time by :meth:`set_tenant_quota`
        self._tenant_quota: Dict[str, int] = {}
        #: per-slot tenant and serving timeline (monotonic seconds:
        #: enqueue, admit, first and last token), set at admission and
        #: cleared at retirement
        self._slot_tenant: list = [None] * fw.slots
        self._slot_time: list = [None] * fw.slots
        #: stream id and prompt [1, T] per live or admitting slot
        self._slot_sid: list = [None] * fw.slots
        self._slot_prompt: list = [None] * fw.slots
        #: control commands (drain, adopt) for the serve thread, run at the
        #: top of its next iteration
        self._ctl: collections.deque = collections.deque()
        #: set once the warm-up (one prefill chunk, one decode step) ran
        self.warmed = threading.Event()
        #: weight swaps that landed (``llm.serve.param_version``)
        self.param_version = 0
        #: decode steps, speculative rounds and prefill chunks dispatched
        #: since the warm-up, and the host seconds spent issuing the decode
        #: steps or rounds (a replay waits there while the card's launch
        #: queue is full)
        self.stats = {"decode_steps": 0, "spec_rounds": 0,
                      "prefill_chunks": 0, "decode_host_s": 0.0}
        self._thread = threading.Thread(
            target=self._run, name="llm-serve", daemon=True)
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def submit(self, prompt: np.ndarray, meta: Dict, emit) -> int:
        # The id is minted HERE, server-side: a client-supplied value is
        # overwritten, so no client can cancel another's stream.
        meta = dict(meta)
        sid = elastic.next_stream_id()
        meta[META_STREAM_ID] = sid
        # The error check lives inside the lock: the crash terminator
        # drains _pending under it, so no request slips into a dead loop.
        with self._idle_lock:
            self.check()
            self._idle.clear()
            self._owned_sids.add(sid)
            elastic.register_stream(
                sid, functools.partial(self._mark_cancel, sid))
            self._pending.put((prompt, meta, emit, time.monotonic()))
        self._wake.set()
        return sid

    def _mark_cancel(self, sid: int, reason: str = "cancelled",
                     force: bool = False) -> None:
        """The :mod:`~..utils.elastic` backchannel: mark one stream dead.
        Reaped at the first chunk boundary past the
        ``stream_idle_timeout`` grace (``force=True`` skips the grace).
        Idempotent: an earlier deadline is never extended."""
        grace = 0.0 if force else self.fw.stream_idle_timeout
        deadline = time.monotonic() + grace
        prev = self._cancelled.get(sid)
        if prev is None or deadline < prev[1]:
            self._cancelled[sid] = (reason, deadline)
            metrics.count("llm.serve.cancelled")
        self._wake.set()

    def set_tenant_quota(self, tenant: str, max_blocks: Optional[int]) -> None:
        """Cap (or uncap, with None) a tenant's total reserved KV blocks.
        A host value: admission enforces it from its next pass (the
        autoscaler's ``kv_quota`` action)."""
        if max_blocks is None:
            self._tenant_quota.pop(tenant, None)
        else:
            self._tenant_quota[tenant] = max(0, int(max_blocks))
        self._wake.set()

    def pool_stats(self) -> Dict[str, int]:
        """The allocator's accounting: total and free blocks, live streams,
        blocks indexed by the prefix cache (many resting in the free list)
        and blocks mapped by more than one stream.  Host values the serve
        thread mutates: consistent at quiet points (after a drain)."""
        free = getattr(self, "_free", None)
        ref = getattr(self, "_ref", None)
        return {
            "blocks_total": self.n_blocks,
            "blocks_free": self.n_blocks if free is None else len(free),
            "live_streams": sum(1 for s in self._live_slots if s is not None),
            "blocks_cached": len(getattr(self, "_block_hash", {})),
            "blocks_shared": 0 if ref is None else int((ref > 1).sum()),
        }

    def stream_table(self) -> Dict[int, Dict]:
        """``stream_id -> {"state", "tenant", "slot", "blocks"}`` for every
        stream this loop holds: queued, admitting (in prefill) or live."""
        out: Dict[int, Dict] = {}
        for ent in list(self._waiting):
            sid = ent[1].get(META_STREAM_ID)
            if sid is not None:
                out[sid] = {"state": "queued", "slot": None, "blocks": 0,
                            "tenant": ent[1].get(META_TENANT)}
        blocks = getattr(self, "_slot_blocks", None) or [[]] * self.fw.slots
        for st in list(self._admitting):
            sid = st["meta"].get(META_STREAM_ID)
            if sid is not None:
                out[sid] = {"state": "admitting", "slot": st["slot"],
                            "blocks": len(blocks[st["slot"]]),
                            "tenant": st["meta"].get(META_TENANT)}
        for s, slot in enumerate(list(self._live_slots)):
            sid = self._slot_sid[s]
            if slot is None or sid is None:
                continue
            out[sid] = {"state": "live", "slot": s, "blocks": len(blocks[s]),
                        "tenant": slot[0].get(META_TENANT)}
        return out

    def _ctl_call(self, cmd: Dict, timeout: float):
        """Queue one control command and wait until the serve thread has
        run it at a chunk boundary; returns its result or raises its
        error."""
        tp = self.fw.tp
        if tp is not None and tp.group is not None:
            # a command runs at one rank's chunk boundary: the ranks'
            # steps would part
            raise FrameworkError(
                f"serve-loop {cmd['kind']}: refused under tensor parallelism "
                "across processes")
        cmd["ev"] = threading.Event()
        cmd["deadline"] = time.monotonic() + timeout
        with self._idle_lock:
            self.check()
            self._idle.clear()
            self._ctl.append(cmd)
        self._wake.set()
        if not cmd["ev"].wait(timeout + 1.0):
            raise FrameworkError(
                f"serve-loop {cmd['kind']} command timed out after {timeout}s")
        if cmd.get("error"):
            raise FrameworkError(cmd["error"])
        return cmd.get("result")

    def drain_stream(self, sid: int, timeout: float = 30.0) -> Dict:
        return self._ctl_call({"kind": "drain", "sid": int(sid)}, timeout)

    def adopt_stream(self, snapshot: Dict, emit, timeout: float = 30.0) -> int:
        return self._ctl_call(
            {"kind": "adopt", "snapshot": snapshot, "emit": emit}, timeout)

    def swap_params(self, tree, timeout: float = 30.0) -> int:
        """Queue a param hot-swap, run at the next chunk boundary; returns
        the loop's new param version."""
        return self._ctl_call({"kind": "swap", "tree": tree}, timeout)

    @staticmethod
    def _span(rec, kind: str, t0_ns: int, **args) -> None:
        if rec is not None and rec.active:
            now = time.monotonic_ns()
            rec.record(kind, "llm.serve", None, t0_ns, now - t0_ns, **args)

    def _release_sid(self, sid) -> None:
        """A stream left the loop (completed, aborted or reaped)."""
        if sid is None:
            return
        elastic.unregister_stream(sid)
        self._owned_sids.discard(sid)
        self._cancelled.pop(sid, None)

    def check(self) -> None:
        if self._error is not None:
            raise FrameworkError(
                f"continuous serve loop died: {self._error!r}")

    def drain(self, timeout: float) -> bool:
        return self._idle.wait(timeout)

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30)
        # the process-wide registry must not keep pointing at a dead loop
        for sid in list(self._owned_sids):
            elastic.unregister_stream(sid)
        self._owned_sids.clear()

    # -- serve thread ------------------------------------------------------
    def _emit_token(self, emit, meta: Dict, token_id: int, index: int,
                    last: bool, extra: Optional[Dict] = None) -> None:
        out_meta = dict(meta, **(extra or {}))
        out_meta[META_STREAM_INDEX] = index
        out_meta[META_EMIT_T] = time.monotonic()
        if last:
            out_meta[META_STREAM_LAST] = True
        piece = self.fw.tokenizer.decode_piece(token_id)
        emit([np.asarray([token_id], np.int32),
              np.frombuffer(piece, np.uint8).copy()], out_meta)
        metrics.count("llm.tokens")

    def _abort(self, meta: Dict, emit, reason: Optional[str] = None,
               idx: int = 0) -> None:
        """Typed terminator: one ``stream_aborted`` token buffer, with the
        policy that fired as ``abort_reason``."""
        self._release_sid(meta.get(META_STREAM_ID))
        meta = {**meta, META_STREAM_ABORTED: True}
        if reason is not None:
            meta[META_ABORT_REASON] = reason
        try:
            self._emit_token(emit, meta, 0, idx, True)
        except Exception:  # noqa: BLE001 - downstream may be gone too
            log.exception("abort terminator could not be emitted")

    def _run(self) -> None:
        try:
            fw = self.fw
            if fw.device.type == "cuda":
                # device, stream and inference mode are per thread
                torch.cuda.set_device(fw.device)
            with torch.inference_mode():
                self._serve()
        except BaseException as e:  # noqa: BLE001 - daemon thread: report
            log.exception("continuous serve loop died")
            # Terminate every live, mid-prefill, waiting and queued stream
            # so no client waits out its timeout on a dead loop.  The queue
            # drain and the idle flag go under _idle_lock, pairing with
            # submit().
            for slot in list(self._live_slots):
                if slot is not None:
                    self._abort(slot[0], slot[1], idx=1 << 30)
            for st in list(self._admitting):
                self._abort(st["meta"], st["emit"])
            for ent in list(self._waiting) + list(self._arrived):
                self._abort(ent[1], ent[2])
            with self._idle_lock:
                self._error = e
                while self._ctl:
                    cmd = self._ctl.popleft()
                    cmd["error"] = f"continuous serve loop died: {e!r}"
                    cmd["ev"].set()
                while True:
                    try:
                        ent = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    self._abort(ent[1], ent[2])
                self._idle.set()
            self.warmed.set()

    def _seed(self, admission: int) -> int:
        seed = np.random.SeedSequence([self.fw.seed, admission])
        return int(seed.generate_state(1, np.uint64)[0] >> 1)

    def _serve(self) -> None:
        fw, cfg, dev = self.fw, self.fw.cfg, self.fw.device
        B, bs, C = fw.slots, fw.block_size, fw.prefill_chunk
        params = fw.bundle.params
        spec = fw.draft_bundle is not None
        sampled = fw.temperature > 0
        pool = llama.init_paged_cache(cfg, self.n_blocks, bs, dtype=fw.dtype,
                                      device=dev, tp=fw.tp)
        dparams = dpool = None
        if spec:
            # one allocator and one table set steer both pools: block j
            # holds both models' K/V of the same positions
            dparams = fw.draft_bundle.params
            dpool = llama.init_paged_cache(fw.draft_cfg, self.n_blocks, bs,
                                           dtype=fw.dtype, device=dev,
                                           tp=dparams if fw.tp is not None else None)
        # The captured steps' static inputs on the card, which their graphs
        # read and write in place; the host's values go into them by
        # copies (from fresh pinned buffers: an earlier copy may still be
        # reading the last one) on this thread's stream, which a replay
        # follows.
        tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        pos_dev = torch.full((B,), self.park, dtype=torch.long, device=dev)
        tables_dev = torch.full((B, self.max_blocks), self.sentinel,
                                dtype=torch.int32, device=dev)
        gens = [torch.Generator(device=dev) for _ in range(B)]
        # Host bookkeeping: positions advance by the chunk (or the round's
        # accepted tokens) for live rows, parked rows stay parked, and
        # tables change only at admit and retire, so both live as numpy
        # and go up when they changed.
        pos = np.full((B,), self.park, np.int64)
        tables = np.full((B, self.max_blocks), self.sentinel, np.int32)
        alloc = BlockAllocator(self.n_blocks, bs)
        slot_blocks: list = [[] for _ in range(B)]
        slot_sid = self._slot_sid  # stream id holding each slot
        remaining = np.zeros((B,), np.int64)
        sidx = np.zeros((B,), np.int64)
        # host mirrors of each slot's last token and the one before it,
        # from the tokens the host reads each chunk (a snapshot carries
        # both; the card's copies are never read back for it)
        tok_h = np.zeros((B,), np.int64)
        tok_prev_h = np.zeros((B,), np.int64)
        slots = self._live_slots
        # published for tests and post-mortems (mutated in place)
        self._pos, self._tables = pos, tables
        self._free, self._slot_blocks = alloc.free, slot_blocks
        self._ref, self._prefix_index = alloc.ref, alloc.prefix_index
        self._block_hash = alloc.block_hash
        self._pool, self._draft_pool = pool, dpool
        self._pool_nbytes = sum(
            t.numel() * t.element_size() for p_ in (pool, dpool) if p_
            for part in _pool_parts(p_) for t in part.values())
        #: the pool's placement under tensor parallelism (cut by kv head)
        self._pool_sharding = None
        if fw.mesh is not None:
            from ..parallel.sharding import NamedSharding

            self._pool_sharding = NamedSharding(
                fw.mesh, llama.paged_cache_pspecs()["k"])
        self._tok_h, self._tok_prev_h = tok_h, tok_prev_h
        eos = self.fw.tokenizer.eos if fw.stop_eos else -1
        admissions = 0
        dirty = False      # host tables changed since the last upload
        pos_dirty = False  # host positions changed outside a round
        #: stream id -> chain hashes of its prompt, for prompts still
        #: waiting (a deferred head is looked up again every iteration)
        chain_cache: Dict[int, list] = {}

        def cow_fork(src: int) -> int:
            """Copy-on-write fork: a private copy of shared block ``src``,
            target and draft rows, copied in place on this thread's
            stream before the prefill chunk that writes into it."""
            t0 = time.monotonic_ns()
            new = alloc.take(1)[0]
            for p in (pool, dpool):
                if p is not None:
                    for part in _pool_parts(p):
                        for key in ("k", "v"):
                            part[key][:, new].copy_(part[key][:, src])
            metrics.count("llm.serve.cow_forks")
            self._span(rec, "serve.cow_fork", t0, src=int(src), dst=int(new))
            return new

        def retire(s: int) -> None:
            nonlocal dirty, pos_dirty
            self._release_sid(slot_sid[s])
            slot_sid[s] = None
            alloc.release(slot_blocks[s])
            slot_blocks[s] = []
            tables[s, :] = self.sentinel
            dirty = True
            pos[s] = self.park
            pos_dirty = True
            slots[s] = None
            remaining[s] = 0
            sidx[s] = 0
            tt = self._slot_time[s]
            if tt is not None and tt["first"] is not None:
                # the stream's phases: queued, admission to first token
                # (prefill and the first dispatch), decoding
                ten = self._slot_tenant[s]
                metrics.observe_latency("llm.serve.queue_ms",
                                        (tt["admit"] - tt["enq"]) * 1e3, tenant=ten)
                metrics.observe_latency("llm.serve.prefill_ms",
                                        (tt["first"] - tt["admit"]) * 1e3, tenant=ten)
                metrics.observe_latency("llm.serve.decode_ms",
                                        (tt["last"] - tt["first"]) * 1e3, tenant=ten)
            self._slot_time[s] = None
            self._slot_tenant[s] = None
            self._slot_prompt[s] = None

        def mark_emit(s: int) -> None:
            """One emitted token's host stamp: the first observes TTFT
            (enqueue to first token, what the client sees), later ones the
            gap since the previous token.  A chunk's tokens reach the host
            together, so gaps inside a chunk are ~0 and its boundary
            carries the wait: the timeline a streaming client sees.  An
            adopted stream has no local enqueue stamp and is skipped."""
            tt = self._slot_time[s]
            if tt is None:
                return
            now = time.monotonic()
            if tt["first"] is None:
                tt["first"] = tt["last"] = now
                metrics.observe_latency("llm.serve.ttft_ms", (now - tt["enq"]) * 1e3,
                                        tenant=self._slot_tenant[s])
            else:
                metrics.observe_latency("llm.serve.itl_ms", (now - tt["last"]) * 1e3,
                                        tenant=self._slot_tenant[s])
                tt["last"] = now

        def tenant_blocks(tenant) -> int:
            return sum(len(slot_blocks[s]) for s in range(B)
                       if self._slot_tenant[s] == tenant)

        def snapshot_base(sid: int, kind: str, meta: Dict) -> Dict:
            return {"version": 2, "kind": kind, META_STREAM_ID: sid,
                    "cfg": dataclasses.asdict(cfg), "dtype": fw.dtype,
                    "block_size": bs, "greedy": not sampled,
                    "meta": {k: v for k, v in meta.items()
                             if k not in _SNAPSHOT_META_DROP}}

        def blocks_to_host(ids: List[int]):
            """The K and V rows of pool blocks ``ids`` as host copies (on the
            card: gathered there, then copied into pinned memory on this
            thread's stream, waited for here)."""
            idx = upload(np.asarray(ids, np.int64), dev)
            # a tensor-parallel pool's shards joined on the kv-head axis
            got = [torch.cat([part[key].index_select(1, idx.to(part[key].device))
                              .to(dev) for part in _pool_parts(pool)], dim=3)
                   for key in ("k", "v")]
            if dev.type == "cuda":
                got, done = start_fetch(got)
                done.synchronize()
            return got

        group = fw.tp.group if fw.tp is not None else None

        def take_pending() -> None:
            """The thread hand-off queue into the admission-order list.
            Under tensor parallelism across processes every rank serves
            the same prompts in the same order, and its steps are
            collectives: a prompt joins the list only once every rank
            has it (the ranks agree on the count, one small all-gather
            per iteration with work), so every rank admits, prefills and
            decodes alike.  An idle rank (nothing arrived, queued or
            live) calls no collective: the others wait in theirs until
            its prompt comes, within the group's timeout."""
            got = self._waiting if group is None else self._arrived
            while True:
                try:
                    got.append(self._pending.get_nowait())
                except queue.Empty:
                    break
            if group is None or not (self._arrived or self._waiting
                                     or self._admitting or (remaining > 0).any()):
                return
            from ..parallel.distributed import agree_min

            n = agree_min(len(self._arrived), group)
            self._waiting.extend(self._arrived[:n])
            del self._arrived[:n]

        def drain_cmd(cmd: Dict, rec, deferred: list) -> bool:
            """A drain at this chunk boundary; False when it did not run
            (deferred or refused)."""
            sid = cmd["sid"]
            t0 = time.monotonic_ns()
            take_pending()  # a stream submitted just before its drain
            s = next((i for i in range(B)
                      if slot_sid[i] == sid and slots[i] is not None), None)
            wi = next((i for i, ent in enumerate(self._waiting)
                       if ent[1].get(META_STREAM_ID) == sid), None)
            if s is not None:
                used = slot_blocks[s][:math.ceil(int(pos[s]) / bs)]
                blocks_k, blocks_v = blocks_to_host(used)
                snap = snapshot_base(sid, "live", slots[s][0])
                snap.update(
                    pos=int(pos[s]), remaining=int(remaining[s]),
                    sidx=int(sidx[s]), tok=int(tok_h[s]),
                    tok_prev=int(tok_prev_h[s]),
                    shared_blocks=sum(1 for b in used if alloc.ref[b] > 1),
                    prompt=self._slot_prompt[s].copy(),
                    blocks_k=blocks_k, blocks_v=blocks_v)
                if sampled:
                    # the slot's generator between replays: a CPU one's
                    # MT19937 state or a CUDA one's seed and Philox offset
                    snap["gen_state"] = gens[s].get_state()
                    snap["generator"] = dev.type
                nb = len(slot_blocks[s])
                retire(s)
                self._span(rec, "elastic.drain", t0, stream_id=sid,
                           state="live", blocks=nb)
            elif wi is not None:
                ent = self._waiting.pop(wi)
                snap = snapshot_base(sid, "queued", ent[1])
                snap["prompt"] = np.asarray(ent[0])
                self._release_sid(sid)
                self._span(rec, "elastic.drain", t0, stream_id=sid,
                           state="queued", blocks=0)
            elif any(st["meta"].get(META_STREAM_ID) == sid
                     for st in self._admitting):
                deferred.append(cmd)  # in prefill: live within a few chunks
                return False
            else:
                cmd["error"] = f"unknown or already-finished stream {sid}"
                cmd["ev"].set()
                return False
            cmd["result"] = snap
            cmd["ev"].set()
            return True

        def adopt_cmd(cmd: Dict, rec) -> bool:
            """An adopt at this chunk boundary; False when refused."""
            nonlocal dirty, pos_dirty, admissions
            snap = cmd["snapshot"]
            t0 = time.monotonic_ns()
            sid = int(snap.get(META_STREAM_ID) or 0)
            if sid <= 0 or sid in elastic.live_stream_ids():
                # a snapshot from another process may hold a live local id:
                # the snapshot's id is a continuity hint only
                sid = elastic.next_stream_id()
            meta = dict(snap.get("meta") or {})
            meta[META_STREAM_ID] = sid
            prompt = np.asarray(snap["prompt"] if snap.get("prompt") is not None
                                else np.zeros((1, 0)), np.int32).reshape(1, -1)
            if snap.get("kind") == "queued":
                self._owned_sids.add(sid)
                elastic.register_stream(
                    sid, functools.partial(self._mark_cancel, sid))
                self._waiting.append((prompt, meta, cmd["emit"], time.monotonic()))
                self._span(rec, "elastic.adopt", t0, stream_id=sid,
                           state="queued", blocks=0)
                cmd["result"] = sid
                cmd["ev"].set()
                return True
            p_next, rem = int(snap["pos"]), int(snap["remaining"])
            need_tok = p_next + rem
            need = math.ceil(need_tok / bs)
            n_used = math.ceil(p_next / bs)
            src = [host_tensor(snap[f"blocks_{key}"]) for key in ("k", "v")]
            want = (cfg.n_layers, n_used, bs, cfg.n_kv_heads, cfg.head_dim)
            state = snap.get("gen_state") if sampled else None
            if state is not None:
                state = host_tensor(state).clone()
            busy = {st["slot"] for st in self._admitting}
            freeslots = [i for i in range(B) if slots[i] is None
                         and remaining[i] == 0 and i not in busy]
            pool_dt = _pool_parts(pool)[0]["k"].dtype
            if any(tuple(t.shape) != want or t.dtype != pool_dt for t in src):
                cmd["error"] = (
                    f"snapshot blocks {[tuple(t.shape) for t in src]} "
                    f"{src[0].dtype}, the pool takes {want} {pool_dt}")
            elif not freeslots:
                cmd["error"] = "no free slot to adopt into"
            elif need > self.max_blocks:
                cmd["error"] = (f"stream needs {need} blocks > table span "
                                f"{self.max_blocks}")
            elif len(alloc.free) * bs < need_tok:
                cmd["error"] = (f"insufficient free KV blocks "
                                f"({len(alloc.free)} free, {need} needed)")
            elif state is not None and (state.dtype != torch.uint8 or state.numel()
                                        != gens[0].get_state().numel()):
                cmd["error"] = (f"the snapshot's generator state ({state.numel()} "
                                f"bytes) is not a {dev.type} generator's")
            if cmd.get("error"):
                cmd["ev"].set()
                return False
            s = freeslots[0]
            blocks = alloc.take(need)
            slot_blocks[s] = blocks
            tables[s, :len(blocks)] = blocks
            dirty = True
            if n_used:
                # into the pool in place: the captured steps (and the
                # kernels' TMA maps) hold its address
                idx = upload(np.asarray(blocks[:n_used], np.int64), dev)
                parts = _pool_parts(pool)
                for key, t in zip(("k", "v"), src):
                    pinned = dev.type == "cuda" and t.is_pinned()
                    # a tensor-parallel pool takes its kv heads' share
                    for part, piece in zip(parts, t.chunk(len(parts), dim=3)):
                        pd = part[key].device
                        part[key].index_copy_(1, idx.to(pd), piece.to(
                            pd, non_blocking=pinned and len(parts) == 1))
            tok_h[s] = int(snap["tok"])
            tok_prev_h[s] = int(snap.get("tok_prev", 0))
            tok[s] = int(tok_h[s])
            if spec:
                # the refresh step re-feeds tok_prev at pos - 1; the draft
                # pool's rows stay unwritten (proposals degrade until the
                # positions are rewritten, the target decides the tokens)
                tok_prev[s] = int(tok_prev_h[s])
            if sampled:
                if state is not None:
                    gens[s].set_state(state)
                else:  # a snapshot from before sampling: a fresh seed
                    gens[s].manual_seed(self._seed(admissions))
                    admissions += 1
            pos[s] = p_next
            pos_dirty = True
            remaining[s] = rem
            sidx[s] = int(snap["sidx"])
            slots[s] = (meta, cmd["emit"])
            slot_sid[s] = sid
            self._slot_tenant[s] = meta.get(META_TENANT)
            self._slot_time[s] = None  # no local enqueue stamp
            self._slot_prompt[s] = prompt
            self._owned_sids.add(sid)
            elastic.register_stream(sid, functools.partial(self._mark_cancel, sid))
            self._span(rec, "elastic.adopt", t0, stream_id=sid, state="live",
                       slot=s, blocks=len(blocks))
            cmd["result"] = sid
            cmd["ev"].set()
            return True

        def swap_cmd(cmd: Dict, rec) -> bool:
            """Copy the new weights into the tensors every step reads (the
            same addresses: nothing is recaptured).  The prefix index goes:
            its blocks hold K/V of the old weights (blocks live streams
            hold stay theirs).  A tree that does not match changes
            nothing."""
            t0 = time.monotonic_ns()
            try:
                place_swapped_params(params, cmd["tree"])
            except Exception as e:  # noqa: BLE001 - the caller's error
                cmd["error"] = str(e)
            else:
                alloc.prefix_index.clear()
                alloc.block_hash.clear()
                self.param_version += 1
                metrics.count("llm.serve.param_swaps")
                metrics.gauge("llm.serve.param_version", float(self.param_version))
                self._span(rec, "learn.swap", t0, version=self.param_version)
                cmd["result"] = self.param_version
            cmd["ev"].set()
            return True

        def run_commands(rec) -> bool:
            """The control commands queued so far; True when one ran."""
            ran, deferred = False, []
            while self._ctl:
                cmd = self._ctl.popleft()
                if time.monotonic() > cmd["deadline"]:
                    cmd["error"] = (f"{cmd['kind']} timed out inside the "
                                    "serve loop")
                    cmd["ev"].set()
                elif cmd["kind"] == "drain":
                    ran |= drain_cmd(cmd, rec, deferred)
                elif cmd["kind"] == "adopt":
                    ran |= adopt_cmd(cmd, rec)
                elif cmd["kind"] == "swap":
                    ran |= swap_cmd(cmd, rec)
                else:
                    cmd["error"] = f"unknown command {cmd['kind']!r}"
                    cmd["ev"].set()
            self._ctl.extend(deferred)
            return ran

        # Warm-up before admitting real work: first-use costs (kernel
        # library loads, allocator growth, library handles) and the
        # captures land here and not on the first requests.  The prefill
        # chunk writes garbage through real blocks and releases them, the
        # captured steps (every slot parked) only the sink block; nothing
        # can attend either.
        warm = alloc.take(min(math.ceil(C / bs), self.n_blocks))
        tables[0, :len(warm)] = warm
        zeros = torch.zeros((1, C), dtype=torch.int32, device=dev)
        for prm, mcfg, p in ((params, cfg, pool), (dparams, fw.draft_cfg, dpool)):
            if prm is not None:
                llama.forward_paged(prm, zeros, p, upload(tables[:1], dev),
                                    np.zeros(1, np.int64), mcfg, fw.dtype,
                                    logit_off=C - 1)
        alloc.release(warm)
        tables[0, :] = self.sentinel
        generators = gens if sampled else ()
        if spec:
            K = fw.spec_k
            tok_prev = torch.zeros((B,), dtype=torch.int32, device=dev)
            props = torch.zeros((B, K), dtype=torch.int32, device=dev)
            dprobs = torch.zeros((B, K, cfg.vocab), dtype=torch.float32,
                                 device=dev) if sampled else None
            spec_out = torch.zeros((B, K + 2), dtype=torch.int32, device=dev)
            propose = fw.census.capture(
                ("propose", B, K, str(fw.dtype), sampled),
                spec_propose_step(dparams, fw.draft_cfg, fw.dtype, dpool, tok,
                                  tok_prev, pos_dev, tables_dev, props, dprobs,
                                  gens, self.park, fw.temperature, fw.top_k,
                                  fw.top_p), generators=generators)
            verify = fw.census.capture(
                ("verify", B, K, str(fw.dtype), sampled),
                spec_verify_step(params, cfg, fw.dtype, pool, tok, tok_prev,
                                 pos_dev, tables_dev, props, dprobs, spec_out,
                                 gens, self.park, fw.temperature, fw.top_k,
                                 fw.top_p), generators=generators)
        else:
            live_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
            decode = fw.census.capture(
                ("continuous", B, str(fw.dtype), sampled),
                paged_decode_step(params, cfg, fw.dtype, pool, tok, pos_dev,
                                  tables_dev, live_dev, gens, fw.temperature,
                                  fw.top_k, fw.top_p), generators=generators)
        tok.cpu()  # the warm-up has run on the card
        # the card-side tokens, for tests of the host mirrors
        self._tok, self._tok_prev = tok, (tok_prev if spec else None)
        self.warmed.set()

        while not self._stop.is_set():
            progressed = False
            rec = getattr(fw, "_trace_rec", None)
            # 0. the thread hand-off queue into the admission-order list
            take_pending()

            # 0a. control commands (drain, adopt): here every slot's host
            # state is consistent and the last chunk's tokens are out
            if self._ctl:
                progressed |= run_commands(rec)

            # 0b. reap cancelled streams past their grace: queued ones
            # leave the queue, mid-prefill and live ones give their slot
            # and blocks back; each gets a typed terminator
            if self._cancelled:
                now = time.monotonic()
                for sid, (reason, deadline) in list(self._cancelled.items()):
                    if now < deadline:
                        continue
                    ent = next((e for e in self._waiting
                                if e[1].get(META_STREAM_ID) == sid), None)
                    if ent is not None:
                        self._waiting.remove(ent)
                        self._abort(ent[1], ent[2], reason)
                        progressed = True
                        continue
                    st = next((st for st in self._admitting
                               if st["meta"].get(META_STREAM_ID) == sid),
                              None)
                    s = st["slot"] if st is not None else next(
                        (s for s in range(B) if slot_sid[s] == sid), None)
                    if s is None:
                        # a stale mark (the stream has left the loop);
                        # an owned id not found is still being handed off
                        if sid not in self._owned_sids:
                            self._cancelled.pop(sid, None)
                        continue
                    t0 = time.monotonic_ns()
                    nb = len(slot_blocks[s])
                    if st is not None:
                        # mid-prefill: nothing emitted yet; drop its state
                        # first so step 2 writes no more into its blocks
                        self._admitting.remove(st)
                        meta, emit, idx = st["meta"], st["emit"], 0
                    else:
                        (meta, emit), idx = slots[s], int(sidx[s])
                    metrics.count("llm.serve.reaped")
                    metrics.count("llm.serve.reaped_blocks", nb)
                    self._span(rec, "serve.reap", t0, slot=s, stream_id=sid,
                               blocks=nb, reason=reason)
                    retire(s)
                    self._abort(meta, emit, reason, idx=idx)
                    progressed = True

            # 1. admission: waiting prompts into free slots while a slot
            # and the stream's unshared block reservation are free.
            # FIFO, with two carve-outs: the head times out after
            # admit_timeout, and a tenant over its quota is skipped
            # (deferral scoped to the tenant).  The prefix lookup comes
            # before the capacity check: a hit needs blocks for its
            # unshared part only.
            waiting_sids = {e[1].get(META_STREAM_ID) for e in self._waiting}
            for k in [k for k in chain_cache if k not in waiting_sids]:
                del chain_cache[k]
            wi = 0
            while wi < len(self._waiting):
                prompt, meta, emit, t_enq = self._waiting[wi]
                sid = meta.get(META_STREAM_ID)
                T = prompt.shape[1]
                n = max(1, min(fw.max_new, cfg.max_seq - T))
                reason = None
                if T >= cfg.max_seq:
                    reason = "prompt-oversize"
                elif T + n > self.n_blocks * bs:
                    # no amount of retiring satisfies it: deferring would
                    # wedge the FIFO head
                    reason = "reservation-impossible"
                # (a clock read: off where the ranks must agree)
                overdue = (fw.admit_timeout > 0 and group is None
                           and time.monotonic() - t_enq > fw.admit_timeout)
                tenant = meta.get(META_TENANT)
                quota = self._tenant_quota.get(tenant) if tenant is not None else None
                # the quota charges LOGICAL blocks: every block a stream
                # maps, shared or not
                logical = math.ceil((T + n) / bs)
                if reason is None and quota is not None \
                        and tenant_blocks(tenant) + logical > quota:
                    if not overdue:
                        metrics.count("llm.serve.quota_deferred")
                        wi += 1
                        continue
                    reason = "admit-timeout"
                    metrics.count("llm.serve.admit_timeouts")
                hashes, matched = [], []
                if reason is None and fw.prefix_cache:
                    hashes = chain_cache.get(sid)
                    if hashes is None:
                        hashes = chain_cache[sid] = alloc.chain_hashes(
                            prompt[0], T // bs)
                    matched = alloc.match(hashes)
                # the suffix starts at p0, the largest chunk multiple not
                # past the matched extent or the last real token; a
                # matched block straddling p0 is forked
                s0 = len(matched) * bs
                p0 = min(s0 // C, (T - 1) // C) * C if s0 else 0
                shared = p0 // bs
                fork = 1 if p0 % bs else 0
                phys = logical - shared
                # matched blocks resting in the free list count as free
                # now, but mapping them takes them off it
                resting = sum(1 for b in matched[:shared] if alloc.ref[b] == 0)
                busy = {st["slot"] for st in self._admitting}
                freeslots = [s for s in range(B) if remaining[s] == 0
                             and slots[s] is None and s not in busy]
                if reason is None and (not freeslots
                                       or len(alloc.free) < phys + resting):
                    if not overdue:
                        break  # pool or slots full: defer, never overflow
                    reason = "admit-timeout"
                    metrics.count("llm.serve.admit_timeouts")
                t_admit = time.monotonic_ns()
                self._waiting.pop(wi)
                progressed = True
                if reason is not None:
                    self._abort(meta, emit, reason)
                    continue
                s = freeslots[0]
                slot_sid[s] = sid
                self._slot_prompt[s] = prompt[:, :T].copy()
                blocks = list(matched[:shared])
                for b in blocks:
                    alloc.map_shared(b)
                if fork:
                    blocks.append(cow_fork(matched[shared]))
                blocks.extend(alloc.take(phys - fork))
                slot_blocks[s] = blocks
                tables[s, :len(blocks)] = blocks
                dirty = True
                self._slot_tenant[s] = tenant
                self._slot_time[s] = {"enq": t_enq, "admit": t_admit / 1e9,
                                      "first": None, "last": None}
                if shared:
                    metrics.count("llm.serve.prefix_hits")
                    metrics.count("llm.serve.prefix_hit_blocks", shared)
                    self._span(rec, "serve.prefix_hit", t_admit, slot=s,
                               blocks=shared, tokens=p0)
                # chunk-multiple padding; only the suffix [p0, P) is
                # prefilled
                P = p0 + math.ceil((T - p0) / C) * C
                if P > T:
                    prompt = np.pad(prompt, ((0, 0), (0, P - T)))
                metrics.count("llm.serve.prefill_tokens", P - p0)
                metrics.count("llm.serve.prefill_pad_waste", P - T)
                self._admitting.append({
                    "slot": s, "prompt": prompt.astype(np.int32), "T": T,
                    "P": P, "p": p0, "n": n, "meta": meta, "emit": emit,
                    "first": None, "hashes": hashes})
                self._span(rec, "serve.admit", t_admit, slot=s, tokens=T,
                           blocks=phys, shared=shared)

            # 2. chunked prefill: up to prefill_budget tokens of [1, C]
            # chunks into the admitting streams' blocks (the budget is
            # waived while nothing decodes); the draft's twin writes the
            # same chunk into the draft pool
            budget = fw.prefill_budget if (remaining > 0).any() else 1 << 30
            newly_live = []
            for st in list(self._admitting):
                while budget > 0 and st["p"] < st["P"]:
                    t_pf = time.monotonic_ns()
                    s, p = st["slot"], st["p"]
                    final = p + C >= st["P"]
                    if dirty:
                        tables_dev.copy_(upload(tables, dev))
                        dirty = False
                    # last REAL token's offset within the final chunk
                    off = st["T"] - 1 - p if final else 0
                    chunk = upload(st["prompt"][:, p:p + C], dev)
                    start = np.asarray([p], np.int64)
                    logits, pool = llama.forward_paged(
                        params, chunk, pool, tables_dev[s:s + 1], start, cfg,
                        fw.dtype, logit_off=off)
                    if spec:
                        llama.forward_paged(dparams, chunk, dpool,
                                            tables_dev[s:s + 1], start,
                                            fw.draft_cfg, fw.dtype, logit_off=0)
                    self.stats["prefill_chunks"] += 1
                    st["p"] = p + C
                    budget -= C
                    progressed = True
                    self._span(rec, "serve.prefill_chunk", t_pf, slot=s, pos=p,
                               final=bool(final))
                    if not final:
                        continue
                    if fw.nan_guard and not bool(torch.isfinite(logits).all()):
                        self._admitting.remove(st)
                        self._poisoned(st)
                        retire(s)
                        break
                    gens[s].manual_seed(self._seed(admissions))
                    admissions += 1
                    st["first"] = llama.sample_token_per_slot(
                        logits[:, 0], [gens[s]], fw.temperature,
                        fw.top_k, fw.top_p)
                    tok[s] = st["first"][0]
                    tok_prev_h[s] = int(st["prompt"][0, st["T"] - 1])
                    if spec:
                        # the round's refresh step re-feeds the last
                        # prompt token at T - 1
                        tok_prev[s] = int(tok_prev_h[s])
                    if fw.prefix_cache:
                        alloc.register(st["hashes"], slot_blocks[s])
                    pos[s] = st["T"]
                    pos_dirty = True
                    remaining[s] = st["n"] - 1
                    sidx[s] = 1
                    # visible to the crash terminator from here on
                    slots[s] = (st["meta"], st["emit"])
                    newly_live.append(st)
                    self._admitting.remove(st)
                    break

            # 3. dispatch for the live slots: one speculative round, or one
            # chunk of stream_chunk decode steps.  Streams that finish
            # mid-chunk decode garbage to its end (their writes stay in
            # their reserved blocks or go to the sink; never emitted).
            live = remaining > 0
            toks_dev = None
            round_sent = False
            if live.any():
                t_dec = time.monotonic_ns()
                if dirty:
                    tables_dev.copy_(upload(tables, dev))
                    dirty = False
                if spec:
                    if pos_dirty:
                        pos_dev.copy_(upload(pos, dev))
                        pos_dirty = False
                    t_host = time.perf_counter()
                    propose.replay()
                    verify.replay()
                    self.stats["spec_rounds"] += 1
                    metrics.count("llm.serve.spec_rounds")
                    round_sent = True
                else:
                    pos_dev.copy_(upload(pos, dev))
                    live_dev.copy_(upload(live, dev))
                    t_host = time.perf_counter()
                    steps = []
                    ctx = pos[live] + 1  # positions each live row attends
                    for _ in range(fw.chunk):
                        decode.replay()
                        steps.append(tok.clone())
                        if decode.track is not None:
                            # xray: the live contexts' K/V rows (block-
                            # rounded) and their attention FLOPs
                            blocks = -(-ctx // bs)
                            decode.add_work(
                                4.0 * cfg.n_heads * cfg.head_dim
                                * cfg.n_layers * float(ctx.sum()),
                                float(blocks.sum()) * bs * self._kv_per_pos)
                            ctx = ctx + 1
                    toks_dev = torch.stack(steps, dim=1)
                    self.stats["decode_steps"] += fw.chunk
                    pos[live] += fw.chunk
                self.stats["decode_host_s"] += time.perf_counter() - t_host
                progressed = True

            # 4. emit the admitted streams' first tokens (the card is
            # already computing the chunk above)
            for st in newly_live:
                s = st["slot"]
                first = tok_h[s] = int(st["first"][0])
                first_last = st["n"] == 1 or first == eos
                self._emit_token(st["emit"], st["meta"], first, 0, first_last)
                mark_emit(s)
                if first_last:
                    retire(s)

            # 5. deliver the chunk's tokens: ONE copy to the host per chunk
            if toks_dev is not None:
                host = toks_dev.cpu().numpy()
                # closed here, where the chunk's tokens reach the host:
                # the replays above only queued the work
                self._span(rec, "serve.decode", t_dec,
                           occupancy=int(live.sum()), chunk=fw.chunk)
                for s in np.flatnonzero(live):
                    seq = [tok_h[s]] + host[s].tolist()
                    tok_h[s], tok_prev_h[s] = seq[-1], seq[-2]
                for j in range(host.shape[1]):
                    for s in np.flatnonzero(live):
                        if remaining[s] == 0:
                            continue  # finished mid-chunk: discard
                        meta, emit = slots[s]
                        tokid = int(host[s, j])
                        last = remaining[s] == 1 or tokid == eos
                        self._emit_token(emit, meta, tokid, int(sidx[s]),
                                         bool(last))
                        mark_emit(int(s))
                        sidx[s] += 1
                        remaining[s] -= 1
                        if last:
                            retire(int(s))

            # 5b. deliver the round's tokens: ONE copy of the accept
            # counts and emitted rows; everything past a stream's first
            # rejection is dropped (its K/V rows are overwritten before
            # any position attends them)
            if round_sent:
                host = spec_out.cpu().numpy()
                self._span(rec, "serve.spec_verify", t_dec,
                           occupancy=int(live.sum()), k=K)
                for s in np.flatnonzero(live):
                    s = int(s)
                    if remaining[s] == 0:
                        continue  # retired at its first token
                    meta, emit = slots[s]
                    acc = int(host[s, 0])
                    seq = [tok_h[s]] + host[s, 1:acc + 2].tolist()
                    tok_h[s], tok_prev_h[s] = seq[-1], seq[-2]
                    metrics.count("llm.serve.spec_accepted", acc)
                    metrics.count("llm.serve.spec_rejected", K - acc)
                    metrics.gauge("llm.serve.spec_accept_rate", acc / K)
                    ten = self._slot_tenant[s]
                    if ten is not None:
                        metrics.gauge("llm.serve.spec_accept_rate", acc / K,
                                      tenant=ten)
                    for j in range(acc + 1):
                        tokid = int(host[s, 1 + j])
                        last = remaining[s] == 1 or tokid == eos
                        self._emit_token(emit, meta, tokid, int(sidx[s]),
                                         bool(last),
                                         extra={"spec_draft": int(j < acc)})
                        mark_emit(s)
                        sidx[s] += 1
                        remaining[s] -= 1
                        if last:
                            # re-parks the row over the round's advance
                            retire(s)
                            break
                    else:
                        pos[s] += acc + 1

            if not progressed:
                with self._idle_lock:
                    if self._pending.empty() and not self._waiting \
                            and not self._arrived \
                            and not self._admitting and not self._ctl \
                            and not (remaining > 0).any():
                        self._idle.set()
                self._wake.wait(0.02)
                self._wake.clear()

    def _poisoned(self, st: Dict) -> None:
        """``nan_guard``: the prompt of admission state ``st`` prefilled
        to non-finite logits.  Quarantine it through the pipeline's armor
        (when the pipeline has one) and answer ``abort_reason=poison``;
        the loop serves every other stream on."""
        err = FloatingPointError("non-finite prefill logits (nan_guard)")
        armor = self.fw._armor
        if armor is not None:
            armor.quarantine(Buffer([st["prompt"][:, :st["T"]].copy()],
                                    meta=dict(st["meta"])),
                             error=err, stage="llm.serve")
        metrics.count("llm.serve.poisoned")
        self._abort(st["meta"], st["emit"], "poison")
