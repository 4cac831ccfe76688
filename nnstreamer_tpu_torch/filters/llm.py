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
share, each admitted into a free slot while the others decode.

Pipeline usage::

    appsrc name=prompt ! tensor_filter framework=llm model=llama_tiny
        custom=max_new:32,temperature:0.0 ! tensor_sink name=tokens

Input: one uint8 tensor (UTF-8 prompt bytes, byte-level ids) or int32
token ids ``[T]`` / ``[B, T]``.  Output per token: ``[B]`` int32 ids, plus
the uint8 piece bytes at batch 1.  The filter runs on the CUDA card
unless the element sets ``accelerator=true:cpu``.
"""

from __future__ import annotations

import functools
import math
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.buffer import upload
from ..core.config import get_config
from ..core.log import logger, metrics
from ..core.meta_keys import (META_ABORT_REASON, META_EMIT_T,
                              META_STREAM_ABORTED, META_STREAM_ID,
                              META_STREAM_INDEX, META_STREAM_LAST)
from ..core.registry import register_filter
from ..core.types import TensorFormat, TensorsSpec
from ..models import llama
from ..models.zoo import build as build_model
from ..pipeline.graphs import Census
from ..utils import elastic
from .base import Framework, FrameworkError, parse_custom_options, resolve_device

log = logger(__name__)


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


#: custom= options of the JAX package's llm filter whose paths this port
#: does not carry yet; asking for one raises instead of serving another path
_NOT_PORTED = ("draft", "spec_k", "draft_seed", "tp", "tokenizer")
#: switches of the continuous loop that turn on a path not ported yet:
#: only their off value is taken (the JAX package's prefix_cache defaults
#: to on; here it is off)
_OFF_ONLY = ("prefix_cache", "nan_guard")

def serving_plan(cfg, *, slots: int, block_size: int = 16,
                 kv_blocks: int = 0, prefill_chunk: int = 32) -> Dict[str, int]:
    """Static sizing of the paged-KV serving state, without building
    anything (the JAX package's ``serving_plan``, same integers, cut to
    the two the loop reads):

    * ``max_blocks`` — block-table width per slot.  Prefill pads prompts
      to ``prefill_chunk`` multiples, so the table spans the largest
      padded prompt's final chunk, not just ``max_seq``; the extra
      entries stay sentinel.
    * ``n_blocks`` — pool size.  ``kv_blocks`` 0 = worst case
      (``slots * ceil(max_seq / block_size)``: admission never defers on
      blocks); larger is clamped to it.
    """
    bs = max(1, int(block_size))
    C = max(1, int(prefill_chunk))
    pad_max = math.ceil((cfg.max_seq - 1) / C) * C
    max_blocks = math.ceil(max(cfg.max_seq, pad_max) / bs)
    worst = int(slots) * math.ceil(cfg.max_seq / bs)
    n_blocks = min(int(kv_blocks), worst) if kv_blocks else worst
    return {"max_blocks": max_blocks, "n_blocks": n_blocks}


@register_filter("llm", aliases=("llamacpp", "llama.cpp"))
class LLMFramework(Framework):
    """Streaming generation.  ``custom=`` options:

    ``max_new:N`` (default 32), ``temperature:F`` (0 = greedy), ``seed:N``
    (sampling seed), ``top_k:N`` / ``top_p:F`` (sampler truncation),
    ``stream_chunk:N`` (tokens decoded per host sync, default 8),
    ``stop_eos:0|1`` (stop at the tokenizer's EOS id, default off for the
    byte-level tokenizer), ``quant:int4`` (nibble-packed weights, decoded
    through the CUDA kernel of ``csrc/int4_matmul.cu``),
    ``dtype:bfloat16|float32`` (compute), ``param_dtype:...`` (weights),
    plus model geometry overrides (``dim:…``, ``n_layers:…``,
    ``max_seq:…``) forwarded to the zoo.

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
    host sync.

    Not ported yet, and raising: ``draft:`` (speculative decoding),
    ``prefix_cache:1``, ``nan_guard:1``, ``tp:``, ``tokenizer:``,
    ``quant:int8``.
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
        self._serve: Optional[_ContinuousLoop] = None
        self._serve_lock = threading.Lock()
        #: the captured decode steps of this filter (static sets or the
        #: continuous loop's one step)
        self.census: Optional[Census] = None
        #: idle static decode sets, at most one per batch size
        self._free_sets: Dict[int, _StaticDecode] = {}
        self._sets_lock = threading.Lock()

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        model = str(props.get("model") or "llama_tiny")
        opts = parse_custom_options(str(props.get("custom", "")))
        for key in _NOT_PORTED:
            if key in opts:
                raise FrameworkError(
                    f"custom={key}:{opts[key]} is not yet ported to "
                    "nnstreamer_tpu_torch")
        for key in _OFF_ONLY:
            if str(opts.pop(key, "0")).lower() not in ("0", "false", "no"):
                raise FrameworkError(
                    f"custom={key}:1 is not yet ported to "
                    "nnstreamer_tpu_torch")
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
        quant = str(opts.get("quant", "")).lower()
        if quant not in ("", "int4"):
            raise FrameworkError(
                f"custom=quant:{quant} is not yet ported to "
                "nnstreamer_tpu_torch (quant:int4 only)")
        self.device = resolve_device(str(props.get("accelerator", "")))
        self.max_new = int(opts.pop("max_new", 32))
        self.temperature = float(opts.pop("temperature", 0.0))
        self.top_k = int(opts.pop("top_k", 0))
        self.top_p = float(opts.pop("top_p", 1.0))
        self.seed = int(opts.pop("seed", 0))
        self.stop_eos = str(opts.pop("stop_eos", "0")).lower() \
            not in ("0", "false", "no")
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
        self.census = Census(self.device)

    def close(self) -> None:
        if self._serve is not None:
            self._serve.shutdown()
            self._serve = None
        with self._sets_lock:
            self._free_sets = {}
        self.bundle = None

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
        dec = self._take_decode(B)
        try:
            yield from self._decode(dec, prompt, t0)
        finally:
            self._give_back(dec)

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
        cache = self.cache = llama.init_cache(cfg, B, dtype=dtype, device=dev)
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


class _ContinuousLoop:
    """Standing decode loop for ``custom=serve:continuous`` over a
    block-paged KV pool (port of the JAX package's ``_ContinuousLoop``,
    without prefix sharing, speculative decoding, drain/adopt, tenant
    quotas or the poison guard).

    **The pool.**  One thread owns the pool ``[L, n_blocks + 1, bs, Hkv,
    hd]`` (:func:`~..models.llama.init_paged_cache`; the extra block takes
    dropped writes), a host free list of block ids and a per-slot block
    table ``[slots, max_blocks]`` whose entries map a stream's logical
    block j to a pool block (``n_blocks`` = sentinel).  A decode step
    reads only each stream's live blocks (the paged kernel).

    **Admission = reservation.**  A prompt of T tokens is admitted, in
    FIFO order, when a slot and ``ceil((T + n) / block_size)`` free blocks
    exist (n = tokens to generate): a live stream never stalls on an
    empty free list.  A prompt of ``max_seq`` tokens or more is rejected
    (``prompt-oversize``), so is one whose reservation exceeds the whole
    pool (``reservation-impossible``), and one that waited at the head of
    the queue past ``admit_timeout`` (``admit-timeout``): each with a
    ``stream_aborted`` terminator carrying ``abort_reason``.

    **Chunked prefill.**  An admitted prompt pads to a multiple of
    ``prefill_chunk`` and prefills chunk by chunk into its blocks, at most
    ``prefill_budget`` tokens per iteration while other streams decode.

    **Decode.**  Each iteration replays ``stream_chunk`` times the one
    decode step its warm-up captured (:func:`paged_decode_step`, one
    signature in the filter's census), every slot at its own position
    (idle slots parked at ``max_blocks * block_size``: they write only
    the sink block and attend nothing), with ONE card-to-host copy of the
    chunk's tokens.  The step reads the token, positions, tables and live
    mask in place; the host copies its own positions, tables and live
    mask into them once per chunk, and a stream's join, leave or
    completion changes only those values, never the step.

    **Sampling.**  Greedy at temperature 0.  Otherwise each slot keeps one
    ``torch.Generator``, re-seeded from (seed, admission number) when a
    stream is admitted to it, drawn once for the first token and once per
    decode step (an idle slot's draws are thrown away): a stream's
    tokens are a function of the seed, its admission number and its
    positions, whichever streams share the batch.

    **Cancel.**  Every stream registers its id with
    :mod:`~..utils.elastic` at submit and unregisters when it completes
    or is aborted.  A cancel (:meth:`_mark_cancel`, e.g. the query
    serversink on a dead connection) marks it with a deadline
    ``stream_idle_timeout`` ahead; the first chunk boundary past it reaps
    the stream, queued, mid-prefill or live: its blocks go back to the
    free list, its slot parks, and a typed terminator goes downstream.
    Like a completion, a reap changes only the host's tables, positions
    and live mask, which reach the captured step by copies.
    """

    def __init__(self, fw: LLMFramework):
        self.fw = fw
        plan = serving_plan(fw.cfg, slots=fw.slots, block_size=fw.block_size,
                            kv_blocks=fw.kv_blocks,
                            prefill_chunk=fw.prefill_chunk)
        self.max_blocks = plan["max_blocks"]
        self.n_blocks = plan["n_blocks"]
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
        self._live_slots: list = [None] * fw.slots  # (meta, emit) per slot
        #: stream id -> (reason, reap deadline), set by _mark_cancel from
        #: any thread, consumed by the serve thread at chunk boundaries
        self._cancelled: Dict[int, tuple] = {}
        #: registered stream ids not yet unregistered (shutdown clears
        #: what completion and abort did not)
        self._owned_sids: set = set()
        #: set once the warm-up (one prefill chunk, one decode step) ran
        self.warmed = threading.Event()
        #: decode steps and prefill chunks dispatched since the warm-up, and
        #: the host seconds spent issuing the decode steps (a replay waits
        #: there while the card's launch queue is full)
        self.stats = {"decode_steps": 0, "prefill_chunks": 0,
                      "decode_host_s": 0.0}
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
                    last: bool) -> None:
        out_meta = dict(meta)
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
            for ent in list(self._waiting):
                self._abort(ent[1], ent[2])
            with self._idle_lock:
                self._error = e
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
        pool = llama.init_paged_cache(cfg, self.n_blocks, bs, dtype=fw.dtype,
                                      device=dev)
        # The decode step's static inputs on the card, which its graph
        # reads and writes in place; the host's values go into them by
        # copies (from fresh pinned buffers: an earlier copy may still be
        # reading the last one) on this thread's stream, which a replay
        # follows.
        tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        pos_dev = torch.full((B,), self.park, dtype=torch.long, device=dev)
        tables_dev = torch.full((B, self.max_blocks), self.sentinel,
                                dtype=torch.int32, device=dev)
        live_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        gens = [torch.Generator(device=dev) for _ in range(B)]
        # Host bookkeeping: positions advance by the chunk for live rows
        # (parked rows stay parked) and tables change only at admit and
        # retire, so both live as numpy and go up once per chunk.
        pos = np.full((B,), self.park, np.int64)
        tables = np.full((B, self.max_blocks), self.sentinel, np.int32)
        free = list(range(self.n_blocks))
        slot_blocks: list = [[] for _ in range(B)]
        slot_sid: list = [None] * B  # stream id holding each slot
        remaining = np.zeros((B,), np.int64)
        sidx = np.zeros((B,), np.int64)
        slots = self._live_slots
        # published for tests and post-mortems (mutated in place)
        self._pos, self._tables = pos, tables
        self._free, self._slot_blocks = free, slot_blocks
        eos = self.fw.tokenizer.eos if fw.stop_eos else -1
        admissions = 0
        dirty = False  # host tables changed since the last upload

        def take_blocks(need: int) -> list:
            if len(free) < need:
                # admission checks capacity first: a shortfall is an
                # allocator bug, never a truncated table
                raise RuntimeError(f"KV allocator invariant violated: asked "
                                   f"for {need} blocks, {len(free)} free")
            got = free[:need]
            del free[:need]
            return got

        def retire(s: int) -> None:
            nonlocal dirty
            self._release_sid(slot_sid[s])
            slot_sid[s] = None
            free.extend(slot_blocks[s])
            slot_blocks[s] = []
            tables[s, :] = self.sentinel
            dirty = True
            pos[s] = self.park
            slots[s] = None
            remaining[s] = 0
            sidx[s] = 0

        # Warm-up before admitting real work: first-use costs (kernel
        # library loads, allocator growth, library handles) and the decode
        # step's capture land here and not on the first requests.  The
        # prefill chunk writes garbage through real blocks and frees them,
        # the decode step (every slot parked) only the sink block; nothing
        # can attend either.
        warm = take_blocks(min(math.ceil(C / bs), self.n_blocks))
        tables[0, :len(warm)] = warm
        zeros = torch.zeros((1, C), dtype=torch.int32, device=dev)
        llama.forward_paged(params, zeros, pool, upload(tables[:1], dev),
                            np.zeros(1, np.int64), cfg, fw.dtype,
                            logit_off=C - 1)
        free[0:0] = warm
        tables[0, :] = self.sentinel
        decode = fw.census.capture(
            ("continuous", B, str(fw.dtype), fw.temperature > 0),
            paged_decode_step(params, cfg, fw.dtype, pool, tok, pos_dev,
                              tables_dev, live_dev, gens, fw.temperature,
                              fw.top_k, fw.top_p),
            generators=gens if fw.temperature > 0 else ())
        tok.cpu()  # the warm-up has run on the card
        self.warmed.set()

        while not self._stop.is_set():
            progressed = False
            # 0. the thread hand-off queue into the admission-order list
            while True:
                try:
                    self._waiting.append(self._pending.get_nowait())
                except queue.Empty:
                    break

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
                    retire(s)
                    self._abort(meta, emit, reason, idx=idx)
                    progressed = True

            # 1. admission: waiting prompts into free slots while a slot
            # and the stream's whole block reservation are free.  Strict
            # FIFO; the head times out after admit_timeout.
            while self._waiting:
                prompt, meta, emit, t_enq = self._waiting[0]
                T = prompt.shape[1]
                n = max(1, min(fw.max_new, cfg.max_seq - T))
                reason = None
                if T >= cfg.max_seq:
                    reason = "prompt-oversize"
                elif T + n > self.n_blocks * bs:
                    # no amount of retiring satisfies it: deferring would
                    # wedge the FIFO head
                    reason = "reservation-impossible"
                need = math.ceil((T + n) / bs)
                busy = {st["slot"] for st in self._admitting}
                freeslots = [s for s in range(B) if remaining[s] == 0
                             and slots[s] is None and s not in busy]
                if reason is None and (not freeslots or len(free) < need):
                    if fw.admit_timeout > 0 and \
                            time.monotonic() - t_enq > fw.admit_timeout:
                        reason = "admit-timeout"
                        metrics.count("llm.serve.admit_timeouts")
                    else:
                        break  # pool or slots full: defer, never overflow
                self._waiting.pop(0)
                progressed = True
                if reason is not None:
                    self._abort(meta, emit, reason)
                    continue
                s = freeslots[0]
                slot_sid[s] = meta.get(META_STREAM_ID)
                slot_blocks[s] = take_blocks(need)
                tables[s, :need] = slot_blocks[s]
                dirty = True
                P = math.ceil(T / C) * C  # chunk-multiple padding
                if P > T:
                    prompt = np.pad(prompt, ((0, 0), (0, P - T)))
                metrics.count("llm.serve.prefill_tokens", P)
                metrics.count("llm.serve.prefill_pad_waste", P - T)
                self._admitting.append({
                    "slot": s, "prompt": prompt.astype(np.int32), "T": T,
                    "P": P, "p": 0, "n": n, "meta": meta, "emit": emit,
                    "first": None})

            # 2. chunked prefill: up to prefill_budget tokens of [1, C]
            # chunks into the admitting streams' blocks (the budget is
            # waived while nothing decodes)
            budget = fw.prefill_budget if (remaining > 0).any() else 1 << 30
            newly_live = []
            for st in list(self._admitting):
                while budget > 0 and st["p"] < st["P"]:
                    s, p = st["slot"], st["p"]
                    final = p + C >= st["P"]
                    if dirty:
                        tables_dev.copy_(upload(tables, dev))
                        dirty = False
                    # last REAL token's offset within the final chunk
                    off = st["T"] - 1 - p if final else 0
                    logits, pool = llama.forward_paged(
                        params, upload(st["prompt"][:, p:p + C], dev), pool,
                        tables_dev[s:s + 1], np.asarray([p], np.int64), cfg,
                        fw.dtype, logit_off=off)
                    self.stats["prefill_chunks"] += 1
                    st["p"] = p + C
                    budget -= C
                    progressed = True
                    if final:
                        gens[s].manual_seed(self._seed(admissions))
                        admissions += 1
                        st["first"] = llama.sample_token_per_slot(
                            logits[:, 0], [gens[s]], fw.temperature,
                            fw.top_k, fw.top_p)
                        tok[s] = st["first"][0]
                        pos[s] = st["T"]
                        remaining[s] = st["n"] - 1
                        sidx[s] = 1
                        # visible to the crash terminator from here on
                        slots[s] = (st["meta"], st["emit"])
                        newly_live.append(st)
                        self._admitting.remove(st)
                        break

            # 3. dispatch one chunk of per-row paged decode for the live
            # slots.  The chunk is always stream_chunk steps: streams that
            # finish mid-chunk decode garbage to its end (their writes stay
            # in their reserved blocks or go to the sink; never emitted).
            live = remaining > 0
            toks_dev = None
            if live.any():
                if dirty:
                    tables_dev.copy_(upload(tables, dev))
                    dirty = False
                pos_dev.copy_(upload(pos, dev))
                live_dev.copy_(upload(live, dev))
                t_host = time.perf_counter()
                steps = []
                for _ in range(fw.chunk):
                    decode.replay()
                    steps.append(tok.clone())
                toks_dev = torch.stack(steps, dim=1)
                self.stats["decode_host_s"] += time.perf_counter() - t_host
                self.stats["decode_steps"] += fw.chunk
                pos[live] += fw.chunk
                progressed = True

            # 4. emit the admitted streams' first tokens (the card is
            # already computing the chunk above)
            for st in newly_live:
                s = st["slot"]
                first = int(st["first"][0])
                first_last = st["n"] == 1 or first == eos
                self._emit_token(st["emit"], st["meta"], first, 0, first_last)
                if first_last:
                    retire(s)

            # 5. deliver the chunk's tokens: ONE copy to the host per chunk
            if toks_dev is not None:
                host = toks_dev.cpu().numpy()
                for j in range(host.shape[1]):
                    for s in np.flatnonzero(live):
                        if remaining[s] == 0:
                            continue  # finished mid-chunk: discard
                        meta, emit = slots[s]
                        tokid = int(host[s, j])
                        last = remaining[s] == 1 or tokid == eos
                        self._emit_token(emit, meta, tokid, int(sidx[s]),
                                         bool(last))
                        sidx[s] += 1
                        remaining[s] -= 1
                        if last:
                            retire(int(s))

            if not progressed:
                with self._idle_lock:
                    if self._pending.empty() and not self._waiting \
                            and not self._admitting \
                            and not (remaining > 0).any():
                        self._idle.set()
                self._wake.wait(0.02)
                self._wake.clear()
