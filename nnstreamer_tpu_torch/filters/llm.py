"""LLM token-streaming framework for tensor_filter.

Port of the static stream path of ``nnstreamer_tpu/filters/llm.py``
(reference analog: the llama.cpp sub-plugin — prompt in, generated
tokens streamed out as flexible tensors):

* one prefill over the (bucketed) prompt, then decode one token per
  step against a KV cache that stays on the device;
* tokens are produced in bursts of ``stream_chunk``: each burst is a
  Python loop of decode steps with ONE host sync at its end, and the
  burst's tokens then stream downstream one buffer each;
* ``llm.prefill`` (prompt in to first token on the host) and
  ``llm.decode_token`` (burst time per token) are recorded as latency
  series in :data:`~..core.log.metrics`.

Pipeline usage::

    appsrc name=prompt ! tensor_filter framework=llm model=llama_tiny
        custom=max_new:32,temperature:0.0 ! tensor_sink name=tokens

Input: one uint8 tensor (UTF-8 prompt bytes, byte-level ids) or int32
token ids ``[T]`` / ``[B, T]``.  Output per token: ``[B]`` int32 ids, plus
the uint8 piece bytes at batch 1.  The filter runs on the CUDA card
unless the element sets ``accelerator=true:cpu``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import get_config
from ..core.log import metrics
from ..core.registry import register_filter
from ..core.types import TensorFormat, TensorsSpec
from ..models import llama
from ..models.zoo import build as build_model
from .base import Framework, FrameworkError, parse_custom_options, resolve_device


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
_NOT_PORTED = ("serve", "draft", "tp", "tokenizer")


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
    ``max_seq:…``) forwarded to the zoo.  ``serve:continuous``, ``draft:``,
    ``tp:``, ``tokenizer:`` and ``quant:int8`` are not ported yet and
    raise.
    """

    name = "llm"
    streaming = True

    def __init__(self):
        super().__init__()
        self.bundle = None
        self.cfg: Optional[llama.LlamaConfig] = None
        self.tokenizer = ByteTokenizer()
        self.device = torch.device("cpu")

    def open(self, props: Dict[str, object]) -> None:
        super().open(props)
        model = str(props.get("model") or "llama_tiny")
        opts = parse_custom_options(str(props.get("custom", "")))
        for key in _NOT_PORTED:
            if key in opts:
                raise FrameworkError(
                    f"custom={key}:{opts[key]} is not yet ported to "
                    "nnstreamer_tpu_torch (static stream path only)")
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
            self.bundle = build_model(model, opts, self.device)
        except KeyError as e:
            raise FrameworkError(str(e)) from e
        self.cfg = self.bundle.config
        if self.cfg is None:
            raise FrameworkError(
                f"model {model!r} has no LlamaConfig; the llm framework needs "
                "a decoder-LM bundle (models/llama.py)")

    def close(self) -> None:
        self.bundle = None

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
    @torch.inference_mode()
    def _gen_tokens(self, prompt: np.ndarray) -> Iterator[np.ndarray]:
        cfg = self.cfg
        B, T = prompt.shape
        if T >= cfg.max_seq:
            raise FrameworkError(f"prompt length {T} >= max_seq {cfg.max_seq}")
        t0 = time.perf_counter()
        cache = llama.init_cache(cfg, B, dtype=self.dtype, device=self.device)
        params = self.bundle.params
        # Prompt-length bucketing: right-pad to the next power of two so
        # mixed prompt lengths share a few prefill shapes.  Causal
        # attention keeps real tokens from seeing pad rows, decode
        # overwrites cache row `pos` before any later position attends it,
        # and the sampled logit is read at the REAL last position.
        P = T
        if get_config().shape_bucketing:
            P = min(_next_bucket(T), cfg.max_seq - 1)
        if P > T:
            prompt = np.pad(prompt, ((0, 0), (0, P - T)))
        tokens = torch.from_numpy(prompt).to(self.device)
        logits, cache = llama.forward_cached(params, tokens, cache, 0, cfg,
                                             compute_dtype=self.dtype)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # At least one token is always safe; later decode steps feed
        # positions T..T+n-2, each of which must stay < max_seq.
        n = max(1, min(self.max_new, cfg.max_seq - T))
        eos = self.tokenizer.eos if self.stop_eos else -1
        tok = llama.sample_token(logits[:, T - 1], gen, self.temperature,
                                 self.top_k, self.top_p)
        first = tok.cpu().numpy()
        # host clock around work that ends in a device sync (the copy)
        metrics.observe_latency("llm.prefill", time.perf_counter() - t0)
        yield first
        if B == 1 and int(first[0]) == eos:
            return
        done, pos = 1, T
        while done < n:
            length = min(self.chunk, n - done)
            t0 = time.perf_counter()
            steps = []
            for i in range(length):
                logits, cache = llama.forward_cached(
                    params, tok[:, None], cache, pos + i, cfg,
                    compute_dtype=self.dtype)
                tok = llama.sample_token(logits[:, -1], gen, self.temperature,
                                         self.top_k, self.top_p)
                steps.append(tok)
            host = torch.stack(steps, dim=1).cpu().numpy()  # ONE sync per chunk
            metrics.observe_latency("llm.decode_token",
                                    (time.perf_counter() - t0) / length)
            for j in range(length):
                yield host[:, j]
                if B == 1 and int(host[0, j]) == eos:
                    return
            done += length
            pos += length

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
