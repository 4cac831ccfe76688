"""SentencePiece (SPM) tokenizer reconstructed from GGUF metadata.

Port of ``nnstreamer_tpu/models/tokenizer.py`` (pure Python, copied):
the llama.cpp sub-plugin tokenizes prompts with the model's OWN
vocabulary, carried inside the ``.gguf`` file as ``tokenizer.ggml.tokens``
/ ``.scores`` / ``.token_type`` metadata arrays.  This module implements
the same greedy-merge SentencePiece algorithm (the Llama tokenizer
family), so a real checkpoint's text path works end to end without any
vendor tokenizer library:

* **encode**: byte-exact normalization (space -> U+2581 ``▁``, optional
  prefix space), split into UTF-8 characters, then repeatedly merge the
  adjacent pair whose concatenation exists in the vocab with the highest
  score (a priority queue over bigrams — the ``llm_tokenizer_spm``
  procedure).  Characters that never merge into a known piece fall back
  to byte tokens (``<0xXX>``), or UNK when the vocab has no byte pieces.
* **decode**: per piece (the streaming contract): ``▁`` -> space, byte
  tokens -> their raw byte, control tokens -> nothing.

The tokenizer drops into :class:`~..filters.llm.ByteTokenizer`'s slot on
the llm framework (same ``encode`` / ``decode_piece`` surface), and
models/gguf.py's writer can embed a vocab so a written .gguf round-trips
text -> ids -> text.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

# SentencePiece's visible-space marker (U+2581 LOWER ONE EIGHTH BLOCK)
_SPACE = "▁"

# llama.cpp token_type values (gguf.md vocab spec)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6


class SentencePieceTokenizer:
    """Greedy-merge SPM over a (pieces, scores, types) vocab.

    Same duck-typed surface the llm framework's ByteTokenizer exposes:
    ``encode(bytes) -> List[int]`` (BOS prepended) and
    ``decode_piece(id) -> bytes``.
    """

    def __init__(self, pieces: Sequence[str], scores: Sequence[float],
                 types: Optional[Sequence[int]] = None,
                 bos: int = 1, eos: int = 2, unk: int = 0,
                 add_prefix_space: bool = True):
        if len(pieces) != len(scores):
            raise ValueError(
                f"vocab size mismatch: {len(pieces)} pieces vs "
                f"{len(scores)} scores")
        self.pieces = list(pieces)
        self.scores = list(scores)
        self.types = list(types) if types is not None else \
            [TYPE_NORMAL] * len(self.pieces)
        if len(self.types) != len(self.pieces):
            raise ValueError(
                f"vocab size mismatch: {len(self.pieces)} pieces vs "
                f"{len(self.types)} token types")
        self.bos = bos
        self.eos = eos
        self.unk = unk
        self.add_prefix_space = add_prefix_space
        self.n_vocab = len(self.pieces)
        self._index: Dict[str, int] = {}
        for i, p in enumerate(self.pieces):
            # first occurrence wins (duplicate pieces exist in some vocabs)
            self._index.setdefault(p, i)
        self._byte_ids: Dict[int, int] = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == TYPE_BYTE and len(p) == 6 and p.startswith("<0x"):
                try:
                    self._byte_ids[int(p[3:5], 16)] = i
                except ValueError:
                    pass
        # pre-decoded piece bytes for the streaming hot path
        self._piece_bytes: List[bytes] = [
            self._decode_one(i) for i in range(self.n_vocab)]

    # -- encode ------------------------------------------------------------
    def encode(self, text_bytes: bytes) -> List[int]:
        """UTF-8 text -> token ids, BOS prepended (the llm framework's
        prompt contract)."""
        text = text_bytes.decode("utf-8", "replace")
        return [self.bos] + self.encode_text(text)

    def encode_text(self, text: str) -> List[int]:
        """Core SPM encode, no BOS."""
        if not text:
            return []
        # SPM prepends the dummy space UNCONDITIONALLY (before escaping),
        # so " a" -> "▁▁a": two markers, not one.  Replacing first and
        # skipping the prefix when the text already starts with ▁ dropped
        # one marker on leading-space text (caught by the HF-tokenizers
        # oracle, tests/test_tokenizer_oracle.py).
        if self.add_prefix_space:
            text = " " + text
        text = text.replace(" ", _SPACE)
        sym = list(text)  # one symbol per unicode char to start
        n = len(sym)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n

        def try_pair(l: int) -> None:
            r = nxt[l]
            if r < 0:
                return
            merged = sym[l] + sym[r]
            tid = self._index.get(merged)
            if tid is None:
                return
            # heap entry revalidated at pop via the merged string
            heapq.heappush(heap, (-self.scores[tid], l, merged))

        heap: List = []
        for i in range(n - 1):
            try_pair(i)
        while heap:
            _, l, merged = heapq.heappop(heap)
            if not alive[l]:
                continue
            r = nxt[l]
            if r < 0 or sym[l] + sym[r] != merged:
                continue  # stale entry: one side already merged away
            sym[l] = merged
            alive[r] = False
            nxt[l] = nxt[r]
            if nxt[r] >= 0:
                prv[nxt[r]] = l
            try_pair(l)
            if prv[l] >= 0:
                try_pair(prv[l])

        ids: List[int] = []
        i = 0
        while i >= 0:
            if alive[i]:
                tid = self._index.get(sym[i])
                if tid is not None and self.types[tid] != TYPE_UNUSED:
                    ids.append(tid)
                else:
                    # byte fallback: emit each UTF-8 byte's token
                    bs = sym[i].encode("utf-8")
                    if self._byte_ids:
                        ids.extend(self._byte_ids.get(b, self.unk)
                                   for b in bs)
                    else:
                        ids.append(self.unk)
            i = nxt[i]
        return ids

    # -- decode ------------------------------------------------------------
    def _decode_one(self, token_id: int) -> bytes:
        if not (0 <= token_id < self.n_vocab):
            return b""
        t = self.types[token_id]
        if t in (TYPE_CONTROL, TYPE_UNUSED, TYPE_UNKNOWN):
            return b""
        p = self.pieces[token_id]
        if t == TYPE_BYTE and len(p) == 6 and p.startswith("<0x"):
            try:
                return bytes([int(p[3:5], 16)])
            except ValueError:
                return b""
        return p.replace(_SPACE, " ").encode("utf-8")

    def decode_piece(self, token_id: int) -> bytes:
        """One token -> its byte contribution (streaming contract)."""
        if 0 <= token_id < self.n_vocab:
            return self._piece_bytes[token_id]
        return b""

    def decode(self, ids: Sequence[int]) -> str:
        """Full-sequence detokenize: pieces joined, the single leading
        prefix space stripped (SentencePiece convention)."""
        text = b"".join(self._piece_bytes[i] for i in ids
                        if 0 <= i < self.n_vocab).decode("utf-8", "replace")
        if self.add_prefix_space and text.startswith(" "):
            text = text[1:]
        return text

    # -- GGUF metadata -----------------------------------------------------
    @classmethod
    def from_gguf_meta(cls, meta: Dict) -> "SentencePieceTokenizer":
        """Build from the ``tokenizer.ggml.*`` keys of a GGUF file's
        metadata (the same keys llama.cpp reads)."""
        pieces = meta.get("tokenizer.ggml.tokens")
        if not pieces:
            raise ValueError(
                "GGUF metadata has no tokenizer.ggml.tokens array")
        scores = meta.get("tokenizer.ggml.scores")
        if scores is None:
            scores = [0.0] * len(pieces)
        types = meta.get("tokenizer.ggml.token_type")
        return cls(
            pieces, scores, types,
            bos=int(meta.get("tokenizer.ggml.bos_token_id", 1)),
            eos=int(meta.get("tokenizer.ggml.eos_token_id", 2)),
            unk=int(meta.get("tokenizer.ggml.unknown_token_id", 0)),
            add_prefix_space=bool(
                meta.get("tokenizer.ggml.add_space_prefix", True)),
        )

    def to_gguf_meta(self) -> Dict:
        """The metadata keys :func:`from_gguf_meta` reads — lets
        models/gguf.py embed this vocab when exporting a checkpoint."""
        return {
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": list(self.pieces),
            "tokenizer.ggml.scores": [float(s) for s in self.scores],
            "tokenizer.ggml.token_type": list(self.types),
            "tokenizer.ggml.bos_token_id": self.bos,
            "tokenizer.ggml.eos_token_id": self.eos,
            "tokenizer.ggml.unknown_token_id": self.unk,
            "tokenizer.ggml.add_space_prefix": self.add_prefix_space,
        }


def load_gguf_tokenizer(path: str) -> Optional[SentencePieceTokenizer]:
    """Read only the metadata section of a .gguf and build the tokenizer;
    None when the file carries no vocab (weights-only exports)."""
    from . import gguf

    meta = gguf.read_metadata(path)
    if "tokenizer.ggml.tokens" not in meta:
        return None
    return SentencePieceTokenizer.from_gguf_meta(meta)


def toy_vocab(extra_pieces: Optional[Dict[str, float]] = None,
              n_normal_pad: int = 0) -> SentencePieceTokenizer:
    """A small but REAL SPM vocab for tests and demos: specials, the full
    byte range, single printable-ASCII characters, plus caller-supplied
    merge pieces with scores.  Deterministic id layout:
    0=<unk> 1=<s> 2=</s>, 3..258 = bytes, then ``▁`` + printable chars,
    then ``extra_pieces`` in insertion order."""
    pieces = ["<unk>", "<s>", "</s>"]
    types = [TYPE_UNKNOWN, TYPE_CONTROL, TYPE_CONTROL]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        pieces.append(f"<0x{b:02X}>")
        types.append(TYPE_BYTE)
        scores.append(0.0)
    singles = [_SPACE] + [chr(c) for c in range(0x21, 0x7F)]
    for ch in singles:
        pieces.append(ch)
        types.append(TYPE_NORMAL)
        scores.append(-1e4)  # chars merge only when no better piece exists
    for p, s in (extra_pieces or {}).items():
        pieces.append(p)
        types.append(TYPE_NORMAL)
        scores.append(float(s))
    for i in range(n_normal_pad):
        pieces.append(f"<pad{i}>")
        types.append(TYPE_UNUSED)
        scores.append(0.0)
    return SentencePieceTokenizer(pieces, scores, types,
                                  bos=1, eos=2, unk=0)
