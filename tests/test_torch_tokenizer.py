"""The port's ``models/tokenizer.py`` against the JAX package's: ``encode``
ids and every ``decode_piece`` exact, on a ``toy_vocab`` with merges and
on a vocab embedded in a GGUF (read back by each package's loader),
including byte fallback, the leading-space rule, control tokens and a
vocab without byte pieces."""

import numpy as np
import pytest

from nnstreamer_tpu.models import gguf as jgguf
from nnstreamer_tpu.models import llama as jl
from nnstreamer_tpu.models import tokenizer as jtok
from nnstreamer_tpu_torch.models import tokenizer as ttok

MERGES = {"▁h": 2.0, "▁he": 3.0, "ll": 2.5, "llo": 3.5, "▁hello": 5.0,
          "▁w": 1.0, "or": 1.5, "ld": 1.2, "▁world": 4.0, "in": 0.5,
          "ing": 0.8, "▁the": 2.2, "é": 0.1}

TEXTS = ["hello world", " hello", "  two leading", "trailing ", "",
         "héllo wörld ☃ 日本", "the thing in the ring", "tab\tand\nnewline",
         "a" * 40, "\x00\x01 bytes"]


def _pair(**kw):
    return jtok.toy_vocab(MERGES, **kw), ttok.toy_vocab(MERGES, **kw)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_exact(text):
    j, t = _pair()
    b = text.encode("utf-8")
    assert t.encode(b) == j.encode(b)
    assert t.decode(t.encode(b)[1:]) == j.decode(j.encode(b)[1:])


def test_decode_piece_every_id():
    j, t = _pair(n_normal_pad=5)
    assert t.n_vocab == j.n_vocab
    for i in range(-2, j.n_vocab + 2):
        assert t.decode_piece(i) == j.decode_piece(i), i


def test_no_byte_pieces_falls_back_to_unk():
    pieces = ["<unk>", "<s>", "</s>", "▁", "a", "b", "▁a"]
    scores = [0.0, 0.0, 0.0, -1.0, -1.0, -1.0, 1.0]
    types = [2, 3, 3, 1, 1, 1, 1]
    j = jtok.SentencePieceTokenizer(pieces, scores, types)
    t = ttok.SentencePieceTokenizer(pieces, scores, types)
    for text in ("a b", "ab☃", "zz"):
        assert t.encode(text.encode()) == j.encode(text.encode())


@pytest.mark.parametrize("prefix", [True, False])
def test_gguf_embedded_vocab_exact(tmp_path, prefix):
    cfg = jl.LlamaConfig(vocab=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                         ffn_hidden=48, max_seq=64)
    tok = jtok.toy_vocab(MERGES, n_normal_pad=512 - 3 - 256 - 95 - len(MERGES))
    tok.add_prefix_space = prefix
    params = jl.init_params(cfg, seed=0)
    p = str(tmp_path / "m.gguf")
    jgguf.export_llama(p, params, cfg, tokenizer=tok)
    j, t = jtok.load_gguf_tokenizer(p), ttok.load_gguf_tokenizer(p)
    assert t.n_vocab == j.n_vocab == 512
    assert (t.bos, t.eos, t.unk, t.add_prefix_space) == \
        (j.bos, j.eos, j.unk, j.add_prefix_space)
    for text in TEXTS:
        b = text.encode("utf-8")
        assert t.encode(b) == j.encode(b), text
    for i in range(t.n_vocab):
        assert t.decode_piece(i) == j.decode_piece(i), i
    # a weights-only file carries no tokenizer
    q = str(tmp_path / "w.gguf")
    jgguf.export_llama(q, params, cfg)
    assert ttok.load_gguf_tokenizer(q) is None


def test_to_gguf_meta_equal():
    j, t = _pair(n_normal_pad=3)
    assert t.to_gguf_meta() == j.to_gguf_meta()
    again = ttok.SentencePieceTokenizer.from_gguf_meta(j.to_gguf_meta())
    assert again.encode(b"hello world") == j.encode(b"hello world")


def test_bytes_round_trip_through_pieces():
    _, t = _pair()
    text = "héllo wörld ☃"
    ids = t.encode(text.encode())[1:]
    assert b"".join(t.decode_piece(i) for i in ids).decode().lstrip(" ") == text
    assert np.all(np.asarray(ids) < t.n_vocab)
