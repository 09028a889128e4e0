"""CLIP byte-pair-encoding tokenizer (numpy only).

The port's own copy of ``livelyspeaker_tpu/data/clip_tokenizer.py``, with the
same semantics bit for bit: byte-level unicode mapping, lowercasing and a
word regex, merges from the standard ``bpe_simple_vocab_16e6.txt.gz`` file
(its path supplied by the user, as checkpoints are), and
``<|startoftext|> ... <|endoftext|>`` framing padded to a 77-token context.

Without a merges file, :class:`HashTokenizer` gives ids with the same framing
and interface.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Sequence

import numpy as np

__all__ = ["CLIPTokenizer", "HashTokenizer", "tokenize"]

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map used by GPT-2/CLIP BPE."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """CLIP's BPE, given the standard merges file (``.txt`` or ``.txt.gz``)."""

    def __init__(self, bpe_path: str):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(bpe_path)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # ASCII letter and digit classes: the stdlib ``re`` has no \p{L}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def __call__(
        self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        """int32 ids [len(texts), context_length]; a text longer than the
        context keeps its first ``context_length - 1`` ids and ends in EOT."""
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context_length:
                toks = toks[: context_length - 1] + [self.eot]
            result[i, : len(toks)] = toks
        return result


class HashTokenizer:
    """Stand-in with CLIP's framing for tests and runs without a merges
    file: whitespace words hashed into the BPE id range.

    The ids come from Python's ``hash()`` of each word, which is salted per
    process (unless ``PYTHONHASHSEED`` is set): they agree within one
    process, and across processes only by chance. The JAX package's
    tokenizer does the same; this copy keeps it so the two give the same
    ids in one process."""

    sot = 49406
    eot = 49407

    def __call__(
        self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            words = whitespace_clean(basic_clean(text)).lower().split(" ")
            ids = [hash(w) % 49152 + 1 for w in words if w]
            toks = [self.sot] + ids[: context_length - 2] + [self.eot]
            result[i, : len(toks)] = toks
        return result


def tokenize(
    texts: Sequence[str],
    bpe_path: str | None = None,
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """Token ids of ``texts``: CLIP's BPE with a merges file, else
    :class:`HashTokenizer`."""
    tok = CLIPTokenizer(bpe_path) if bpe_path else HashTokenizer()
    return tok(texts, context_length)
