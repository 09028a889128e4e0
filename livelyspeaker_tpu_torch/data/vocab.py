"""Word vocabulary, and the speaker model of the TED records.

Port of ``livelyspeaker_tpu/data/vocab.py``. The embedding table is filled
from a precomputed {word: vec} npz, or left random. A vocabulary is saved
as a pickle of :class:`Vocab`; :meth:`Vocab.load` also reads the pickles the
JAX package writes (``speaker_model.pkl`` beside its records), whose class
it maps onto this one, so the JAX package need not be importable.
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["Vocab", "build_vocab"]


class Vocab:
    PAD_token = 0
    SOS_token = 1
    EOS_token = 2
    UNK_token = 3

    def __init__(self, name: str, insert_default_tokens: bool = True):
        self.name = name
        self.trimmed = False
        self.word_embedding_weights = None
        self._reset_dictionaries(insert_default_tokens)

    def _reset_dictionaries(self, insert_default_tokens: bool = True):
        self.word2index: Dict[str, int] = {}
        self.word2count: Dict[str, int] = {}
        if insert_default_tokens:
            self.index2word = {
                self.PAD_token: "<PAD>",
                self.SOS_token: "<SOS>",
                self.EOS_token: "<EOS>",
                self.UNK_token: "<UNK>",
            }
        else:
            self.index2word = {self.UNK_token: "<UNK>"}
        self.n_words = len(self.index2word)

    def index_word(self, word: str) -> int:
        if word not in self.word2index:
            self.word2index[word] = self.n_words
            self.word2count[word] = 1
            self.index2word[self.n_words] = word
            self.n_words += 1
        else:
            self.word2count[word] += 1
        return self.word2index[word]

    def add_vocab(self, words: Sequence[str]) -> None:
        for w in words:
            self.index_word(w)

    def get_word_index(self, word: str) -> int:
        return self.word2index.get(word, self.UNK_token)

    def trim(self, min_count: int) -> None:
        """Drop rare words (vocab.py trim semantics)."""
        if self.trimmed:
            return
        self.trimmed = True
        keep = [w for w, c in self.word2count.items() if c >= min_count]
        old_counts = dict(self.word2count)
        self._reset_dictionaries()
        for w in keep:
            self.index_word(w)
            self.word2count[w] = old_counts[w]

    def init_random_embeddings(self, dim: int, seed: int = 233) -> None:
        rng = np.random.default_rng(seed)
        self.word_embedding_weights = rng.normal(
            0, 1, (self.n_words, dim)
        ).astype(np.float32)

    def load_word_vectors_npz(self, path: str, dim: int) -> None:
        """Fill embeddings from a {word: vector} archive (fastText export)."""
        archive = np.load(path)
        self.init_random_embeddings(dim)
        hit = 0
        for w, i in self.word2index.items():
            if w in archive:
                self.word_embedding_weights[i] = archive[w]
                hit += 1
        logging.info("loaded %d/%d word vectors", hit, self.n_words)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path, "rb") as f:
            return _VocabUnpickler(f).load()


class _VocabUnpickler(pickle.Unpickler):
    """Reads a pickled ``Vocab`` of either package as this module's class."""

    def find_class(self, module: str, name: str):
        if name == "Vocab" and module.endswith(".data.vocab"):
            return Vocab
        return super().find_class(module, name)


def build_vocab(
    name: str,
    word_lists: Sequence[Sequence[str]],
    cache_path: Optional[str] = None,
    embedding_dim: Optional[int] = None,
) -> Vocab:
    """Build (or load cached) vocab from word sequences
    (utils/vocab_utils.py:12-54 semantics, minus the fastText dependency)."""
    import os

    if cache_path and os.path.exists(cache_path):
        return Vocab.load(cache_path)
    vocab = Vocab(name)
    for words in word_lists:
        if words:
            vocab.add_vocab(words)
    if embedding_dim:
        vocab.init_random_embeddings(embedding_dim)
    if cache_path:
        vocab.save(cache_path)
    return vocab
