"""Data pipeline of the port (counterpart of ``repro/data/pipeline.py``,
copied as pure numpy so batches are bit-equal to the reference's).

``SyntheticCorpus`` is a deterministic PG-19 stand-in: long "documents"
sampled from a fixed random order-2 Markov chain with controllable
entropy.  Low-entropy structure means small models actually learn it, so
draft accept lengths and SpecPV speed-ups are measurable.

``continuation_task`` extracts (prompt, continuation) pairs of a given
context length: the paper's story-continuation efficiency benchmark.

A document's generator is seeded with ``hash(("doc", seed, doc_id))``,
the reference's expression, kept as it is.  Python salts string hashes
per process unless ``PYTHONHASHSEED`` is set, so a corpus is the same
within one process (and equal to the reference's there), but differs
from one process to the next.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticCorpus:
    vocab_size: int = 512
    order: int = 2
    branching: int = 4          # plausible next-tokens per state (entropy)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v, k = self.vocab_size, self.branching
        # transition table: state (pair of tokens) -> k candidate tokens
        n_states = v * v if self.order == 2 else v
        self._cand = rng.integers(0, v, size=(n_states, k), dtype=np.int32)
        # skewed choice distribution (zipf-ish) => learnable + drafty
        p = 1.0 / np.arange(1, k + 1) ** 1.5
        self._p = p / p.sum()

    def _state(self, a: int, b: int) -> int:
        return (a * self.vocab_size + b) if self.order == 2 else b

    def document(self, doc_id: int, length: int) -> np.ndarray:
        # salted per process unless PYTHONHASHSEED is set (module doc)
        rng = np.random.default_rng(hash(("doc", self.seed, doc_id)) % 2**32)
        out = np.empty(length, np.int32)
        a, b = rng.integers(0, self.vocab_size, 2)
        for i in range(length):
            cand = self._cand[self._state(int(a), int(b))]
            nxt = cand[rng.choice(len(cand), p=self._p)]
            out[i] = nxt
            a, b = b, nxt
        return out

    def tokens(self, n: int, seed: int = 0) -> np.ndarray:
        """A flat stream of n tokens (concatenated documents)."""
        chunks = []
        total, i = 0, 0
        while total < n:
            d = self.document(seed * 100003 + i, min(n - total, 8192))
            chunks.append(d)
            total += len(d)
            i += 1
        return np.concatenate(chunks)[:n]


def batch_iterator(corpus: SyntheticCorpus, *, batch: int, seq_len: int,
                   seed: int = 0) -> Iterator[np.ndarray]:
    """Packed LM batches [batch, seq_len+1] (inputs+labels overlap)."""
    step = 0
    while True:
        rows = []
        for b in range(batch):
            rows.append(corpus.tokens(seq_len + 1,
                                      seed=seed + step * batch + b))
        step += 1
        yield np.stack(rows)


def continuation_task(corpus: SyntheticCorpus, *, batch: int,
                      context_len: int, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(prompt [B, context_len], reference continuation [B, 256])."""
    prompts, refs = [], []
    for b in range(batch):
        doc = corpus.tokens(context_len + 256, seed=seed * 7919 + b)
        prompts.append(doc[:context_len])
        refs.append(doc[context_len:])
    return np.stack(prompts), np.stack(refs)
