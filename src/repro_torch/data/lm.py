"""Synthetic LM token pipeline (port of ``repro.data.lm``; numpy only, so
both packages draw the same token streams; no downloaded corpora).

A sparse first-order Markov chain over the model vocab with Zipfian marginals
gives a learnable next-token structure: a model that learns the transition
table reaches substantially-below-uniform loss, so training curves are
meaningful. Deterministic per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    branching: int = 8           # successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        self.succ = rng.integers(0, v, size=(v, self.branching))
        # Zipfian start distribution
        ranks = np.arange(1, v + 1)
        p = 1.0 / ranks
        self.start_p = p / p.sum()
        self._rng = np.random.default_rng(self.seed + 1)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng
        b, s, v = self.batch, self.seq_len, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=self.start_p)
        choices = rng.integers(0, self.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def entropy_floor(self) -> float:
        """Per-token loss floor: log(branching) for uniform successor picks."""
        return float(np.log(self.branching))


def markov_stream(vocab: int, seq_len: int, batch: int, seed: int = 0) -> LMStream:
    return LMStream(vocab, seq_len, batch, seed)
