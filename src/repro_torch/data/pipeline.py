"""Deterministic synthetic LM data (PyTorch port of
``repro.data.pipeline``).

``SyntheticLMStream`` gives the same tokens for the same (seed, step) as
the reference's, from ``np.random.default_rng((seed, step))``, with labels
= tokens rolled left by one.  Batches stay numpy on the host; the train
loop copies each to the card.  The reference's threaded ``Prefetcher`` is
not ported yet (ROADMAP Queue A, item A3): one step's batch is a few
hundred KB of int32.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMStream:
    """Deterministic tokens: tokens[step] = default_rng((seed, step))
    integers in [0, vocab) of shape [global_batch, seq_len]."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 *, seed: int = 0):
        self.vocab = vocab_size
        self.B = global_batch
        self.S = seq_len
        self.seed = seed

    def _tokens_for(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.vocab, (self.B, self.S), dtype=np.int32)

    def batch(self, step: int) -> dict:
        tok = self._tokens_for(step)
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
