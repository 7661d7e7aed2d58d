"""Synthetic language-model token pipeline (the port's copy of the JAX
package's ``data/lm.py``: numpy only, the same tokens for a seed).

A second-order structured stream: the next token is a deterministic mixture
of affine maps of the previous two tokens plus Zipfian "function words",
giving a corpus whose cross-entropy is learnably below the uniform bound —
enough structure to verify end-to-end training dynamics without bundling a
real corpus offline.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.a = int(rng.integers(3, 23)) * 2 + 1
        self.b = int(rng.integers(1, vocab))
        # Zipfian function-word table
        ranks = np.arange(1, 65)
        p = 1.0 / ranks
        self.fw_p = (p / p.sum()).astype(np.float64)
        self.fw = rng.integers(0, vocab, 64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        out = np.empty((batch, seq), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        out[:, 1] = rng.integers(0, self.vocab, batch)
        for t in range(2, seq):
            det = (self.a * out[:, t - 1] + out[:, t - 2] + self.b) % self.vocab
            fw = self.fw[rng.choice(64, batch, p=self.fw_p)]
            use_fw = rng.random(batch) < 0.25
            noise = rng.random(batch) < 0.05
            rnd = rng.integers(0, self.vocab, batch)
            out[:, t] = np.where(noise, rnd, np.where(use_fw, fw, det))
        return out.astype(np.int32)

    def batches(self, batch: int, seq: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        while True:
            toks = self.sample(rng, batch, seq)
            yield {"tokens": toks}
