"""Deterministic data pipeline (port of ``repro.data.pipeline``; numpy only,
a copy of the reference's arithmetic, so its tokens are the reference's).

A "virtual dataset" derives every token from a counter-mode hash of (seed,
sample, position): reproducible across restarts and cheap to generate on
the fly.  Structure is injected (short Markov motifs) so losses actually
decrease during the example training runs.  Batches are host numpy arrays;
the caller moves them to its device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenPipeline"]


def _hash_tokens(seed: int, sample_idx: np.ndarray, seq_len: int,
                 vocab: int) -> np.ndarray:
    """counter-mode splitmix64 -> tokens (n, seq_len) int32, with motif
    structure: token_t depends on token_{t-1} for learnability."""
    pos = np.arange(seq_len, dtype=np.uint64)[None, :]
    x = (sample_idx.astype(np.uint64)[:, None] * np.uint64(0x9E3779B97F4A7C15)
         + pos * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(seed))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    raw = (x % np.uint64(vocab)).astype(np.int64)
    # motif: every odd position repeats an affine function of its predecessor
    out = raw.copy()
    out[:, 1::2] = (out[:, 0::2][:, : out[:, 1::2].shape[1]] * 7 + 13) % vocab
    return out.astype(np.int32)


class TokenPipeline:
    """Iterator of training batches shaped (M, mb, S) for grad accumulation."""

    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 microbatches: int = 1, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.microbatches = microbatches
        self.seed = seed
        self._cursor = 0

    def next_host_batch(self) -> dict:
        """``{"tokens", "labels"}``, each (M, global_batch // M, seq_len)
        int32; labels are the tokens shifted by one."""
        idx = np.arange(self._cursor, self._cursor + self.global_batch)
        self._cursor += self.global_batch
        toks = _hash_tokens(self.seed, idx, self.seq_len + 1, self.vocab)
        M, B = self.microbatches, self.global_batch // self.microbatches
        return {
            "tokens": toks[:, :-1].reshape(M, B, self.seq_len),
            "labels": toks[:, 1:].reshape(M, B, self.seq_len),
        }

    def state(self) -> dict:
        return {"cursor": self._cursor, "seed": self.seed}

    def restore(self, st: dict) -> None:
        self._cursor = int(st["cursor"])
        self.seed = int(st["seed"])
