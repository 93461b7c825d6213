"""Synthetic LM token pipeline (own copy of ``repro.data.pipeline``).

``batch_at(step)`` is a pure function of ``(seed, step)`` built from a
SplitMix64 counter hash, so the port draws exactly the reference's prompts.
Tokens follow a noisy affine recurrence ``t[i+1] = (a * t[i] + 1 + eps)
mod V`` with document resets.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — counter-based, vectorised."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class TokenBatch:
    tokens: np.ndarray     # (B, S) int32 — inputs
    labels: np.ndarray     # (B, S) int32 — next-token targets


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise_vocab: int = 17          # eps in [0, noise_vocab)
    doc_len: int = 256             # document reset period
    a_mult: int = 31               # affine recurrence multiplier

    def _rows(self, step: int, row_ids: np.ndarray) -> TokenBatch:
        S, V = self.seq_len, self.vocab
        base = (np.uint64(self.seed) << np.uint64(40)) \
            + (np.uint64(step) << np.uint64(20))
        row_seed = _mix(base + row_ids.astype(np.uint64))        # (b,)
        n_tok = S + 1
        pos = np.arange(n_tok, dtype=np.uint64)[None, :]
        h = _mix(row_seed[:, None] ^ _mix(pos))                  # (b, S+1)
        eps = (h % np.uint64(self.noise_vocab)).astype(np.int64)
        doc_id = (np.arange(n_tok) // self.doc_len).astype(np.uint64)[None, :]
        starts = (_mix(row_seed[:, None] ^ _mix(doc_id + np.uint64(7)))
                  % np.uint64(V)).astype(np.int64)
        toks = np.empty((len(row_ids), n_tok), np.int64)
        toks[:, 0] = starts[:, 0]
        for i in range(1, n_tok):
            fresh = (i % self.doc_len) == 0
            nxt = (self.a_mult * toks[:, i - 1] + 1 + eps[:, i]) % V
            toks[:, i] = np.where(fresh, starts[:, i], nxt)
        return TokenBatch(tokens=toks[:, :-1].astype(np.int32),
                          labels=toks[:, 1:].astype(np.int32))

    def batch_at(self, step: int) -> TokenBatch:
        return self._rows(step, np.arange(self.global_batch))

    def local_batch_at(self, step: int, shard: int,
                       n_shards: int) -> TokenBatch:
        """Shard ``shard`` of ``n_shards`` of step ``step``'s global batch
        (the shards concatenate to :meth:`batch_at`)."""
        if self.global_batch % n_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        per = self.global_batch // n_shards
        return self._rows(step, np.arange(shard * per, (shard + 1) * per))

    def uniform_nll(self) -> float:
        """Loss of the know-nothing predictor (upper baseline)."""
        return float(np.log(self.vocab))

    def oracle_nll(self) -> float:
        """Loss of the perfect predictor knowing the recurrence (~log eps)."""
        return float(np.log(self.noise_vocab))
