"""Data pipeline: deterministic synthetic token streams and batch packing.

The numpy part of ``repro.data``, copied as it is, so the port's batches
are bit-identical to ``repro``'s for the same seed and step:

* ``SyntheticLM`` — a deterministic Zipf-ish Markov stream (seeded,
  resumable by step index),
* ``pack_indices`` / ``pack_batch`` — a heterogeneous per-data-shard sample
  allocation (Algorithm 1): each micro-batch split unevenly across shards,
  every shard zero-padded to ``B_max = max_d y_d``.

``repro``'s ``shard_batch`` (placement on a JAX mesh) has no counterpart:
``TrainStep.shard_batch`` puts a batch on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic structured token stream (learnable bigram structure)."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    n_codebooks: int = 1
    prefix_len: int = 0
    prefix_dim: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # sparse bigram transition table: each token has 4 likely successors
        self._succ = rng.randint(0, v, size=(v, 4))

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.RandomState((self.seed * 9176 + step) % (2 ** 31))
        n_str = self.n_codebooks if self.n_codebooks > 1 else 1
        toks = np.zeros((batch_size, n_str, self.seq_len), np.int32)
        cur = rng.randint(0, self.vocab_size, size=(batch_size, n_str))
        toks[:, :, 0] = cur
        for t in range(1, self.seq_len):
            pick = rng.randint(0, 4, size=cur.shape)
            nxt = self._succ[cur, pick]
            noise = rng.rand(*cur.shape) < 0.1
            rand = rng.randint(0, self.vocab_size, size=cur.shape)
            cur = np.where(noise, rand, nxt)
            toks[:, :, t] = cur
        out = {"tokens": toks if self.n_codebooks > 1 else toks[:, 0]}
        if self.prefix_len:
            out["prefix"] = rng.randn(batch_size, self.prefix_len,
                                      self.prefix_dim).astype(np.float32) * 0.02
        return out


def pack_indices(shard_alloc, n_micro: int):
    """Gather indices + validity realizing a heterogeneous batch packing.

    Returns ``(idx, valid)`` of shape ``(dp, n_micro, B_max)``: shard ``d``'s
    row ``m * B_max + b`` holds input row ``idx[d, m, b]`` when
    ``valid[d, m, b]`` (micro-batch ``m`` = input rows
    ``[m * micro_batch, (m+1) * micro_batch)``, split consecutively across
    shards per ``shard_alloc``), and zero padding otherwise.
    """
    alloc = [int(y) for y in shard_alloc]
    if any(y < 0 for y in alloc) or sum(alloc) <= 0:
        raise ValueError(f"invalid shard allocation {shard_alloc}")
    micro_batch, b_max = sum(alloc), max(alloc)
    offs = np.cumsum([0] + alloc[:-1])
    idx = np.zeros((len(alloc), n_micro, b_max), np.int64)
    valid = np.zeros((len(alloc), n_micro, b_max), bool)
    for d, (y, o) in enumerate(zip(alloc, offs)):
        for m in range(n_micro):
            idx[d, m, :y] = m * micro_batch + o + np.arange(y)
            valid[d, m, :y] = True
    return idx, valid


def pack_batch(batch: dict, shard_alloc, n_micro: int) -> dict:
    """Re-lay a host batch for a heterogeneous per-shard sample allocation.

    Input arrays are ``(n_micro * sum(shard_alloc), ...)``; the output is
    ``(dp * n_micro * B_max, ...)`` (shard-major, then micro-batch, then
    sample slot) with invalid slots zeroed — ready for the train specs'
    ``(pod, data)`` batch sharding.  Every input sample appears exactly once.
    """
    idx, valid = pack_indices(shard_alloc, n_micro)
    flat_idx, flat_valid = idx.reshape(-1), valid.reshape(-1)
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.shape[0] != n_micro * sum(int(y) for y in shard_alloc):
            raise ValueError(f"batch[{k!r}] has {a.shape[0]} rows; expected "
                             f"{n_micro} micro-batches of {sum(shard_alloc)}")
        g = a[flat_idx].copy()
        g[~flat_valid] = 0
        out[k] = g
    return out
