"""Deterministic data pipeline: synthetic LM batches, host-sharded.

Synthetic sequences are a seeded Markov-ish token stream with enough
structure that cross-entropy visibly falls during the example training
runs. ``ShardedLoader`` yields only this host's slice of the global
batch (data-parallel ingestion); ``skip_to(step)`` gives exact resume
after checkpoint restart. The draws are the reference's, from the same
``np.random.RandomState`` calls; batches are int32 CPU tensors, which
the train step moves to its device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_patterns: int = 64):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        rng = np.random.RandomState(seed)
        # structured source: each sequence interleaves a repeated motif
        # with noise, so an LM can reach well below uniform entropy
        self.motifs = rng.randint(0, vocab, size=(n_patterns, 8))

    def batch(self, step: int, host_slice: slice = slice(None)):
        rng = np.random.RandomState(self.seed * 100003 + step)
        B, S = self.global_batch, self.seq_len
        m = rng.randint(0, len(self.motifs), size=B)
        toks = np.tile(self.motifs[m], (1, S // 8 + 2))[:, :S + 1]
        noise = rng.randint(0, self.vocab, size=(B, S + 1))
        mask = rng.rand(B, S + 1) < 0.15
        toks = np.where(mask, noise, toks).astype(np.int32)
        toks = toks[host_slice]
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}


class ShardedLoader:
    """Iterator over this host's shard of the global batch."""

    def __init__(self, source: SyntheticLM, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0):
        if source.global_batch % n_hosts:
            raise ValueError(f"a global batch of {source.global_batch} does "
                             f"not split over {n_hosts} hosts")
        per = source.global_batch // n_hosts
        self.slice = slice(host_id * per, (host_id + 1) * per)
        self.source = source
        self.step = start_step

    def skip_to(self, step: int):
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.source.batch(self.step, self.slice)
        self.step += 1
        return b
