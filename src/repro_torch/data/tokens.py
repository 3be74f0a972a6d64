"""Deterministic synthetic LM token pipeline (sharded, seedable, restartable).

Generates structured pseudo-text (Zipf-distributed unigrams + short-range
repetition so a real LM can actually reduce loss) as fixed-shape batches.
Each (step, shard) pair is derived purely from the seed — restart at any
step reproduces the same stream (checkpoint/restart correctness), and each
data shard draws disjoint substreams (no cross-host coordination needed,
the 1000-node property).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    seed: int = 0
    zipf_a: float = 1.3
    repeat_p: float = 0.3


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, shard_id: int = 0):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.shard_id = shard_id
        self.local_batch = cfg.global_batch // cfg.n_shards

    def batch_at(self, step: int) -> dict:
        """{tokens, labels} for this shard at `step` — pure function of
        (seed, step, shard)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard_id)
        shape = (self.local_batch, cfg.seq_len + 1)
        base = rng.zipf(cfg.zipf_a, size=shape)
        toks = np.clip(base, 1, cfg.vocab - 1).astype(np.int32)
        # Short-range repetition: with prob repeat_p copy the token 2 back.
        rep = rng.uniform(size=shape) < cfg.repeat_p
        toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
