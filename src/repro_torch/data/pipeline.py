"""Token data pipeline: synthetic LM stream + file-backed binary shards.

Synthetic stream: Zipf-distributed unigrams overlaid with deterministic
bigram structure (token t is followed by (t*7+3) % vocab with prob ~0.5)
so a capable model's loss decreases well below the unigram entropy — used
by the integration tests and the ~100M-param example run.

File-backed: flat uint16/uint32 binary shards, host-sharded by
(process_index, num_processes) for multi-host training.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None         # None -> synthetic
    dtype: str = "uint16"


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        while True:
            b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
            toks = np.empty((b, s), np.int32)
            toks[:, 0] = self.rng.choice(v, size=b, p=self.unigram)
            for t in range(1, s):
                follow = (toks[:, t - 1] * 7 + 3) % v
                rand = self.rng.choice(v, size=b, p=self.unigram)
                use_bigram = self.rng.random(b) < 0.5
                toks[:, t] = np.where(use_bigram, follow, rand)
            yield {"tokens": toks}


class BinaryShards:
    """Reads <path>/shard_*.bin flat token files."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 num_processes: int = 1):
        self.cfg = cfg
        files = sorted(f for f in os.listdir(cfg.path)
                       if f.endswith(".bin"))
        self.files = files[process_index::num_processes]
        if not self.files:
            raise FileNotFoundError(f"no shards for host {process_index}")
        self.rng = np.random.default_rng(cfg.seed + process_index)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        while True:
            for fname in self.files:
                arr = np.memmap(os.path.join(cfg.path, fname),
                                dtype=cfg.dtype, mode="r")
                n_windows = len(arr) // need
                order = self.rng.permutation(n_windows)
                for w in order:
                    chunk = np.asarray(arr[w * need:(w + 1) * need],
                                       np.int32)
                    toks = chunk.reshape(cfg.global_batch, cfg.seq_len + 1)
                    yield {"tokens": toks[:, :-1].copy()}


def make_pipeline(cfg: DataConfig, process_index: int = 0,
                  num_processes: int = 1, start: int = 0):
    """The stream from its seed, advanced past its first ``start``
    batches (drawn on the host and dropped), so that batch ``start`` comes
    next: a run resumed at step ``start`` trains on the batches an
    uninterrupted run would."""
    if cfg.path is None:
        stream = iter(SyntheticLM(cfg))
    else:
        stream = iter(BinaryShards(cfg, process_index, num_processes))
    for _ in range(start):
        next(stream)
    return stream
