"""Deterministic, shard-indexed synthetic token pipeline.

Port of ``repro/data/pipeline.py``: numpy only, so its arrays are the
reference's bit for bit; callers move them to the device.

Fault-tolerance property: batch(step, shard) is a pure function of
(seed, step, shard) — after any host failure the replacement host recomputes
exactly the shards it now owns, with no inter-host shuffle state to rebuild.
This is the data-side half of elastic restart (DESIGN.md §5).

The stream is a mixture of Zipfian unigrams and short Markov motifs so the
loss actually decreases (pure uniform noise would pin CE at log V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_shards: int = 1          # data-parallel shard count (hosts × replicas)
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 512


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # global motif table, identical on every host (derived from seed)
        self.motifs = root.integers(
            0, cfg.vocab, (cfg.n_motifs, cfg.motif_len)).astype(np.int32)

    def shard_batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        """One shard's slice of the global batch at ``step``."""
        cfg = self.cfg
        assert cfg.global_batch % cfg.n_shards == 0
        b = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + shard)
        # Zipfian base stream
        toks = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1)).astype(np.int64)
        toks = (toks - 1) % cfg.vocab
        # splice motifs (learnable structure)
        n_splice = max((cfg.seq_len // cfg.motif_len) // 4, 1)
        for i in range(b):
            ids = rng.integers(0, cfg.n_motifs, n_splice)
            pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len, n_splice)
            for m, p in zip(ids, pos):
                toks[i, p: p + cfg.motif_len] = self.motifs[m]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        parts = [self.shard_batch(step, s) for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([p[k] for p in parts], 0) for k in parts[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.global_batch(step)
            step += 1


class PrefetchingLoader:
    """Double-buffered host-side prefetch (overlaps batch synthesis /
    disk IO with device compute — the UVM-overlap analogue)."""

    def __init__(self, pipeline: TokenPipeline, start_step: int = 0):
        import threading
        import queue
        self.pipeline = pipeline
        self.q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = pipeline.global_batch(step)
                batch["_step"] = step
                self.q.put(batch)
                step += 1

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def next(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except Exception:
            pass
