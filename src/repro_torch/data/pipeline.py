"""Deterministic synthetic token pipeline with host slicing and prefetch.

Counterpart of ``repro.data.pipeline``, in numpy (a copy, not an import):
every host materializes only its own slice of the global batch, and a batch
is a pure function of (seed, step, host), so a restarted job regenerates
bit-identical data for any step without coordination.  :meth:`batch_at`
equals the reference's bit for bit.  The reference's ``shard_batch``, which
places a batch on a device mesh, has no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Zipfian token stream with structure (the next token mostly follows
    from the previous one), so losses fall during a training run."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"a global batch of {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        probs = 1.0 / np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` and ``labels`` (host batch, seq_len) int32 for
        ``step``: a pure function of (seed, step, host)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = self.host_batch, cfg.seq_len
        fresh = rng.choice(cfg.vocab, size=(b, s + 1), p=self._probs)
        # 75% of positions follow t+1 = (t*7+3) % V
        follow = rng.random((b, s)) < 0.75
        base = np.empty((b, s + 1), dtype=np.int64)
        base[:, 0] = fresh[:, 0]
        for t in range(s):      # in order, so the chain is self-consistent
            nxt = (base[:, t] * 7 + 3) % cfg.vocab
            base[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t + 1])
        return {"tokens": base[:, :-1].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[Dict[str, np.ndarray]]:
        """The batches from ``start_step`` on, made ahead by a background
        thread."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
