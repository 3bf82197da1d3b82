"""The synthetic corpus and the trainer's data pipeline.

The port's copy of ``repro.data.pipeline``: ``DataConfig``,
``SyntheticCorpus`` (Zipfian unigrams with per-document Markov structure),
``global_batch``, and ``Pipeline`` / ``make_pipeline`` (a prefetching
iterator from step 0).  Rows are a pure function of (seed, step, row), the
same numbers as the JAX package's global batch for the same config.  The
port trains on one host from step 0: the host split and the resumable
cursor come with the distributed and the state-and-resilience slices.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512


#: the batches the pipeline's worker makes ahead of the trainer (the JAX
#: ``DataConfig.prefetch`` default)
PREFETCH = 2


class SyntheticCorpus:
    """Zipf-distributed tokens with Markov bigram structure + EOS-packed
    documents."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # stationary Zipf over the vocabulary
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.p = ranks ** (-cfg.zipf_a)
        self.p /= self.p.sum()
        # a cheap bigram: token t prefers a band around a random permutation
        self.perm = rng.permutation(V)

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        n = max(8, int(rng.exponential(cfg.mean_doc_len)))
        toks = rng.choice(cfg.vocab_size, size=n, p=self.p)
        # Markov-ize: with prob .5 follow the permutation of the previous
        follow = rng.random(n) < 0.5
        toks[1:] = np.where(follow[1:],
                            self.perm[toks[:-1]] % cfg.vocab_size, toks[1:])
        toks[-1] = 0                              # EOS = 0
        return toks.astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        """The (global_batch, seq_len) batch ``step``: row r is a pure
        function of (seed, step, r)."""
        cfg = self.cfg
        out = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        for r in range(cfg.global_batch):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, r]))
            buf = []
            need = cfg.seq_len
            while need > 0:
                d = self._doc(rng)
                buf.append(d[:need])
                need -= len(d)
            out[r] = np.concatenate(buf)[: cfg.seq_len]
        return out


def global_batch(cfg: DataConfig, step: int) -> np.ndarray:
    """The full ``(global_batch, seq_len)`` batch at ``step``."""
    return SyntheticCorpus(cfg).batch(step)


class Pipeline:
    """Iterator over the batches from step 0 on, a worker thread making the
    next ``PREFETCH`` of them ahead of the trainer."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._corpus = SyntheticCorpus(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._produce, daemon=True)
        self._worker.start()

    def _produce(self):
        step = 0
        while not self._stop.is_set():
            try:
                self._q.put(self._corpus.batch(step), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> "Pipeline":
        return self

    def __next__(self) -> np.ndarray:
        if self._stop.is_set():
            raise StopIteration
        return self._q.get()

    def close(self):
        """Stop the worker; it exits within its one-second put timeout."""
        self._stop.set()


def make_pipeline(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Prefetching iterator over the batches from step 0."""
    return Pipeline(cfg)
