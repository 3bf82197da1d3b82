"""The synthetic corpus and the trainer's data pipeline.

The port's copy of ``repro.data.pipeline``: ``DataConfig``,
``SyntheticCorpus`` (Zipfian unigrams with per-document Markov structure),
``global_batch``, and ``Pipeline`` / ``make_pipeline``.  Row ``g`` of the
global batch at ``step`` is a pure function of (seed, step, g), the same
numbers as the JAX package's, so:

* every host makes exactly its shard (``n_hosts``, ``host_id``: global
  row ``host_id * per_host + r``), and the shards in host order are the
  one-host batch byte for byte;
* a restarted job replays the stream bit for bit from a checkpointed
  ``Pipeline.cursor`` (``Pipeline(cfg, start_step=cursor)``): there is no
  other loader state to save.

A worker thread makes the next ``prefetch`` batches ahead of the trainer.
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
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    prefetch: int = 2

    @property
    def per_host(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"into {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


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
        """The (per_host, seq_len) shard of global batch ``step`` for this
        host: row r is a pure function of (seed, step, global row id)."""
        cfg = self.cfg
        out = np.empty((cfg.per_host, cfg.seq_len), np.int32)
        for r in range(cfg.per_host):
            gidx = cfg.host_id * cfg.per_host + r      # global row id
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, gidx]))
            buf = []
            need = cfg.seq_len
            while need > 0:
                d = self._doc(rng)
                buf.append(d[:need])
                need -= len(d)
            out[r] = np.concatenate(buf)[: cfg.seq_len]
        return out


def global_batch(cfg: DataConfig, step: int) -> np.ndarray:
    """The full ``(global_batch, seq_len)`` batch at ``step``, whatever the
    host split: every host's shard concatenated in host order."""
    full = dataclasses.replace(cfg, n_hosts=1, host_id=0)
    return SyntheticCorpus(full).batch(step)


class Pipeline:
    """Prefetching iterator over this host's batches with a checkpointable
    **cursor**.

    ``cursor`` is the step of the next batch ``__next__`` hands out: the
    batches waiting in the prefetch queue do not advance it, so it is always
    safe to persist, and ``Pipeline(cfg, start_step=cursor)`` replays the
    stream bit for bit.  The worker queues ``(step, batch)`` pairs and
    ``__next__`` asserts the pairing, so a cursor/queue desync fails loudly.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.cursor = start_step
        self._corpus = SyntheticCorpus(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._produce,
                                        args=(start_step,), daemon=True)
        self._worker.start()

    def _produce(self, start_step: int):
        step = start_step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._corpus.batch(step)), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> "Pipeline":
        return self

    def __next__(self) -> np.ndarray:
        if self._stop.is_set():
            raise StopIteration
        step, batch = self._q.get()
        assert step == self.cursor, \
            f"pipeline desync: queued step {step} != cursor {self.cursor}"
        self.cursor += 1
        return batch

    def close(self):
        """Stop the worker; it exits within its one-second put timeout."""
        self._stop.set()


def make_pipeline(cfg: DataConfig, start_step: int = 0) -> Iterator[np.ndarray]:
    """Prefetching iterator over this host's batches from ``start_step``."""
    return Pipeline(cfg, start_step=start_step)
