"""The synthetic corpus: Zipfian unigrams with per-document Markov structure.

The port's copy of ``DataConfig`` and ``SyntheticCorpus`` from
``repro.data.pipeline`` (one host: the host-sharding and prefetch fields,
which only the trainer reads, come with the training slice).  Rows are a
pure function of (seed, step, row), the same numbers as the JAX package's
for the same config.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512


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
