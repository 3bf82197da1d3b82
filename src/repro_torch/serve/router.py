"""Cross-pod request router: a front end over several serving engines.

The port's counterpart of ``repro.serve.router``.  The router balances on
two signals, in order:

1. **prefix history**: a bounded, per-pod FIFO of recently routed prompt
   prefixes (:func:`repro_torch.serve.engine.prefix_key`).  A request whose
   prefix a pod has seen goes back to that pod, where the paged engine
   turns the affinity into shared-prefix block reuse (COW blocks still
   resident from the earlier request);
2. **pod load**: waiting + live requests; fresh prefixes go to the
   least-loaded pod, and among history hits the least-loaded hit wins.

The router never touches tokens or caches: routing only picks *which*
engine a request is submitted to, so per-request token streams are the
single-engine streams.  On one card the pods are engines that share one
``Model``.
"""
from __future__ import annotations

from .engine import Request, prefix_key


class PrefixRouter:
    """Route requests across engines on prefix history + load."""

    def __init__(self, engines, prefix_cap: int = 64):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        self.prefix_cap = prefix_cap
        # insertion-ordered dicts as bounded FIFO sets: stale prefixes age
        # out as pods recycle
        self._history: list[dict] = [{} for _ in self.engines]
        self.routed = [0] * len(self.engines)
        self.affinity_hits = 0

    def load(self, pod: int) -> int:
        e = self.engines[pod]
        return e.n_waiting + e.n_live

    def route(self, req: Request) -> int:
        """Submit ``req`` to the chosen pod's engine; returns the pod."""
        key = prefix_key(req.prompt)
        hits = [p for p, seen in enumerate(self._history) if key in seen]
        if hits:
            pod = min(hits, key=self.load)
            self.affinity_hits += 1
        else:
            pod = min(range(len(self.engines)), key=self.load)
        seen = self._history[pod]
        seen.pop(key, None)                 # refresh recency
        seen[key] = True
        while len(seen) > self.prefix_cap:
            seen.pop(next(iter(seen)))
        self.engines[pod].submit(req)
        self.routed[pod] += 1
        return pod

    # engine-shaped surface so the traffic generator can drive a router
    # exactly like a single engine
    submit = route

    @property
    def n_live(self) -> int:
        return sum(e.n_live for e in self.engines)

    @property
    def n_waiting(self) -> int:
        return sum(e.n_waiting for e in self.engines)

    @property
    def capacity(self) -> int:
        return sum(e.capacity for e in self.engines)

    @property
    def peak_live(self) -> int:
        return sum(e.peak_live for e in self.engines)

    @property
    def finished(self) -> list[Request]:
        return [r for e in self.engines for r in e.finished]

    def step(self) -> bool:
        return any([e.step() for e in self.engines])

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step() and self.n_waiting == 0:
                break
        return self.finished
