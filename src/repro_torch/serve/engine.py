"""Batched serving engine: continuous batching over prefill + decode steps.

The port's counterpart of ``repro.serve.engine`` (topology-blind; placing
the cache over a topology belongs to the distributed slice).

Engine loop:
  1. admit: pack waiting requests into free slots (up to ``max_batch``),
     prefill each alone and copy its cache rows into the live batch cache
     at its slot;
  2. step: one batched decode_step for the whole batch, each slot at its
     own position;
  3. retire: slots whose request hit EOS/max_tokens free up.

The engine keeps its own host-clock spans (``timing``): seconds spent in
prefills and in decode steps, and each request's submit and first-token
times.  Each span ends where the engine reads a token back to the host,
which waits for the card's work on the stream, so it holds that work.

The engine runs on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA it raises instead of carrying on on the CPU.  It
takes no context, as the reference's engine does not (its prefill passes
none), so it refuses the encdec and vlm families (:func:`refuse_context`):
those serve through ``lm.prefill(..., ctx_embeds)`` and ``lm.decode_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.params import tree_map
from repro_torch.testing.timing import now


#: prompt tokens that key a request's prefix for routing
PREFIX_TOKENS = 16


def prefix_key(prompt: np.ndarray) -> tuple:
    """Hashable key of the prompt head (the prefix a pod's cache can reuse)."""
    return tuple(int(t) for t in np.asarray(prompt)[:PREFIX_TOKENS])


class PromptTooLongError(ValueError):
    """Prompt does not fit the engine's cache: the cache holds ``max_seq``
    positions and the first decode writes at position ``len(prompt)``, so
    admissible prompts satisfy ``len(prompt) <= max_seq - 1``."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int | None = None             # set at admit (observability)
    t_submit: float = 0.0               # host clock at submit
    t_first: float = 0.0                # host clock when its first token was read


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 256
    eos_id: int = 0


def validate_prompt(prompt, max_seq: int) -> int:
    """Shared submit()-time gate: returns the prompt length or raises
    :class:`PromptTooLongError` (a cache overflow waiting to happen) /
    ``ValueError`` (empty prompt)."""
    plen = int(np.asarray(prompt).shape[0])
    if plen < 1:
        raise ValueError("empty prompt")
    if plen >= max_seq:
        raise PromptTooLongError(
            f"prompt length {plen} >= max_seq {max_seq}: decode would "
            f"write position {plen} into a {max_seq}-position cache")
    return plen


def refuse_context(cfg) -> None:
    """Raise for a model whose decoder reads a context (encdec, vlm): the
    engines take none."""
    if cfg.family in lm.CONTEXT_FAMILIES:
        raise ValueError(
            f"{cfg.name} is a {cfg.family} model, whose decoder attends to a "
            f"context; the serving engines take no context (ctx_embeds), as "
            f"the reference's engine does not: serve it through "
            f"lm.prefill(..., ctx_embeds) and lm.decode_step")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present if asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


class ServingEngine:
    def __init__(self, model: lm.Model, scfg: ServeConfig, *, device="cuda"):
        refuse_context(model.cfg)
        self.device = resolve_device(device)
        self.cfg = cfg = model.cfg
        self.model = model.to(self.device)
        self.params = self.model.tree()
        self.scfg = scfg
        B, S = scfg.max_batch, scfg.max_seq
        self.cache = tree_map(
            lambda pv: torch.zeros(pv.shape, dtype=pv.dtype, device=self.device),
            lm.cache_defs(cfg, B, S))
        self.slots: list[Request | None] = [None] * B
        self.slot_pos = np.zeros(B, np.int64)       # per-slot next position
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        self.peak_live = 0                  # high-water mark of live slots
        self.timing = {"prefill_s": 0.0, "prefills": 0,
                       "decode_s": 0.0, "decode_steps": 0}

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        validate_prompt(req.prompt, self.scfg.max_seq)
        req.t_submit = now()
        self.waiting.append(req)

    @property
    def n_live(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def capacity(self) -> int:
        return self.scfg.max_batch

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.waiting:
            req = self.waiting.pop(0)
            slot = free.pop(0)
            req.slot = slot
            t0 = now()
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                   device=self.device)[None, :]
            cache, logits = lm.prefill(self.params, toks, self.cfg,
                                       self.scfg.max_seq)
            req.out.append(int(torch.argmax(logits[0, -1])))
            req.t_first = now()
            self.timing["prefill_s"] += req.t_first - t0
            self.timing["prefills"] += 1
            # copy this request's cache rows into the live batch cache in
            # place (JAX builds a new tree with big.at[:, slot].set(...))
            _merge(self.cache, cache, slot)
            self.slots[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self.peak_live = max(self.peak_live, self.n_live)

    # -- decode --------------------------------------------------------------
    def _live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def step(self) -> bool:
        self._admit()
        live = self._live()
        if not live:
            return False
        t0 = now()
        B = self.scfg.max_batch
        tok = np.zeros((B, 1), np.int64)
        for i in live:
            tok[i, 0] = self.slots[i].out[-1]
        # per-slot true positions: each slot writes its own ring slot and
        # masks at its own depth (dead slots carry a stale position and
        # write into their own retired rows — overwritten at next admit)
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        logits, self.cache = lm.decode_step(
            self.params, torch.as_tensor(tok, device=self.device), self.cache,
            pos, self.cfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.timing["decode_s"] += now() - t0
        self.timing["decode_steps"] += 1
        for i in live:
            req = self.slots[i]
            t = int(nxt[i])
            req.out.append(t)
            self.slot_pos[i] += 1
            if t == self.scfg.eos_id or \
                    len(req.out) >= req.max_new_tokens or \
                    self.slot_pos[i] >= self.scfg.max_seq - 1:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
        return True

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                break
        return self.finished


def _merge(big: dict, small: dict, slot: int) -> None:
    for k, v in small.items():
        if isinstance(v, dict):
            _merge(big[k], v, slot)
        else:
            big[k][:, slot] = v[:, 0]
