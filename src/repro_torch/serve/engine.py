"""Batched serving engine: continuous batching over prefill + decode steps.

The port's counterpart of ``repro.serve.engine``.

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

**On a process mesh** (``rules``: a ``ShardingRules`` over a
``parallel.comm.Mesh``) the engine is SPMD: every rank runs the same
admit, step and retire loop on the same host state, and holds only its
block of the weights (``sharding.place_tree``) and of the cache, as the
cache rules place it.  A prefill runs as the reference's, the batch not
cut, tensor-parallel over `model`, and only the ranks that hold the
request's slot merge its rows.  A decode step runs each rank's slot rows,
tensor-parallel over `model`, and gathers the logits over the dimensions
that cut the slots, so that every rank picks the same greedy token.

Topology-aware serving (``topology=``, with a mesh) places the cache
*pod-locally*: its rules come from the inner topology levels only
(:func:`pod_local_cache_rules`), the slot dimension cut over the inner
data-parallel levels where the batch divides them, so the pod ring never
cuts a cache dimension.  Slots are partitioned into per-pod blocks, and
admission prefers a free slot of a pod that has served the request's
prompt prefix (a bounded FIFO of prefixes a pod).  Both only move where a
request lands, never what it computes; without a topology the engine keeps
the first-free order bit for bit.

The engine runs on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA it raises instead of carrying on on the CPU.  It
takes no context, as the reference's engine does not (its prefill passes
none), so it refuses the encdec and vlm families (:func:`refuse_context`):
those serve through ``lm.prefill(..., ctx_embeds)`` and ``lm.decode_step``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           param_placements, place_tree,
                                           rule_axes)
from repro_torch.params import tree_map
from repro_torch.testing.timing import now


#: prompt tokens that key a request's prefix for routing
PREFIX_TOKENS = 16


def pod_local_cache_rules(rules: ShardingRules, topology) -> ShardingRules:
    """Cache placement from the *inner* topology levels only: the outermost
    level's mesh dimensions stripped from every rule, so no cache dimension
    is ever cut across the pod ring and each pod holds (and reads) a whole
    replica of its slots' KV."""
    if rules.mesh is None or rules.rules is None or topology.n_levels < 2:
        return rules
    outer = set(topology.levels[0].axes)

    def strip(v):
        if v is None:
            return None
        axes = (v,) if isinstance(v, str) else tuple(v)
        kept = tuple(a for a in axes if a not in outer)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    return ShardingRules(rules.mesh, {k: strip(v) for k, v in rules.rules.items()})


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


def local_zeros(defs, rules: ShardingRules | None, device) -> dict:
    """Zeros of every leaf of a ``PV`` tree, each this rank's block under
    ``rules`` (whole off-mesh)."""
    if rules is None or rules.mesh is None:
        return tree_map(lambda pv: torch.zeros(pv.shape, dtype=pv.dtype,
                                               device=device), defs)
    specs = param_placements(defs, rules)

    def walk(d, sp):
        if isinstance(d, dict):
            return {k: walk(d[k], sp[k]) for k in d}
        return torch.zeros(local_shape(d.shape, sp, rules.mesh), dtype=d.dtype,
                           device=device)
    return walk(defs, specs)


class ServingEngine:
    def __init__(self, model: lm.Model, scfg: ServeConfig, *,
                 rules: ShardingRules | None = None, topology=None,
                 device="cuda"):
        """``model``'s weights whole or, under ``rules``, already this
        rank's blocks; ``topology`` (a ``repro_torch.topology.Topology``
        whose levels name the mesh's dimensions, outermost first) places the
        cache pod-locally and steers admission by prompt prefix."""
        refuse_context(model.cfg)
        self.device = resolve_device(device)
        self.cfg = cfg = model.cfg
        self.model = model.to(self.device)
        self.scfg = scfg
        self.topology = topology
        self.rules = rules = rules or ShardingRules()
        mesh = rules.mesh
        self.params = place_tree(self.model.tree(), lm.model_defs(cfg), rules)
        B, S = scfg.max_batch, scfg.max_seq
        cache_defs = lm.cache_defs(cfg, B, S)
        self.n_pods = 1
        cache_rules = rules
        if topology is not None:
            self.n_pods = topology.levels[0].size if topology.n_levels > 1 else 1
            if mesh is not None:
                cache_rules = pod_local_cache_rules(rules, topology)
                rr = dict(cache_rules.rules)
                if rr.get("batch") is None:
                    # the admit loop prefills one request at a time, so the
                    # serving rules leave the batch whole; the cache's slot
                    # dimension is still cut over the inner data-parallel
                    # levels where the slots divide them, the pod whole
                    inner_dp = tuple(a for lvl in topology.levels[1:-1]
                                     for a in lvl.axes if a in mesh.shape)
                    dp = math.prod(mesh.shape[a] for a in inner_dp)
                    if inner_dp and B % dp == 0:
                        rr["batch"] = inner_dp
                cache_rules = ShardingRules(mesh, rr)
        self.cache_rules = cache_rules
        #: the decode step's rules: the weights' placement, the cache's
        #: slot cut
        self.step_rules = rules if mesh is None else ShardingRules(
            mesh, {**rules.rules, "batch": cache_rules.rules["batch"]})
        self.cache_specs = param_placements(cache_defs, cache_rules)
        self.cache = local_zeros(cache_defs, cache_rules, self.device)
        self._slot_axes = rule_axes(self.step_rules, "batch")
        n = B // (mesh.axis_size(self._slot_axes) if self._slot_axes else 1)
        lo = mesh.index(self._slot_axes) * n if self._slot_axes else 0
        self.slot_rows = range(lo, lo + n)          # the slots this rank holds
        # per-pod recently served prompt prefixes (insertion-ordered dicts
        # as bounded FIFO sets: a pod's slots recycle, so its old prefixes'
        # KV is overwritten, and the history must not grow with distinct
        # prompts)
        self._prefix_cap = max(1, 4 * B // self.n_pods)
        self.pod_prefixes: list[dict] = [{} for _ in range(self.n_pods)]
        self.slots: list[Request | None] = [None] * B
        self.slot_pos = np.zeros(B, np.int64)       # per-slot next position
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        self.peak_live = 0                  # high-water mark of live slots
        self.timing = {"prefill_s": 0.0, "prefills": 0,
                       "decode_s": 0.0, "decode_steps": 0}
        #: set to a list to keep every greedy pick's logits on the host:
        #: ("prefill", rid, (V,)) and ("decode", live rids, (n_live, V))
        self.logit_log: list | None = None

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

    @property
    def mesh(self):
        return self.rules.mesh

    def slot_pod(self, slot: int) -> int:
        """Home pod of a slot: slots are partitioned into contiguous
        per-pod blocks (pod p serves slots [p*B/P, (p+1)*B/P))."""
        return slot * self.n_pods // self.scfg.max_batch

    def _remember_prefix(self, pod: int, key: tuple) -> None:
        seen = self.pod_prefixes[pod]
        seen.pop(key, None)                 # refresh recency
        seen[key] = True
        while len(seen) > self._prefix_cap:
            seen.pop(next(iter(seen)))      # FIFO-evict the oldest

    def _pick_slot(self, free: list[int], req: Request) -> int:
        """First free slot, preferring pods that already hold the request's
        prompt prefix (pod-local KV reuse).  Topology-blind engines keep
        the first-free order bit for bit."""
        if self.topology is None or self.n_pods == 1:
            return free[0]
        key = prefix_key(req.prompt)
        for slot in free:
            if key in self.pod_prefixes[self.slot_pod(slot)]:
                return slot
        return free[0]

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.waiting:
            req = self.waiting.pop(0)
            slot = self._pick_slot(free, req)
            free.remove(slot)
            self._remember_prefix(self.slot_pod(slot), prefix_key(req.prompt))
            req.slot = slot
            t0 = now()
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                   device=self.device)[None, :]
            cache, logits = lm.prefill(self.params, toks, self.cfg,
                                       self.scfg.max_seq, rules=self.rules)
            req.out.append(int(torch.argmax(logits[0, -1])))
            req.t_first = now()
            if self.logit_log is not None:
                self.logit_log.append(("prefill", req.rid, logits[0, -1].cpu()))
            self.timing["prefill_s"] += req.t_first - t0
            self.timing["prefills"] += 1
            # copy this request's cache rows into the live batch cache in
            # place (JAX builds a new tree with big.at[:, slot].set(...)),
            # on the ranks that hold the slot
            if slot in self.slot_rows:
                _merge(self.cache, cache, slot - self.slot_rows.start)
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
        # write into their own retired rows — overwritten at next admit);
        # under a mesh this rank's slot rows
        rows = slice(self.slot_rows.start, self.slot_rows.stop)
        pos = torch.as_tensor(self.slot_pos[rows], device=self.device)
        logits, self.cache = lm.decode_step(
            self.params, torch.as_tensor(tok[rows], device=self.device),
            self.cache, pos, self.cfg, rules=self.step_rules)
        if self._slot_axes:
            logits = comm.all_gather_raw(logits, self._slot_axes, self.mesh, dim=0)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.timing["decode_s"] += now() - t0
        if self.logit_log is not None:
            self.logit_log.append(("decode", [self.slots[i].rid for i in live],
                                  logits[live, 0].cpu()))
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
