"""Paged KV serving: block-table cache, COW prefix sharing, chunked prefill.

The port's counterpart of ``repro.serve.paged``.  Instead of one dense
``max_seq``-long KV region per slot, K/V live in a shared pool of
fixed-size token *blocks* (the VRF chunk map applied to serving).  Each
request holds a table of block ids; attention reads through the table
(``ops.paged_attention``); a free-list allocator hands blocks out on demand.
Block 0 is a reserved, permanently-zero block: unallocated table entries
read zeros, which is what the dense cache's unwritten rows hold, so paged
streams equal the dense engine's for the same admission order.

Prefix sharing: full prompt blocks are registered under their token-content
key and retained by later requests with the same prefix; a partially-filled
last block is keyed by the whole prompt.  Shared blocks are copy-on-write:
the first decode write into a refcount > 1 block copies it.

Chunked prefill (``PagedServeConfig.chunk``): prompts are prefilled in
fixed-size chunks, one per engine step, interleaved with decode steps, so
admitting a long prompt never stalls the running batch.

Block sizing: the JAX package caps ``block_tokens`` by a TPU register-group
budget; here a block must divide the paged-attention kernel's 64-token
round, which it stages in shared memory (:func:`max_block_tokens`).

The engine keeps the dense engine's host-clock spans (``timing``) and each
request's submit and first-token stamps.  It runs on the card unless the
caller asks for the CPU.

On a process mesh (``rules``) the engine is SPMD as the dense one is:
every rank runs the same allocator, tables and loop, holds its block of
the weights, and its kv heads of the pool (``lm.pool_defs``' ``kv`` cut,
the reference's ``constraint``); prefills, chunks and decode steps run
tensor-parallel over `model`, each rank's paged attention on its kv heads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels.paged_attention import TOKENS_PER_ROUND
from repro_torch.models import lm
from repro_torch.parallel.sharding import ShardingRules, param_placements, place_tree
from repro_torch.params import tree_leaves
from repro_torch.testing.timing import now
from .engine import (Request, local_zeros, refuse_context, resolve_device,
                     validate_prompt)

# chunked-prefill slot states
PREFILL, DECODE = 0, 1


def kv_token_bytes(cfg: ModelConfig) -> int:
    """KV bytes per token across the whole model (k+v, every attention
    sublayer instance): the unit of both engines' resident-bytes metrics."""
    n_attn = sum(kind == ATTN for layer in cfg.layer_period
                 for kind in layer) * cfg.n_periods
    return 2 * cfg.n_kv_heads * cfg.head_dim * cfg.dtype.itemsize * n_attn


def max_block_tokens(cfg: ModelConfig) -> int:
    """Largest block size the paged-attention kernel takes: it walks a
    sequence in rounds of 64 tokens staged in shared memory, so a block must
    divide 64 tokens, for every config it takes."""
    return TOKENS_PER_ROUND


@dataclasses.dataclass(frozen=True)
class PagedServeConfig:
    """``n_blocks`` counts *allocatable* blocks; the pool holds one more
    (the reserved zero block).  Equal-device-memory comparisons against the
    dense engine equate ``n_blocks * block_tokens`` with the dense
    ``max_batch * max_seq`` token-slots."""
    max_batch: int = 8
    max_seq: int = 256
    eos_id: int = 0
    block_tokens: int = 16
    n_blocks: int = 128
    chunk: int = 0          # 0 = whole-prompt prefill; else chunk length


class BlockAllocator:
    """Free-list allocator over fixed-size KV token blocks with refcounts
    and a shared-prefix registry.

    Block ids index the pool; id 0 is the reserved zero block: never
    allocated, never written by a live slot.  ``alloc`` optionally
    registers the block under a content key so later requests with the
    same prefix can ``lookup`` + ``retain`` it; the *engine* implements
    copy-on-write above this class and must ``forget_key`` a block before
    writing into it exclusively (the content diverges from the key)."""

    def __init__(self, n_blocks: int, block_tokens: int):
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self._free = list(range(self.n_blocks, 0, -1))   # pop() -> lowest id
        self.refcount = np.zeros(self.n_blocks + 1, np.int64)
        self._prefix: dict[tuple, int] = {}
        self._key_of: dict[int, tuple] = {}
        self.peak_allocated = 0
        self.shared_hits = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, key: tuple | None = None) -> int:
        if not self._free:
            raise RuntimeError("block pool exhausted (reservation bug: "
                               "admission must cover worst-case growth)")
        bid = self._free.pop()
        self.refcount[bid] = 1
        if key is not None:
            self.register(bid, key)
        self.peak_allocated = max(self.peak_allocated, self.n_allocated)
        return bid

    def lookup(self, key: tuple) -> int | None:
        return self._prefix.get(key)

    def retain(self, bid: int) -> int:
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"retain of free block {bid}")
        self.refcount[bid] += 1
        self.shared_hits += 1
        return bid

    def release(self, bid: int) -> None:
        if self.refcount[bid] <= 0:
            raise RuntimeError(f"release of free block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            self.forget_key(bid)
            self._free.append(bid)

    def register(self, bid: int, key: tuple) -> None:
        """Publish a block's content key (no-op if the key is taken: first
        writer wins; the duplicate block just stays private)."""
        if key in self._prefix:
            return
        self._prefix[key] = bid
        self._key_of[bid] = key

    def forget_key(self, bid: int) -> None:
        """Drop a block's registry entry before its content diverges."""
        key = self._key_of.pop(bid, None)
        if key is not None and self._prefix.get(key) == bid:
            del self._prefix[key]

    def assert_quiescent(self) -> None:
        """Shutdown hygiene gate: with no work in flight, every block must
        be back on the free list, every refcount zero (the zero block's
        too), and the shared-prefix registry empty.  A violation is a
        leaked reservation: invisible to correctness checks, fatal to a
        long-running server as the pool quietly shrinks.  Raises
        :class:`BlockLeakError` naming the leaked block ids."""
        problems = []
        live = [int(b) for b in np.nonzero(self.refcount)[0]]
        if live:
            counts = {b: int(self.refcount[b]) for b in live[:8]}
            problems.append(f"{len(live)} blocks with live refcounts "
                            f"(id -> count, first 8: {counts})")
        if self.n_free != self.n_blocks:
            problems.append(f"free list holds {self.n_free} of "
                            f"{self.n_blocks} blocks")
        if self._prefix or self._key_of:
            problems.append(f"prefix registry not empty "
                            f"({len(self._prefix)} keys, "
                            f"{len(self._key_of)} reverse entries)")
        if problems:
            raise BlockLeakError("; ".join(problems))


class BlockLeakError(RuntimeError):
    """A shutdown-time block-accounting violation; see
    :meth:`BlockAllocator.assert_quiescent`."""


class PagedServingEngine:
    """Continuous batching over a paged KV pool.

    Same loop as :class:`ServingEngine` (admit -> step -> retire) with
    three changes: (1) admission allocates block-table entries instead of
    a dense slot region, sharing full prefix blocks COW; (2) admission is
    *reservation-based*: a request is admitted only if the pool can cover
    its worst-case future growth plus every outstanding reservation, so a
    decode-time ``alloc`` can never fail; (3) with ``chunk`` set, prefill
    runs one fixed-size chunk per engine step, interleaved with the decode
    batch, instead of blocking on the whole prompt."""

    def __init__(self, model: lm.Model, scfg: PagedServeConfig, *,
                 rules: ShardingRules | None = None, device="cuda"):
        cfg = model.cfg
        refuse_context(cfg)
        if cfg.window:
            raise ValueError("paged serving supports full attention only")
        B, S, bt = scfg.max_batch, scfg.max_seq, scfg.block_tokens
        if S % bt:
            raise ValueError(f"max_seq {S} not a multiple of "
                             f"block_tokens {bt}")
        if scfg.chunk and (scfg.chunk % bt or S % scfg.chunk):
            raise ValueError(f"chunk {scfg.chunk} must be a multiple of "
                             f"block_tokens {bt} and divide max_seq {S}")
        cap = max_block_tokens(cfg)
        if cap % bt:
            raise ValueError(f"block_tokens {bt} must divide the paged-"
                             f"attention kernel's {cap}-token round")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.rules = rules = rules or ShardingRules()
        self.params = place_tree(self.model.tree(), lm.model_defs(cfg), rules)
        self.scfg = scfg
        self.max_blocks = S // bt
        pool_defs = lm.pool_defs(cfg, scfg.n_blocks + 1, bt)
        self.pool_specs = param_placements(pool_defs, rules)
        self.pool = local_zeros(pool_defs, rules, self.device)
        self.alloc = BlockAllocator(scfg.n_blocks, bt)
        self.tables = np.zeros((B, self.max_blocks), np.int32)
        self.slots: list[Request | None] = [None] * B
        self.slot_pos = np.zeros(B, np.int32)
        self.slot_state = np.full(B, DECODE, np.int32)
        self.slot_fill = np.zeros(B, np.int32)      # chunked-prefill progress
        self.slot_reserve = np.zeros(B, np.int64)   # worst-case future allocs
        self._slot_new: list[list[tuple[int, int]]] = [[] for _ in range(B)]
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        self.peak_live = 0
        self.cow_copies = 0
        self.timing = {"prefill_s": 0.0, "prefills": 0,
                       "chunk_s": 0.0, "chunks": 0,
                       "decode_s": 0.0, "decode_steps": 0}
        #: set to a list to keep every greedy pick's logits on the host:
        #: ("prefill", rid, (V,)) and ("decode", live rids, (n_live, V))
        self.logit_log: list | None = None

    # -- observability -------------------------------------------------------
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
    def decode_steps(self) -> int:
        return self.timing["decode_steps"]

    @property
    def prefill_chunks(self) -> int:
        return self.timing["chunks"]

    def kv_bytes_resident(self) -> int:
        return self.alloc.n_allocated * self.scfg.block_tokens \
            * kv_token_bytes(self.cfg)

    def kv_bytes_resident_peak(self) -> int:
        return self.alloc.peak_allocated * self.scfg.block_tokens \
            * kv_token_bytes(self.cfg)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        plen = validate_prompt(req.prompt, self.scfg.max_seq)
        bt = self.scfg.block_tokens
        worst = min(math.ceil((plen + req.max_new_tokens) / bt),
                    self.max_blocks)
        if worst > self.scfg.n_blocks:
            raise ValueError(
                f"request needs up to {worst} blocks but the pool holds "
                f"{self.scfg.n_blocks}")
        req.t_submit = now()
        self.waiting.append(req)

    def _plan(self, req: Request):
        """Admission plan: (table row, owned (blk_idx, key) list, shared
        bids, reservation).  None if the pool cannot cover this request's
        worst case plus every outstanding reservation."""
        bt = self.scfg.block_tokens
        prompt = np.asarray(req.prompt)
        plen = len(prompt)
        nfull = plen // bt
        row: list[int] = []
        own: list[tuple[int, tuple | None]] = []   # (blk_idx, registry key)
        shared: list[int] = []
        partial_shared = False
        for j in range(nfull):
            key = ("full", tuple(int(t) for t in prompt[:(j + 1) * bt]))
            bid = self.alloc.lookup(key)
            if bid is not None:
                row.append(bid)
                shared.append(bid)
            else:
                row.append(-1)
                own.append((j, key))
        if plen % bt:
            key = ("part", tuple(int(t) for t in prompt))
            bid = self.alloc.lookup(key)
            if bid is not None:
                row.append(bid)
                shared.append(bid)
                partial_shared = True
            else:
                row.append(-1)
                own.append((nfull, key))
        total = min(math.ceil((plen + req.max_new_tokens) / bt),
                    self.max_blocks)
        growth = total - len(row)
        # reservation: decode-time growth blocks, plus one COW copy if the
        # partial block is shared (full shared blocks are never written)
        reserve = growth + (1 if partial_shared else 0)
        if self.alloc.n_free < len(own) + reserve + int(self.slot_reserve.sum()):
            return None
        return row, own, shared, reserve

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.waiting:
            plan = self._plan(self.waiting[0])
            if plan is None:
                break                       # head-of-line waits for blocks
            row, own, shared, reserve = plan
            req = self.waiting.pop(0)
            slot = free.pop(0)
            req.slot = slot
            for bid in shared:
                self.alloc.retain(bid)
            new_bids = []
            chunked = bool(self.scfg.chunk)
            for j, key in own:
                # chunked prefill registers keys only once the content is
                # fully written (prefill completion), so a concurrent
                # admit never shares a half-filled block
                bid = self.alloc.alloc(None if chunked else key)
                row[row.index(-1)] = bid
                new_bids.append((j, bid))
            self._slot_new[slot] = new_bids
            self.tables[slot] = 0
            self.tables[slot, :len(row)] = row
            self.slot_reserve[slot] = reserve
            self.slots[slot] = req
            self.peak_live = max(self.peak_live, self.n_live)
            if chunked:
                self.slot_state[slot] = PREFILL
                self.slot_fill[slot] = 0
                self.slot_pos[slot] = 0
            else:
                self._prefill_whole(slot, req, len(row), new_bids)

    def _prefill_whole(self, slot: int, req: Request, n_row: int,
                       new_bids: list[tuple[int, int]]):
        """Whole-prompt admission: the dense engine's prefill (the same
        first token and K/V) over the prompt's blocks, then the newly owned
        blocks of its cache are copied into the pool; shared blocks already
        hold the same content and are skipped."""
        bt = self.scfg.block_tokens
        t0 = now()
        toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                               device=self.device)[None, :]
        cache, logits = lm.prefill(self.params, toks, self.cfg, n_row * bt,
                                   rules=self.rules)
        req.out.append(int(torch.argmax(logits[0, -1])))
        req.t_first = now()
        if self.logit_log is not None:
            self.logit_log.append(("prefill", req.rid, logits[0, -1].cpu()))
        self.timing["prefill_s"] += req.t_first - t0
        self.timing["prefills"] += 1
        if new_bids:
            js = torch.tensor([j for j, _ in new_bids], device=self.device)
            bids = torch.tensor([b for _, b in new_bids], device=self.device)
            for pool_leaf, cache_leaf in zip(tree_leaves(self.pool),
                                             tree_leaves(cache)):
                P, _, _, H, D = pool_leaf.shape
                blocks = cache_leaf[:, 0].reshape(P, n_row, bt, H, D)
                pool_leaf[:, bids] = blocks[:, js]
        self.slot_state[slot] = DECODE
        self.slot_pos[slot] = len(req.prompt)

    # -- chunked prefill -----------------------------------------------------
    def _prefill_step(self) -> bool:
        """Run ONE prefill chunk for the lowest-index PREFILL slot (at most
        one chunk of prefill work per engine step, so the decode batch never
        waits on a whole long prompt)."""
        pf = [i for i, s in enumerate(self.slots)
              if s is not None and self.slot_state[i] == PREFILL]
        if not pf:
            return False
        i = pf[0]
        req = self.slots[i]
        c = self.scfg.chunk
        prompt = np.asarray(req.prompt)
        plen = len(prompt)
        start = int(self.slot_fill[i])
        valid = min(c, plen - start)
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :valid] = prompt[start:start + valid]
        t0 = now()
        logits, self.pool = lm.prefill_chunk(
            self.params, torch.as_tensor(chunk, device=self.device), self.pool,
            self.tables[i], start, valid, self.cfg, rules=self.rules)
        # read every chunk's last real row back, so the span holds the
        # chunk's work on the card; only the final chunk's token is kept
        tok = int(torch.argmax(logits[0, valid - 1]))
        self.slot_fill[i] = start + valid
        if self.slot_fill[i] >= plen:
            req.out.append(tok)
            req.t_first = now()
            if self.logit_log is not None:
                self.logit_log.append(("prefill", req.rid,
                                       logits[0, valid - 1].cpu()))
            self.slot_state[i] = DECODE
            self.slot_pos[i] = plen
            # content now complete: publish the owned prompt blocks
            bt = self.scfg.block_tokens
            nfull = plen // bt
            for j, bid in self._slot_new[i]:
                if j < nfull:
                    key = ("full", tuple(int(t) for t in prompt[:(j + 1) * bt]))
                else:
                    key = ("part", tuple(int(t) for t in prompt))
                self.alloc.register(bid, key)
            self._slot_new[i] = []
        self.timing["chunk_s"] += now() - t0
        self.timing["chunks"] += 1
        return True

    # -- decode --------------------------------------------------------------
    def _ensure_writable(self, i: int):
        """Pre-step guarantee for slot i: the block holding position
        ``slot_pos[i]`` exists, is exclusively owned, and carries no
        registry key, so the step's write is a plain write.  On-demand
        alloc and COW both draw on the slot's reservation."""
        bt = self.scfg.block_tokens
        j = int(self.slot_pos[i]) // bt
        bid = int(self.tables[i, j])
        if bid == 0:
            self.tables[i, j] = self.alloc.alloc()
            self.slot_reserve[i] = max(0, self.slot_reserve[i] - 1)
        elif self.alloc.refcount[bid] > 1:
            nb = self.alloc.alloc()
            for leaf in tree_leaves(self.pool):
                leaf[:, nb] = leaf[:, bid]
            self.alloc.release(bid)
            self.tables[i, j] = nb
            self.cow_copies += 1
            self.slot_reserve[i] = max(0, self.slot_reserve[i] - 1)
        else:
            self.alloc.forget_key(bid)

    def _decode_live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and self.slot_state[i] == DECODE]

    def _retire(self, i: int):
        req = self.slots[i]
        req.done = True
        self.finished.append(req)
        for j in range(self.max_blocks):
            bid = int(self.tables[i, j])
            if bid:
                self.alloc.release(bid)
        self.tables[i] = 0
        self.slot_pos[i] = 0
        self.slot_fill[i] = 0
        self.slot_reserve[i] = 0
        self.slot_state[i] = DECODE
        self._slot_new[i] = []
        self.slots[i] = None

    def step(self) -> bool:
        self._admit()
        worked = False
        if self.scfg.chunk:
            worked |= self._prefill_step()
        live = self._decode_live()
        if live:
            for i in live:
                self._ensure_writable(i)
            t0 = now()
            B = self.scfg.max_batch
            tok = np.zeros((B, 1), np.int64)
            lv = np.zeros(B, bool)
            for i in live:
                tok[i, 0] = self.slots[i].out[-1]
                lv[i] = True
            logits, self.pool = lm.decode_step_paged(
                self.params, torch.as_tensor(tok, device=self.device),
                self.pool, self.tables, self.slot_pos, lv, self.cfg,
                rules=self.rules)
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
                    self._retire(i)
            worked = True
        return worked

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                break
        return self.finished

    def shutdown(self) -> None:
        """End-of-life hygiene: refuse to shut down over live work, then
        require the allocator quiescent (:class:`BlockLeakError` names any
        leaked blocks)."""
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if live or self.waiting:
            raise BlockLeakError(
                f"shutdown with work in flight: live slots {live}, "
                f"{len(self.waiting)} waiting requests")
        self.alloc.assert_quiescent()
