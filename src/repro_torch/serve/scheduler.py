"""Continuous-batching scheduler: admission, slot assignment, preemption
(port of ``repro.serve.scheduler``).

Policy (vLLM-style):

- The decode batch is ``n_slots`` fixed shape slots, split contiguously
  across the KV groups (slot s belongs to group ``s // slots_per_group``).
- **Admission**: a free slot takes the oldest waiting request whose whole
  resident sequence (prompt + already-generated tokens after a preemption)
  fits the slot's group freelist.  FCFS with holes: a younger short request
  may pass an older one that doesn't fit yet.
- **Growth**: before each decode step every running request that is about
  to cross a block boundary gets one more block from its group.
- **Preemption by eviction**: if the group freelist is empty, the
  youngest-admitted running request in that group is evicted — its blocks
  are freed, its generated-so-far tokens are folded into its prompt, and it
  re-enters the FRONT of the waiting queue for a later re-prefill.  The
  sampler's position-keyed generator makes the replayed trajectory
  identical.
- **Prefix cache** (when the engine attaches a ``RadixPrefixCache``):
  admission shares a hit's full blocks (``pool.ref``), allocates only the
  rest, and evicts cold cache leaves before it gives up on a candidate;
  growth evicts a cold leaf before it preempts.
"""
from __future__ import annotations

import itertools
from collections import deque

from .kv_cache import PagedKVCache
from .sampling import SamplingParams

_RID = itertools.count()

WAITING, RUNNING, FINISHED, FAILED = "waiting", "running", "finished", "failed"


class Request:
    def __init__(self, prompt, sampling: SamplingParams | None = None,
                 eos_id: int = -1, rid=None, deadline_s: float | None = None,
                 ttft_budget_s: float | None = None, arrival_t: float = 0.0):
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        self.rid = rid if rid is not None else next(_RID)
        self.prompt = [int(t) for t in prompt]  # grows on preemption
        self.orig_prompt_len = len(self.prompt)
        # default is constructed per call: a shared default instance would
        # alias sampling state across every request created without one
        self.sampling = SamplingParams() if sampling is None else sampling
        self.eos_id = eos_id
        # SLO guardrails: wall-clock budgets the engine enforces with its
        # own clock; None = no budget
        self.deadline_s = deadline_s         # total completion budget
        self.ttft_budget_s = ttft_budget_s   # time-to-first-token budget
        self.arrival_t = arrival_t           # engine clock at add_request
        self.first_token_t: float | None = None
        self.last_emit_t: float | None = None
        self.nan_retries = 0                 # quarantine -> re-prefill count
        self.fail_reason = ""                # set when state == FAILED
        self.out_tokens: list = []   # generated since last (re-)prefill
        self.state = WAITING
        self.slot = None
        self.block_ids: list = []
        self.num_cached = 0          # positions materialized in the pool
        self.last_token = None       # next decode step's input token
        self.preemptions = 0
        self.admit_seq = -1          # admission order (preemption priority)
        self.prefix_hit = None       # PrefixHit consumed by the engine
        # speculative decoding: positions the DRAFT pool has materialized
        # (disposable: reset on preemption, the draft re-prefills), and
        # the positions the next decode round writes (1 = plain decode,
        # 1 + k proposals when the engine speculates)
        self.draft_cached = 0
        self.spec_lookahead = 1
        # prefill accounting: prompt positions already counted into the
        # prefix-cache stats, and the highest position ever materialized
        # (replayed chunks after a preemption are not new work); neither
        # is reset by preempt()
        self.prefill_counted = 0
        self.prefill_high = 0

    @property
    def seq_tokens(self):
        """Full resident sequence (prompt + generated) — re-prefill input."""
        return self.prompt + self.out_tokens

    @property
    def generated(self):
        """All tokens generated for this request, across preemptions."""
        return self.seq_tokens[self.orig_prompt_len:]

    @property
    def target_len(self) -> int:
        return self.orig_prompt_len + self.sampling.max_new_tokens

    @property
    def finished(self) -> bool:
        g = self.generated
        return (len(g) >= self.sampling.max_new_tokens
                or (self.eos_id >= 0 and bool(g) and g[-1] == self.eos_id))


class Scheduler:
    def __init__(self, cache: PagedKVCache, n_slots: int):
        if n_slots % cache.n_groups:
            raise ValueError(
                f"n_slots={n_slots} must divide over {cache.n_groups} "
                f"KV groups")
        self.cache = cache
        self.n_slots = n_slots
        self.slots_per_group = n_slots // cache.n_groups
        self.slots: list = [None] * n_slots
        self.waiting: deque = deque()
        self._admit_clock = 0
        # Admission cap <= n_slots: the engine lowers it (graceful decode-
        # batch shrink) after repeated pool-OOM preemption storms and raises
        # it back once the pool calms down.  Only gates NEW admissions.
        self.max_active = n_slots
        # Optional RadixPrefixCache (the engine attaches it): admission then
        # shares cached prefix pages
        self.prefix_cache = None
        # Requests FAILED at admission (prompt can never be resident); the
        # engine drains this list.
        self.admission_failures: list = []

    def group_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_group

    @property
    def running(self):
        return [r for r in self.slots if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(self.slots)

    def add(self, req: Request) -> Request:
        # target_len + 1: the final sampled token's position is written by
        # the decode step that produces it.
        if not self.cache.fits(req.target_len):
            raise ValueError(
                f"request {req.rid}: target length {req.target_len} can "
                f"never be resident (max_seq_len / pool capacity)")
        self.waiting.append(req)
        return req

    def admit(self):
        """Fill free slots from the waiting queue; returns admitted requests
        (the engine prefills them and sets num_cached/last_token)."""
        for req in [r for r in self.waiting
                    if not self.cache.fits(len(r.seq_tokens) + 1)]:
            self.waiting.remove(req)
            req.state = FAILED
            req.fail_reason = (
                f"prompt of {len(req.seq_tokens)} tokens can never be "
                f"resident: needs {self.cache.blocks_for(len(req.seq_tokens) + 1)} "
                f"blocks, pool capacity is {self.cache.pool.capacity(0)} "
                f"blocks/group")
            self.admission_failures.append(req)
        if self.prefix_cache is not None:
            return self._admit_with_prefix_cache()
        admitted = []
        for slot in range(self.n_slots):
            if len(self.running) >= self.max_active:
                break
            if self.slots[slot] is not None:
                continue
            g = self.group_of_slot(slot)
            pick = None
            for req in self.waiting:
                # +1: the first decode step after prefill writes position
                # len(seq); reserving it now avoids paying a full prefill
                # only to self-evict in the same engine step.
                if self.cache.blocks_for(len(req.seq_tokens) + 1) \
                        <= self.cache.pool.available(g):
                    pick = req
                    break
            if pick is None:
                continue
            self.waiting.remove(pick)
            blocks = self.cache.pool.alloc(
                g, self.cache.blocks_for(len(pick.seq_tokens) + 1))
            pick.block_ids = blocks
            pick.slot = slot
            pick.state = RUNNING
            pick.admit_seq = self._admit_clock
            self._admit_clock += 1
            self.slots[slot] = pick
            admitted.append(pick)
        return admitted

    def _admit_with_prefix_cache(self):
        """Admission consulting the radix cache: a hit's full blocks are
        shared (pool.ref), only the remainder is freshly allocated, and a
        dry freelist first evicts cold cache leaves before giving up on a
        candidate.  The same FCFS-with-holes policy as ``admit``."""
        pc = self.prefix_cache
        admitted = []
        for slot in range(self.n_slots):
            if len(self.running) >= self.max_active:
                break
            if self.slots[slot] is not None:
                continue
            g = self.group_of_slot(slot)
            pick = hit = None
            for req in self.waiting:
                seq = req.seq_tokens
                h = pc.lookup(g, seq, len(seq) - 1)
                need_new = (self.cache.blocks_for(len(seq) + 1)
                            - len(h.full_blocks))
                short = need_new - self.cache.pool.available(g)
                if short > 0:
                    # cold shareable leaves first; the hit path is pinned
                    pc.evict(g, short,
                             protect=set(h.full_blocks)
                             | ({h.cow_src} if h.cow_src is not None
                                else set()))
                    short = need_new - self.cache.pool.available(g)
                if short <= 0:
                    pick, hit = req, h
                    break
            if pick is None:
                continue
            self.waiting.remove(pick)
            need_new = (self.cache.blocks_for(len(pick.seq_tokens) + 1)
                        - len(hit.full_blocks))
            fresh = self.cache.pool.alloc(g, need_new)
            self.cache.pool.ref(hit.full_blocks)   # the request's own hold
            pick.block_ids = list(hit.full_blocks) + fresh
            pick.prefix_hit = hit
            pick.slot = slot
            pick.state = RUNNING
            pick.admit_seq = self._admit_clock
            self._admit_clock += 1
            self.slots[slot] = pick
            admitted.append(pick)
        return admitted

    def preempt(self, req: Request) -> None:
        """Evict: free pages, fold generated tokens into the prompt, requeue
        at the front for re-prefill."""
        self.cache.pool.free(req.block_ids)
        req.block_ids = []
        req.prompt = req.seq_tokens
        req.out_tokens = []
        req.slot = None
        req.num_cached = 0
        req.last_token = None
        req.prefix_hit = None
        req.draft_cached = 0         # draft pages may be reallocated
        req.spec_lookahead = 1
        req.state = WAITING
        req.preemptions += 1
        self.waiting.appendleft(req)

    def ensure_decode_capacity(self):
        """Give every running request room for its next position(s):
        ``spec_lookahead`` of them (1 for plain decode, 1 + k when the
        engine speculates, whose proposals need resident pages before
        verification).  A dry freelist first gives up a cold prefix-cache
        leaf, then preempts youngest-first inside the group.  Returns the
        requests preempted this round."""
        preempted = []
        for slot in range(self.n_slots):
            req = self.slots[slot]
            if req is None:
                continue
            need = self.cache.blocks_for(req.num_cached
                                         + max(1, req.spec_lookahead))
            while need > len(req.block_ids):
                g = self.group_of_slot(slot)
                got = self.cache.pool.alloc(g, 1)
                if got is None and self.prefix_cache is not None \
                        and self.prefix_cache.evict(g, 1):
                    got = self.cache.pool.alloc(g, 1)
                if got is not None:
                    req.block_ids.extend(got)
                    continue
                victim = max(
                    (r for r in self.running
                     if self.group_of_slot(r.slot) == g),
                    key=lambda r: r.admit_seq)
                self.slots[victim.slot] = None
                self.preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
        return preempted

    def retire(self, req: Request) -> None:
        self.cache.pool.free(req.block_ids)
        req.block_ids = []
        self.slots[req.slot] = None
        req.slot = None
        req.prefix_hit = None
        req.state = FINISHED
