"""Continuous-batching scheduler: admission, slot assignment, preemption
(port of ``repro.serve.scheduler``, without its prefix-cache admission).

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
        req.state = WAITING
        req.preemptions += 1
        self.waiting.appendleft(req)

    def ensure_decode_capacity(self):
        """Give every running request room for its next position; preempt
        youngest-first inside a group when its freelist runs dry.  Returns
        the requests preempted this round."""
        preempted = []
        for slot in range(self.n_slots):
            req = self.slots[slot]
            if req is None:
                continue
            need = self.cache.blocks_for(req.num_cached + 1)
            while need > len(req.block_ids):
                g = self.group_of_slot(slot)
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
        req.state = FINISHED
