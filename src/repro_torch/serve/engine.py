"""Continuous-batching inference engine (port of ``repro.serve.engine``).

One ``InferenceEngine.step`` is: admit waiting requests into free slots,
prefill them (bucketed fixed shapes, per-request true lengths), scatter the
prefill cache into the paged pool, run ONE fixed-shape paged decode step for
the whole slot batch (mixed lengths, block-table reads and writes), sample
per request, retire finished sequences in place.

The decode batch shape never changes across steps — batch composition does:
retired slots point at the scratch block until re-admission.

SLO guardrails and chaos hardening kept from the reference: a bounded
admission queue (QueueFullError), per-request deadlines and TTFT budgets
against an injectable engine clock, a NaN/Inf logit guard that quarantines
only the poisoned slot (re-prefill with the position-keyed sampler keeps
its tokens), a graceful decode-batch shrink after repeated pool-OOM
preemption storms, and a healthy/degraded state in ``EngineStats``.  A
``runtime/faults.FaultInjector`` (default: the model's fault plan, its
``serve.*`` sites) drives all of it deterministically: ``serve.step``
(drop_step, straggler, pool_exhaust, device_loss), ``serve.logits`` (nan,
inf) and ``serve.prefix`` (evict, flush).  A device loss, or a call of
``replan_to``, re-plans the engine onto the surviving ranks
(``runtime/elastic.replan``: the tensor-parallel group is kept whole and
data shrinks) and moves every running request's resident KV blocks into
its new KV group's partition.

Shared-prompt serving: ``prefix_cache`` indexes prompt prefixes in a radix
tree over refcounted pool pages (``serve/prefix_cache.py``); a hit shares
the cached pages, copies a partly matching donor page copy-on-write, and
prefills only the rest.  The cache implies chunked prefill
(``prefill_chunk``, or an auto width): each step advances every pending
prompt by one fixed-width chunk written straight into the pool
(``DenseLM.prefill_chunk_paged``), interleaved with the decode batch.
Speculative decoding (``spec_k``): per round each slot gets up to k
proposals from the n-gram proposer or a draft model (``serve/spec.py``),
the target verifies them all in one multi-token forward
(``DenseLM.verify_chunk_paged``) and commits the accepted prefix plus one
correction or bonus token; greedy acceptance is exact and sampled
acceptance is rejection sampling, so the committed tokens are the plain
engine's.

Across ranks every rank runs this same host loop in lockstep (multi-
controller): each holds the same scheduler and allocator state and calls
the model's steps with the same host-layout inputs, and the steps return
logits that are the same bytes on every rank (gathered, not reduced).  So
every decision must come from replicated values only: the sampled ids (the
sampler is keyed by (seed, position)), the non-finite guard, and the clock
that deadlines and TTFT budgets read, which is rank 0's clock broadcast to
all (``_now``); each rank's own clock stamps only its statistics.  The
radix tree, the n-gram proposals, the draft's greedy argmax and the
accept/reject test read only host tokens and gathered logits, and a
copy-on-write copy writes only on the ranks of the slot's KV group.  The
fault plan is the same on every rank, so a fault fires on every rank at
the same engine step: a poisoned logit row is the same row everywhere, and
a device loss re-plans every rank at once.  After a re-plan the ranks past
the survivors are idle (``active`` False): their ``step`` returns ``[]``
and ``run`` ``{}``, and they call no collective of the new mesh.  Every
rank builds the new mesh's process groups, so a run re-plans across ranks
once.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..core.collectives import broadcast_scalar
from ..core.device import resolve_device
from ..core.mesh import AXES, Mesh, axis_index
from ..core.ops import Plan, kv_group_axes
from ..kernels.ops import effective_attn_impl
from ..models.registry import build_model
from ..runtime.elastic import replan
from ..runtime.faults import injector_from_run
from ..runtime.steps import page_copy, paged_reshard
from .kv_cache import BlockPool, PagedCacheConfig, PagedKVCache
from .prefix_cache import RadixPrefixCache
from .sampling import (SamplingParams, sample_tokens, slot_arrays,
                       spec_accept, spec_target_probs)
from .scheduler import FAILED, RUNNING, WAITING, Request, Scheduler
from .spec import DraftRunner, NgramProposer


class QueueFullError(RuntimeError):
    """Bounded admission queue is full — the caller must back off or shed
    load upstream."""


@dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    block_size: int = 8
    num_blocks: int = 64         # global, across all KV groups
    max_seq_len: int = 256
    prefill_batch: int = 0       # 0 -> ctx.data (smallest valid)
    eos_id: int = -1
    # --- SLO / resilience knobs ---
    max_waiting: int = 0         # bound on the waiting queue (0 = unbounded)
    nan_retry_limit: int = 2     # quarantine->re-prefill rounds before FAILED
    oom_shrink_after: int = 2    # consecutive preemption-storm steps -> shrink
    oom_recover_after: int = 8   # consecutive calm steps -> grow back
    # --- shared-prompt serving ---
    prefix_cache: bool = False   # radix prefix index over the block pool
    prefill_chunk: int = 0       # chunked prefill width (0 = monolithic;
    #                              prefix_cache implies the chunked path
    #                              with an auto-sized chunk)
    # --- speculative decoding ---
    spec_k: int = 0              # proposals per round (0 = plain decode)
    spec_mode: str = "auto"      # auto | draft | ngram: auto takes draft
    #                              when a draft model is attached, else the
    #                              model-free n-gram prompt-lookup fallback
    spec_ngram_max: int = 3      # longest n-gram the fallback matches


def _pcts(vals, qs=(50, 95, 99)):
    if not vals:
        return {f"p{q}_ms": 0.0 for q in qs}
    t = np.array(vals) * 1e3
    return {f"p{q}_ms": float(np.percentile(t, q)) for q in qs}


@dataclass
class EngineStats:
    steps: int = 0
    prefills: int = 0
    decode_steps: int = 0        # steps that ran the paged decode batch
    preemptions: int = 0
    tokens: int = 0
    token_times: list = field(default_factory=list)  # seconds per emitted token
    wall: float = 0.0
    # --- SLO latency breakdown (engine clock) ---
    ttfts: list = field(default_factory=list)    # arrival -> first token
    itls: list = field(default_factory=list)     # inter-token latencies
    # --- resilience counters ---
    health: str = "healthy"      # healthy | degraded
    shed: int = 0                # deadline / TTFT-budget sheds
    failed: int = 0              # requests terminally FAILED (incl. sheds)
    nan_quarantines: int = 0     # poisoned-slot quarantine -> re-prefill
    batch_shrinks: int = 0       # max_active reductions after OOM storms
    pool_exhaust_events: int = 0  # injected KV-pool exhaustion windows
    dropped_steps: int = 0       # injected lost engine iterations
    # --- shared-prompt serving ---
    prefix_lookups: int = 0      # admissions that consulted the radix cache
    prefix_hits: int = 0         # admissions that reused cached pages
    prefix_tokens_reused: int = 0  # prompt positions served from shared pages
    prefix_tokens_total: int = 0   # prompt positions admitted while cache on
    cow_splits: int = 0          # copy-on-write donor-page copies
    cache_evictions: int = 0     # cold cache leaves dropped (capacity, faults)
    prefill_chunks: int = 0      # chunk steps doing NEW work (replays after
    #                              a preemption don't count)
    chunk_steps: int = 0         # chunk steps run, replays included
    # --- speculative decoding ---
    spec_rounds: int = 0         # verify steps run
    spec_proposed: int = 0       # draft tokens judged by the target
    spec_accepted: int = 0       # draft tokens accepted verbatim
    spec_committed: int = 0      # tokens committed by verify rounds
    spec_slot_rounds: int = 0    # per-slot verify participations

    def tokens_per_s(self) -> float:
        return self.tokens / self.wall if self.wall else 0.0

    def acceptance_rate(self) -> float:
        """Fraction of judged proposals accepted verbatim."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def tokens_per_round(self) -> float:
        """Mean tokens committed per slot per verify round (a plain decode
        step commits 1 per active slot)."""
        return (self.spec_committed / self.spec_slot_rounds
                if self.spec_slot_rounds else 0.0)

    def cache_hit_rate(self) -> float:
        """Fraction of admitted prompt positions served from shared
        pages."""
        return (self.prefix_tokens_reused / self.prefix_tokens_total
                if self.prefix_tokens_total else 0.0)

    def latency_percentiles(self):
        return _pcts(self.token_times)

    def ttft_percentiles(self):
        return _pcts(self.ttfts)

    def itl_percentiles(self):
        return _pcts(self.itls)


class InferenceEngine:
    """Serve ``model`` (a repro_torch DenseLM) with a paged KV pool on
    ``device`` — the card unless the caller asks for the CPU; the model must
    already live there.  ``draft_model`` (a DenseLM of the target's vocab on
    the same device and mesh) drafts for ``spec_k`` > 0; ``injector``
    defaults to the model's fault plan, its ``serve.*`` sites."""

    def __init__(self, model, cfg: EngineConfig, *, device="cuda",
                 clock=None, draft_model=None, injector=None):
        self.model, self.cfg = model, cfg
        self._device = device
        self.draft_model = draft_model
        self.injector = (injector if injector is not None
                         else injector_from_run(model.run, sites=("serve",)))
        # injectable wall clock: deadline/TTFT tests drive a fake clock
        self.clock = clock or time.perf_counter
        self.active = True       # False on a rank a re-plan left idle
        self._hostage = None     # injected pool-exhaustion hold
        self._oom_streak = 0     # consecutive steps with preemptions
        self._calm_streak = 0    # consecutive steps without
        self._evict_carry = 0    # cache evictions from pre-replan caches
        self._build()
        self.stats = EngineStats()   # survive replan rebuilds
        self.requests = []

    def _build(self) -> None:
        """Everything that depends on the model's mesh: the decode plan,
        the pool and its allocator, the scheduler, the prefix cache and
        the proposer (``replan_to`` runs it again on the new mesh)."""
        model, cfg = self.model, self.cfg
        self.device = resolve_device(self._device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        if not hasattr(model, "decode_paged"):
            raise NotImplementedError(
                f"{type(model).__name__} has no paged decode path: serve it "
                f"through its prefill/decode steps")
        self.mesh = model.mesh
        ctx = model.ctx
        # resolved attention data path ("pallas" = the Hopper kernels)
        self.attn_impl = effective_attn_impl(ctx.attn_impl, self.device)
        self.plan = model.decode_plan(cfg.n_slots)
        if self.plan.kind == "decode" and cfg.n_slots % ctx.batch_shards:
            raise ValueError(
                f"n_slots={cfg.n_slots} must divide over "
                f"{ctx.batch_shards} token shards (or be < them to "
                f"downgrade the plan)")
        self.cache = PagedKVCache(
            model, self.plan,
            PagedCacheConfig(num_blocks=cfg.num_blocks,
                             block_size=cfg.block_size,
                             max_seq_len=cfg.max_seq_len))
        self.sched = Scheduler(self.cache, cfg.n_slots)
        self.pool = self.cache.init_arrays()
        self._b_pre = cfg.prefill_batch or max(1, ctx.data)
        if self._b_pre % ctx.data:
            raise ValueError("prefill_batch must divide over data")
        # sequence-shard divisor: (depth, row), or col in Megatron-SP
        self._seq_div = self.mesh.axis_size(ctx.seq_shard_axes)
        # this rank's partition of the pool starts at this global block id
        self._block0 = self.cache.group * self.cache.blocks_per_group
        # the prefix cache implies the chunked prefill: a hit resumes mid-
        # prompt, which the monolithic prefill cannot do without rewriting
        # the shared pages it reuses
        self._chunked = bool(cfg.prefix_cache or cfg.prefill_chunk > 0)
        self.prefix = None
        if cfg.prefix_cache:
            self.prefix = RadixPrefixCache(self.cache.pool, cfg.block_size)
            self.sched.prefix_cache = self.prefix
        self._spec_on = cfg.spec_k > 0
        self._draft = self._ngram = None
        self.spec_mode = None
        if self._spec_on:
            self._build_proposer()

    def _build_proposer(self) -> None:
        cfg, model, draft = self.cfg, self.model, self.draft_model
        mode = cfg.spec_mode
        if mode == "auto":
            mode = "draft" if draft is not None else "ngram"
        if mode not in ("draft", "ngram"):
            raise ValueError(f"spec_mode={cfg.spec_mode!r} not in "
                             f"(auto, draft, ngram)")
        if mode == "draft" and draft is None:
            raise ValueError("spec_mode='draft' needs a draft model")
        self.spec_mode = mode
        if mode == "ngram":
            self._ngram = NgramProposer(max_n=cfg.spec_ngram_max)
            return
        if draft.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(f"draft vocab {draft.cfg.vocab_size} != target "
                             f"vocab {model.cfg.vocab_size}")
        if (draft.device != self.device
                or dict(draft.mesh.sizes) != dict(self.mesh.sizes)
                or draft.mesh.coords != self.mesh.coords):
            raise ValueError("the draft model must live on the target's "
                             "device and mesh")
        self._draft = DraftRunner(draft, cfg.n_slots,
                                  self.cache.blocks_per_group,
                                  cfg.block_size)

    def _bucket(self, n: int) -> int:
        """Prefill bucket covering ``n`` tokens: power-of-two multiples of
        lcm(block_size, seq shards), clamped to the pool's maximum resident
        length (Scheduler.add guarantees n fits that)."""
        base = math.lcm(self.cfg.block_size, self._seq_div)
        cap = -(-self.cache.max_blocks * self.cfg.block_size // base) * base
        b = base
        while b < n and b < cap:
            b = min(b * 2, cap)
        return b

    def _tensor(self, a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(self.device, dtype)

    def _now(self) -> float:
        """The engine clock as every rank reads it: rank 0's reading,
        broadcast (one value for the decisions that deadlines and TTFT
        budgets take)."""
        return broadcast_scalar(self.mesh, self.clock(), self.device)

    # ------------------------------------------------------------- requests
    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    rid=None, deadline_s: float | None = None,
                    ttft_budget_s: float | None = None) -> Request:
        """sampling defaults PER CALL.  Raises QueueFullError when
        cfg.max_waiting bounds the queue."""
        if not self.active:
            raise RuntimeError("this rank left the mesh at a re-plan: its "
                               "engine takes no requests")
        if self.cfg.max_waiting and \
                len(self.sched.waiting) >= self.cfg.max_waiting:
            raise QueueFullError(
                f"admission queue full ({self.cfg.max_waiting} waiting)")
        req = Request(prompt, sampling, eos_id=self.cfg.eos_id, rid=rid,
                      deadline_s=deadline_s, ttft_budget_s=ttft_budget_s,
                      arrival_t=self._now())
        self.requests.append(req)
        return self.sched.add(req)

    def _fail(self, req: Request, reason: str) -> None:
        """Terminally fail one request, releasing whatever it holds."""
        if req.state == RUNNING:
            self.cache.pool.free(req.block_ids)
            req.block_ids = []
            self.sched.slots[req.slot] = None
            req.slot = None
        elif req.state == WAITING and req in self.sched.waiting:
            self.sched.waiting.remove(req)
        req.state = FAILED
        req.fail_reason = reason
        self.stats.failed += 1

    def _shed_expired(self) -> None:
        """Deadline / TTFT-budget enforcement: shed ONLY the expired
        requests (waiting or running); survivors are untouched.  Reads the
        clock (one broadcast across ranks) only when a request has a
        budget."""
        live = list(self.sched.waiting) + self.sched.running
        if all(r.deadline_s is None and r.ttft_budget_s is None
               for r in live):
            return
        now = self._now()
        for req in live:
            age = now - req.arrival_t
            if req.deadline_s is not None and age > req.deadline_s:
                self._fail(req, f"deadline ({req.deadline_s:g}s) exceeded")
                self.stats.shed += 1
            elif (req.ttft_budget_s is not None and req.first_token_t is None
                  and age > req.ttft_budget_s):
                self._fail(req, f"ttft budget ({req.ttft_budget_s:g}s) "
                                f"exceeded")
                self.stats.shed += 1

    def _record_emit(self, req: Request, now: float) -> None:
        """TTFT / inter-token latency accounting on the engine clock; ``now``
        is read once per batch, right after its sampled tokens reach the
        host, so every token of one batch carries the same stamp."""
        if req.first_token_t is None:
            req.first_token_t = now
            self.stats.ttfts.append(now - req.arrival_t)
        elif req.last_emit_t is not None:
            self.stats.itls.append(now - req.last_emit_t)
        req.last_emit_t = now

    def _quarantine(self, req: Request) -> None:
        """NaN/Inf logits in this request's slot: evict ONLY that slot and
        re-prefill it later.  Bounded by cfg.nan_retry_limit, then FAILED."""
        req.nan_retries += 1
        self.stats.nan_quarantines += 1
        if req.nan_retries > self.cfg.nan_retry_limit:
            self._fail(req, f"non-finite logits persisted through "
                            f"{self.cfg.nan_retry_limit} re-prefills")
            return
        self.sched.slots[req.slot] = None
        self.sched.preempt(req)

    @staticmethod
    def _finite_rows(logits) -> np.ndarray:
        """(rows,) bool: row i of the logit batch is sane.  -inf is a legit
        logit value (vocab padding, top-k/top-p masks); only NaN and +inf
        mark a poisoned row."""
        bad = torch.isnan(logits) | torch.isposinf(logits)
        return (~bad.any(dim=-1)).cpu().numpy()

    # -------------------------------------------------------------- prefill
    def _run_prefills(self, admitted):
        """Bucketed, batched prefill of newly admitted requests + scatter of
        their caches into the paged pool.  Returns the number of tokens
        emitted (one per request)."""
        admitted = sorted(admitted, key=lambda r: len(r.seq_tokens))
        emitted = 0
        for i in range(0, len(admitted), self._b_pre):
            chunk = admitted[i:i + self._b_pre]
            bucket = self._bucket(max(len(r.seq_tokens) for r in chunk))
            tokens = np.zeros((self._b_pre, bucket), np.int32)
            lengths = np.ones((self._b_pre,), np.int32)
            nb_bucket = bucket // self.cfg.block_size
            # scatter table: rows/blocks without a real target hit scratch
            tables = np.full((self._b_pre, nb_bucket),
                             self.cache.pool.scratch(0), np.int32)
            for j, req in enumerate(chunk):
                seq = req.seq_tokens
                tokens[j, :len(seq)] = seq
                lengths[j] = len(seq)
                nb_req = self.cache.blocks_for(len(seq))
                tables[j, :nb_req] = req.block_ids[:nb_req]
            logits, pcache = self.model.prefill(self._tensor(tokens),
                                                self._tensor(lengths))
            paged_reshard(self.pool, pcache, self._tensor(tables),
                          block0=self.cache.group
                          * self.cache.blocks_per_group)
            del pcache
            temps, ks, ps, seeds = slot_arrays([r.sampling for r in chunk]
                                               + [SamplingParams()]
                                               * (self._b_pre - len(chunk)))
            toks = sample_tokens(logits, temps, ks, ps, seeds, lengths)
            ok = self._finite_rows(logits)
            now = self.clock()    # one stamp for the whole sampled batch
            for j, req in enumerate(chunk):
                if not ok[j]:
                    # poisoned prefill: quarantine just this request
                    self._quarantine(req)
                    continue
                req.num_cached = len(req.seq_tokens)
                req.prefill_high = max(req.prefill_high, req.num_cached)
                tok = int(toks[j])
                req.out_tokens.append(tok)
                req.last_token = tok
                self._record_emit(req, now)
                emitted += 1
            self.stats.prefills += 1
        # a prefilled request may already be done (max_new_tokens == 1 after
        # a late preemption, or eos right away)
        for req in admitted:
            if req.state == RUNNING and req.finished:
                self.sched.retire(req)
        return emitted

    # ---------------------------------------------------- chunked prefill
    def _chunk_width(self, remaining: int) -> int:
        """Chunked-prefill width: the configured chunk, or (auto, when the
        prefix cache turned chunking on) the smallest power-of-two multiple
        of block_size covering the longest pending suffix, capped at the
        pool's maximum resident length."""
        if self.cfg.prefill_chunk > 0:
            return self.cfg.prefill_chunk
        cap = self.cache.max_blocks * self.cfg.block_size
        c = self.cfg.block_size
        while c < remaining and c < cap:
            c = min(c * 2, cap)
        return c

    def _apply_prefix_hits(self, admitted) -> None:
        """Consume the PrefixHit the scheduler attached at admission: count
        reuse, copy the copy-on-write donor page into the request's first
        private block, and mark the shared prefix as materialized so the
        chunked prefill starts at the divergence point."""
        for req in admitted:
            hit = req.prefix_hit
            self.stats.prefix_lookups += 1
            # each prompt position counts once per request: a request
            # preempted mid-prefill re-enters admission with the same
            # positions (prefill_counted is its high-water mark)
            seq_len = len(req.seq_tokens)
            self.stats.prefix_tokens_total += max(
                0, seq_len - req.prefill_counted)
            if hit is None or hit.tokens == 0:
                req.prefill_counted = max(req.prefill_counted, seq_len)
                continue
            if hit.cow_len:
                # the suffix prefill overwrites positions >= cow_len; the
                # causal mask hides the donor's stale tail until then
                page_copy(self.pool, [hit.cow_src],
                          [req.block_ids[len(hit.full_blocks)]],
                          block0=self._block0)
                self.stats.cow_splits += 1
            req.num_cached = hit.tokens
            self.stats.prefix_hits += 1
            self.stats.prefix_tokens_reused += max(
                0, hit.tokens - req.prefill_counted)
            req.prefill_counted = max(req.prefill_counted, seq_len)

    def _run_chunk_prefills(self) -> int:
        """One fixed-shape chunked-prefill step for every mid-prefill slot
        (running requests with no last_token yet), interleaved with decode:
        each engine step advances every pending prompt by one chunk, then
        the decode batch runs for the slots that hold a token.  A prompt
        that completes in this chunk samples its first token (at position
        len(seq), as the monolithic prefill does) and is indexed into the
        radix tree.  Returns the tokens emitted."""
        pending = [r for r in self.sched.running if r.last_token is None]
        if not pending:
            return 0
        n = self.cfg.n_slots
        width = self._chunk_width(
            max(len(r.seq_tokens) - r.num_cached for r in pending))
        ids = np.zeros((n, width), np.int32)
        pos = np.zeros((n,), np.int32)
        lens = np.zeros((n,), np.int32)
        slot_blocks = [[] for _ in range(n)]
        groups = [self.sched.group_of_slot(s) for s in range(n)]
        samplings = [SamplingParams()] * n
        take = {}
        for req in pending:
            s = req.slot
            seq = req.seq_tokens
            t = min(width, len(seq) - req.num_cached)
            ids[s, :t] = seq[req.num_cached:req.num_cached + t]
            pos[s] = req.num_cached
            lens[s] = t
            slot_blocks[s] = req.block_ids
            samplings[s] = req.sampling
            take[req.rid] = t
        tables = self.cache.make_table(slot_blocks, groups)
        logits = self.model.prefill_chunk_paged(
            self.pool, self._tensor(tables), self._tensor(ids),
            self._tensor(pos), self._tensor(lens))
        self.stats.chunk_steps += 1
        # new prefill work only where a slot passes its prefill_high mark:
        # a slot preempted mid-prefill replays positions it materialized
        if any(req.num_cached + take[req.rid] > req.prefill_high
               for req in pending):
            self.stats.prefill_chunks += 1
        finishing = [r for r in pending
                     if r.num_cached + take[r.rid] == len(r.seq_tokens)]
        emitted = 0
        if finishing:
            ok = self._finite_rows(logits)
            temps, ks, ps, seeds = slot_arrays(samplings)
            toks = sample_tokens(logits, temps, ks, ps, seeds, pos + lens)
            # one stamp at the completing chunk's sampled tokens, before
            # the per-slot bookkeeping below
            now = self.clock()
        for req in pending:
            if req not in finishing:
                req.num_cached += take[req.rid]
                req.prefill_high = max(req.prefill_high, req.num_cached)
                continue
            if not ok[req.slot]:
                self._quarantine(req)
                continue
            req.num_cached = len(req.seq_tokens)
            req.prefill_high = max(req.prefill_high, req.num_cached)
            if self.prefix is not None:
                # only fully covered prompt blocks are indexed, so decode's
                # appends at positions >= len(seq) never touch a shared page
                self.prefix.insert(groups[req.slot], req.seq_tokens,
                                   req.block_ids)
            tok = int(toks[req.slot])
            req.out_tokens.append(tok)
            req.last_token = tok
            self._record_emit(req, now)
            emitted += 1
        for req in finishing:
            if req.state == RUNNING and req.finished:
                self.sched.retire(req)
        return emitted

    # ------------------------------------------------------ fault plumbing
    def _exhaust_pool(self, idx: int, hold_steps: int) -> None:
        """Injected KV-pool exhaustion: take every free block hostage for
        ``hold_steps`` engine steps (drives the preemption storm and the
        batch-shrink recovery)."""
        held = []
        for g in range(self.cache.n_groups):
            n = self.cache.pool.available(g)
            if n:
                held.extend(self.cache.pool.alloc(g, n))
        self._hostage = {"blocks": held, "until": idx + max(1, hold_steps)}
        self.stats.pool_exhaust_events += 1

    def _release_hostages(self, idx: int) -> None:
        if self._hostage is not None and idx >= self._hostage["until"]:
            self.cache.pool.free(self._hostage["blocks"])
            self._hostage = None

    def _fire_step_faults(self, idx: int) -> bool:
        """Run the serve.step and serve.prefix injections due at engine step
        ``idx``; returns True when this iteration is dropped entirely."""
        dropped = False
        for spec in self.injector.fire("serve.step", idx):
            if spec.kind == "drop_step":
                dropped = True
            elif spec.kind == "straggler":
                time.sleep(spec.arg)
            elif spec.kind == "pool_exhaust":
                self._exhaust_pool(idx, int(spec.arg))
            elif spec.kind == "device_loss":
                if self.mesh.rank == 0:
                    print(f"[fault] serve step {idx}: device loss -> replan "
                          f"to {int(spec.arg)} devices", flush=True)
                self.replan_to(int(spec.arg))
                if not self.active:
                    return dropped
        for spec in self.injector.fire("serve.prefix", idx):
            if self.prefix is None:
                continue
            if spec.kind == "flush":
                self.prefix.flush()
            elif spec.kind == "evict":
                # forced eviction pressure: only refcount-1 leaves may go,
                # so pages shared with running requests survive
                want = max(1, int(spec.arg))
                for g in range(self.cache.n_groups):
                    self.prefix.evict(g, want)
        return dropped

    def _poison_logits(self, logits, idx: int) -> None:
        """The serve.logits injections due at step ``idx``: row ``arg %
        n_slots`` of the logits on the device set to NaN or +Inf (what a
        flaky accelerator hands the sampler), the same row on every
        rank."""
        if self.injector is None:
            return
        for spec in self.injector.fire("serve.logits", idx):
            logits[int(spec.arg) % logits.shape[0]] = (
                float("nan") if spec.kind == "nan" else float("inf"))

    def _update_health(self) -> None:
        degraded = (self.sched.max_active < self.cfg.n_slots
                    or self._hostage is not None)
        self.stats.health = "degraded" if degraded else "healthy"
        if self.prefix is not None:
            self.stats.cache_evictions = (self._evict_carry
                                          + self.prefix.evictions)

    # --------------------------------------------------------- speculation
    def _judge(self, req, rows, toks, proposals):
        """Accept/reject one slot's verify rows -> (committed, n_accepted).

        rows: [W, v_pad] target logits (row c governs position num_cached +
        c + 1); toks: [W] the plain sampler's draw at each row's position
        (the code path plain decode uses, so greedy acceptance is exact);
        proposals: the judged draft tokens.  Greedy: accept while proposal
        c equals the argmax, commit the first mismatching draw as the
        correction, or the last row's draw as a bonus on full acceptance.
        temperature > 0: rejection sampling against the post-mask target
        distribution (point-mass proposals), the residual drawn on
        rejection."""
        if req.sampling.temperature <= 0.0:
            committed, m = [], 0
            for c, d in enumerate(proposals):
                t = int(toks[c])
                committed.append(t)
                if t != int(d):
                    return committed, m
                m += 1
            committed.append(int(toks[len(proposals)]))
            return committed, m
        if not proposals:
            return [int(toks[0])], 0
        sp = req.sampling
        probs = spec_target_probs(rows[:len(proposals)], sp.temperature,
                                  sp.top_k, sp.top_p)
        committed, m = spec_accept(probs, proposals, None, sp.seed,
                                   req.num_cached)
        if m == len(proposals):
            committed.append(int(toks[len(proposals)]))
        return committed, m

    def _spec_round(self, running, idx: int):
        """One speculative decode round: propose up to k tokens per slot,
        verify them all in one multi-token forward over the block tables,
        commit the accepted prefix (+1 correction or bonus token) in place.
        A rejected suffix's K/V stays in the pool, but num_cached never
        passes the rejection point, so it is masked by position and
        overwritten by the next round.  Returns the [(rid, token)]
        emitted."""
        n = self.cfg.n_slots
        W = self.cfg.spec_k + 1
        groups = [self.sched.group_of_slot(s) for s in range(n)]
        slot_blocks = [[] for _ in range(n)]
        for r in running:
            slot_blocks[r.slot] = r.block_ids
        tables = self._tensor(self.cache.make_table(slot_blocks, groups))
        k_eff = {r.rid: max(0, r.spec_lookahead - 1) for r in running}
        if self._draft is not None:
            props = self._draft.propose(running, tables, k_eff)
        else:
            props = {r.rid: self._ngram.propose(r.seq_tokens, k_eff[r.rid])
                     for r in running}
        ids = np.zeros((n, W), np.int32)
        pos = np.zeros((n,), np.int32)
        lens = np.zeros((n,), np.int32)
        samplings = [SamplingParams()] * n
        for r in running:
            s = r.slot
            pr = [int(t) for t in props[r.rid][:k_eff[r.rid]]]
            props[r.rid] = pr
            ids[s, 0] = r.last_token
            ids[s, 1:1 + len(pr)] = pr
            pos[s] = r.num_cached
            lens[s] = 1 + len(pr)
            samplings[s] = r.sampling
        lg = self.model.verify_chunk_paged(self.pool, tables,
                                           self._tensor(ids),
                                           self._tensor(pos),
                                           self._tensor(lens))
        self.stats.spec_rounds += 1
        self._poison_logits(lg, idx)
        ok = self._finite_rows(lg.reshape(n, -1))
        temps, ks, ps, seeds = slot_arrays(samplings)
        posmat = pos[:, None] + 1 + np.arange(W, dtype=np.int32)[None, :]
        toks = sample_tokens(
            lg.reshape(n * W, -1), np.repeat(temps, W), np.repeat(ks, W),
            np.repeat(ps, W), np.repeat(seeds, W),
            posmat.reshape(-1)).reshape(n, W)
        now = self.clock()    # one stamp for the whole verified batch
        emitted = []
        for r in running:
            s = r.slot
            if not ok[s]:
                self._quarantine(r)
                continue
            pr = props[r.rid]
            committed, m_acc = self._judge(r, lg[s], toks[s], pr)
            self.stats.spec_proposed += len(pr)
            self.stats.spec_accepted += m_acc
            self.stats.spec_slot_rounds += 1
            n0 = r.num_cached
            for t in committed:
                r.num_cached += 1
                r.out_tokens.append(t)
                r.last_token = t
                self._record_emit(r, now)
                emitted.append((r.rid, t))
                self.stats.spec_committed += 1
                if r.finished:
                    break     # eos / budget: drop the committed tail
            # draft mark: positions <= n0 + m_acc hold draft K/V of tokens
            # actually committed; the correction's position holds the
            # rejected proposal's, and n0 + k_eff was never draft-written
            r.draft_cached = min(n0 + m_acc + 1, r.num_cached,
                                 n0 + k_eff[r.rid])
            if r.finished and r.state == RUNNING:
                if self.prefix is not None:
                    # committed tokens that completed full blocks become
                    # shareable; [:-1]: the last committed token's K/V is
                    # the never-written pending position
                    self.prefix.insert(self.sched.group_of_slot(r.slot),
                                       r.seq_tokens[:-1], r.block_ids)
                self.sched.retire(r)
        return emitted

    # --------------------------------------------------------------- decode
    def _run_decode(self, running, idx: int):
        """One fixed-shape paged decode step over every slot (engine step
        ``idx``); returns the [(rid, token)] emitted."""
        n = self.cfg.n_slots
        ids = np.zeros((n, 1), np.int32)
        pos = np.zeros((n,), np.int32)
        slot_blocks = [[] for _ in range(n)]
        groups = [self.sched.group_of_slot(s) for s in range(n)]
        samplings = [SamplingParams()] * n
        for req in running:
            s = req.slot
            ids[s, 0] = req.last_token
            pos[s] = req.num_cached
            slot_blocks[s] = req.block_ids
            samplings[s] = req.sampling
        tables = self.cache.make_table(slot_blocks, groups)
        logits = self.model.decode_paged(self.pool, self._tensor(tables),
                                         self._tensor(ids), self._tensor(pos))
        self.stats.decode_steps += 1
        self._poison_logits(logits, idx)
        ok = self._finite_rows(logits)
        temps, ks, ps, seeds = slot_arrays(samplings)
        toks = sample_tokens(logits, temps, ks, ps, seeds, pos + 1)
        now = self.clock()    # one stamp for the whole decode batch
        emitted = []
        for req in running:
            if not ok[req.slot]:
                # poisoned slot: quarantine ONLY this request
                self._quarantine(req)
                continue
            req.num_cached += 1
            tok = int(toks[req.slot])
            req.out_tokens.append(tok)
            req.last_token = tok
            self._record_emit(req, now)
            emitted.append((req.rid, tok))
            if req.finished:
                self.sched.retire(req)
        return emitted

    # ---------------------------------------------------------------- step
    def step(self):
        """One engine iteration; returns [(rid, token)] emitted this step."""
        if not self.active:
            return []
        t0 = time.perf_counter()
        idx = self.stats.steps
        self._release_hostages(idx)
        dropped = (self._fire_step_faults(idx)
                   if self.injector is not None else False)
        if not self.active:      # a device loss left this rank idle
            return []
        self._shed_expired()
        if dropped:
            # a lost engine iteration: no admission, no decode; the
            # position-keyed sampler keeps the survivors' tokens
            self.stats.dropped_steps += 1
            self.stats.steps += 1
            self.stats.wall += time.perf_counter() - t0
            self._update_health()
            return []
        admitted = self.sched.admit()
        if self.sched.admission_failures:
            self.stats.failed += len(self.sched.admission_failures)
            self.sched.admission_failures.clear()
        if self._chunked:
            if self.prefix is not None and admitted:
                self._apply_prefix_hits(admitted)
            prefill_emitted = self._run_chunk_prefills()
        else:
            prefill_emitted = self._run_prefills(admitted) if admitted else 0
        if self._spec_on:
            # this round's write window, declared before capacity runs: the
            # in-flight proposals need resident pages
            for r in self.sched.running:
                if r.last_token is not None:
                    remaining = (r.sampling.max_new_tokens
                                 - len(r.generated))
                    r.spec_lookahead = 1 + max(
                        0, min(self.cfg.spec_k, remaining - 1))
        preempted = self.sched.ensure_decode_capacity()
        self.stats.preemptions += len(preempted)
        # mid-chunk-prefill requests (no last_token yet) sit out the decode
        # batch; their slots point at scratch like retired ones
        running = [r for r in self.sched.running if r.last_token is not None]
        if not running:
            emitted = []
        elif self._spec_on:
            emitted = self._spec_round(running, idx)
        else:
            emitted = self._run_decode(running, idx)
        # pool-OOM pressure control: repeated preemption storms shrink the
        # admission cap (graceful decode-batch shrink); calm steps grow it
        # back toward n_slots
        if preempted:
            self._oom_streak += 1
            self._calm_streak = 0
        else:
            self._calm_streak += 1
            self._oom_streak = 0
        if (self._oom_streak >= self.cfg.oom_shrink_after
                and self.sched.max_active > 1):
            self.sched.max_active -= 1
            self.stats.batch_shrinks += 1
            self._oom_streak = 0
        if (self._calm_streak >= self.cfg.oom_recover_after
                and self.sched.max_active < self.cfg.n_slots):
            self.sched.max_active += 1
            self._calm_streak = 0
        dt = time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.wall += dt
        new_tokens = len(emitted) + prefill_emitted
        self.stats.tokens += new_tokens
        if new_tokens:
            self.stats.token_times.extend([dt / new_tokens] * new_tokens)
        self._update_health()
        return emitted

    def run(self, max_steps: int = 100000):
        """Drive until every request finishes; returns {rid: generated
        tokens} for every request this engine has ever accepted ({} on a
        rank a re-plan left idle)."""
        for _ in range(max_steps):
            if not self.active:
                return {}
            if not self.sched.has_work:
                break
            self.step()
        else:
            raise RuntimeError("engine did not drain (stuck scheduler?)")
        return {r.rid: list(r.generated) for r in self.requests}

    # -------------------------------------------------------------- elastic
    def replan_to(self, n_devices: int):
        """Re-plan onto the first ``n_devices`` ranks and move the live KV
        blocks (the reference's ``replan_to``, multi-controller).

        Every rank runs this at the same engine step.  ``runtime/elastic.
        replan`` keeps the tensor-parallel group whole and shrinks data,
        the outermost mesh axis, so a surviving rank keeps its (depth, row,
        col) coordinates and its parameter blocks: the model (and the
        draft) is rebuilt on a ``Mesh`` over the survivors and loads them
        through ``state_dict``.  Injected hostages are dropped (they hold
        the old pool's block ids), the prefix index starts empty (its
        evictions carry into the stats), the draft pool starts zeroed, and
        the scheduler's queue, admission clock and cap carry over.  Each
        running request gets blocks in its new KV group's partition, and
        its resident blocks move there over the old mesh before the ranks
        past the survivors go idle; a request its new group cannot host is
        preempted for a later re-prefill.  Returns the ``Replan``."""
        if not self.active:
            raise RuntimeError("this rank left the mesh at an earlier "
                               "re-plan")
        if self.mesh.size < self.mesh.world:
            # the ranks an earlier re-plan left idle build no more groups
            raise RuntimeError("a run re-plans across ranks once")
        cfg = self.cfg
        rp = replan(n_devices, self.model.ctx, global_batch=cfg.n_slots)
        # hostages hold the old pool's block ids: drop them, never free
        # them into the rebuilt pool
        self._hostage = None
        if self.prefix is not None:
            self._evict_carry += self.prefix.evictions
        old = dict(mesh=self.mesh, sched=self.sched, cache=self.cache,
                   pool=self.pool)
        mesh = Mesh(rp.ctx)      # collective: every rank builds its groups
        plan = Plan.for_shape("decode", global_batch=cfg.n_slots,
                              batch_shards=rp.ctx.batch_shards,
                              data=rp.ctx.data)
        new_axes = kv_group_axes(rp.ctx, plan)
        if mesh.active:
            self.model = _rebuild(self.model, rp.ctx, mesh)
            if self.draft_model is not None:
                self.draft_model = _rebuild(
                    self.draft_model,
                    self.draft_model.ctx.replace(data=rp.ctx.data), mesh)
            self._build()
            for r in self.requests:
                r.draft_cached = 0
            # the admission clock carries too: carried residents keep their
            # admit_seq, and a reset clock would invert eviction priority
            self.sched.waiting = old["sched"].waiting
            self.sched._admit_clock = old["sched"]._admit_clock
            self.sched.max_active = old["sched"].max_active
            self.sched.admission_failures = old["sched"].admission_failures
            alloc = self.cache.pool
        else:
            n_groups = mesh.axis_size(new_axes)
            alloc = BlockPool(n_groups, cfg.num_blocks // n_groups)
        spg = cfg.n_slots // alloc.n_groups
        moves = [(slot, req, slot // spg,
                  alloc.alloc(slot // spg, len(req.block_ids)))
                 for slot, req in enumerate(old["sched"].slots)
                 if req is not None]
        _move_blocks(old, mesh, new_axes, alloc.blocks_per_group, moves,
                     self.pool if mesh.active else None)
        if not mesh.active:
            self.active = False
            self.mesh = mesh
            self.model = self.draft_model = self.pool = self._draft = None
            return rp
        for slot, req, _, blocks in moves:
            if blocks is None:
                # the new group cannot host it: evict, re-prefill later
                req.block_ids = []
                self.sched.preempt(req)
                continue
            req.block_ids = blocks
            req.slot = slot
            self.sched.slots[slot] = req
        return rp


def _rebuild(model, ctx, mesh):
    """``model`` rebuilt for ``ctx`` on ``mesh`` with its own parameters:
    the layout keeps this rank's model coordinates, so its blocks load as
    they are (``load_state_dict`` refuses a shape that differs)."""
    new = build_model(model.cfg, ctx, model.run, device=model.device,
                      mesh=mesh)
    new.load_state_dict(model.state_dict())
    return new


def _move_blocks(old, mesh, new_axes, new_bpg, moves, pool) -> None:
    """Copy each moved request's resident blocks from its old KV group's
    partition (``old``: the old mesh, scheduler, cache and pool) into the
    blocks allocated in its new group's (``moves``: (slot, request, new
    group, new block ids or None)), this rank's part of it.  For each
    rank of the new mesh in the request's new group the source is the
    lowest rank of the old mesh in its old group with the same col
    coordinate (the same KV heads); a rank sends each peer one tensor of
    [k|v, L, blocks, bs, Hkv_loc, D] and receives one from each, point
    to point over the world's ranks, whose numbers the old and the new
    mesh share.  ``pool``: this rank's new partition (None on a rank
    leaving the mesh)."""
    old_mesh, old_cache = old["mesh"], old["cache"]
    me = old_mesh.rank

    def coords(m, r):
        shape = tuple(m.sizes[a] for a in AXES)
        return dict(zip(AXES, (int(c) for c in np.unravel_index(r, shape))))

    olds = [coords(old_mesh, r) for r in range(old_mesh.size)]
    news = [coords(mesh, r) for r in range(mesh.size)]
    old_bpg = old_cache.blocks_per_group
    send, recv = {}, {}                      # peer -> local block ids
    for slot, req, g_new, blocks in moves:
        if blocks is None:
            continue
        g_old = old["sched"].group_of_slot(slot)
        for d, cd in enumerate(news):
            if axis_index(mesh.sizes, cd, new_axes) != g_new:
                continue
            src = min(r for r, c in enumerate(olds)
                      if axis_index(old_mesh.sizes, c, old_cache.group_axes)
                      == g_old and c["col"] == cd["col"])
            if src == me:
                send.setdefault(d, []).extend(b - g_old * old_bpg
                                              for b in req.block_ids)
            if d == me:
                recv.setdefault(src, []).extend(b - g_new * new_bpg
                                                for b in blocks)
    leaves = ("k", "v")
    ops, into = [], []
    for peer, idx in sorted(send.items()):
        if peer != me:
            ops.append(dist.P2POp(dist.isend, torch.stack(
                [old["pool"][k][:, idx] for k in leaves]).contiguous(), peer))
    for peer, idx in sorted(recv.items()):
        if peer == me:
            for k in leaves:
                pool[k][:, idx] = old["pool"][k][:, send[me]]
            continue
        ref = pool["k"]
        buf = torch.empty((2, ref.shape[0], len(idx), *ref.shape[2:]),
                          dtype=ref.dtype, device=ref.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
        into.append((idx, buf))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for idx, buf in into:
        for i, k in enumerate(leaves):
            pool[k][:, idx] = buf[i]

