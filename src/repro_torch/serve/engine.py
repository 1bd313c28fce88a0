"""Continuous-batching inference engine (port of ``repro.serve.engine``).

One ``InferenceEngine.step`` is: admit waiting requests into free slots,
prefill them (bucketed fixed shapes, per-request true lengths), scatter the
prefill cache into the paged pool, run ONE fixed-shape paged decode step for
the whole slot batch (mixed lengths, block-table reads and writes), sample
per request, retire finished sequences in place.

The decode batch shape never changes across steps — batch composition does:
retired slots point at the scratch block until re-admission.

SLO guardrails kept from the reference: a bounded admission queue
(QueueFullError), per-request deadlines and TTFT budgets against an
injectable engine clock, a NaN/Inf logit guard that quarantines only the
poisoned slot (re-prefill with the position-keyed sampler keeps its tokens),
and a graceful decode-batch shrink after repeated pool-OOM preemption
storms.

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
engine's.  The ``serve.prefix`` fault site (evict, flush) is wired; a plan
naming ``serve.step`` or ``serve.logits`` is refused, as are elastic
replans (ROADMAP Queue A).

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
copy-on-write copy writes only on the ranks of the slot's KV group.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.collectives import broadcast_scalar
from ..core.device import resolve_device
from ..kernels.ops import effective_attn_impl
from ..runtime.faults import injector_from_run
from ..runtime.steps import page_copy, paged_reshard
from .kv_cache import PagedCacheConfig, PagedKVCache
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
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        if not hasattr(model, "decode_paged"):
            raise NotImplementedError(
                f"{type(model).__name__} has no paged decode path: serve it "
                f"through its prefill/decode steps")
        self.injector = (injector if injector is not None
                         else injector_from_run(model.run, sites=("serve",)))
        if self.injector is not None:
            unported = sorted({s.site for s in self.injector.plan.specs}
                              & {"serve.step", "serve.logits"})
            if unported:
                raise NotImplementedError(
                    f"the fault plan names {', '.join(unported)}: only the "
                    f"serve.prefix site is ported (ROADMAP Queue A, item A3)")
        self.model, self.cfg = model, cfg
        self.mesh = model.mesh
        # injectable wall clock: deadline/TTFT tests drive a fake clock
        self.clock = clock or time.perf_counter
        self._oom_streak = 0     # consecutive steps with preemptions
        self._calm_streak = 0    # consecutive steps without
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
        self.draft_model = draft_model
        self._spec_on = cfg.spec_k > 0
        self._draft = self._ngram = None
        self.spec_mode = None
        if self._spec_on:
            self._build_proposer()
        self.stats = EngineStats()
        self.requests = []

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

    def _fire_prefix_faults(self, idx: int) -> None:
        """The serve.prefix injections due at engine step ``idx``: a flush
        of the whole index, or forced eviction pressure (only refcount-1
        leaves may go, so pages shared with running requests survive)."""
        for spec in self.injector.fire("serve.prefix", idx):
            if self.prefix is None:
                continue
            if spec.kind == "flush":
                self.prefix.flush()
            elif spec.kind == "evict":
                want = max(1, int(spec.arg))
                for g in range(self.cache.n_groups):
                    self.prefix.evict(g, want)

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

    def _spec_round(self, running):
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
    def _run_decode(self, running):
        """One fixed-shape paged decode step over every slot; returns the
        [(rid, token)] emitted."""
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
        t0 = time.perf_counter()
        if self.injector is not None:
            self._fire_prefix_faults(self.stats.steps)
        self._shed_expired()
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
            emitted = self._spec_round(running)
        else:
            emitted = self._run_decode(running)
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
        self.stats.health = ("degraded"
                             if self.sched.max_active < self.cfg.n_slots
                             else "healthy")
        if self.prefix is not None:
            self.stats.cache_evictions = self.prefix.evictions
        return emitted

    def run(self, max_steps: int = 100000):
        """Drive until every request finishes; returns {rid: generated
        tokens} for every request this engine has ever accepted."""
        for _ in range(max_steps):
            if not self.sched.has_work:
                break
            self.step()
        else:
            raise RuntimeError("engine did not drain (stuck scheduler?)")
        return {r.rid: list(r.generated) for r in self.requests}
