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
storms.  Not in this port yet (ROADMAP Queue A): the prefix cache, chunked
prefill, speculative decoding, the engine's fault sites (a plan naming a
``serve.*`` site is refused) and elastic replans.

Across ranks every rank runs this same host loop in lockstep (multi-
controller): each holds the same scheduler and allocator state and calls
the model's steps with the same host-layout inputs, and the steps return
logits that are the same bytes on every rank (gathered, not reduced).  So
every decision must come from replicated values only: the sampled ids (the
sampler is keyed by (seed, position)), the non-finite guard, and the clock
that deadlines and TTFT budgets read, which is rank 0's clock broadcast to
all (``_now``); each rank's own clock stamps only its statistics.
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
from ..runtime.steps import paged_reshard
from .kv_cache import PagedCacheConfig, PagedKVCache
from .sampling import SamplingParams, sample_tokens, slot_arrays
from .scheduler import FAILED, RUNNING, WAITING, Request, Scheduler


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
    # --- not ported yet: setting any of these raises ---
    prefix_cache: bool = False
    prefill_chunk: int = 0
    spec_k: int = 0


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

    def tokens_per_s(self) -> float:
        return self.tokens / self.wall if self.wall else 0.0

    def latency_percentiles(self):
        return _pcts(self.token_times)

    def ttft_percentiles(self):
        return _pcts(self.ttfts)

    def itl_percentiles(self):
        return _pcts(self.itls)


class InferenceEngine:
    """Serve ``model`` (a repro_torch DenseLM) with a paged KV pool on
    ``device`` — the card unless the caller asks for the CPU; the model must
    already live there."""

    def __init__(self, model, cfg: EngineConfig, *, device="cuda",
                 clock=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine runs "
                             f"on {self.device}")
        if not hasattr(model, "decode_paged"):
            raise NotImplementedError(
                f"{type(model).__name__} has no paged decode path: serve it "
                f"through its prefill/decode steps")
        for knob in ("prefix_cache", "prefill_chunk", "spec_k"):
            if getattr(cfg, knob):
                raise NotImplementedError(
                    f"EngineConfig.{knob} is not ported yet (ROADMAP Queue A, "
                    f"item A3)")
        if injector_from_run(model.run, sites=("serve",)) is not None:
            raise NotImplementedError(
                f"the fault plan {model.run.fault_plan!r} names a serve.* "
                f"site: the engine's fault sites are not ported yet (ROADMAP "
                f"Queue A, item A3)")
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
        self.stats = EngineStats()
        self.requests = []

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
        self._shed_expired()
        admitted = self.sched.admit()
        if self.sched.admission_failures:
            self.stats.failed += len(self.sched.admission_failures)
            self.sched.admission_failures.clear()
        prefill_emitted = self._run_prefills(admitted) if admitted else 0
        preempted = self.sched.ensure_decode_capacity()
        self.stats.preemptions += len(preempted)
        running = [r for r in self.sched.running if r.last_token is not None]
        emitted = self._run_decode(running) if running else []
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
