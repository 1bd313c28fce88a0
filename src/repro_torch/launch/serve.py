"""Serving launcher of the PyTorch port: continuous-batching engine over the
paged KV cache (or the static steps of an ssm model), on one GPU, on a
Tesseract mesh or the 1-D Megatron baseline (``--mode megatron1d``) of
GPUs under ``torchrun``, or on the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --requests 8 --n-slots 8 --prompt-lens 128,512 --new-tokens 16 \
        --block-size 16 --num-blocks 1024 --max-seq-len 1024

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch yi-6b --rows 2 --cols 2 \
        --dtype bfloat16 --requests 16 --n-slots 8 \
        --prompt-lens 128,512,1000,2000 --new-tokens 32 --block-size 16 \
        --num-blocks 2048 --max-seq-len 4096

(and ``--mode megatron1d --cols 4`` in place of ``--rows 2 --cols 2`` for
the 1-D baseline on the same four cards)

Shared-prompt serving and speculative decoding (the engine's features):
``--prefix-cache`` (radix prefix cache; chunked prefill of
``--prefill-chunk`` positions, or an auto width), ``--spec-k K`` proposals
a round from ``--spec-mode`` ngram or draft (``--draft-config``, an arch
built reduced iff ``--reduced``, on the same mesh, with the target's
vocab, its weights from seed 7).  ``--system-prompt-len N`` puts one
N-token system prompt ahead of every request's prompt:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --dtype bfloat16 --requests 16 --n-slots 8 --system-prompt-len 1024 \
        --prompt-lens 64,192,320,448 --new-tokens 32 --block-size 16 \
        --num-blocks 2048 --max-seq-len 2048 --prefix-cache \
        --prefill-chunk 256 [--spec-k 4 --draft-config smollm-360m]

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch yi-6b --reduced --rows 2 --cols 2 --device cpu \
        --prompt-lens 8,16 --new-tokens 8

An ssm model (``--arch mamba2-1.3b``), which the paged engine cannot
serve, runs the static serve steps instead: one prefill of ``--requests``
prompts of one ``--prompt-lens`` length, then ``--new-tokens`` greedy
decode steps (the engine's flags are ignored):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch mamba2-1.3b --rows 2 --cols 2 \
        --dtype bfloat16 --requests 8 --prompt-lens 2048 --new-tokens 32

Requests with mixed prompt lengths are admitted into a fixed slot batch,
prefilled in buckets, scattered into the block pool and decoded one
fixed-shape step at a time; finished sequences retire in place.  Weights
are random, from a fixed seed, the same global weights on every layout
(each rank draws them and keeps its blocks); prompts are drawn from the
whole vocabulary with ``numpy.random.RandomState(0)``.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) every rank
runs the same engine loop in lockstep on the [data, depth, rows, cols]
mesh, NCCL on the cards and gloo on the CPU; each rank takes card
``LOCAL_RANK`` before anything else, and rank 0 prints.
``--profile-steps N`` then profiles N decode steps on rank 0.

Faults (the reference's ``--fault-plan``, ``--fault-seed`` and
``--replan-to``): a plan of ``serve.*`` sites, seeded, fires on every rank
at the same engine step; ``--replan-to N`` runs two engine steps, then
re-plans onto the first N ranks (data shrinks, the tensor-parallel group
is kept) and serves on:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch yi-6b --data 2 --depth 2 \
        --requests 8 --n-slots 8 --prompt-lens 128,512 --new-tokens 16 \
        --block-size 16 --num-blocks 1024 --max-seq-len 1024 \
        --fault-plan "serve.logits@2:nan(3);serve.step@4:drop_step" \
        --replan-to 2

The ranks past the survivors wait at a barrier over the world and leave.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--prompt-lens", default="8,16",
                    help="comma list cycled over requests (mixed lengths)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--mode", default="tesseract",
                    choices=("tesseract", "summa2d", "megatron1d"),
                    help="op set: megatron1d is the 1-D baseline (rows = "
                         "depth = 1, cols = the tensor-parallel ranks)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--cols", type=int, default=1)
    ap.add_argument("--matmul-schedule", default="fused",
                    choices=("fused", "ring", "auto"),
                    help="SUMMA schedule: gathers + kernel #1, or the "
                         "skewed ring + kernel #2 per step")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="param and compute dtype")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("jnp", "pallas", "auto"),
                    help="attention data path: the CUDA kernels (flash "
                         "prefill + paged decode), the plain PyTorch "
                         "versions, or auto (kernels on a GPU)")
    ap.add_argument("--replan-to", type=int, default=0,
                    help="after 2 engine steps, re-plan onto this many "
                         "ranks and move the live KV blocks (elastic)")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault schedule, e.g. "
                         "'serve.logits@2:nan(1);serve.step@4:drop_step'")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault schedule (replays identically)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request completion deadline (0 = none)")
    ap.add_argument("--ttft-budget-s", type=float, default=0.0,
                    help="per-request time-to-first-token budget (0 = none)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound on the admission queue (0 = unbounded)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: shared prompt prefixes reuse "
                         "refcounted pool pages, divergent tails split "
                         "copy-on-write")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width interleaved with decode "
                         "steps (0 = monolithic bucketed prefill; the "
                         "prefix cache auto-chunks when 0)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: proposals verified per "
                         "engine step (0 = plain decode)")
    ap.add_argument("--spec-mode", default="auto",
                    choices=("auto", "draft", "ngram"),
                    help="proposal source: a draft model (--draft-config) "
                         "or the n-gram prompt lookup; auto picks draft "
                         "when one is configured")
    ap.add_argument("--draft-config", default="",
                    help="arch name of the draft model (e.g. smollm-360m); "
                         "built reduced iff --reduced, on the same mesh, "
                         "with vocab_size set to the target's")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="one shared system prompt of this many tokens "
                         "ahead of every request's prompt")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the run, profile this many decode steps of "
                         "n-slots 1000-token requests on rank 0 (an ssm "
                         "model: one prefill and this many decode steps "
                         "of the run's batch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)

    from ..core.mesh import init_distributed
    dev = init_distributed(args.device)

    import numpy as np
    import torch

    from ..configs.base import RunConfig
    from ..core import collectives as col
    from ..core.api import ParallelContext
    from ..core.mesh import AXES, Mesh
    from ..kernels import ops as kops
    from ..models.registry import build_model, get_arch, get_reduced
    from ..serve import EngineConfig, InferenceEngine, SamplingParams

    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    run = RunConfig(param_dtype=args.dtype, compute_dtype=args.dtype,
                    attn_impl=args.attn_impl, use_pallas=True,
                    fault_plan=args.fault_plan, fault_seed=args.fault_seed)
    ctx = ParallelContext(mode=args.mode, data=args.data, depth=args.depth,
                          rows=args.rows, cols=args.cols,
                          matmul_schedule=args.matmul_schedule,
                          attn_impl=run.attn_impl)
    mesh = Mesh(ctx)
    rank0 = mesh.rank == 0
    model = build_model(arch.model, ctx, run, device=dev, seed=0, mesh=mesh)
    if arch.model.family == "ssm":
        _serve_static(args, model, dev)
        return model
    draft = None
    if args.draft_config:
        import dataclasses
        darch = (get_reduced(args.draft_config) if args.reduced
                 else get_arch(args.draft_config))
        # the verify step judges the proposals in the target's vocab
        draft = build_model(dataclasses.replace(
            darch.model, vocab_size=model.cfg.vocab_size), ctx, run,
            device=dev, seed=7, mesh=mesh)
    engine = InferenceEngine(model, EngineConfig(
        n_slots=args.n_slots, block_size=args.block_size,
        num_blocks=args.num_blocks, max_seq_len=args.max_seq_len,
        max_waiting=args.max_waiting, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
        spec_mode=args.spec_mode), device=dev, draft_model=draft)

    plens = [int(x) for x in args.prompt_lens.split(",")]
    rng = np.random.RandomState(0)
    system = rng.randint(0, model.cfg.vocab_size,
                         (args.system_prompt_len,)).tolist()
    reqs = []
    for i in range(args.requests):
        prompt = system + rng.randint(0, model.cfg.vocab_size,
                                      (plens[i % len(plens)],)).tolist()
        reqs.append(engine.add_request(
            prompt,
            SamplingParams(temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=i,
                           max_new_tokens=args.new_tokens),
            deadline_s=args.deadline_s or None,
            ttft_budget_s=args.ttft_budget_s or None))

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    if args.replan_to:
        engine.step()
        engine.step()
        rp = engine.replan_to(args.replan_to)
        if rank0:
            print(f"replanned to {rp.n_used} devices: data={rp.ctx.data} "
                  f"[q={rp.ctx.rows},{rp.ctx.cols},d={rp.ctx.depth}] "
                  f"(idle={rp.n_idle})", flush=True)
    results = engine.run()
    if not engine.active:
        # a rank the re-plan left idle: nothing to report
        _world_barrier()
        return engine
    launches = dict(kops.LAUNCHES)
    peaks = None
    mesh = engine.mesh              # the survivors' mesh after a re-plan
    if cuda:
        torch.cuda.synchronize()
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 2**30],
                            dtype=torch.float64, device=dev)
        peaks = col.all_gather_inv(mesh, peak, AXES, tiled=True).tolist()
    s = engine.stats
    ctx = engine.model.ctx
    if rank0:
        for r in reqs:
            print(f"req {r.rid} (prompt {r.orig_prompt_len}, "
                  f"preempted {r.preemptions}x): {results[r.rid]}")
        lat = s.latency_percentiles()
        ttft, itl = s.ttft_percentiles(), s.itl_percentiles()
        print(f"steps={s.steps} prefills={s.prefills} "
              f"decode_steps={s.decode_steps} "
              f"preemptions={s.preemptions} tokens={s.tokens} "
              f"tokens/s={s.tokens_per_s():.1f} "
              f"p50={lat['p50_ms']:.1f}ms p95={lat['p95_ms']:.1f}ms "
              f"p99={lat['p99_ms']:.1f}ms "
              f"attn_impl={engine.attn_impl} device={engine.device}")
        print(f"slo: health={s.health} "
              f"ttft p50={ttft['p50_ms']:.1f}ms p99={ttft['p99_ms']:.1f}ms "
              f"itl p50={itl['p50_ms']:.1f}ms p99={itl['p99_ms']:.1f}ms "
              f"shed={s.shed} failed={s.failed} "
              f"nan_quarantines={s.nan_quarantines} "
              f"batch_shrinks={s.batch_shrinks} "
              f"dropped_steps={s.dropped_steps} "
              f"pool_exhaust_events={s.pool_exhaust_events}")
        if args.prefix_cache or args.prefill_chunk:
            print(f"prefix: hit_rate={s.cache_hit_rate():.3f} "
                  f"hits={s.prefix_hits}/{s.prefix_lookups} "
                  f"tokens_reused={s.prefix_tokens_reused}/"
                  f"{s.prefix_tokens_total} cow_splits={s.cow_splits} "
                  f"evictions={s.cache_evictions} "
                  f"prefill_chunks={s.prefill_chunks} "
                  f"chunk_steps={s.chunk_steps} "
                  f"cached_nodes={len(engine.prefix) if engine.prefix else 0}")
        if args.spec_k:
            d = engine._draft
            print(f"spec: mode={engine.spec_mode} k={args.spec_k} "
                  f"rounds={s.spec_rounds} proposed={s.spec_proposed} "
                  f"accepted={s.spec_accepted} committed={s.spec_committed} "
                  f"acceptance={s.acceptance_rate():.3f} "
                  f"tokens/slot-round={s.tokens_per_round():.3f}"
                  + (f" draft_chunk_steps={d.chunk_steps} "
                     f"draft_decode_steps={d.decode_steps}" if d else ""))
        print(f"mesh: {ctx.mode} data={ctx.data} depth={ctx.depth} "
              f"rows={ctx.rows} cols={ctx.cols} matmul_schedule={ctx.matmul_schedule} "
              f"dtype={args.dtype}; launches per rank {launches}"
              + (f"; peak device memory per rank GiB "
                 f"{[round(p, 2) for p in peaks]}" if peaks else ""),
              flush=True)
    if args.profile_steps:
        profile = _profile_decode(engine, rng, args.profile_steps, rank0)
        if rank0:
            print(json.dumps(profile), flush=True)
    _world_barrier()
    return engine


def _world_barrier() -> None:
    """Every rank of the world, the ones a re-plan left idle too, meets
    here before the process group goes."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _reduce_profile(prof, n):
    """A torch.profiler run of ``n`` steps reduced per step: (its events,
    the device kernels [(name, ms, calls)] longest first, their busy ms,
    the NCCL kernels' ms, the collectives issued by kind).  The "nccl:*"
    events are host annotations over the NCCL kernels, one per collective
    issued: they count the collectives and are not kernels."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n,
                       e.count / n) for e in events
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not e.key.startswith("nccl:")),
                     key=lambda kv: -kv[1])
    calls = {e.key: e.count / n for e in events
             if e.key.startswith("nccl:") and e.device_type == DeviceType.CPU}
    busy = sum(ms for _, ms, _ in kernels)
    nccl = sum(ms for k, ms, _ in kernels if "nccl" in k.lower())
    return events, kernels, busy, nccl, calls


def _profile_decode(engine, rng, steps, rank0):
    """Decode steps of ``n_slots`` resident 1000-token requests, the last
    ``steps`` of them under torch.profiler on rank 0 (every rank runs them):
    device time by kernel, the NCCL kernels' share, the GEMMs' time, the
    idle share and the host's time by op."""
    import contextlib
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..serve import SamplingParams
    from .train import is_gemm
    vocab = engine.model.cfg.vocab_size
    for _ in range(engine.cfg.n_slots):
        engine.add_request(rng.randint(0, vocab, 1000).tolist(),
                           SamplingParams(max_new_tokens=steps + 3))
    engine.step()                  # admit + prefill all, first decode
    engine.step()
    torch.cuda.synchronize()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if rank0 else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    engine.run()
    if not rank0:
        return None
    events, kernels, busy, nccl, _ = _reduce_profile(prof, steps)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count
                    // steps) for e in events
                   if e.device_type == DeviceType.CPU),
                  key=lambda kv: -kv[1])
    return {"profile": f"decode step on rank 0, {engine.cfg.n_slots} slots "
                       f"at ~1000 positions",
            "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
            "nccl_ms_per_step": nccl,
            "nccl_share_of_busy": nccl / busy if busy else None,
            "nccl_share_of_wall": nccl / wall_ms,
            "gemm_ms_per_step": sum(ms for k, ms, _ in kernels
                                    if is_gemm(k)),
            "top_kernels_ms_per_step": [[k[:80], ms]
                                        for k, ms, _ in kernels[:12]],
            "top_host_ops_self_ms_calls_per_step": [[k[:60], ms, n]
                                                    for k, ms, n in host[:15]]}


def _serve_static(args, model, dev):
    """Serve an ssm model through the static steps
    (``runtime/serve_steps.py``, the reference's ``build_prefill_step`` /
    ``build_decode_step``): one prefill of ``--requests`` prompts of one
    length, drawn with ``numpy.random.RandomState(0)``, then
    ``--new-tokens`` greedy decode steps.  One untimed prefill and decode
    step first (NCCL's communicators and the libraries' handles are made
    on first use); then the launch counters are zeroed and the run is
    timed on every rank's clock, rank 0's printed: the prefill (the
    batch's time to first token), each decode step (the reshard of the
    prefill cache included in the first), output tokens/s and the peak
    device memory per rank."""
    import time

    import numpy as np
    import torch

    from ..configs.base import ShapeSpec
    from ..core import collectives as col
    from ..core.mesh import AXES
    from ..kernels import ops as kops
    from ..runtime.serve_steps import build_decode_step, build_prefill_step
    plens = {int(x) for x in args.prompt_lens.split(",")}
    if len(plens) != 1:
        raise ValueError(f"an ssm model is served one prompt length at a "
                         f"time (static steps), got --prompt-lens "
                         f"{args.prompt_lens}")
    T, B, steps = plens.pop(), args.requests, args.new_tokens
    if args.profile_steps and dev.type != "cuda":
        raise ValueError("--profile-steps profiles the card")
    mesh, ctx, cfg = model.mesh, model.ctx, model.cfg
    rank0 = mesh.rank == 0
    cuda = dev.type == "cuda"
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, T))).to(dev)
    pre = build_prefill_step(model, ShapeSpec("prefill", T, B, "prefill"))
    dec = build_decode_step(model, ShapeSpec("decode", T, B, "decode"))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def run(n):
        """(ids per step, cache, prefill s, decode step s)."""
        sync()
        t0 = time.perf_counter()
        ids, cache = pre.fn(tokens)
        sync()
        t_pre = time.perf_counter() - t0
        out, t_dec = [ids], []
        for t in range(n):
            t1 = time.perf_counter()
            if t == 0:
                cache = dec.from_prefill(cache)
            ids, cache = dec.fn(cache, ids, T + t)
            sync()
            t_dec.append(time.perf_counter() - t1)
            out.append(ids)
        return out, cache, t_pre, t_dec

    run(1)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    out, cache, t_pre, t_dec = run(steps)
    launches = dict(kops.LAUNCHES)
    ids = torch.cat(out, 1)
    if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
        raise RuntimeError("ssm serve: an out-of-vocab token")
    if not all(bool(torch.isfinite(v).all()) for v in cache.values()):
        raise RuntimeError("ssm serve: a non-finite cache leaf")
    peaks = None
    if cuda:
        peak = torch.tensor([torch.cuda.max_memory_allocated() / 2**30],
                            dtype=torch.float64, device=dev)
        peaks = col.all_gather_inv(mesh, peak, AXES, tiled=True).tolist()
    if rank0:
        wall = t_pre + sum(t_dec)
        p50, p99 = (float(np.percentile(t_dec, q)) * 1e3 for q in (50, 99))
        for b in range(min(B, 4)):
            print(f"seq {b}: {ids[b].tolist()}")
        print(f"ssm serve: {cfg.name} {args.dtype} L={cfg.num_layers}, {B} "
              f"prompts x {T} tokens, {steps} decode steps (plan "
              f"{dec.plan.kind}); prefill (time to first token of the "
              f"batch) {t_pre * 1e3:.1f} ms; decode step p50 {p50:.2f} ms "
              f"p99 {p99:.2f} ms; output tokens/s {ids.numel() / wall:.1f} "
              f"({ids.numel()} tokens in {wall:.3f} s, prefill included)")
        print(f"mesh: {ctx.mode} data={ctx.data} depth={ctx.depth} "
              f"rows={ctx.rows} cols={ctx.cols} "
              f"matmul_schedule={ctx.matmul_schedule} dtype={args.dtype}; "
              f"launches per rank {launches}"
              + (f"; peak device memory per rank GiB "
                 f"{[round(p, 2) for p in peaks]}" if peaks else ""),
              flush=True)
    if args.profile_steps:
        profile = _profile_static(model, pre, dec, tokens,
                                  args.profile_steps, rank0)
        if rank0:
            print(json.dumps(profile), flush=True)


def _profile_static(model, pre, dec, tokens, steps, rank0):
    """One prefill and ``steps`` decode steps of an ssm model under
    torch.profiler on rank 0 (every rank runs them), each phase in its own
    profile: per phase the wall, device busy and idle share, the NCCL
    kernels' time, the collectives issued (the ``nccl:*`` annotations),
    the SSD kernel's (#7) and the SUMMA kernels' (#1/#2) device time, and
    the top kernels."""
    import contextlib
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    T = tokens.shape[1]
    state = {}

    def prefill():
        state["ids"], cache = pre.fn(tokens)
        state["cache"] = dec.from_prefill(cache)

    def decode():
        for t in range(steps):
            state["ids"], state["cache"] = dec.fn(state["cache"],
                                                  state["ids"], T + t)

    out = {}
    for name, fn, n in (("prefill", prefill, 1), ("decode", decode, steps)):
        torch.cuda.synchronize()
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if rank0 else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        if not rank0:
            continue
        _, kernels, busy, nccl, calls = _reduce_profile(prof, n)
        out[name] = {
            "per": "prefill" if n == 1 else "decode step",
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
            "nccl_ms": nccl,
            "collectives": sum(calls.values()), "collectives_by_kind": calls,
            "ssd_intra_ms": sum(ms for k, ms, _ in kernels
                                if "ssd_intra" in k),
            "tesseract_mm_ms": sum(ms for k, ms, _ in kernels
                                   if "tesseract_mm" in k),
            "top_kernels_ms_calls": [[k[:80], ms, c]
                                     for k, ms, c in kernels[:12]]}
    if not rank0:
        return None
    return {"profile": f"ssm serve on rank 0, {model.cfg.name}, "
                       f"{tokens.shape[0]} x {T} tokens, {model.ctx.mode} "
                       f"{model.ctx.matmul_schedule}", **out}


if __name__ == "__main__":
    from ..core.mesh import shutdown_distributed
    served = None
    try:
        served = main()
    finally:
        shutdown_distributed(*([served.mesh] if served is not None else []))
