"""Serving launcher of the PyTorch port: continuous-batching engine over the
paged KV cache, on one GPU (or the CPU with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --requests 8 --n-slots 8 --prompt-lens 128,512 --new-tokens 16 \
        --block-size 16 --num-blocks 1024 --max-seq-len 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \
        --device cpu --prompt-lens 8,16 --new-tokens 8

Requests with mixed prompt lengths are admitted into a fixed slot batch,
prefilled in buckets, scattered into the block pool and decoded one
fixed-shape step at a time; finished sequences retire in place.  Weights
are random, from a fixed seed; params are float32 like the JAX launcher's.
Only the one-device layout runs so far, so the reference's mesh flags
(--mode, --data, --depth, --rows, --cols, --matmul-schedule) come back
with the multi-rank slice (ROADMAP Queue A, item A1).
"""
from __future__ import annotations

import argparse


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
    ap.add_argument("--attn-impl", default="auto",
                    choices=("jnp", "pallas", "auto"),
                    help="attention data path: the CUDA kernels (flash "
                         "prefill + paged decode), the plain PyTorch "
                         "versions, or auto (kernels on a GPU)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request completion deadline (0 = none)")
    ap.add_argument("--ttft-budget-s", type=float, default=0.0,
                    help="per-request time-to-first-token budget (0 = none)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound on the admission queue (0 = unbounded)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)

    import numpy as np

    from ..configs.base import RunConfig
    from ..core.api import ParallelContext
    from ..models.registry import build_model, get_arch, get_reduced
    from ..serve import EngineConfig, InferenceEngine, SamplingParams

    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl=args.attn_impl)
    ctx = ParallelContext(attn_impl=run.attn_impl)
    model = build_model(arch.model, ctx, run, device=args.device, seed=0)
    engine = InferenceEngine(model, EngineConfig(
        n_slots=args.n_slots, block_size=args.block_size,
        num_blocks=args.num_blocks, max_seq_len=args.max_seq_len,
        max_waiting=args.max_waiting), device=args.device)

    plens = [int(x) for x in args.prompt_lens.split(",")]
    rng = np.random.RandomState(0)
    vocab = min(250, model.cfg.vocab_size)
    reqs = []
    for i in range(args.requests):
        prompt = rng.randint(0, vocab, (plens[i % len(plens)],)).tolist()
        reqs.append(engine.add_request(
            prompt,
            SamplingParams(temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=i,
                           max_new_tokens=args.new_tokens),
            deadline_s=args.deadline_s or None,
            ttft_budget_s=args.ttft_budget_s or None))

    results = engine.run()
    for r in reqs:
        print(f"req {r.rid} (prompt {r.orig_prompt_len}, "
              f"preempted {r.preemptions}x): {results[r.rid]}")
    s = engine.stats
    lat = s.latency_percentiles()
    ttft, itl = s.ttft_percentiles(), s.itl_percentiles()
    print(f"steps={s.steps} prefills={s.prefills} "
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
          f"batch_shrinks={s.batch_shrinks}")
    return engine


if __name__ == "__main__":
    main()
