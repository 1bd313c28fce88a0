"""Training launcher of the PyTorch port: one card, a Tesseract mesh or the
1-D Megatron baseline (``--mode megatron1d``) across cards under
``torchrun``, or the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 10 --seq 2048 --batch 8 --compute-dtype bfloat16

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch yi-6b --rows 2 --cols 2 \
        --steps 10 --seq 2048 --batch 8 --compute-dtype bfloat16 \
        [--matmul-schedule ring] [--profile-step]

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch yi-6b --mode megatron1d \
        --cols 4 --steps 10 --seq 2048 --batch 8 --compute-dtype bfloat16

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --device cpu --steps 4 --seq 32 --batch 4

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --device cpu --steps 8 --seq 32 --batch 4 --ckpt ckpt \
        --fault-plan "train.grads@3:nan;ckpt.write@5:corrupt(0,bit_flip)"

Weights are random, from a fixed seed, the same global weights on every
layout (each rank draws them and keeps its blocks), or the JAX package's
global tree from ``--params`` (an .npz of ``convert.flatten_params``);
data is the
step-keyed synthetic stream, the same batch on every rank, of which each
keeps its block.  Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) every rank runs the same loop on the [data, depth, rows,
cols] mesh, NCCL on the cards and gloo on the CPU; rank 0 prints the
losses, grad norms, step time p50, tokens/s, the model-FLOPs share of the
cards' bf16 peak, every rank's peak memory, that of one more forward and
backward without the optimizer state (the activations' share) and the
caching allocator's retries (``--out`` writes the
losses and grad norms as JSON), and with ``--profile-step`` one more
step's device time under torch.profiler (its NCCL kernels and its GEMMs
apart).  ``--ckpt DIR`` checkpoints every 50 steps and after the last
one, and restores the newest checkpoint in DIR first (onto this layout,
whatever layout wrote it); ``--fault-plan`` / ``--fault-seed`` inject the
reference's faults at the train and ckpt sites (``runtime/faults.py``), and
the summary then adds the ``resilience:`` line.  The reference's pipeline
and sequence-shard flags raise (ROADMAP Queue A, item A3).  A caller of
``main`` may pass the gradient wire formats (``grad_compression="bf16"``,
``dgrad_rs_bf16=True``), the optimizer (``optimizer="lamb"``) and the
activation checkpointing (``remat="none" | "full" | "dots"``, default
"full") as keywords, as the reference's launcher has no flag for them:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 --no-python \
        python3 -c "import sys; from repro_torch.launch.train import main; \
        main(sys.argv[1:], optimizer='lamb', remat='dots')" --arch yi-6b \
        --rows 2 --cols 2 --steps 10 --seq 2048 --batch 8 \
        --compute-dtype bfloat16
"""
from __future__ import annotations

import argparse
import json

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak of one H100 SXM


def main(argv=None, *, grad_compression: str = "none",
         dgrad_rs_bf16: bool = False, optimizer: str = "adamw",
         remat: str = "full"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--param-dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"))
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16", "float16"),
                    help="bf16 compute + fp32 master weights is the "
                         "mixed-precision recipe")
    ap.add_argument("--loss-scale", type=float, default=1.0,
                    help="static loss scaling (grads are unscaled before "
                         "clip/optimizer)")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("jnp", "pallas", "auto"),
                    help="attention data path: the CUDA kernels (flash "
                         "forward + dQ and dK/dV backward), the plain "
                         "PyTorch versions, or auto (kernels on a GPU)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microsteps per optimizer "
                         "step")
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
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: optimizer state sharded over the data "
                         "and depth axes each leaf is replicated on")
    ap.add_argument("--zero-stage", type=int, default=0, choices=(0, 1))
    ap.add_argument("--profile-step", action="store_true",
                    help="after the run, profile one more step on rank 0")
    ap.add_argument("--params", default="",
                    help="start from this .npz of the JAX package's global "
                         "param tree (convert.flatten_params)")
    ap.add_argument("--out", default="",
                    help="write the losses and grad norms here (JSON)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: restore the newest "
                         "checkpoint there first, save every 50 steps")
    ap.add_argument("--fault-plan", default="",
                    help="deterministic fault schedule (runtime/faults.py "
                         "DSL), e.g. 'train.grads@5:nan;ckpt.write@9:"
                         "corrupt(0,bit_flip)'")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule (replays identically)")
    # the reference's flags the port does not run yet
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--seq-shards", type=int, default=1)
    args = ap.parse_args(argv)
    from ..models.registry import build_model, get_arch, get_reduced
    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    if arch.model.family == "ssm" and args.mode == "megatron1d":
        # the reference's refusal (repro/models/ssm.py:110)
        raise NotImplementedError("ssm arch runs in tesseract modes")
    for flag, off, ssm_reason in (
            ("--pipe", args.pipe == 1,
             "does not support the pipeline stage API "
             "(supports_pipeline=False)"),
            ("--seq-shards", args.seq_shards == 1,
             "does not support sequence-axis sharding "
             "(supports_seq_shard=False): every time-mixing op must be "
             "ring-able")):
        if off:
            continue
        if arch.model.family == "ssm":
            # the reference's reasons (repro/runtime/steps.py)
            raise NotImplementedError(f"MambaLM {ssm_reason}")
        raise NotImplementedError(
            f"{flag} is not supported by repro_torch yet (ROADMAP Queue A, "
            f"item A3)")

    from ..core.mesh import init_distributed
    dev = init_distributed(args.device)

    import numpy as np
    import torch

    from ..configs.base import RunConfig, ShapeSpec
    from ..convert import load_params, params_from_jax, shard_params
    from ..core.api import ParallelContext
    from ..core.mesh import Mesh
    from ..kernels import ops as kops
    from ..runtime.train_loop import train

    run = RunConfig(param_dtype=args.param_dtype,
                    compute_dtype=args.compute_dtype, loss_chunk=128,
                    lr=args.lr, loss_scale=args.loss_scale,
                    attn_impl=args.attn_impl, accum_steps=args.accum,
                    zero1=args.zero1, zero_stage=args.zero_stage,
                    fault_plan=args.fault_plan, fault_seed=args.fault_seed,
                    grad_compression=grad_compression, optimizer=optimizer,
                    remat=remat)
    ctx = ParallelContext(mode=args.mode, data=args.data, depth=args.depth,
                          rows=args.rows, cols=args.cols,
                          matmul_schedule=args.matmul_schedule,
                          attn_impl=run.attn_impl,
                          dgrad_rs_bf16=dgrad_rs_bf16)
    mesh = Mesh(ctx)
    rank0 = mesh.rank == 0
    model = build_model(arch.model, ctx, run, device=dev, seed=0, mesh=mesh)
    if args.params:
        tree = load_params(args.params)
        with torch.no_grad():
            params_from_jax(shard_params(tree, arch.model, ctx, mesh.coords),
                            model)
    shape = ShapeSpec("train", seq_len=args.seq, global_batch=args.batch,
                      kind="train")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    res = train(model, shape, steps=args.steps, log_every=10,
                ckpt_dir=args.ckpt)
    launches = dict(kops.LAUNCHES)
    mem = None
    if cuda:
        mem = _memory_per_rank(model, shape, mesh)
    if rank0:
        print(f"final loss {res.losses[-1]:.4f} after {len(res.losses)} "
              f"steps ({res.restarts} restarts)")
        if args.fault_plan:
            print(f"resilience: nan_skips={res.nan_skips} "
                  f"loss_scale_backoffs={res.loss_scale_backoffs} "
                  f"ckpt_fallbacks={res.ckpt_fallbacks} "
                  f"faults_fired={len(res.fault_log)}")
        print(f"losses {[round(x, 4) for x in res.losses]} grad norms "
              f"{[round(x, 4) for x in res.grad_norms]} step ms "
              f"{[round(t * 1e3, 1) for t in res.step_times]}")
        p50 = float(np.median(res.step_times))
        flops = train_flops(model, shape)
        flops_rule = ("6 N per token + 3 x the SSD einsums (full Q x Q)"
                      if arch.model.family == "ssm" else
                      "6 N per token + 12 D per causal pair per head")
        print(f"mesh: {ctx.mode} data={ctx.data} depth={ctx.depth} "
              f"rows={ctx.rows} cols={ctx.cols} "
              f"matmul_schedule={ctx.matmul_schedule} "
              f"zero1={run.zero_enabled} compute={run.compute_dtype} "
              f"optimizer={run.optimizer} remat={run.remat} "
              f"grad_compression={run.grad_compression} "
              f"dgrad_rs_bf16={ctx.dgrad_rs_bf16}; "
              f"step p50 {p50 * 1e3:.1f} ms (first "
              f"{res.step_times[0] * 1e3:.1f} ms), tokens/s "
              f"{shape.seq_len * shape.global_batch / p50:.1f}; model "
              f"FLOPs per step {flops:.4g} ({flops_rule})"
              + (f", {flops / p50 / (mesh.size * H100_BF16_FLOPS):.4f} of "
                 f"{mesh.size} x 989 TFLOP/s bf16 "
                 f"({torch.cuda.get_device_name(dev)})" if cuda else "")
              + f"; launches per rank {launches}"
              + (f"; peak device memory per rank GiB {mem[0]}, of one "
                 f"forward and backward (no optimizer state) {mem[1]}; "
                 f"allocator retries per rank {mem[2]}" if mem else ""),
              flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"losses": res.losses,
                           "grad_norms": res.grad_norms}, f)
    if args.profile_step:
        profile = _profile_step(model, shape, rank0)
        if rank0:
            print(json.dumps(profile), flush=True)
    return res


def _memory_per_rank(model, shape, mesh):
    """Every rank's (peak device memory of the run GiB, the peak of one more
    forward and backward after it GiB, with the optimizer state freed and
    the gradients cleared: the activations' share; the caching
    allocator's retries in the run), each as a list over the ranks."""
    import torch

    from ..core import collectives as col
    from ..core.mesh import AXES
    from ..data.pipeline import SyntheticLMStream
    torch.cuda.synchronize()
    run_peak = torch.cuda.max_memory_allocated() / 2**30
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    stream = SyntheticLMStream(model.cfg.vocab_size, shape.global_batch,
                               shape.seq_len, seed=0)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in stream.batch(0).items()}
    model.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    model.loss(batch).backward()
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    got = col.all_gather_inv(mesh, torch.tensor(
        [[run_peak, fb_peak, float(retries)]], dtype=torch.float64,
        device=model.device), AXES, tiled=True).tolist()
    return ([round(r[0], 2) for r in got], [round(r[1], 2) for r in got],
            [int(r[2]) for r in got])


def train_flops(model, shape) -> float:
    """Model FLOPs of one train step: 6 N per token for the matmuls (N
    counts the head but not the embedding table, whose lookup multiplies
    nothing), plus the sequence mixing: for attention 4 D per causal (q, k)
    pair per q head forward and 8 D backward (QK^T recomputed in both
    backward passes is not counted); for the ssm family ``ssd_flops``
    forward and twice that backward (a recompute under remat is not
    counted)."""
    cfg = model.cfg
    n_matmul = cfg.param_count() - cfg.vocab_size * cfg.d_model
    mm = 6 * n_matmul * shape.seq_len * shape.global_batch
    if cfg.family == "ssm":
        return mm + 3 * ssd_flops(cfg, shape.seq_len) * shape.global_batch
    pairs = shape.seq_len * (shape.seq_len + 1) // 2
    return (mm + 12 * model.D * pairs * cfg.num_heads * shape.global_batch
            * cfg.num_layers)


def ssd_flops(cfg, seq_len: int) -> float:
    """Forward FLOPs of the SSD einsums of one sequence over all layers,
    as the einsum path computes them (``models/ssm.py::ssd_chunked`` with
    ``ssd_intra_plain``): per chunk of Q tokens (the chunk shrunk to
    divide ``seq_len``) the full Q x Q scores C.B^T (2 Q^2 N) and Y = W x
    (2 Q^2 d_inner), not only their causal half, the chunk states (2 Q
    d_inner N) and the inter-chunk term C.h (2 Q d_inner N).  The masks,
    decays and the state scan's elementwise work are not counted."""
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    Q = min(cfg.ssm_chunk, seq_len)
    while seq_len % Q:
        Q -= 1
    per_chunk = 2 * Q * Q * N + 2 * Q * Q * di + 4 * Q * di * N
    return float(per_chunk * (seq_len // Q) * cfg.num_layers)


def is_gemm(kernel: str) -> bool:
    """Whether a device kernel's name is a matrix product's: kernel #1/#2
    (``tesseract_mm*``) or a cuBLAS / CUTLASS GEMM."""
    k = kernel.lower()
    return any(s in k for s in ("tesseract_mm", "gemm", "nvjet", "cutlass",
                                "xmma"))


def _profile_step(model, shape, rank0):
    """One train step (after a warm-up step) under torch.profiler on rank 0
    (every rank runs both): device time by kernel, the NCCL kernels' sum
    and launches, the GEMMs' sum (``is_gemm``) and the idle share."""
    import contextlib
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..data.pipeline import SyntheticLMStream
    from ..runtime.steps import build_train_step, init_opt_state
    step = build_train_step(model, shape)
    opt = init_opt_state(model)
    stream = SyntheticLMStream(model.cfg.vocab_size, shape.global_batch,
                               shape.seq_len, seed=0)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in stream.batch(100).items()}
    step(opt, batch)
    torch.cuda.synchronize()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if rank0 else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        step(opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not rank0:
        return None
    # device kernels only: "nccl:*" are annotations over the NCCL kernels
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not e.key.startswith("nccl:")),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms, _ in kernels)
    nccl = sum(ms for k, ms, _ in kernels if "nccl" in k.lower())
    nccl_calls = sum(n for k, _, n in kernels if "nccl" in k.lower())
    return {"profile": f"train step on rank 0, {model.cfg.name} seq "
                       f"{shape.seq_len} x batch {shape.global_batch}, "
                       f"{model.ctx.mode}, {model.run.optimizer}, remat "
                       f"{model.run.remat}",
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
            "nccl_ms": nccl, "nccl_calls": nccl_calls,
            "gemm_ms": sum(ms for k, ms, _ in kernels if is_gemm(k)),
            "top_kernels_ms_calls": [[k[:80], ms, n]
                                     for k, ms, n in kernels[:14]]}


if __name__ == "__main__":
    from ..core.mesh import shutdown_distributed
    try:
        main()
    finally:
        shutdown_distributed()
