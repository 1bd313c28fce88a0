"""Training launcher of the PyTorch port: one device, the model's own
train loop (the GPU unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 10 --seq 2048 --batch 8 --compute-dtype bfloat16

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --reduced --device cpu --steps 4 --seq 32 --batch 4

Weights are random, from a fixed seed; data is the step-keyed synthetic
stream.  Only the one-device layout runs so far, so the reference's mesh,
ZeRO, pipeline, sequence-shard, checkpoint and fault flags come back with
the slices that port them (ROADMAP Queue A).
"""
from __future__ import annotations

import argparse


def main(argv=None):
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
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)

    from ..configs.base import RunConfig, ShapeSpec
    from ..core.api import ParallelContext
    from ..models.registry import build_model, get_arch, get_reduced
    from ..runtime.train_loop import train

    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    run = RunConfig(param_dtype=args.param_dtype,
                    compute_dtype=args.compute_dtype, loss_chunk=128,
                    lr=args.lr, loss_scale=args.loss_scale,
                    attn_impl=args.attn_impl, accum_steps=args.accum)
    ctx = ParallelContext(attn_impl=run.attn_impl)
    model = build_model(arch.model, ctx, run, device=args.device, seed=0)
    shape = ShapeSpec("train", seq_len=args.seq, global_batch=args.batch,
                      kind="train")
    res = train(model, shape, steps=args.steps, log_every=10)
    print(f"final loss {res.losses[-1]:.4f} after {len(res.losses)} steps")
    return res


if __name__ == "__main__":
    main()
