"""Train and serve steps of the port.

Counterpart of ``repro.runtime.steps``.  The reference builds jitted
``shard_map`` steps over the mesh.  At one device PyTorch runs the model
eagerly, so:

- the serve steps are the model's own ``prefill`` and ``decode_paged``,
  which the engine calls directly; only the reshard, which is no model
  method, lives here (``paged_reshard``);
- ``build_train_step`` is the one-device counterpart of the reference's
  flat-mesh train step (``build_train_step``, non-ZeRO): loss scaling,
  microbatch accumulation, unscale, global grad-norm clip, the cosine
  learning rate, AdamW and the non-finite update guard.  It updates the
  model's parameters and the optimizer state in place.
"""
from __future__ import annotations

import torch

from ..optim.adamw import adamw_update, cosine_lr


@torch.no_grad()
def paged_reshard(pool, pcache, tables):
    """Scatter a prefill cache [L, B, S, Hkv, D] into the pool
    [L, P, bs, Hkv, D] through per-request tables [B, S // bs] of block ids
    (rows and tail blocks without a target point at the scratch block).
    In place, where the reference returns the updated pool.  Block ids are
    global ids, which at one KV group are also the local ids the model
    reads."""
    L, B, S = pcache["k"].shape[:3]
    idx = tables.reshape(-1).long()
    for leaf in ("k", "v"):
        dst = pool[leaf]
        src = pcache[leaf].reshape(L, B * (S // dst.shape[2]), *dst.shape[2:])
        dst[:, idx] = src.to(dst.dtype)


def build_train_step(model, shape, *, accum_steps: int = 1,
                     loss_scale: float | None = None):
    """The train step of ``model`` (a DenseLM) for batches of ``shape``
    (a train ShapeSpec): ``step(opt_state, batch) -> metrics``.

    ``batch`` holds "tokens" and "labels" ([B, S] int tensors on the
    model's device); ``opt_state`` is ``adamw_init(list(model.parameters()),
    master=model.run.master_weights)``.  One call runs, as the reference's
    step does:

    - loss * loss_scale and its backward, over ``accum_steps`` equal
      microbatches split from the batch (the mean of their mean losses and
      gradients, so only one microbatch's activations are live);
    - the unscale, the global grad-norm clip at ``run.grad_clip`` and the
      AdamW update at ``cosine_lr(step, base_lr=run.lr, warmup=100,
      total=10000)``;
    - the non-finite guard: when the loss or the grad norm is not finite
      the update is not applied, so params and optimizer state stay
      bit-identical and ``metrics["skipped"]`` reads 1.

    ``loss_scale`` defaults to ``model.run.loss_scale``; the train loop's
    back-off passes a smaller one.  Metrics are floats: "loss" (unscaled),
    "grad_norm" (before clipping), "lr", "skipped"."""
    run = model.run
    if shape.kind != "train":
        raise ValueError(f"build_train_step needs a train shape, got "
                         f"{shape.kind!r}")
    if accum_steps < 1 or shape.global_batch % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} does not evenly split "
                         f"the batch of {shape.global_batch}")
    ls = run.loss_scale if loss_scale is None else loss_scale
    params = list(model.parameters())

    def step(opt_state, batch):
        for p in params:
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in range(accum_steps):
            n = shape.global_batch // accum_steps
            part = {k: v[mb * n:(mb + 1) * n] for k, v in batch.items()}
            out = model.loss(part)
            (out * ls if ls != 1.0 else out).backward()
            loss += out.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        # (sum of scaled microbatch grads) / accum / loss_scale, in the
        # reference's order
        if accum_steps > 1:
            loss /= accum_steps
            torch._foreach_div_(grads, float(accum_steps))
        if ls != 1.0:
            torch._foreach_div_(grads, float(ls))
        # in fp32 whatever the grads' dtype, as the reference sums
        # g.astype(float32) ** 2
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.float() for g in grads])))
        lr = cosine_lr(opt_state["step"], base_lr=run.lr, warmup=100,
                       total=10000)
        finite = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if finite:
            scale = torch.clamp(run.grad_clip / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, scale)
            adamw_update(params, grads, opt_state, lr=lr,
                         weight_decay=run.weight_decay)
        for p in params:
            p.grad = None
        return {"loss": float(loss), "grad_norm": float(gnorm),
                "lr": float(lr), "skipped": 0.0 if finite else 1.0}

    return step
