"""Train and serve steps of the port.

Counterpart of ``repro.runtime.steps``.  The reference builds jitted
``shard_map`` steps over the mesh; PyTorch runs the model eagerly on every
rank, so:

- the serve steps are the model's own ``prefill`` and ``decode_paged``,
  which the engine calls directly on every rank; only the reshard, which
  is no model method, lives here (``paged_reshard``);
- ``build_train_step`` is the reference's flat-mesh train step
  (``build_train_step`` and ``zero_optimizer_step``): loss scaling,
  microbatch accumulation, the deferred gradient sync of replicated
  leaves, unscale, the layout-aware global grad-norm clip, the cosine
  learning rate, AdamW (replicated, or ZeRO-1 on state slices) or LAMB
  (replicated: the reference refuses it with ZeRO-1) and the non-finite
  update guard.  It updates the model's parameters and the
  optimizer state in place.

Gradient sync.  The reference puts ``grad_sync`` on every param leaf in its
loss: a ``pvary`` whose backward psums the leaf's cotangent over the axes
it is replicated on (``replicated_axes``).  Here each rank's autograd gives
every leaf its own partial gradient, and the step all-reduces each leaf
over the same axes after the backward (``sync_grads``), which is that
backward, one collective per bucket of leaves.  A SUMMA weight whose dW
the op reduced already (``reduce_dgrad_in_op``, ``tess_weight_names``)
syncs over nothing; under ZeRO-1 the data and depth axes move from the
psum to the reduce-scatter onto the state slice.
"""
from __future__ import annotations

from functools import partial

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..core import collectives as col
from ..core.mesh import AXES
from ..optim import zero
from ..optim.adamw import adamw_init, adamw_update, cosine_lr, lamb_update

# Elements per all-reduce of a gradient bucket.
BUCKET_NUMEL = 1 << 25


@torch.no_grad()
def paged_reshard(pool, pcache, tables, *, block0: int = 0):
    """Scatter a prefill cache [L, B, S, Hkv, D] into this rank's partition
    of the pool [L, P, bs, Hkv, D] through per-request tables [B, S // bs]
    of GLOBAL block ids (rows and tail blocks without a target point at a
    scratch block).  The partition holds global ids ``block0 .. block0 +
    P`` (this rank's KV group's); entries in other groups' partitions are
    left to their ranks, as the reference's reshard scatters each block to
    the device that holds it (``repro/runtime/steps.py``
    ``build_paged_reshard`` and the group offset of
    ``build_paged_decode_step``).  In place, where the reference returns
    the updated pool."""
    L, B, S = pcache["k"].shape[:3]
    P = pool["k"].shape[1]
    idx = tables.reshape(-1).long() - block0
    keep = (idx >= 0) & (idx < P)
    for leaf in ("k", "v"):
        dst = pool[leaf]
        src = pcache[leaf].reshape(L, B * (S // dst.shape[2]), *dst.shape[2:])
        dst[:, idx[keep]] = src[:, keep].to(dst.dtype)


def replicated_axes(spec) -> tuple:
    """Mesh axes a leaf with per-dim axes ``spec`` is replicated over."""
    used = {a for dim in spec for a in dim}
    return tuple(a for a in AXES if a not in used)


def leaf_layouts(model):
    """Per parameter of ``model.parameters()`` (a DenseLM), in that order:
    (spec, the axes the step psums its gradient over, ZeRO-1 layout,
    whether the SUMMA op reduced its dW already).  A weight reduced in the
    op syncs over nothing; under ZeRO-1 the zaxes leave the psum for the
    reduce-scatter."""
    tess = model.tess_weight_names() if model.ctx.reduce_dgrad_in_op else ()
    use_zero = model.run.zero_enabled
    out = []
    for name, _ in model.named_parameters():
        base = name.rsplit(".", 1)[-1]
        in_block = name.startswith("blocks.")
        _, shape, spec = (model.block_specs if in_block
                          else model.top_specs)[base]
        lay = zero.layout_for(spec, shape, model.mesh.sizes)
        in_op = in_block and base in tess
        axes = () if in_op else tuple(
            a for a in replicated_axes(spec)
            if not use_zero or a not in lay.zaxes)
        out.append((spec, axes, lay, in_op))
    return out


def init_opt_state(model) -> dict:
    """The optimizer state ``build_train_step``'s step takes (AdamW's and
    LAMB's are the same): per leaf (the
    order of ``model.parameters()``) fp32 m and v of the leaf's shape, or
    of its [k] slice under ZeRO-1, and the fp32 master copy (slice) when
    the params are low precision."""
    params = list(model.parameters())
    run = model.run
    if not run.zero_enabled:
        return adamw_init(params, master=run.master_weights)
    return zero.zero_opt_init(model.mesh, params,
                              [leaf[2] for leaf in leaf_layouts(model)],
                              master=run.master_weights)


def sync_grads(mesh, grads, axes_per_leaf, compress: str = "none") -> None:
    """All-reduce each gradient over its axes, in place: the backward of the
    reference's ``grad_sync``.  Leaves of one axis tuple and dtype go in
    buckets of up to ``BUCKET_NUMEL`` elements, in the same order on every
    rank.  ``compress="bf16"`` (``RunConfig.grad_compression``) sends each
    bucket as bf16 and widens the sum back to the leaves' dtype, as the
    reference's compressed ``grad_sync`` backward does."""
    groups: dict = {}
    for g, axes in zip(grads, axes_per_leaf):
        if mesh.group(axes) is not None:
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), leaves in groups.items():
        bucket, n = [], 0
        for g in leaves + [None]:
            if bucket and (g is None or n + g.numel() > BUCKET_NUMEL):
                flat = _flatten_dense_tensors(bucket)
                if compress == "bf16":
                    flat = flat.to(torch.bfloat16)
                flat = col.psum(mesh, flat, axes)
                for dst, src in zip(bucket,
                                    _unflatten_dense_tensors(flat, bucket)):
                    dst.copy_(src)
                bucket, n = [], 0
            if g is not None:
                bucket.append(g)
                n += g.numel()


def build_train_step(model, shape, *, accum_steps: int = 1,
                     loss_scale: float | None = None):
    """The train step of ``model`` (a DenseLM, on one rank or on its mesh)
    for batches of ``shape`` (a train ShapeSpec): ``step(opt_state, batch)
    -> metrics``.

    ``batch`` holds "tokens" and "labels" ([B, S] int tensors on the
    model's device, host layout: every rank passes the same batch and the
    model keeps its block); ``opt_state`` is ``init_opt_state(model)``.
    One call runs, as the reference's step does:

    - loss * loss_scale and its backward, over ``accum_steps`` equal
      microbatches split from the batch (the mean of their mean losses and
      gradients, so only one microbatch's activations are live);
    - the gradient sync of replicated leaves (``sync_grads``);
    - the unscale, the global grad-norm clip at ``run.grad_clip`` and the
      update of ``run.optimizer`` (AdamW, or LAMB with its trust ratios
      per reference leaf, ``lamb_update_fn``) at ``cosine_lr(step,
      base_lr=run.lr, warmup=100, total=10000)``; across ranks the norm is
      layout-aware (each leaf's sum of squares divided by its replication
      factor, then psum'd over the mesh), and under ZeRO-1 the clip and
      the AdamW update run on the state slices (``zero_optimizer_step``;
      LAMB with ZeRO-1 raises, as the reference does);
    - the non-finite guard: when the loss or the grad norm is not finite
      on any rank the update is not applied, so params and optimizer state
      stay bit-identical and ``metrics["skipped"]`` reads 1.

    The fault port: a batch may hold ``fault_scale`` (a float), which
    multiplies every gradient after the unscale, as the reference's
    ``fault_port`` does; the train loop's injector sends NaN or Inf there
    (``train.grads``), which the guard then catches.  With
    ``run.grad_compression="bf16"`` the gradient sync and ZeRO-1's
    reduce-scatter run in bf16 on the wire.

    ``loss_scale`` defaults to ``model.run.loss_scale``; the train loop's
    back-off passes a smaller one.  Metrics are floats, the same on every
    rank: "loss" (unscaled), "grad_norm" (before clipping), "lr",
    "skipped"."""
    run = model.run
    mesh = model.mesh
    if not hasattr(model, "loss"):
        raise NotImplementedError(
            f"{type(model).__name__} has no loss: ssm training is not "
            f"ported yet (ROADMAP Queue A, item A3: ssm training; the "
            f"reference has no backward for ssd_intra)")
    if run.optimizer == "lamb" and run.zero_enabled:
        raise NotImplementedError(
            "optimizer='lamb' with ZeRO-1 is not wired: the trust ratios "
            "need unsharded per-leaf norms")
    if shape.kind != "train":
        raise ValueError(f"build_train_step needs a train shape, got "
                         f"{shape.kind!r}")
    split = accum_steps * model.ctx.batch_shards
    if accum_steps < 1 or shape.global_batch % split:
        raise ValueError(f"accum_steps={accum_steps} microbatches over "
                         f"{model.ctx.batch_shards} token shards do not "
                         f"evenly split the batch of {shape.global_batch}")
    ls = run.loss_scale if loss_scale is None else loss_scale
    params = list(model.parameters())
    leaves = leaf_layouts(model) if mesh.size > 1 or run.zero_enabled \
        else None
    update = (lamb_update_fn(model, leaves) if run.optimizer == "lamb"
              else adamw_update)

    def step(opt_state, batch):
        batch = dict(batch)
        fscale = batch.pop("fault_scale", None)
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
        if leaves is not None:
            sync_grads(mesh, grads, [leaf[1] for leaf in leaves],
                       run.grad_compression)
        # (sum of scaled microbatch grads) / accum / loss_scale, in the
        # reference's order
        if accum_steps > 1:
            loss /= accum_steps
            torch._foreach_div_(grads, float(accum_steps))
        if ls != 1.0:
            torch._foreach_div_(grads, float(ls))
        if fscale is not None and float(fscale) != 1.0:
            # the fault port: an injected NaN / Inf reaches every gradient
            torch._foreach_mul_(grads, float(fscale))
        lr = cosine_lr(opt_state["step"], base_lr=run.lr, warmup=100,
                       total=10000)
        if run.zero_enabled:
            gnorm, finite = zero_optimizer_step(model, params, grads,
                                                opt_state, leaves, lr=lr,
                                                loss=loss)
        else:
            gnorm = _global_norm(mesh, grads, leaves)
            finite = _finite(mesh, loss, gnorm)
            if finite:
                scale = torch.clamp(run.grad_clip / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, scale)
                update(params, grads, opt_state, lr=lr,
                       weight_decay=run.weight_decay)
        for p in params:
            p.grad = None
        return {"loss": float(loss), "grad_norm": float(gnorm),
                "lr": float(lr), "skipped": 0.0 if finite else 1.0}

    return step


def lamb_update_fn(model, leaves):
    """``lamb_update`` for ``model``'s parameters: each leaf grouped with
    the other layers' copies of its block param (one stacked reference
    leaf, ``blocks.<name>``; every top-level param its own), and across
    ranks (``leaves``, from ``leaf_layouts``) the [2, n_groups] float64
    sums of squares divided by each group's replication factor and psum'd
    over the mesh in one all-reduce."""
    keys = {}
    groups = [keys.setdefault(
        "blocks." + name.rsplit(".", 1)[-1] if name.startswith("blocks.")
        else name, len(keys)) for name, _ in model.named_parameters()]
    if leaves is None:
        return partial(lamb_update, leaf_groups=groups)
    mesh = model.mesh
    rep = [1.0] * len(keys)
    for g, leaf in zip(groups, leaves):
        rep[g] = float(mesh.axis_size(replicated_axes(leaf[0])))
    rep = torch.tensor(rep, dtype=torch.float64, device=model.device)

    def norm_fn(sq):
        return col.psum(mesh, sq / rep, AXES)

    return partial(lamb_update, leaf_groups=groups, norm_fn=norm_fn)


def _global_norm(mesh, grads, leaves):
    """The global L2 norm of the gradients, in fp32 whatever their dtype
    (the reference sums g.astype(float32) ** 2).  Across ranks each leaf's
    sum of squares is divided by its replication factor and the total is
    psum'd over the mesh, so every element counts once."""
    norms = torch._foreach_norm([g.float() for g in grads])
    if leaves is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = sum(n * n / mesh.axis_size(replicated_axes(leaf[0]))
             for n, leaf in zip(norms, leaves))
    return torch.sqrt(col.psum(mesh, sq, AXES))


def _finite(mesh, loss, gnorm) -> bool:
    """Whether the loss and the grad norm are finite on every rank."""
    ok = (torch.isfinite(loss) & torch.isfinite(gnorm)).float()
    return bool(col.pmin(mesh, ok.reshape(1), AXES)[0] > 0)


@torch.no_grad()
def zero_optimizer_step(model, params, grads, state, leaves, *, lr, loss):
    """The ZeRO-1 update (the reference's ``zero_optimizer_step``):
    reduce-scatter each gradient over its zaxes into the rank's [k] slice
    (a weight the SUMMA op already reduced is only cut), clip on the
    slices (each slice's sum of squares divided by the leaf's replication
    that remains outside its zaxes), AdamW on the fp32 slices of m, v and
    the master copy, then the new param slices cast to the param dtype and
    all-gathered back into the params.  Returns (the grad norm, whether
    the update ran): it is skipped when the norm or the loss is not finite
    on any rank."""
    mesh, run = model.mesh, model.run
    g_sl = [zero.zslice(mesh, g, lay) if in_op else
            zero.zreduce_scatter(mesh, g, lay, run.grad_compression)
            for g, (_, _, lay, in_op) in zip(grads, leaves)]
    sq = sum((g.float() ** 2).sum() / mesh.axis_size(
        tuple(a for a in replicated_axes(spec) if a not in lay.zaxes))
        for g, (spec, _, lay, _) in zip(g_sl, leaves))
    gnorm = torch.sqrt(col.psum(mesh, sq, AXES))
    if not _finite(mesh, loss, gnorm):
        return gnorm, False
    scale = torch.clamp(run.grad_clip / (gnorm + 1e-6), max=1.0)
    g_sl = [g.float() * scale for g in g_sl]
    p_sl = [zero.zslice(mesh, p.detach(), leaf[2]).float().clone()
            for p, leaf in zip(params, leaves)]
    adamw_update(p_sl, g_sl, state, lr=lr, weight_decay=run.weight_decay)
    for p, sl, leaf in zip(params, p_sl, leaves):
        p.copy_(zero.zgather(mesh, sl, leaf[2], p.dtype))
    return gnorm, True
