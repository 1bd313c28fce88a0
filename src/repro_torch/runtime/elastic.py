"""Elastic re-meshing (the port's copy of ``repro.runtime.elastic``):
pick a valid layout for the ranks that survive a failure.

Policy (the paper's composition, Fig. 6): the tensor-parallel group
[rows, cols, depth] is the atomic unit (a group that lost a member is
dropped whole) and the data axis absorbs the shrink.  The global batch
is kept by ``Replan.accum_steps``, which the caller passes to
``runtime/train_loop.train``: each optimizer step still sees the whole
step-keyed batch, accumulated over that many microbatches, so per-rank
activation memory stays the same and no token is dropped.  The caller
then builds a ``core.mesh.Mesh`` of ``Replan.ctx`` over the first
``n_used`` ranks and calls ``train`` again on it, which restores the
last checkpoint onto the new layout.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.api import ParallelContext


@dataclass
class Replan:
    ctx: ParallelContext
    n_used: int
    n_idle: int
    accum_steps: int


def replan(n_devices: int, ctx: ParallelContext, *, global_batch: int,
           seq_sharded: bool = False) -> Replan:
    """Largest valid layout with the same TP factorization.

    Raises RuntimeError when the TP group no longer fits and ValueError when
    no surviving data-parallel width divides the global batch (an invalid
    plan must never be returned silently).
    """
    tp = ctx.tp
    if n_devices < tp:
        raise RuntimeError(
            f"cannot fit a [{ctx.rows},{ctx.cols},{ctx.depth}] TP group in "
            f"{n_devices} devices; reduce q/d in the config")
    shard_factor = 1 if seq_sharded else ctx.depth * ctx.rows
    for data in range(n_devices // tp, 0, -1):
        shards = data * shard_factor
        if global_batch % shards:
            continue
        # ceil: a non-divisible shrink (e.g. 8 -> 3 replicas) must round the
        # accumulation UP or each optimizer step would drop tokens.
        accum = -(-ctx.data // data)
        # accum microbatches must evenly split each shard's batch rows
        rows_per_shard = global_batch // shards
        while accum <= rows_per_shard and rows_per_shard % accum:
            accum += 1
        if accum > rows_per_shard:
            continue
        new_ctx = ctx.replace(data=data)
        used = data * tp
        return Replan(ctx=new_ctx, n_used=used, n_idle=n_devices - used,
                      accum_steps=accum)
    raise ValueError(
        f"no data-parallel width in [1, {n_devices // tp}] x "
        f"shard_factor={shard_factor} divides global_batch={global_batch}; "
        f"cannot produce a valid elastic plan")
