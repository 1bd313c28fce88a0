"""Static serve steps of the port: the reference's ``build_prefill_step``
and ``build_decode_step`` (``repro/runtime/steps.py:773``, ``:811``) for a
model with ``prefill(tokens)`` and ``decode(cache, ids, pos)`` (the ssm
family, which the paged engine cannot serve).

The reference jits each step under ``shard_map`` with the plan's specs,
and moves the prefill cache (the batch over data) into the decode step's
layout (the batch over the decode plan's token axes) implicitly, through
the decode step's ``in_shardings``.  Here every rank runs the model
eagerly on its blocks, so that move is explicit: the decode step's
``from_prefill`` keeps this rank's rows of its data block, or gathers the
batch whole for ``long_decode``.  The ids every step returns are the host
layout [B, 1] on every rank (the reference's ``unshard_ids``).

    pre = build_prefill_step(model, ShapeSpec("p", T, B, "prefill"))
    dec = build_decode_step(model, ShapeSpec("d", T, B, "decode"))
    ids, cache = pre.fn(tokens)
    cache = dec.from_prefill(cache)
    for t in range(steps):
        ids, cache = dec.fn(cache, ids, T + t)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ShapeSpec
from ..core import collectives as col
from ..core.ops import Plan


@dataclass(frozen=True)
class ServeStep:
    fn: Callable
    plan: Plan
    # decode: the prefill step's cache moved to this step's layout
    from_prefill: Callable | None = None


def _need(model, shape: ShapeSpec, kind: str):
    if shape.kind != kind:
        raise ValueError(f"needs a {kind} shape, got {shape.kind!r}")
    if not (hasattr(model, "prefill") and hasattr(model, "decode")):
        raise NotImplementedError(
            f"{type(model).__name__} has no static prefill and decode")


def build_prefill_step(model, shape: ShapeSpec) -> ServeStep:
    """``fn(tokens [B, S]) -> (ids [B, 1], cache)``: the model's prefill
    on the seq-sharded plan for prompts of ``shape`` (host layout, the
    same on every rank); the cache is this rank's block with the batch
    over data."""
    _need(model, shape, "prefill")
    want = (shape.global_batch, shape.seq_len)

    def fn(tokens):
        if tuple(tokens.shape) != want:
            raise ValueError(f"prefill step for {want}, got "
                             f"{tuple(tokens.shape)}")
        return model.prefill(tokens)

    return ServeStep(fn, Plan.for_shape("prefill"))


def build_decode_step(model, shape: ShapeSpec) -> ServeStep:
    """``fn(cache, ids [B, 1], pos) -> (ids [B, 1], cache)``: one greedy
    step of every sequence on the decode plan of ``shape``'s batch
    (``model.decode_plan``: ``decode``, or ``decode_dp`` / ``long_decode``
    for a small batch), the cache in that plan's layout; the step's
    ``from_prefill(cache)`` moves the prefill step's cache there."""
    _need(model, shape, "decode")
    plan = model.decode_plan(shape.global_batch)
    n = model.mesh.axis_size(model.cache_batch_axes(plan))
    if shape.global_batch % n:
        raise ValueError(f"decode batch {shape.global_batch} does not "
                         f"split over the {n} shards of {plan.kind}")

    def fn(cache, ids, pos=None):
        if tuple(ids.shape) != (shape.global_batch, 1):
            raise ValueError(f"decode step for {shape.global_batch} ids, "
                             f"got {tuple(ids.shape)}")
        return model.decode(cache, ids, pos)

    return ServeStep(fn, plan, lambda cache: _decode_cache(model, cache, plan))


@torch.no_grad()
def _decode_cache(model, cache, plan: Plan) -> dict:
    """The prefill cache (this rank's rows of the batch over data) moved
    to the layout ``plan`` gives the decode cache
    (``model.cache_batch_axes``): on ``decode`` this rank keeps its block
    of its data block's rows over (depth, row); on ``decode_dp`` the
    layouts are the same; on ``long_decode`` the batch is gathered whole
    over data.  Each leaf's batch dim is dim 1 (after the layers)."""
    mesh, ctx = model.mesh, model.ctx
    want = model.cache_batch_axes(plan)
    if not want:
        return {k: col.all_gather_cat(mesh, v, ctx.axis_data, axis=1)
                for k, v in cache.items()}
    rest = want[1:]                 # want[0] is data, the prefill's axis
    n, i = mesh.axis_size(rest), mesh.index(rest)
    if n == 1:
        return cache
    return {k: v.narrow(1, i * (v.shape[1] // n), v.shape[1] // n)
            .contiguous() for k, v in cache.items()}
