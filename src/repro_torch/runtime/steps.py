"""Serve steps of the port.

Counterpart of ``repro.runtime.steps``.  The reference builds jitted
``shard_map`` steps over the mesh: ``build_prefill_step``
(``with_lengths=True``), ``build_paged_decode_step`` and
``build_paged_reshard``.  At one device PyTorch runs the model eagerly, so
the prefill and decode steps are the model's own ``prefill`` and
``decode_paged``, which the engine calls directly; only the reshard, which
is no model method, lives here.  Block ids are global ids, which at one KV
group are also the local ids the model reads.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def paged_reshard(pool, pcache, tables):
    """Scatter a prefill cache [L, B, S, Hkv, D] into the pool
    [L, P, bs, Hkv, D] through per-request tables [B, S // bs] of block ids
    (rows and tail blocks without a target point at the scratch block).
    In place, where the reference returns the updated pool."""
    L, B, S = pcache["k"].shape[:3]
    idx = tables.reshape(-1).long()
    for leaf in ("k", "v"):
        dst = pool[leaf]
        src = pcache[leaf].reshape(L, B * (S // dst.shape[2]), *dst.shape[2:])
        dst[:, idx] = src.to(dst.dtype)
