"""Paged KV cache: block allocator and pool tensors (port of
``repro.serve.kv_cache``).

The pool's block axis is sharded over the decode plan's KV group axes
(``kv_group_axes``: (data, depth, row) when the slots shard over every
token axis) and its KV heads over col: each rank allocates its group's
partition, one pair of device tensors ``[L, num_blocks / n_groups, bs,
Hkv_loc, D]`` in the compute dtype.  Block ids are global, ``group *
blocks_per_group + local``; the allocator below runs, the same, on every
rank (multi-controller), and a slot's blocks all lie in its group's
partition, so cache reads never cross ranks.  Local block 0 of every group
is a scratch block: retired or empty batch slots point their whole table at
it (fixed-shape math, the garbage is masked by per-request positions and
overwritten on reuse).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.ops import Plan, kv_group_axes


@dataclass(frozen=True)
class PagedCacheConfig:
    num_blocks: int          # global physical blocks (multiple of n_groups)
    block_size: int = 8      # positions per block
    max_seq_len: int = 256   # bounds the block-table width


class BlockPool:
    """Pure-python per-group freelist accounting (no devices needed).

    Allocation and liberation are O(1) list ops; ids are global.  The
    scheduler uses ``available`` for admission and preemption decisions.

    Blocks are refcounted so the prefix cache can share pages between
    requests: ``alloc`` hands out blocks at count 1, ``ref`` adds a holder
    and ``free`` drops one; the block returns to the freelist only when
    its last holder releases it.  Over-release and ``ref`` of a free block
    raise.
    """

    def __init__(self, n_groups: int, blocks_per_group: int):
        if blocks_per_group < 2:
            raise ValueError(
                f"need >= 2 blocks per group (1 is the scratch block), got "
                f"{blocks_per_group}")
        self.n_groups = n_groups
        self.blocks_per_group = blocks_per_group
        # local id 0 is the group's scratch block — never allocated
        self._free = [list(range(g * blocks_per_group + 1,
                                 (g + 1) * blocks_per_group))
                      for g in range(n_groups)]
        self._rc = {}            # block id -> live holder count (absent == 0)

    def available(self, group: int) -> int:
        return len(self._free[group])

    def capacity(self, group: int) -> int:
        return self.blocks_per_group - 1

    def scratch(self, group: int) -> int:
        return group * self.blocks_per_group

    def group_of(self, block_id: int) -> int:
        return block_id // self.blocks_per_group

    def refcount(self, block_id: int) -> int:
        return self._rc.get(block_id, 0)

    def alloc(self, group: int, n: int):
        """Pop ``n`` blocks from ``group``'s freelist; None if they don't fit."""
        free = self._free[group]
        if n > len(free):
            return None
        out = free[:n]
        del free[:n]
        for b in out:
            self._rc[b] = 1
        return out

    def ref(self, block_ids) -> None:
        """Add a holder to allocated blocks (prefix-cache sharing)."""
        for b in block_ids:
            if self._rc.get(b, 0) < 1:
                raise ValueError(f"ref of unallocated block {b}")
            self._rc[b] += 1

    def free(self, block_ids) -> None:
        """Drop one holder per block; the last returns it to the freelist."""
        for b in block_ids:
            g = self.group_of(b)
            if b == self.scratch(g):
                raise ValueError(f"cannot free scratch block {b}")
            rc = self._rc.get(b, 0)
            if rc < 1:
                raise ValueError(f"double free of block {b}")
            if rc == 1:
                del self._rc[b]
                self._free[g].append(b)
            else:
                self._rc[b] = rc - 1


class PagedKVCache:
    """Pool layout + allocator for one (model, decode plan) pair."""

    def __init__(self, model, plan: Plan, cfg: PagedCacheConfig):
        ctx = model.ctx
        self.model, self.plan, self.cfg = model, plan, cfg
        self.group_axes = kv_group_axes(ctx, plan)
        sizes = dict(data=ctx.data, depth=ctx.depth, row=ctx.rows,
                     col=ctx.cols)
        self.n_groups = 1
        for a in self.group_axes:
            self.n_groups *= sizes[a]
        if cfg.num_blocks % self.n_groups:
            raise ValueError(
                f"num_blocks={cfg.num_blocks} must divide over "
                f"{self.n_groups} KV groups")
        self.block_size = cfg.block_size
        self.max_blocks = -(-cfg.max_seq_len // cfg.block_size)
        self.blocks_per_group = cfg.num_blocks // self.n_groups
        self.pool = BlockPool(self.n_groups, self.blocks_per_group)
        # this rank's KV group: its partition holds global ids
        # [group * blocks_per_group, (group + 1) * blocks_per_group)
        self.group = model.mesh.index(self.group_axes)
        self.shape, self.dtype = model.paged_cache_shape(
            self.blocks_per_group, cfg.block_size)

    def init_arrays(self):
        """Zero-initialised tensors of this rank's partition of the pool on
        the model's device."""
        return {leaf: torch.zeros(self.shape, dtype=self.dtype,
                                  device=self.model.device)
                for leaf in ("k", "v")}

    def blocks_for(self, n_positions: int) -> int:
        return -(-n_positions // self.block_size)

    def fits(self, n_positions: int) -> bool:
        """Can a sequence of this length ever be resident (table + pool)?"""
        need = self.blocks_for(n_positions)
        return (need <= self.max_blocks
                and need <= self.pool.capacity(0))

    def make_table(self, slot_blocks, slot_groups) -> np.ndarray:
        """[n_slots, max_blocks] int32 of block ids, scratch-padded.

        slot_blocks: per-slot list of allocated block ids (empty for free /
        retired slots); slot_groups: per-slot KV group index."""
        n = len(slot_blocks)
        t = np.zeros((n, self.max_blocks), np.int32)
        for s, (blocks, g) in enumerate(zip(slot_blocks, slot_groups)):
            t[s, :] = self.pool.scratch(g)
            if blocks:
                t[s, :len(blocks)] = blocks
        return t
