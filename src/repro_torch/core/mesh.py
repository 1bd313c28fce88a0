"""The logical mesh of the port over ``torch.distributed`` (counterpart of
``repro.core.mesh.logical_mesh``).

The reference reshapes its device list into ("data", "depth", "row", "col")
with "col" fastest, so the model group [depth, row, col] is contiguous.  The
port does the same with ranks: rank r of a world of data * depth * rows *
cols processes sits at the coordinates ``np.unravel_index(r, (data, depth,
rows, cols))``, the counterpart of ``lax.axis_index``.  A ``Mesh`` holds one
process group per axis tuple the ops reduce or gather over (``GROUP_AXES``);
a group's members are ordered lexicographically over its axes, first axis
outermost, as the reference's multi-axis collectives are.

At one rank a ``Mesh`` needs no ``torch.distributed``: every group has size
1 and every collective of ``core/collectives.py`` is the identity.  Across
ranks ``init_distributed`` starts the process group from ``torchrun``'s
environment first (NCCL on the card, gloo on the CPU).  Creating groups is
collective, so every rank builds every ``Mesh`` in the same order.  A mesh
may be smaller than the world (the layout of an elastic re-plan,
``runtime/elastic.py``): it spans ranks 0 .. size - 1, and the other ranks,
which build it as well, find ``mesh.active`` False and use none of it.
"""
from __future__ import annotations

import gc
import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from .api import ParallelContext, require_supported

AXES = ("data", "depth", "row", "col")

# Axis tuples the ops, the engine, the train step and the checks use, in
# canonical order: the SUMMA gathers (col, row), the in-op dW reduction
# (data, depth), the leaves' gradient syncs and ZeRO-1 slices (their
# replication axes), the loss's gathers (depth, row; the model axes).
GROUP_AXES = (("col",), ("row",), ("data",), ("row", "col"),
              ("depth", "row"), ("data", "depth"), ("depth", "row", "col"),
              ("data", "depth", "row"), AXES)


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK``, made current before
    anything else touches the card, with NCCL; or the CPU with gloo.  A
    process that ``torchrun`` did not start stays alone (world size 1)."""
    kind = torch.device(device).type
    local = int(os.environ.get("LOCAL_RANK", 0))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device}")
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
        if kind == "cuda":
            # one nvcc per host: local rank 0 builds the kernels into
            # repro_torch/_build/, the other ranks load the library after
            from ..kernels import build
            if local == 0:
                build.library()
            dist.barrier()
    return dev


def shutdown_distributed(*meshes) -> None:
    """Leave the process group that ``init_distributed`` joined: drop the
    ``meshes``' references to their groups, destroy every group, and
    collect what still held one.  A group left alive until the
    interpreter's exit is destroyed there, after the state it needs, and
    aborted a gloo rank after its work had passed (``terminate called
    without an active exception``; about 1 spawn in 15 under load)."""
    for mesh in meshes:
        mesh._groups.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


class Mesh:
    """This rank's place in the [data, depth, row, col] mesh of ``ctx`` and
    the process groups over it."""

    def __init__(self, ctx: ParallelContext):
        require_supported(ctx)
        self.ctx = ctx
        self.sizes = {"data": ctx.data, "depth": ctx.depth, "row": ctx.rows,
                      "col": ctx.cols}
        self.size = ctx.size
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < self.size:
            raise ValueError(
                f"{ctx.data}x{ctx.depth}x{ctx.rows}x{ctx.cols} mesh needs "
                f"{self.size} ranks under torch.distributed, have {world} "
                f"(start with torchrun --nproc-per-node {self.size})")
        self.world = world
        rank = dist.get_rank() if world > 1 else 0
        # a mesh smaller than the world (an elastic re-plan onto the
        # survivors) spans ranks 0 .. size - 1; the others build it too
        # (creating groups is collective) but take no part in it
        self.active = rank < self.size
        self.rank = rank if self.active else 0
        shape = tuple(self.sizes[a] for a in AXES)
        self.coords = dict(zip(AXES, (int(c) for c in
                                      np.unravel_index(self.rank, shape))))
        self._groups = {axes: self._new_group(axes) for axes in GROUP_AXES
                        if self.axis_size(axes) > 1}

    def fits(self, ctx: ParallelContext) -> bool:
        """Whether ``ctx`` has this mesh's layout (its knobs may differ)."""
        return self.sizes == {"data": ctx.data, "depth": ctx.depth,
                              "row": ctx.rows, "col": ctx.cols}

    def axis_size(self, axes) -> int:
        return axis_size(self.sizes, axes)

    def index(self, axes) -> int:
        """Lexicographic index of this rank over ``axes`` (first axis
        major): the reference's ``axis_linear_index``."""
        return axis_index(self.sizes, self.coords, axes)

    def rank_at(self, **coords) -> int:
        """Global rank at this rank's coordinates, with ``coords`` replaced."""
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index(tuple(c[a] for a in AXES),
                                        tuple(self.sizes[a] for a in AXES)))

    def group(self, axes):
        """The process group of this rank over ``axes``, or None where the
        axes have size 1 (the collective is then the identity)."""
        axes = _axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self._groups:
            raise KeyError(f"no process group over {axes}; the mesh keeps "
                           f"{sorted(self._groups)}")
        return self._groups[axes]

    def _new_group(self, axes):
        """Partition the world into the groups over ``axes`` (the other
        coordinates fixed) and keep this rank's.  Collective: every rank
        creates every group, in the same order."""
        if len(axes) == len(AXES):
            if self.world == self.size:
                return dist.group.WORLD
            group = dist.new_group(list(range(self.size)))
            return group if self.active else None
        rest = [a for a in AXES if a not in axes]
        parts = []
        for fixed in itertools.product(*(range(self.sizes[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            parts.append(sorted(
                self.rank_at(**base, **dict(zip(axes, free)))
                for free in itertools.product(
                    *(range(self.sizes[a]) for a in axes))))
        mine, _ = dist.new_subgroups_by_enumeration(parts)
        return mine if self.active else None


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(sizes: dict, axes) -> int:
    """Product of the sizes of ``axes`` (1 for no axes)."""
    return math.prod(sizes[a] for a in _axes(axes))


def axis_index(sizes: dict, coords: dict, axes) -> int:
    """Lexicographic index of ``coords`` over ``axes``, first axis major."""
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + coords[a]
    return idx


def local_block(t, spec, sizes: dict, coords: dict):
    """The block at ``coords`` of a global tensor or numpy array ``t`` cut
    by ``spec``: per dim, the mesh axes that split it (lexicographically,
    first axis outermost), empty where it is whole."""
    for dim, axes in enumerate(spec):
        n = axis_size(sizes, axes)
        if n > 1:
            m = t.shape[dim] // n
            i = axis_index(sizes, coords, axes)
            t = t[(slice(None),) * dim + (slice(i * m, (i + 1) * m),)]
    return t
