"""ZeRO stage-1 optimizer-state sharding (PyTorch port of
``repro.optim.zero``).

The AdamW moments (and the fp32 master copy under mixed precision) are the
largest replicated state of the trainer: every rank of the ``data`` axis
(and, for depth-replicated leaves, of the ``depth`` axis) holds the same
fp32 copy.  ZeRO-1 partitions it, per leaf:

- a leaf is sharded over the mesh axes of its spec and replicated over the
  rest; its state is partitioned over the candidate axes it is replicated
  on, ``zaxes = ZERO_CANDIDATE_AXES`` minus its spec's axes (the head is
  sharded over depth and keeps its state depth-local);
- the rank's local block is flattened, zero-padded to a multiple of
  ``zn = prod(|zaxes|)`` and cut into ``zn`` slices of ``k`` elements
  (flat-index partitioning, so uneven leaves need no case of their own);
  member ``i`` of the group over ``zaxes`` owns slice ``i``.

Per step (``runtime/steps.py``): the gradient, a partial sum over the
zaxes, is reduce-scattered into the rank's [k] slice (``zreduce_scatter``;
a weight whose dW the SUMMA op already reduced is only cut,
``zslice``); AdamW runs on the fp32 [k] slices of m, v and the master
copy; the new param slice is cast to the param dtype and all-gathered back
(``zgather``).

A spec here is the port's per-dim tuple of axis tuples
(``models/transformer.py::dense_param_specs``), the reference's
``spec_dim_axes`` of its PartitionSpec.  The reference's host-side
reslicing (``host_shard``, ``convert_leaf`` and the checkpoint converter)
comes with checkpointing (ROADMAP Queue A, item A3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import collectives as col

# Axes whose replicated copies of optimizer state are partitioned away.
ZERO_CANDIDATE_AXES = ("data", "depth")


@dataclass(frozen=True)
class LeafLayout:
    """Static ZeRO-1 layout of one leaf."""
    param_shape: tuple          # global param shape
    dim_axes: tuple             # per-dim tuple of sharding axis names
    zaxes: tuple                # state-partition axes (replicated DP axes)
    sizes: tuple                # ((axis, size), ...) for every involved axis

    @property
    def extra_axes(self) -> tuple:
        """The leaf's own sharding axes, flattened in spec order."""
        return tuple(a for dim in self.dim_axes for a in dim)

    @property
    def local_shape(self) -> tuple:
        sz = dict(self.sizes)
        out = []
        for d, axes in zip(self.param_shape, self.dim_axes):
            f = math.prod(sz[a] for a in axes)
            if d % f:
                raise ValueError(
                    f"dim {d} of {self.param_shape} not divisible by its "
                    f"sharding axes {axes} (x{f})")
            out.append(d // f)
        return tuple(out)

    @property
    def zn(self) -> int:
        sz = dict(self.sizes)
        return math.prod(sz[a] for a in self.zaxes)

    @property
    def k(self) -> int:
        return -(-math.prod(self.local_shape) // self.zn)


def layout_for(spec, shape, axis_sizes: dict,
               candidates: tuple = ZERO_CANDIDATE_AXES) -> LeafLayout:
    """Layout of one leaf: its state partitioned over the candidate axes the
    leaf is not sharded on."""
    dim_axes = tuple(tuple(d) for d in spec)
    used = {a for dim in dim_axes for a in dim}
    zaxes = tuple(a for a in candidates if a not in used)
    involved = tuple(dict.fromkeys(zaxes + tuple(a for dim in dim_axes
                                                 for a in dim)))
    sizes = tuple((a, int(axis_sizes[a])) for a in involved)
    return LeafLayout(param_shape=tuple(shape), dim_axes=dim_axes,
                      zaxes=zaxes, sizes=sizes)


def build_layouts(specs, shapes, axis_sizes: dict,
                  candidates: tuple = ZERO_CANDIDATE_AXES):
    """Layouts of a tree of specs (nested dicts of per-dim axis tuples) and
    the matching tree of global shapes (tuples, or anything with
    ``.shape``)."""
    if isinstance(specs, dict):
        return {k: build_layouts(specs[k], shapes[k], axis_sizes, candidates)
                for k in specs}
    return layout_for(specs, tuple(getattr(shapes, "shape", shapes)),
                      axis_sizes, candidates)


def _pad_flat(x, lay: LeafLayout):
    flat = x.reshape(-1)
    pad = lay.k * lay.zn - flat.numel()
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def zslice(mesh, x, lay: LeafLayout):
    """This rank's [k] slice of an already reduced local value."""
    flat = _pad_flat(x, lay)
    if lay.zn == 1:
        return flat
    i = mesh.index(lay.zaxes)
    return flat[i * lay.k:(i + 1) * lay.k]


def zreduce_scatter(mesh, g, lay: LeafLayout):
    """The reduce-scatter of a gradient that is a partial sum over
    ``zaxes``: each member contributes its padded flat gradient and keeps
    the fully reduced [k] slice it owns (the ZeRO-1 stand-in for the
    gradient psum over those axes)."""
    flat = _pad_flat(g, lay)
    if lay.zn == 1:
        return flat
    return col.psum_scatter_dim(mesh, flat, lay.zaxes, 0)


def zgather(mesh, sl, lay: LeafLayout, dtype=None):
    """All-gather the updated slices back into the leaf's local block,
    cast to ``dtype`` first (a bf16 param rides the wire in bf16)."""
    if dtype is not None:
        sl = sl.to(dtype)
    flat = col.all_gather_cat(mesh, sl, lay.zaxes) if lay.zn > 1 else sl
    return flat[:math.prod(lay.local_shape)].reshape(lay.local_shape)


def zero_opt_init(mesh, params, layouts, *, master: bool = False) -> dict:
    """Fresh ZeRO-1 AdamW state for ``params`` (a list) and their
    ``layouts`` (the same order): fp32 zeros of [k] for m and v, step 0,
    and with ``master`` the fp32 slices of the params."""
    st = {"m": [torch.zeros(lay.k, dtype=torch.float32, device=p.device)
                for p, lay in zip(params, layouts)],
          "v": [torch.zeros(lay.k, dtype=torch.float32, device=p.device)
                for p, lay in zip(params, layouts)],
          "step": 0}
    if master:
        st["master"] = [zslice(mesh, p.detach(), lay).float().clone()
                        for p, lay in zip(params, layouts)]
    return st
