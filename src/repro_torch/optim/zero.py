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
``spec_dim_axes`` of its PartitionSpec.

Host side (numpy): ``host_shard`` / ``host_unshard`` move one leaf between
its global array and the reference's [n_slices, k] ZeRO-1 layout (dim 0
lexicographic over (zaxes..., the leaf's own axes...)), ``convert_leaf``
between two layouts, and ``make_ckpt_converter`` turns a checkpoint's
``opt/{m,v,master}`` leaves written under the layouts in its manifest
(``meta.opt_layout``, the reference's ``LeafLayout`` JSON) into global
arrays.  The port's own checkpoints store every optimizer leaf as a
global array, so they carry no layout (``checkpoint/ckpt.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
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

    @property
    def n_extra(self) -> int:
        """Blocks the leaf's own sharding axes cut it into."""
        sz = dict(self.sizes)
        return math.prod(sz[a] for a in self.extra_axes)

    @property
    def n_slices(self) -> int:
        """Rows of the reference's global [n_slices, k] state leaf."""
        return self.zn * self.n_extra

    def to_json(self) -> dict:
        """The reference's manifest form of the layout."""
        return {"param_shape": list(self.param_shape),
                "dim_axes": [list(d) for d in self.dim_axes],
                "zaxes": list(self.zaxes),
                "sizes": [list(s) for s in self.sizes]}

    @staticmethod
    def from_json(d: dict) -> "LeafLayout":
        return LeafLayout(
            param_shape=tuple(d["param_shape"]),
            dim_axes=tuple(tuple(x) for x in d["dim_axes"]),
            zaxes=tuple(d["zaxes"]),
            sizes=tuple((a, int(n)) for a, n in d["sizes"]))


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


def zreduce_scatter(mesh, g, lay: LeafLayout, compress: str = "none"):
    """The reduce-scatter of a gradient that is a partial sum over
    ``zaxes``: each member contributes its padded flat gradient and keeps
    the fully reduced [k] slice it owns (the ZeRO-1 stand-in for the
    gradient psum over those axes).  ``compress="bf16"`` sends an fp32
    gradient as bf16 and widens the reduced slice back to fp32."""
    flat = _pad_flat(g, lay)
    if lay.zn == 1:
        return flat
    if compress == "bf16" and flat.dtype == torch.float32:
        return col.psum_scatter_dim(mesh, flat.to(torch.bfloat16),
                                    lay.zaxes, 0).float()
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


# ---------------------------------------------------------------------------
# host side: reslicing checkpointed optimizer state across layouts (numpy)
# ---------------------------------------------------------------------------

def _block_slices(lay: LeafLayout, coords: dict):
    """Global-array slices of the local block at the axis ``coords``."""
    sz = dict(lay.sizes)
    out = []
    for axes, loc in zip(lay.dim_axes, lay.local_shape):
        idx = 0
        for a in axes:
            idx = idx * sz[a] + coords[a]
        out.append(slice(idx * loc, (idx + 1) * loc))
    return tuple(out)


def _extra_blocks(lay: LeafLayout):
    """(linear index, coords) of each block of the leaf's own axes, in the
    lexicographic order of ``extra_axes``."""
    sz = dict(lay.sizes)
    axes = lay.extra_axes
    dims = [sz[a] for a in axes]
    return enumerate(dict(zip(axes, e))
                     for e in (np.ndindex(*dims) if dims else [()]))


def host_shard(full, lay: LeafLayout) -> np.ndarray:
    """A leaf's global array -> the reference's [n_slices, k] layout: row
    ``i * n_extra + e`` is slice i (over zaxes) of block e (over the
    leaf's own axes), each block flattened and zero-padded to zn * k."""
    full = np.asarray(full)
    if tuple(full.shape) != lay.param_shape:
        raise ValueError(f"{full.shape} != layout {lay.param_shape}")
    zn, k, n_e = lay.zn, lay.k, lay.n_extra
    out = np.zeros((lay.n_slices, k), full.dtype)
    for lin_e, coords in _extra_blocks(lay):
        blk = full[_block_slices(lay, coords)].reshape(-1)
        flat = np.zeros(zn * k, full.dtype)
        flat[:blk.size] = blk
        out[np.arange(zn) * n_e + lin_e] = flat.reshape(zn, k)
    return out


def host_unshard(z, lay: LeafLayout) -> np.ndarray:
    """The reference's [n_slices, k] layout -> the leaf's global array."""
    z = np.asarray(z)
    if tuple(z.shape) != (lay.n_slices, lay.k):
        raise ValueError(f"{z.shape} != layout ({lay.n_slices}, {lay.k})")
    zn, n_e = lay.zn, lay.n_extra
    full = np.zeros(lay.param_shape, z.dtype)
    loc_n = math.prod(lay.local_shape)
    for lin_e, coords in _extra_blocks(lay):
        flat = z[np.arange(zn) * n_e + lin_e].reshape(-1)
        full[_block_slices(lay, coords)] = \
            flat[:loc_n].reshape(lay.local_shape)
    return full


def convert_leaf(arr, old_lay: LeafLayout | None,
                 new_lay: LeafLayout | None) -> np.ndarray:
    """One optimizer leaf from ``old_lay`` to ``new_lay`` (None: the global
    array, the replicated layout)."""
    if old_lay is None and new_lay is None:
        return arr
    if old_lay is not None and new_lay is not None \
            and old_lay.to_json() == new_lay.to_json():
        return arr
    full = host_unshard(arr, old_lay) if old_lay is not None else arr
    return host_shard(full, new_lay) if new_lay is not None else full


def make_ckpt_converter(target_layouts_json: dict | None,
                        state_key: str = "opt"):
    """``convert(path, arr, manifest_meta) -> arr`` for the checkpoint
    restore: moves ``opt/{m,v,master}/<param path>`` leaves from the
    layout the manifest's ``opt_layout`` names for them to the one
    ``target_layouts_json`` names ({param path: layout JSON}; None or a
    missing path: the global array)."""
    prefix = state_key + "/"

    def convert(path: str, arr, meta):
        if not path.startswith(prefix):
            return arr
        group, _, ppath = path[len(prefix):].partition("/")
        if group not in ("m", "v", "master") or not ppath:
            return arr
        old_json = ((meta or {}).get("opt_layout") or {}).get(ppath)
        new_json = (target_layouts_json or {}).get(ppath)
        if old_json == new_json:
            return arr
        old = LeafLayout.from_json(old_json) if old_json else None
        new = LeafLayout.from_json(new_json) if new_json else None
        return convert_leaf(np.asarray(arr), old, new)

    return convert
