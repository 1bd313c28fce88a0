"""Collectives over the logical mesh (counterpart of
``repro.core.collectives``).

Each function takes the ``Mesh`` and the axes the reference names inside
``shard_map`` and runs the matching ``torch.distributed`` collective on the
mesh's group over those axes.  Over a group of size 1 each one is the
identity, as the reference's collectives are at one device.  Gathered and
scattered blocks are ordered lexicographically over the axes, first axis
outermost (the group's rank order, ``core/mesh.py``).

Gradients.  The reference differentiates through its collectives by JAX's
varying/invariant typing: a value is *invariant* over an axis when every
member holds the same copy, and its cotangent is then the true one on every
member; a *varying* value's cotangent is each member's own.  A ``psum`` of
a varying value transposes to the identity, and ``pvary`` (which JAX
inserts wherever an invariant value meets a varying one) transposes to a
``psum`` (``repro/core/collectives.py``, ``grad_sync``).  PyTorch has no
such typing, so each transpose is an ``autograd.Function`` here and the ops
call ``pvary`` where the reference's typing inserts it:

- ``psum``: all-reduce forward, identity backward;
- ``pvary``: identity forward, all-reduce backward (the reference's
  ``grad_sync`` is this on a param leaf; the train step applies its
  backward to buckets of gradients, ``runtime/steps.py::sync_grads``);
- ``all_gather_inv`` / ``all_gather_cat``: all-gather forward,
  reduce-scatter backward: the gathered value meets a varying one, so the
  ``pvary`` implied there sums the members' cotangents, and each member
  keeps its own block;
- ``psum_scatter_dim``: reduce-scatter forward, all-gather backward;
- ``psum_v``: ``pvary`` of a ``psum``, all-reduce forward and backward
  (the Megatron op set's reductions of partial sums whose result meets
  varying math: the residual stream carries each rank's partial
  cotangent, ``core/ops.py::MegatronOps``).

A collective takes its Function only where autograd records it (grad
enabled, an input that requires grad, a group of more than one member), so
every serve step runs the plain collective.  ``pmax``, ``pmin``,
``ppermute`` and the argmax are not differentiable: the loss takes its max
under a stop-gradient, and the SUMMA ring's shifts sit inside
``core/summa.py``'s own backward.  ``torch.distributed.nn``'s all-reduce is
not used: its backward all-reduces again, which counts an already
replicated cotangent once per member.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, _axes

_INT32_MAX = torch.iinfo(torch.int32).max


def _gather(mesh: Mesh, x, axes, axis: int, tiled: bool):
    group = mesh.group(axes)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    n = mesh.axis_size(axes)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device) if x.ndim else \
        torch.empty((n,), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x if x.ndim else x.reshape(1),
                                group=group)
    stacked = out.reshape((n,) + tuple(x.shape))
    axis = axis % (x.ndim + (0 if tiled else 1))
    if not tiled:
        return stacked.movedim(0, axis)
    if axis == 0:
        return out
    moved = stacked.movedim(0, axis)               # [..., n, d_axis, ...]
    return moved.reshape(x.shape[:axis] + (n * x.shape[axis],)
                         + x.shape[axis + 1:])


def _scatter(mesh: Mesh, x, axes, dim: int):
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter_dim: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    blocks = x.movedim(dim, 0).contiguous()
    out = torch.empty((blocks.shape[0] // n,) + tuple(blocks.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, blocks, group=group)
    return out.movedim(0, dim)


def _all_reduce(mesh, x, axes, op):
    group = mesh.group(axes)
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def _records(mesh: Mesh, x, axes) -> bool:
    """Whether autograd records this collective (and it is no identity)."""
    return (torch.is_grad_enabled() and x.requires_grad
            and mesh.group(axes) is not None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, mesh, x, axes, axis, tiled):
        fctx.args = (mesh, axes, axis % (x.ndim + (0 if tiled else 1)),
                     tiled)
        return _gather(mesh, x, axes, axis, tiled)

    @staticmethod
    def backward(fctx, g):
        mesh, axes, axis, tiled = fctx.args
        gx = _scatter(mesh, g, axes, axis)
        return None, (gx if tiled else gx.squeeze(axis)), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, mesh, x, axes, dim):
        fctx.args = (mesh, axes, dim % x.ndim)
        return _scatter(mesh, x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        mesh, axes, dim = fctx.args
        return None, _gather(mesh, g, axes, dim, True), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, mesh, x, axes):
        return _all_reduce(mesh, x, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(fctx, g):
        return None, g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(fctx, mesh, x, axes):
        fctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        mesh, axes = fctx.args
        return None, _all_reduce(mesh, g, axes, dist.ReduceOp.SUM), None


def all_gather_inv(mesh: Mesh, x, axes, *, axis: int = 0,
                   tiled: bool = False):
    """Gather ``x`` from every member of the group over ``axes``: stacked on
    a new dim at ``axis`` (``tiled=False``) or concatenated along ``axis``.
    Every member gets the same bytes.  Backward: the reduce-scatter of the
    members' cotangents."""
    if _records(mesh, x, axes):
        return _AllGather.apply(mesh, x, axes, axis, tiled)
    return _gather(mesh, x, axes, axis, tiled)


def all_gather_cat(mesh: Mesh, x, axes, axis: int = 0):
    """All-gather over (possibly several) axes, concatenated along ``axis``
    in lexicographic order over ``axes``."""
    return all_gather_inv(mesh, x, axes, axis=axis, tiled=True)


def psum(mesh: Mesh, x, axes):
    """Sum of ``x`` over the group (a new tensor; ``x`` is left as is): a
    varying value made invariant.  Backward: the identity."""
    if _records(mesh, x, axes):
        return _Psum.apply(mesh, x, axes)
    return _all_reduce(mesh, x, axes, dist.ReduceOp.SUM)


def pvary(mesh: Mesh, x, axes):
    """``x`` marked varying over ``axes``: the identity forward, the sum of
    the members' cotangents backward."""
    if _records(mesh, x, axes):
        return _Pvary.apply(mesh, x, axes)
    return x


def psum_v(mesh: Mesh, x, axes):
    """The reference's ``psum_v`` as the Megatron op set uses it: the sum of
    ``x`` over the group, ``pvary``'d where the reference's typing pvary's
    it (the result meets a varying param: a down-bias or the next norm's
    scale).  The psum's transpose is the identity and the pvary's a psum,
    so the backward all-reduces the cotangent.  Over a group of size 1 it
    is the identity."""
    return pvary(mesh, psum(mesh, x, axes), axes)


def pmax(mesh: Mesh, x, axes):
    return _all_reduce(mesh, x, axes, dist.ReduceOp.MAX)


def pmax_v(mesh: Mesh, x, axes):
    """``pmax`` then ``pvary`` (the reference's ``pmax_v``).  The max is
    not differentiable (the loss takes it under a stop-gradient), so this
    is the pmax."""
    return pvary(mesh, pmax(mesh, x, axes), axes)


def pmin(mesh: Mesh, x, axes):
    return _all_reduce(mesh, x, axes, dist.ReduceOp.MIN)


def psum_scatter_dim(mesh: Mesh, x, axes, dim: int):
    """Reduce-scatter over ``axes``: the sum over the group, of which this
    member keeps block ``mesh.index(axes)`` of ``dim``.  Backward: the
    all-gather of the members' cotangent blocks."""
    if _records(mesh, x, axes):
        return _PsumScatter.apply(mesh, x, axes, dim)
    return _scatter(mesh, x, axes, dim)


def axis_linear_index(mesh: Mesh, axes) -> int:
    """Lexicographic index of this rank over ``axes`` (first axis major)."""
    return mesh.index(axes)


def distributed_argmax(mesh: Mesh, values, index_offset: int, axes):
    """argmax over the last dim of ``values`` [..., v_loc], each member of
    the group over ``axes`` holding the shard that starts at global index
    ``index_offset``; ties go to the smallest global index.  Returns int32
    global indices, the same on every member."""
    loc_val, loc_idx = values.max(dim=-1)          # first maximum
    gmax = pmax(mesh, loc_val, axes)
    cand = torch.where(loc_val >= gmax,
                       (loc_idx + index_offset).to(torch.int32),
                       torch.full_like(loc_idx, _INT32_MAX, dtype=torch.int32))
    return pmin(mesh, cand, axes)


def ppermute(mesh: Mesh, x, axes, perm, *, wait: bool = True):
    """Send ``x`` along ``perm``, a tuple of (src, dst) pairs over the
    linear index of ``axes`` (the other coordinates fixed), and receive the
    block whose dst is this rank.  With ``wait=False`` returns (buffer,
    works): the caller waits on the works before it reads the buffer, so a
    shift overlaps the work launched in between."""
    me = mesh.index(axes)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) != 1 or len(src) != 1:
        raise ValueError(f"ppermute: {perm} is not a permutation at {me}")
    if dst[0] == me:
        return (x, []) if not wait else x
    x = x.contiguous()
    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, _global_rank(mesh, axes, dst[0])),
        dist.P2POp(dist.irecv, buf, _global_rank(mesh, axes, src[0]))])
    if not wait:
        return buf, works
    for w in works:
        w.wait()
    return buf


def halo_exchange_left(mesh: Mesh, x, axes, halo: int, axis: int):
    """The last ``halo`` entries of ``x`` along ``axis`` on the previous
    shard in the lexicographic order of ``axes``; the first shard gets
    zeros (the reference's ``halo_exchange_left``: the causal conv's left
    context across sequence shards).  One ``ppermute`` around the cyclic
    chain 0 -> 1 -> ... -> n-1 -> 0, so every member sends and receives
    one block; the block the first shard receives is dropped.  Serve only:
    not differentiable."""
    tail = x.narrow(axis, x.shape[axis] - halo, halo)
    n = mesh.axis_size(axes)
    if n == 1:
        return torch.zeros_like(tail)
    recv = ppermute(mesh, tail, axes, tuple((i, (i + 1) % n)
                                            for i in range(n)))
    return torch.zeros_like(recv) if mesh.index(axes) == 0 else recv


def distributed_linear_scan_carry(mesh: Mesh, a_prod, b_red, axes):
    """The state entering this shard of the recurrence h = a h + b chained
    across the shards over ``axes``, zeros for the first (the reference's
    ``distributed_linear_scan_carry``).  ``a_prod`` [...]: the product of
    a over this shard's steps; ``b_red`` [..., *rest]: the state the shard
    ends in from a zero start.  One all-gather of both summaries (packed
    into one buffer), then the exclusive combine h_{i+1} = a_i h_i + b_i
    up to this shard, locally (``linear_scan_carry``).  ``a_prod``
    travels at its own shape and is broadcast over ``b_red``'s trailing
    dims after the gather, where the reference broadcasts it before: the
    same products on 1/prod(rest) of its bytes.  Serve only: not
    differentiable."""
    n = mesh.axis_size(axes)
    if n == 1:
        return torch.zeros_like(b_red)
    na = a_prod.numel()
    flat = torch.cat([a_prod.reshape(-1), b_red.reshape(-1)])
    got = all_gather_inv(mesh, flat, axes)                 # [n, na + nb]
    return linear_scan_carry(got[:, :na].reshape((n,) + a_prod.shape),
                             got[:, na:].reshape((n,) + b_red.shape),
                             mesh.index(axes))


def linear_scan_carry(a_all, b_all, idx: int):
    """The local combine of ``distributed_linear_scan_carry``: from every
    shard's summaries, a_all [n, ...] and b_all [n, ..., *rest], the state
    entering shard ``idx`` (h_0 = 0, h_{i+1} = a_i h_i + b_i), a_i
    broadcast over b's trailing dims."""
    a_all = a_all.reshape(a_all.shape + (1,) * (b_all.ndim - a_all.ndim))
    h = torch.zeros_like(b_all[0])
    for i in range(idx):
        h = a_all[i] * h + b_all[i]
    return h


def last_shard_value(mesh: Mesh, x, axes):
    """The value the last shard over ``axes`` (lexicographic) holds, on
    every shard of ``axes`` (the reference's ``last_shard_value``, a psum
    of ``x`` masked to that shard: here one broadcast from it).  Serve
    only: not differentiable."""
    group = mesh.group(axes)
    if group is None:
        return x
    last = mesh.axis_size(axes) - 1
    y = (x.contiguous() if mesh.index(axes) == last else
         torch.empty(x.shape, dtype=x.dtype, device=x.device))
    dist.broadcast(y, src=_global_rank(mesh, axes, last), group=group)
    return y


def _global_rank(mesh: Mesh, axes, linear: int) -> int:
    """Global rank of the member at ``linear`` over ``axes``."""
    coords = {}
    for a in reversed(_axes(axes)):
        linear, coords[a] = divmod(linear, mesh.sizes[a])
    return mesh.rank_at(**coords)


def broadcast_scalar(mesh: Mesh, value: float, device) -> float:
    """Rank 0's ``value`` on every rank of the mesh (float64)."""
    group = mesh.group(tuple(mesh.sizes))
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0, group=group)
    return float(t.item())
