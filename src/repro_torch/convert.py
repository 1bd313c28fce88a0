"""Carry parameters between the JAX package's param trees and the port's
modules (``DenseLM`` and ``MambaLM``).

The reference's param pytree (``DenseLM.init``, ``MambaLM.init``) is
``embed``, ``head``, ``ln_f`` (``ln_fb``) and ``blocks``, a dict of
per-layer arrays stacked on a leading [L] axis; the port's modules hold the
same names (top-level params, and ``blocks[i]``'s params).  Both packages
keep weights in the [in, out] layout (``x @ w``), so loading is a slice
per layer and no transpose.  The tree
travels as numpy arrays, so the two packages never share random bits:
``params_from_jax`` loads one into the model, ``params_to_numpy`` and
``grads_to_numpy`` give the model's params and gradients back in the same
layout (float32), so tests compare them leaf by leaf.  Across ranks
``shard_params`` cuts the reference's global tree into one rank's blocks
first, and ``unshard_params`` puts every rank's blocks back together.
A global tree travels between processes as an .npz file of
``flatten_params``, read back by ``load_params``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.mesh import AXES, axis_index, axis_size, local_block
from .models.ssm import ssm_param_specs
from .models.transformer import dense_param_specs


def _load(param, arr, name):
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                         f"{tuple(param.shape)}")
    src = torch.from_numpy(np.array(arr, dtype=np.float32))
    param.copy_(src.to(device=param.device, dtype=param.dtype))


@torch.no_grad()
def params_from_jax(tree, model):
    """Load ``tree`` (the reference's params as numpy arrays) into ``model``
    (a repro_torch DenseLM or MambaLM) in place and return the model."""
    top = {k: v for k, v in tree.items() if k != "blocks"}
    want = {n for n, _ in model.named_parameters(recurse=False)}
    if set(top) != want:
        raise KeyError(f"top-level params {sorted(top)} != {sorted(want)}")
    for name, arr in top.items():
        _load(getattr(model, name), arr, name)
    blocks = tree["blocks"]
    want = {n for n, _ in model.blocks[0].named_parameters()}
    if set(blocks) != want:
        raise KeyError(f"block params {sorted(blocks)} != {sorted(want)}")
    for name, stacked in blocks.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != len(model.blocks):
            raise ValueError(f"blocks.{name}: {stacked.shape[0]} layers, "
                             f"model has {len(model.blocks)}")
        for i, blk in enumerate(model.blocks):
            _load(getattr(blk, name), stacked[i], f"blocks.{name}[{i}]")
    return model


def _tree(model, leaf):
    """The reference's tree layout of ``leaf(param)`` over ``model``."""
    tree = {n: leaf(p) for n, p in model.named_parameters(recurse=False)}
    names = [n for n, _ in model.blocks[0].named_parameters()]
    tree["blocks"] = {n: np.stack([leaf(getattr(blk, n))
                                   for blk in model.blocks])
                      for n in names}
    return tree


def _np32(t):
    """A float32 numpy copy (never a view of the live tensor's storage)."""
    return t.detach().float().cpu().numpy().copy()


def params_to_numpy(model):
    """The model's params as the reference's tree of float32 numpy arrays,
    blocks stacked on [L]."""
    return _tree(model, _np32)


def grads_to_numpy(model):
    """The params' ``.grad`` in the same layout (zeros where a param has
    no gradient)."""
    return _tree(model, lambda p: (_np32(p.grad) if p.grad is not None
                                   else np.zeros(p.shape, np.float32)))


def param_specs(cfg, ctx):
    """The family's spec table of ``cfg`` under ``ctx``:
    ``dense_param_specs`` or ``ssm_param_specs``."""
    if cfg.family == "ssm":
        return ssm_param_specs(cfg, ctx)
    return dense_param_specs(cfg, ctx)


def shard_params(tree, cfg, ctx, coords):
    """One rank's local blocks of the reference's global param tree
    (``DenseLM.init`` or ``MambaLM.init``, as numpy arrays) on the mesh of
    ``ctx``, the rank at ``coords`` ({"data", "depth", "row", "col"}), in
    the same tree layout:
    each leaf zero-padded to the layout's padded shape where it has the
    logical one (vocab and q heads, as the reference's ``winit_padded``
    pads: a tree drawn for one device serves every layout), then cut by the
    reference's partition specs (``param_specs``, blocks stacked on a
    leading [L]).
    ``params_from_jax(shard_params(...), model)`` loads them into that
    rank's model."""
    sizes = {"data": ctx.data, "depth": ctx.depth, "row": ctx.rows,
             "col": ctx.cols}
    top, block = param_specs(cfg, ctx)

    def cut(arr, spec_entry, lead=()):
        logical, padded, spec = spec_entry
        arr = np.asarray(arr)
        if arr.shape == lead + logical and logical != padded:
            arr = np.pad(arr, [(0, 0)] * len(lead) + [
                (0, p - n) for n, p in zip(logical, padded)])
        return np.ascontiguousarray(local_block(
            arr, ((),) * len(lead) + spec, sizes, coords))

    out = {name: cut(arr, top[name])
           for name, arr in tree.items() if name != "blocks"}
    out["blocks"] = {name: cut(arr, block[name], lead=(cfg.num_layers,))
                     for name, arr in tree["blocks"].items()}
    return out


def unshard_params(trees, cfg, ctx):
    """The inverse of ``shard_params``: the global tree (logical shapes,
    the padding cut off) from ``trees``, every rank's tree of local blocks
    (``params_to_numpy`` or ``grads_to_numpy`` of each rank's model) in
    rank order.  A block a leaf repeats over the axes it is replicated on
    is taken from every rank that holds it, so the ranks must agree there
    (as synced gradients and params do)."""
    sizes = {"data": ctx.data, "depth": ctx.depth, "row": ctx.rows,
             "col": ctx.cols}
    shape = tuple(sizes[a] for a in AXES)
    if len(trees) != ctx.size:
        raise ValueError(f"{len(trees)} trees for a mesh of {ctx.size}")
    coords = [dict(zip(AXES, (int(c) for c in np.unravel_index(r, shape))))
              for r in range(ctx.size)]
    top, block = param_specs(cfg, ctx)

    def join(blocks, spec_entry, lead=()):
        logical, padded, spec = spec_entry
        spec = ((),) * len(lead) + spec
        out = np.zeros(lead + padded, np.float32)
        for arr, c in zip(blocks, coords):
            idx = []
            for dim, axes in enumerate(spec):
                m = out.shape[dim] // axis_size(sizes, axes)
                i = axis_index(sizes, c, axes)
                idx.append(slice(i * m, (i + 1) * m))
            out[tuple(idx)] = arr
        return np.ascontiguousarray(out[tuple(slice(n) for n in
                                              lead + logical)])

    out = {name: join([t[name] for t in trees], top[name])
           for name in trees[0] if name != "blocks"}
    out["blocks"] = {name: join([t["blocks"][name] for t in trees],
                                block[name], lead=(cfg.num_layers,))
                     for name in trees[0]["blocks"]}
    return out


def flatten_params(tree, prefix=""):
    """The reference's param tree as {"a/b": array} for an .npz file."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_params(path):
    """The param tree of an .npz file written from ``flatten_params``."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree
