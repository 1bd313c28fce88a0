"""Carry parameters between the JAX package's ``DenseLM`` tree and the
port's module.

The reference's param pytree (``DenseLM.init``) is ``embed``, ``head``,
``ln_f`` (``ln_fb``) and ``blocks``, a dict of per-layer arrays stacked on a
leading [L] axis.  Both packages keep weights in the [in, out] layout
(``x @ w``), so loading is a slice per layer and no transpose.  The tree
travels as numpy arrays, so the two packages never share random bits:
``params_from_jax`` loads one into the model, ``params_to_numpy`` and
``grads_to_numpy`` give the model's params and gradients back in the same
layout (float32), so tests compare them leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch


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
    (a repro_torch DenseLM) in place and return the model."""
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
