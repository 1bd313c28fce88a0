"""Carry parameters of the JAX package's ``DenseLM`` into the port's module.

The reference's param pytree (``DenseLM.init``) is ``embed``, ``head``,
``ln_f`` (``ln_fb``) and ``blocks``, a dict of per-layer arrays stacked on a
leading [L] axis.  Both packages keep weights in the [in, out] layout
(``x @ w``), so loading is a slice per layer and no transpose.  The tree
arrives as numpy arrays, so the two packages never share random bits.
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
