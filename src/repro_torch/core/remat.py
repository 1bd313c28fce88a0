"""remat="dots": a block's products kept in its forward and handed back in
its recompute.

The reference checkpoints each block with
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the outputs
of its projections (dots without batch dims) are saved, and the backward
recomputes the rest from them and the block input.  Attention, whose
products have batch dims, is recomputed.  JAX then saves only what the
backward reads, so the block's last product (the down projection, which
only the residual add reads) is neither saved nor recomputed.

Here the block runs under ``torch.utils.checkpoint`` with
``context_fn=dots_contexts``: the block's forward runs in a "record"
context and its recompute in a "replay" context of the same
``DotsStash``.  Every product of the block calls ``product``: in record it
computes its output and keeps it (or, with ``keep=False``, only its
shape); in replay it hands the kept output back, in the same order,
without computing it, or, with ``keep=False``, an uninitialised tensor of
its shape, which nothing of the backward reads (the recompute stops once
the last saved tensor is recomputed, right after that product's own
inputs are saved).  A product still saves what its own backward reads in
either context.  The hook sits inside the products (``core/summa.py``'s
``_TesseractMatmul``, ``core/ops.py``'s ``_LocalMatmul``), so it sees the
kernel launches that a policy over dispatcher ops would not.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_active = threading.local()


class DotsStash:
    """The products of one block's forward, in call order: a tensor for a
    kept output, (shape, dtype, device) for one that is not kept."""

    def __init__(self):
        self.outs = []
        self._next = 0

    @contextlib.contextmanager
    def _mode(self, mode):
        prev = getattr(_active, "state", None)
        _active.state = (self, mode)
        try:
            yield
        finally:
            _active.state = prev

    def kept(self):
        """The kept outputs (tensors), in call order."""
        return [o for o in self.outs if isinstance(o, torch.Tensor)]

    def _record(self, out, keep):
        self.outs.append(out.detach() if keep
                         else (out.shape, out.dtype, out.device))

    def _replay(self):
        out = self.outs[self._next]
        self.outs[self._next] = None          # freed once handed back
        self._next += 1
        if isinstance(out, torch.Tensor):
            return out
        shape, dtype, device = out
        return torch.empty(shape, dtype=dtype, device=device)


def dots_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for remat="dots": the
    (forward, recompute) contexts of a new ``DotsStash``."""
    stash = DotsStash()
    return stash._mode("record"), stash._mode("replay")


def replaying() -> bool:
    """Whether a block's recompute is running under remat="dots"."""
    state = getattr(_active, "state", None)
    return state is not None and state[1] == "replay"


def product(compute, keep: bool = True):
    """A product's output: ``compute()`` outside remat="dots"; recorded in
    a block's forward; handed back, not computed, in its recompute."""
    state = getattr(_active, "state", None)
    if state is None:
        return compute()
    stash, mode = state
    if mode == "replay":
        return stash._replay()
    out = compute()
    stash._record(out, keep)
    return out
