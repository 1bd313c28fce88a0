"""AdamW, LAMB and the cosine learning-rate schedule (PyTorch port of
``repro.optim.adamw``).

Plain functions on lists of tensors (the leaves of the reference's param
tree, in one fixed order), term for term the reference's updates, with
fp32 moments and an fp32 master copy when the params are low precision.
AdamW: b1 0.9, b2 0.95, eps 1e-8, ``p - lr * ((m / c1) / (sqrt(v / c2) +
eps) + wd * p)`` with weight decay on every leaf.  LAMB: b1 0.9, b2 0.999,
eps 1e-6, the same direction ``u`` scaled per reference leaf by the trust
ratio ``||p|| / ||u||`` (1 where either norm is 0).  The updates run in
place (``torch._foreach_*``) where the reference returns new trees: an
fp32 param is its own fp32 copy and is updated where it lies.
"""
from __future__ import annotations

import math

import torch


def adamw_init(params, *, master: bool = False) -> dict:
    """{"m", "v": fp32 zeros per leaf, "step": 0, "master": fp32 copies
    (only when ``master``)}."""
    st = {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
          "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
          "step": 0}
    if master:
        st["master"] = [p.detach().float().clone() for p in params]
    return st


def _check_state_f32(state):
    """The moments (and master copy) must stay fp32: a bf16 m/v silently
    destroys the running second moment (eps^2-scale values underflow)."""
    for name in ("m", "v", "master"):
        for i, leaf in enumerate(state.get(name, ())):
            if leaf.dtype != torch.float32:
                raise TypeError(
                    f"optimizer state {name}[{i}] is {leaf.dtype}, must be "
                    f"float32 — a low-precision moment/master accumulates "
                    f"silent rounding error")


def _adam_direction(params, grads, state, *, b1, b2, eps, weight_decay):
    """Advance the moments in place and return (the fp32 params, the
    update direction ``(m / c1) / (sqrt(v / c2) + eps) + wd * p``), both
    lists of fp32 tensors; the bias corrections in fp32, as the reference
    computes them."""
    _check_state_f32(state)
    state["step"] += 1
    sf = torch.tensor(float(state["step"]), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** sf)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** sf)
    m, v = state["m"], state["v"]
    gf = [g.float() for g in grads]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gf, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, gf, gf, value=1 - b2)
    del gf
    pf = state.get("master") or [p if p.dtype == torch.float32 else p.float()
                                 for p in params]
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, pf, alpha=weight_decay)
    return pf, upd


def _write_back(params, pf):
    for p, new in zip(params, pf):
        if new is not p:
            p.copy_(new)


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step on ``params`` (updated in place, cast from the fp32
    result) and ``state`` (updated in place); ``lr`` is a float or a
    0-dim tensor.  Returns ``state``."""
    pf, upd = _adam_direction(params, grads, state, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay)
    torch._foreach_add_(pf, upd, alpha=-float(lr))
    _write_back(params, pf)
    return state


@torch.no_grad()
def lamb_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-6,
                weight_decay=0.0, leaf_groups=None, norm_fn=None):
    """One LAMB step (the reference's ``lamb_update``): the AdamW direction
    u, then ``p - lr * trust * u`` with ``trust = ||p|| / ||u||`` where
    both norms are > 0, else 1.  ``params`` and ``state`` are updated in
    place, as ``adamw_update`` does; returns ``state``.

    The norms are those of the reference's leaves.  ``leaf_groups`` gives
    each leaf the index of the reference leaf it is a part of (the port's
    per-layer ``blocks.<i>.wq`` are the layers of the reference's stacked
    ``blocks.wq``); by default every leaf is its own.  The sums of squares
    of p and u are summed per group into one [2, n_groups] float64 tensor
    (the reference sums in fp32, whose error over a stacked leaf of 10^5 to
    10^8 elements reaches ~1e-6 of the norm), and ``norm_fn`` maps it to
    the global sums (across ranks: each group's sums divided by its
    replication factor and psum'd over the mesh, one collective for every
    group; by default the local sums, one unsharded rank); ``lr * trust``
    is rounded to fp32 once."""
    pf, upd = _adam_direction(params, grads, state, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay)
    n = len(pf)
    groups = list(range(n)) if leaf_groups is None else list(leaf_groups)
    dev = pf[0].device
    idx = torch.tensor(groups, dtype=torch.long, device=dev)
    f64 = torch.float64
    norms = torch.stack(torch._foreach_norm(pf, 2, dtype=f64)
                        + torch._foreach_norm(upd, 2, dtype=f64))
    sq = torch.zeros(2, max(groups) + 1, dtype=f64, device=dev)
    sq.index_add_(1, idx, (norms * norms).reshape(2, n))
    if norm_fn is not None:
        sq = norm_fn(sq)
    pn, un = torch.sqrt(sq)
    trust = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
    coef = (torch.as_tensor(lr, dtype=f64, device=dev)
            * trust[idx]).float()
    torch._foreach_mul_(upd, list(coef.unbind(0)))
    torch._foreach_sub_(pf, upd)
    _write_back(params, pf)
    return state


def cosine_lr(step, *, base_lr, warmup: int, total: int,
              min_frac: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; a 0-dim fp32 tensor
    computed in fp32, as the reference's."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
