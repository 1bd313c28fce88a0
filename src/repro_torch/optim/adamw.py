"""AdamW and the cosine learning-rate schedule (PyTorch port of
``repro.optim.adamw``).

Plain functions on lists of tensors (the leaves of the reference's param
tree, in one fixed order), term for term the reference's update:
b1 0.9, b2 0.95, eps 1e-8, ``p - lr * ((m / c1) / (sqrt(v / c2) + eps)
+ wd * p)`` with weight decay on every leaf, fp32 moments, and an fp32
master copy when the params are low precision.  The update runs in place
(``torch._foreach_*``) where the reference returns new trees: an fp32
param is its own fp32 copy and is updated where it lies.  LAMB is not
ported yet (ROADMAP Queue A, item A3).
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


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step on ``params`` (updated in place, cast from the fp32
    result) and ``state`` (updated in place); ``lr`` is a float or a
    0-dim tensor.  Returns ``state``."""
    _check_state_f32(state)
    state["step"] += 1
    sf = torch.tensor(float(state["step"]), dtype=torch.float32)
    # the bias corrections in fp32, as the reference computes them
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** sf)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** sf)
    lr = float(lr)
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
    torch._foreach_add_(pf, upd, alpha=-lr)
    for p, new in zip(params, pf):
        if new is not p:
            p.copy_(new)
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
