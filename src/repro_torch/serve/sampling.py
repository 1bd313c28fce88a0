"""Per-request token sampling over full-vocab decode logits (port of
``repro.serve.sampling``).

The steps return [B, v_pad] float32 logits with padded vocab at -inf.  Each
slot carries its own (temperature, top_k, top_p, seed).  ``temperature ==
0`` rows take the greedy argmax, ties going to the smallest vocab id.  A
sampled row draws Gumbel noise from a ``torch.Generator`` seeded from
(seed, position), so a request's random stream depends only on its seed and
the absolute position of the token being sampled: preemption + re-prefill
replays the same trajectory.  These are not JAX's threefry bits, so a
sampled trajectory differs from the reference's; greedy ones agree.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0               # 0 = off
    top_p: float = 1.0           # 1 = off
    seed: int = 0
    max_new_tokens: int = 16


def _per_row(x, logits):
    """Scalar or [...] per-row parameter -> tensor shaped [..., 1]."""
    t = torch.as_tensor(x, device=logits.device)
    return t.reshape(*logits.shape[:-1], 1)


def mask_top_k(logits, k):
    """Keep the k highest logits of each row [..., V]; k <= 0 keeps all."""
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)          # rank of each vocab entry
    kk = _per_row(k, logits)
    kk = torch.where(kk <= 0, torch.full_like(kk, v), kk)
    return logits.masked_fill(ranks >= kk, float("-inf"))


def mask_top_p(logits, p):
    """Nucleus: keep the smallest prefix of each row's sorted distribution
    whose mass reaches p; p >= 1 keeps all.  As in the reference, token i
    (in sorted order) is kept iff the EXCLUSIVE prefix mass before it is
    < p, the top token is always kept, and ties resolve toward the smaller
    vocab id (stable sort)."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits.gather(-1, order), dim=-1)
    cum = probs.cumsum(-1)
    excl = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], -1)
    pp = _per_row(p, logits)
    keep_sorted = excl < pp
    keep_sorted[..., 0] = True                     # never empty support
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    keep |= pp >= 1.0
    return logits.masked_fill(~keep, float("-inf"))


def _generator(seed: int, position: int, device) -> torch.Generator:
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(key)


def sample_tokens(logits, temperature, top_k, top_p, seed, position):
    """logits [B, v_pad] float32; the rest are [B] per-slot arrays (host).

    position: absolute sequence position each sampled token will occupy
    (the generator's key).  Returns [B] token ids as a numpy int array."""
    out = logits.argmax(-1)
    temperature = np.asarray(temperature)
    hot = np.flatnonzero(temperature > 0.0)
    if hot.size:
        rows = torch.as_tensor(hot, device=logits.device)
        temps = torch.as_tensor(temperature[hot], device=logits.device)
        lg = logits[rows] / temps.clamp(min=1e-6)[:, None]
        lg = mask_top_k(lg, np.asarray(top_k)[hot])
        lg = mask_top_p(lg, np.asarray(top_p, np.float32)[hot])
        tiny = torch.finfo(torch.float32).tiny
        for j, i in enumerate(hot):
            gen = _generator(seed[i], position[i], logits.device)
            u = torch.rand(lg.shape[-1], generator=gen, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
            out[i] = torch.argmax(lg[j] + gumbel)   # gumbel-max == categorical
    return out.cpu().numpy()


def slot_arrays(params_list):
    """Stack per-slot SamplingParams into the sampler's input arrays."""
    return (np.array([p.temperature for p in params_list], np.float32),
            np.array([p.top_k for p in params_list], np.int32),
            np.array([p.top_p for p in params_list], np.float32),
            np.array([p.seed for p in params_list], np.int64))
