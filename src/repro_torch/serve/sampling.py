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

Speculative decoding's rejection sampling (``spec_target_probs``,
``spec_accept``; Leviathan et al. 2023) commits at every position a token
distributed exactly as the plain sampler's.  Its accept (tag 1) and
residual (tag 2) draws are keyed on (seed, position, tag), apart from the
(seed, position) stream the plain sampler and the bonus token draw from,
so a preempted request replays its accept/reject trajectory too.
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


def spec_target_probs(logits, temperature, top_k, top_p):
    """logits [R, v_pad] -> [R, v_pad] float32: the post-mask distribution
    each row's temperature > 0 draw in ``sample_tokens`` samples from
    (temperature, then top-k, then top-p, then softmax), the target p of
    the accept/reject test.  The parameters are scalars, shared by every
    row (one request's verify rows)."""
    lg = torch.as_tensor(logits, dtype=torch.float32)
    rows = lg.shape[0]
    lg = lg / max(float(temperature), 1e-6)
    lg = mask_top_k(lg, np.full(rows, int(top_k), np.int32))
    lg = mask_top_p(lg, np.full(rows, float(top_p), np.float32))
    return torch.softmax(lg, dim=-1)


def _spec_generator(seed: int, position: int, tag: int) -> torch.Generator:
    """Host generator of the accept (tag 1) / residual (tag 2) draw at a
    position: the (seed, position) key of ``_generator`` mixed with the
    tag (splitmix64), so it never reads the plain sampler's stream."""
    mask = (1 << 64) - 1
    key = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
           + (int(tag) + 1) * 0x9E3779B97F4A7C15) & mask
    key = ((key ^ (key >> 30)) * 0xBF58476D1CE4E5B9) & mask
    key = ((key ^ (key >> 27)) * 0x94D049BB133111EB) & mask
    return torch.Generator().manual_seed(key ^ (key >> 31))


def spec_accept(row_probs, proposals, draft_probs, seed, pos0):
    """Host-side accept/reject over one slot's verify rows.

    row_probs: [C, V] target distributions (row c governs the token at
    absolute position pos0 + c + 1); proposals: the judged draft tokens
    (proposal c by row c); draft_probs: None for point-mass proposers
    (n-gram lookup, a greedy draft), else [len(proposals), V] draft
    distributions q.  Returns (tokens, n_accepted): one token per judged
    row up to and including the first rejection, the accepted proposals
    verbatim, then one draw from the residual max(p - q, 0) / Z.  When
    every proposal is accepted the caller appends the bonus token, which
    the plain sampler draws from the last row."""
    rp = np.asarray(torch.as_tensor(row_probs).double().cpu())
    tokens, n_acc = [], 0
    for c, d in enumerate(proposals):
        d = int(d)
        p = rp[c]
        q_d = 1.0 if draft_probs is None else float(draft_probs[c][d])
        position = int(pos0) + c + 1
        u = float(torch.rand(1, generator=_spec_generator(seed, position, 1),
                             dtype=torch.float64))
        if u * q_d < p[d] or q_d <= 0.0:
            tokens.append(d)
            n_acc += 1
            continue
        # rejected: the correction comes from the residual distribution
        if draft_probs is None:
            r = p.copy()
            r[d] = 0.0
        else:
            r = np.maximum(p - np.asarray(draft_probs[c], np.float64), 0.0)
        z = r.sum()
        if z <= 0.0:
            # p == q numerically: any p-distributed draw is correct
            r, z = p, p.sum()
        u2 = torch.rand(r.shape[0],
                        generator=_spec_generator(seed, position, 2),
                        dtype=torch.float64).numpy()
        g = -np.log(-np.log(np.maximum(u2, np.finfo(np.float64).tiny)))
        with np.errstate(divide="ignore"):
            logr = np.where(r > 0.0, np.log(np.maximum(r / z, 1e-300)),
                            -np.inf)
        tokens.append(int(np.argmax(logr + g)))
        break
    return tokens, n_acc


def slot_arrays(params_list):
    """Stack per-slot SamplingParams into the sampler's input arrays."""
    return (np.array([p.temperature for p in params_list], np.float32),
            np.array([p.top_k for p in params_list], np.int32),
            np.array([p.top_p for p in params_list], np.float32),
            np.array([p.seed for p in params_list], np.int64))
