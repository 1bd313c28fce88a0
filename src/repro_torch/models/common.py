"""Shared model components (PyTorch port of ``repro.models.common``): RoPE,
MLP activations, the attention dispatchers and the paged-pool primitives.

Attention tensors use the model layout [B, T, H, D].  The dispatchers route
by ``attn_impl`` (kernels/ops.py): "pallas" to the kernel wrappers, "jnp" to
the plain versions beside them.  The reference's ``decode_pos_mask`` (the
jnp decode path's hoisted mask) lives inside
``kernels/paged_attention.py::paged_attention_plain``.

The dense-cache primitives (``cache_update``, ``decode_attention`` over the
``dense_view`` of the caches) serve the static decode loop; the
chunked-prefill primitives at the end serve the engine's chunk and
speculative-verify steps.  ``chunk_attention`` is plain PyTorch on every
device: the reference computes it as a full-score fp32 masked softmax in
jnp whatever ``attn_impl`` says, so it has no Pallas kernel to port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import FlashAttention, flash_fwd_plain
from ..kernels.ops import effective_attn_impl
from ..kernels.paged_attention import paged_attention as paged_kernel
from ..kernels.paged_attention import paged_attention_plain


def mlp_act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    if name == "relu2":  # squared ReLU (nemotron-4)
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 1e4):
    """Half-split rotation with fp32 angles.  x: [B, T, H, D]; positions:
    [T] or [B, T] global position ids."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # [D/2]
    if positions.ndim == 1:
        ang = (positions[:, None].float() * freqs[None, :])[None, :, None, :]
    else:
        ang = (positions[..., None].float() * freqs)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def attention(q, k, v, *, q_pos, causal: bool = True, local_window: int = 0,
              softmax_scale=None, impl: str = "jnp", q_start=None):
    """Prefill / training attention in the model layout: q [B, Tq, Hq, D],
    k/v [B, Tk, Hkv, D] with KV rows at positions 0..Tk-1 -> [B, Tq, Hq, D].

    Differentiable on both paths: "pallas" goes through ``FlashAttention``
    (the flash forward kernel, and the dQ and dK/dV kernels in the
    backward); "jnp" is autograd through ``flash_fwd_plain``, the
    independent oracle.  ``q_start`` is the static q-row offset that lets
    the kernels skip tiles; None (the seq-sharded Tesseract prefill, as in
    the reference) walks every tile under the ``q_pos`` masks."""
    path = effective_attn_impl(impl, q.device)
    args = (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())
    q_pos = None if q_start is not None else q_pos
    if path == "pallas":
        out = FlashAttention.apply(*args, causal, local_window, q_pos,
                                   q_start, softmax_scale)
    else:
        out, _ = flash_fwd_plain(*args, causal=causal,
                                 local_window=local_window, q_pos=q_pos,
                                 q_start=q_start, softmax_scale=softmax_scale)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Paged KV cache primitives (serve/ continuous batching).
#
# A layer's pool is [P, bs, Hkv, D]: P physical blocks of bs positions.  A
# block table [B, nb] maps request b's logical block i (positions i*bs ..
# i*bs+bs-1) to a physical block id.  Retired/inactive batch slots point
# every table entry at the scratch block and are masked by their position,
# so the math stays fixed-shape across steps.
# ---------------------------------------------------------------------------

def contiguous_kv_map(Hq: int, Hkv: int, device=None):
    """[Hq] int32 q head -> kv head of contiguous GQA (h // (Hq / Hkv))."""
    return (torch.arange(Hq, dtype=torch.int32, device=device)
            // (Hq // Hkv)).to(torch.int32)


def paged_step_indices(table, pos, bs: int):
    """(blk, off) scatter coordinates of each request's current position;
    position-only, so a decode step computes them once for all layers."""
    blk = table.gather(1, (pos // bs).long()[:, None])[:, 0]
    return blk.long(), (pos % bs).long()


def paged_update(pool, new_k, new_v, idx):
    """Write one step's K/V [B, 1, Hkv, D] into the layer pool
    {"k", "v": [P, bs, Hkv, D]} at ``idx`` = paged_step_indices(...).

    In place (the reference returns an updated copy via ``.at[].set``): the
    pool views share storage with the engine's [L, P, bs, Hkv, D] pool."""
    blk, off = idx
    pool["k"][blk, off] = new_k[:, 0].to(pool["k"].dtype)
    pool["v"][blk, off] = new_v[:, 0].to(pool["v"].dtype)


def paged_attention(q, pool_k, pool_v, table, pos, *, kv_map,
                    local_window: int = 0, softmax_scale=None,
                    impl: str = "jnp"):
    """Single-step attention against a paged pool.  q: [B, Hq, D]; pos: [B]
    int32 positions of the incoming tokens, whose K/V paged_update already
    wrote; kv_map: [Hq] int32 (contiguous_kv_map for plain GQA)."""
    path = effective_attn_impl(impl, q.device)
    fn = paged_kernel if path == "pallas" else paged_attention_plain
    return fn(q.contiguous(), pool_k, pool_v, table, pos, kv_map,
              local_window=local_window, softmax_scale=softmax_scale)


def decode_bs(S: int) -> int:
    """Page size of a dense cache's pool view: the largest divisor of S up
    to 128 (the reference's ``_decode_bs``)."""
    bs = min(128, S)
    while S % bs:
        bs -= 1
    return bs


def dense_view(B: int, S: int, cur_pos: int, device):
    """The block table of B dense caches of S positions viewed as one
    contiguous page pool, (page size, table [B, S / bs] int32 =
    arange(B * S / bs), positions [B] int32 all ``cur_pos``); position-only,
    so a decode step builds it once for all layers."""
    bs = decode_bs(S)
    table = torch.arange(B * (S // bs), dtype=torch.int32,
                         device=device).reshape(B, S // bs)
    return bs, table, torch.full((B,), cur_pos, dtype=torch.int32,
                                 device=device)


def cache_update(cache, new_k, new_v, cur_pos: int):
    """Write one step's K/V [B, 1, Hkv, D] into the layer's dense cache
    {"k", "v": [B, S, Hkv, D]} at position ``cur_pos``, in place."""
    cache["k"][:, cur_pos] = new_k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cur_pos] = new_v[:, 0].to(cache["v"].dtype)


def decode_attention(q, k_cache, v_cache, view, *, kv_map,
                     local_window: int = 0, softmax_scale=None,
                     impl: str = "jnp"):
    """Single-step attention against dense caches: q [B, Hq, D], k_cache /
    v_cache [B, S, Hkv, D] holding the new token's K/V at ``cur_pos``,
    ``view`` = dense_view(B, S, cur_pos): the caches are viewed as a
    contiguous page pool and the paged decode runs on it (the reference's
    ``decode_attention`` with impl="pallas"; its jnp path's masked softmax
    is the paged kernel's plain version)."""
    bs, table, pos = view
    B, S, Hkv, D = k_cache.shape
    pool_k = k_cache.reshape(B * (S // bs), bs, Hkv, D)
    pool_v = v_cache.reshape(B * (S // bs), bs, Hkv, v_cache.shape[-1])
    return paged_attention(q, pool_k, pool_v, table, pos, kv_map=kv_map,
                           local_window=local_window,
                           softmax_scale=softmax_scale, impl=impl)


def paged_gather(pool_k, pool_v, table, kv_map=None):
    """Each request's pages as contiguous K/V [B, nb * bs, H, D] in logical
    position order.  pool_k/pool_v: [P, bs, Hkv, D]; table: [B, nb] local
    block ids; ``kv_map`` ([Hq] q head -> kv head) expands the heads in the
    same gather (H = Hq), else H = Hkv."""
    B, nb = table.shape
    idx = table.long()
    k, v = pool_k[idx], pool_v[idx]               # [B, nb, bs, Hkv, D]
    k = k.reshape(B, nb * pool_k.shape[1], *pool_k.shape[2:])
    v = v.reshape(B, nb * pool_v.shape[1], *pool_v.shape[2:])
    if kv_map is not None:
        heads = kv_map.long()
        k, v = k[:, :, heads], v[:, :, heads]
    return k, v


# ---------------------------------------------------------------------------
# Chunked-prefill primitives (the engine's prefix cache, chunk interleave
# and speculative verify).  A chunk step processes C consecutive positions
# per batch slot against the same paged pool the decode step uses; per-slot
# chunk starts differ, so positions and masks carry a [B, C] batch axis.
# ---------------------------------------------------------------------------

def chunk_pos_mask(positions, S: int, local_window: int = 0):
    """[B, C, S] causal validity mask of a chunk at absolute q positions
    ``positions`` [B, C]; position-only, so computed once for all layers."""
    kv = torch.arange(S, device=positions.device)
    mask = kv[None, None, :] <= positions[:, :, None]
    if local_window > 0:
        mask &= kv[None, None, :] > (positions[:, :, None] - local_window)
    return mask


def paged_chunk_indices(table, positions, bs: int, valid):
    """(blk, off) [B, C] scatter coordinates of a whole chunk.  Padded
    entries (``valid`` False) go to the scratch block (local id 0) at
    offset 0, where garbage is masked by construction."""
    nb = table.shape[1]
    blk_i = (positions // bs).clamp(0, nb - 1).long()
    blk = table.gather(1, blk_i).long()
    blk = torch.where(valid, blk, torch.zeros_like(blk))
    off = torch.where(valid, positions % bs, torch.zeros_like(positions))
    return blk, off.long()


def paged_update_chunk(pool, new_k, new_v, idx):
    """Write a chunk's K/V [B, C, Hkv, D] into the layer pool {"k", "v":
    [P, bs, Hkv, D]} at ``idx`` = paged_chunk_indices(...), in place like
    ``paged_update`` (the reference returns an updated copy)."""
    blk, off = idx
    pool["k"][blk, off] = new_k.to(pool["k"].dtype)
    pool["v"][blk, off] = new_v.to(pool["v"].dtype)


def chunk_attention(q, k_cache, v_cache, *, mask, softmax_scale=None):
    """Causal attention of a C-token chunk against contiguous K/V.

    q: [B, C, Hq, D]; k_cache/v_cache: [B, S, H, D] (H == Hq when the GQA
    map was folded into the gather, else Hkv with contiguous grouping);
    mask: [B, C, S] (``chunk_pos_mask``).  A full-score fp32 masked softmax
    with no online accumulation, so the result does not depend on how a
    prompt was split into chunks; the probabilities are rounded to V's
    dtype before the second product, as the reference's are.  Fully
    masked rows (padding) come out zero."""
    B, C, Hq, D = q.shape
    H = k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    g = Hq // H
    qg = q.float().reshape(B, C, H, g, D)
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k_cache.float()) * scale
    s.masked_fill_(~mask[:, None, None], float("-inf"))
    row_has = mask.any(-1)[:, None, None, :, None]       # [B, 1, 1, C, 1]
    s.masked_fill_(~row_has, 0.0)
    p = torch.softmax(s, dim=-1)
    del s
    p.masked_fill_(~row_has, 0.0)
    out = torch.einsum("bhgcs,bshd->bchgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, C, Hq, v_cache.shape[-1]).to(q.dtype)
