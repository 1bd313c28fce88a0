"""Shared model components (PyTorch port of ``repro.models.common``): RoPE,
MLP activations, the attention dispatchers and the paged-pool primitives.

Attention tensors use the model layout [B, T, H, D].  The dispatchers route
by ``attn_impl`` (kernels/ops.py): "pallas" to the kernel wrappers, "jnp" to
the plain versions beside them.  The reference's ``decode_pos_mask`` and
``paged_gather`` (the jnp decode path's hoisted mask and page gather) live
inside ``kernels/paged_attention.py::paged_attention_plain``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_fwd, flash_fwd_plain
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
    """Prefill attention in the model layout: q [B, Tq, Hq, D], k/v
    [B, Tk, Hkv, D] with KV rows at positions 0..Tk-1 -> [B, Tq, Hq, D].

    ``q_start`` is the static q-row offset that lets the flash kernel skip
    KV tiles; None (the seq-sharded Tesseract prefill, as in the reference)
    walks every tile under the ``q_pos`` masks."""
    path = effective_attn_impl(impl, q.device)
    fn = flash_fwd if path == "pallas" else flash_fwd_plain
    out, _ = fn(q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=causal,
                local_window=local_window,
                q_pos=None if q_start is not None else q_pos,
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
