"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention.py`` (``_kernel`` /
``paged_attention``).  The kernel is ``csrc/paged_attention.cu``;
``paged_attention_plain`` gathers every request's pages and runs a masked
fp32 softmax over them, and serves the CPU tests, ``attn_impl="jnp"`` and
``chip_smoke.py``'s comparison.

Contract of both (the reference's): q [B, Hq, D]; pool_k/pool_v
[P, bs, Hkv, D]; table [B, nb] int32 local block ids; pos [B] int32, the
inclusive position of the new token (its K/V already written); kv_map [Hq]
int32 q head -> kv head.  Positions > pos and outside ``local_window`` are
masked with -1e30 and the running max is floored at -1e25, so a row with
nothing to attend gives zeros.  Returns [B, Hq, D] in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attention import DTYPES, HEAD_DIMS, M_FLOOR, NEG_INF, _scale
from .ops import LAUNCHES

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def paged_attention_plain(q, pool_k, pool_v, table, pos, kv_map, *,
                          local_window: int = 0, softmax_scale=None):
    """Plain PyTorch version of the paged kernel (see the module doc)."""
    B, Hq, D = q.shape
    bs = pool_k.shape[1]
    nb = table.shape[1]
    S = nb * bs
    idx = table.long()
    heads = kv_map.long()
    k = pool_k[idx].reshape(B, S, -1, D)[:, :, heads]        # [B, S, Hq, D]
    v = pool_v[idx].reshape(B, S, -1, pool_v.shape[-1])[:, :, heads]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * _scale(
        D, softmax_scale)
    ppos = torch.arange(S, device=q.device)[None, :]
    cur = pos.long()[:, None]
    mask = ppos <= cur
    if local_window > 0:
        mask &= ppos > cur - local_window
    s = s.masked_fill(~mask[:, None, :], NEG_INF)
    m = s.amax(-1).clamp(min=M_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    ls = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhs,bshd->bhd", p, v.float()) / ls[..., None]
    return out.to(q.dtype)


def _check(q, pool_k, pool_v, table, pos, kv_map):
    dev = q.device
    if any(t.device != dev for t in (pool_k, pool_v, table, pos, kv_map)):
        raise ValueError("paged_attention: tensors on different devices")
    if q.dtype not in DTYPES or not (q.dtype == pool_k.dtype
                                     == pool_v.dtype):
        raise TypeError(f"paged_attention: needs one dtype among "
                        f"{list(DTYPES)}, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if any(t.dtype != torch.int32 for t in (table, pos, kv_map)):
        raise TypeError("paged_attention: table, pos, kv_map must be int32")
    B, Hq, D = q.shape
    if (pool_k.ndim != 4 or pool_k.shape != pool_v.shape
            or pool_k.shape[3] != D or table.ndim != 2
            or table.shape[0] != B or pos.shape != (B,)
            or kv_map.shape != (Hq,) or table.shape[1] == 0):
        raise ValueError(
            f"paged_attention: bad shapes q{tuple(q.shape)} "
            f"pool{tuple(pool_k.shape)} table{tuple(table.shape)} "
            f"pos{tuple(pos.shape)} kv_map{tuple(kv_map.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {D} not in {HEAD_DIMS}")
    if not all(t.is_contiguous()
               for t in (q, pool_k, pool_v, table, pos, kv_map)):
        raise ValueError("paged_attention: inputs must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned "
                         "(the kernel reads K rows 16 bytes at a time)")


def paged_attention(q, pool_k, pool_v, table, pos, kv_map, *,
                    local_window: int = 0, softmax_scale=None):
    """One decode step against a paged pool.  A CUDA tensor launches
    ``csrc/paged_attention.cu`` (or raises); a CPU tensor takes
    ``paged_attention_plain``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, table, pos, kv_map,
                                     local_window=local_window,
                                     softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check(q, pool_k, pool_v, table, pos, kv_map)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    fn = build.function("repro_paged_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                table.data_ptr(), pos.data_ptr(), kv_map.data_ptr(),
                out.data_ptr(), B, Hq, pool_k.shape[2], pool_k.shape[1],
                table.shape[1], D, DTYPES[q.dtype], int(local_window),
                float(_scale(D, softmax_scale)), stream)
    build.check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
