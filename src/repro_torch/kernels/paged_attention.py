"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention.py`` (``_kernel`` /
``paged_attention``).  The kernel is ``csrc/paged_attention.cu``: a split
kernel over (position split, kv head, batch) writes fp32 partials, and a
combine kernel on the same stream merges them.  The split is
``SPLIT_POSITIONS`` positions rounded down to whole pages
(``split_pages``), from nb and bs alone, so the wrapper never reads
``pos`` on the host.  ``paged_attention_plain`` gathers every request's
pages and runs a masked fp32 softmax over them, and serves the CPU tests,
``attn_impl="jnp"`` and ``chip_smoke.py``'s comparison.

Contract of both (the reference's): q [B, Hq, D]; pool_k/pool_v
[P, bs, Hkv, D]; table [B, nb] int32 local block ids; pos [B] int32, the
inclusive position of the new token (its K/V already written); kv_map [Hq]
int32 q head -> kv head.  Positions > pos and outside ``local_window`` are
masked with -1e30 and the running max is floored at -1e25, so a row with
nothing to attend gives zeros.  Returns [B, Hq, D] in q's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .flash_attention import DTYPES, HEAD_DIMS, M_FLOOR, NEG_INF, _scale
from .ops import LAUNCHES

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])

SPLIT_POSITIONS = 128   # positions per split block of the kernel
MAX_Q_HEADS = 256       # q heads the kernel's kv_map scan holds
_INT32S = (torch.int32,) * 3


@functools.cache
def _entry():
    """The kernel's C entry, built and resolved at the first launch."""
    return build.function("repro_paged_attention", _ARGTYPES)


def split_pages(nb: int, bs: int) -> tuple[int, int]:
    """(pages per split, number of splits) of the kernel's grid for a
    table of ``nb`` pages of ``bs`` positions: ``SPLIT_POSITIONS`` rounded
    down to whole pages (at least one)."""
    pps = max(1, SPLIT_POSITIONS // bs)
    return pps, -(-nb // pps)


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
    # Every layer of every decode step passes here, so the checks are
    # written without generators (a third of their host time).
    dev = q.get_device()
    if [t.get_device() for t in (pool_k, pool_v, table, pos,
                                 kv_map)] != [dev] * 5:
        raise ValueError("paged_attention: tensors on different devices")
    if q.dtype not in DTYPES or not (q.dtype == pool_k.dtype
                                     == pool_v.dtype):
        raise TypeError(f"paged_attention: needs one dtype among "
                        f"{list(DTYPES)}, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if (table.dtype, pos.dtype, kv_map.dtype) != _INT32S:
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
    if Hq > MAX_Q_HEADS:
        raise ValueError(f"paged_attention: {Hq} q heads > {MAX_Q_HEADS}")
    if not (q.is_contiguous() and pool_k.is_contiguous()
            and pool_v.is_contiguous() and table.is_contiguous()
            and pos.is_contiguous() and kv_map.is_contiguous()):
        raise ValueError("paged_attention: inputs must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned "
                         "(the kernel reads K rows 16 bytes at a time)")
    return dev


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
    dev = _check(q, pool_k, pool_v, table, pos, kv_map)
    B, Hq, D = q.shape
    bs, nb = pool_k.shape[1], table.shape[1]
    pps, n_splits = split_pages(nb, bs)
    out = torch.empty_like(q)
    # the partials (m, l, acc[D]) of every (batch, q head, split)
    scratch = torch.empty(B * Hq * n_splits * (D + 2), dtype=torch.float32,
                          device=q.device)
    # the raw handle of the device's current stream, and a device context
    # only off the current device, as kernel #1's launch does
    args = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), pos.data_ptr(), kv_map.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, Hq, pool_k.shape[2], bs,
            nb, D, DTYPES[q.dtype], int(local_window), pps,
            float(_scale(D, softmax_scale)),
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        rc = _entry()(*args)
    else:
        with torch.cuda.device(dev):
            rc = _entry()(*args)
    build.check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
