"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py`` (``_fwd_kernel`` /
``_fwd_call``, reached from ``flash_attention`` and ``flash_fwd_step``).
The kernel is ``csrc/flash_fwd.cu``; ``flash_fwd_plain`` is the same
function in straightforward PyTorch (the full fp32 score matrix), used by
the CPU tests, by ``attn_impl="jnp"`` and by ``chip_smoke.py``'s comparison.

Contract of both (the reference's): q [B, Hq, Tq, D], k/v [B, Hkv, Tk, D]
with Hq = g * Hkv (q head h reads kv head h // g); KV rows sit at positions
0..Tk-1; ``q_pos`` ([Tq] int, default ``q_start + arange(Tq)``) drives the
causal and ``local_window`` masks; ``q_start`` is the static row offset that
lets the kernel skip KV tiles (None walks every tile under the mask).
Scores, softmax and the P.V sum are fp32.  A masked score is -1e30 and the
running max is floored at -1e25, so a fully masked row gives an exact-zero
output row and lse = -1e25.  Returns (out in q's dtype, lse [B, Hq, Tq]
fp32).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ops import LAUNCHES

NEG_INF = -1e30
M_FLOOR = -1e25
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p])


def _scale(D, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)


def _q_positions(q_pos, q_start, Tq, device):
    if q_pos is None:
        return (q_start or 0) + torch.arange(Tq, dtype=torch.int32,
                                             device=device)
    return q_pos.to(device=device, dtype=torch.int32)


def flash_fwd_plain(q, k, v, *, causal=True, local_window: int = 0,
                    q_pos=None, q_start=0, softmax_scale=None):
    """Plain PyTorch version of the flash kernel (see the module doc)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"flash_fwd: Hq={Hq} not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    rows = _q_positions(q_pos, q_start, Tq, q.device)[:, None]
    cols = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if local_window > 0:
        mask &= cols > rows - local_window
    qf = q.float().reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * _scale(
        D, softmax_scale)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1).clamp(min=M_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    ls = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / ls[..., None]
    lse = m + torch.log(ls)
    return (out.reshape(B, Hq, Tq, Dv).to(q.dtype),
            lse.reshape(B, Hq, Tq))


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_fwd: needs one dtype among "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] or Tq == 0 \
            or k.shape[2] == 0:
        raise ValueError(f"flash_fwd: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k, v must be contiguous")


def flash_fwd(q, k, v, *, causal=True, local_window: int = 0, q_pos=None,
              q_start=0, softmax_scale=None):
    """Flash forward -> (out, lse).  A CUDA tensor launches
    ``csrc/flash_fwd.cu`` (or raises); a CPU tensor takes
    ``flash_fwd_plain``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal,
                               local_window=local_window, q_pos=q_pos,
                               q_start=q_start, softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check(q, k, v)
    if q_start is not None and q_start < 0:
        raise ValueError(f"flash_fwd: q_start must be >= 0 or None, "
                         f"got {q_start}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qp = _q_positions(q_pos, q_start, Tq, q.device).contiguous()
    if qp.shape != (Tq,):
        raise ValueError(f"flash_fwd: q_pos shape {tuple(qp.shape)} != "
                         f"({Tq},)")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    fn = build.function("repro_flash_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, Tq, Tk, D,
                DTYPES[q.dtype], int(bool(causal)), int(local_window),
                -1 if q_start is None else int(q_start),
                float(_scale(D, softmax_scale)), stream)
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse
