"""Flash attention, forward and backward: the Hopper kernels' wrappers, their
plain versions and the autograd Function that joins them.

Counterpart of ``repro/kernels/flash_attention.py``: ``flash_fwd`` of
``_fwd_kernel`` / ``_fwd_call``, ``flash_dq`` of ``_dq_kernel`` /
``_dq_call``, ``flash_dkv`` of ``_dkv_kernel`` / ``_dkv_call``, and
``FlashAttention`` of the ``_flash`` custom_vjp.  The kernels are
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``; each ``*_plain`` function
is the same function in straightforward PyTorch (the full fp32 score
matrix), used by the CPU tests, by ``attn_impl="jnp"`` and by
``chip_smoke.py``'s comparison.  A bf16 CUDA tensor reaches the
kernels' tensor-core routes (the forward, dQ and dK/dV), fp32 their FMA
routes; ``flash_kv_tiles`` mirrors the KV tile range the bf16 forward and
dQ walk.

Contract of all (the reference's): q [B, Hq, Tq, D], k/v [B, Hkv, Tk, D]
with Hq = g * Hkv (q head h reads kv head h // g); KV rows sit at positions
0..Tk-1; ``q_pos`` ([Tq] int, default ``q_start + arange(Tq)``) drives the
causal and ``local_window`` masks; ``q_start`` is the static row offset that
lets the kernels skip tiles (None walks every tile under the mask).
Scores, softmax and every sum are fp32.  A masked score is -1e30 and the
running max is floored at -1e25, so a fully masked row gives an exact-zero
output row and lse = -1e25.  The forward returns (out in q's dtype, lse
[B, Hq, Tq] fp32).  The backward passes take that lse and
delta = rowsum(dout * out) ([B, Hq, Tq] fp32) and give, with
p = exp(s - lse) and ds = p * (dout . v^T - delta), dq = ds . k * scale
(``flash_dq``) and dk = ds^T . q * scale, dv = p^T . dout (``flash_dkv``)
in the inputs' dtype; a masked entry has p = 0, so a fully masked row gives
exact-zero gradients.
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
_DQ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_void_p])


def _scale(D, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)


def _q_positions(q_pos, q_start, Tq, device):
    if q_pos is None:
        return (q_start or 0) + torch.arange(Tq, dtype=torch.int32,
                                             device=device)
    return q_pos.to(device=device, dtype=torch.int32)


FWD_TILE = 64    # q rows and kv rows of a tile of the bf16 forward and dQ


def flash_kv_tiles(q_pos, Tk, bq=FWD_TILE, bk=FWD_TILE, causal=True,
                   window=0):
    """[(lo, hi)] per q tile of ``bq`` rows: the KV tiles of ``bk`` columns
    that the bf16 routes of ``csrc/flash_fwd.cu`` and of the dQ pass in
    ``csrc/flash_bwd.cu`` walk.  A plain mirror of ``common.cuh``'s
    ``kv_tile_range``, for the tests.

    The range comes from the tile's own positions (rows past Tq continue
    the sequence, as the kernel pads them): causal keeps the tiles whose
    first column is <= the largest position, a window the tiles whose last
    column is > the smallest position - window, and every tile starts below
    Tk.  Every tile outside the range is masked for every row of the q tile,
    so skipping it changes no bit.  An empty range is (lo, lo)."""
    pos = [int(p) for p in q_pos]
    nq, nk = -(-len(pos) // bq), -(-Tk // bk)
    pos += [pos[-1] + 1 + i for i in range(nq * bq - len(pos))]
    tiles = []
    for i in range(nq):
        rows = pos[i * bq:(i + 1) * bq]
        lo, hi = 0, nk
        if causal:
            hi = min(hi, max(max(rows) // bk + 1, 0))
        if window > 0:
            lo = max(lo, (min(rows) - window + 1) // bk)
        tiles.append((lo, max(lo, hi)))
    return tiles


# ---------------------------------------------------------------- plain

def _scores(q, k, *, causal, local_window, q_pos, q_start, softmax_scale):
    """Masked fp32 scores [B, Hkv, g, Tq, Tk] (q head h -> kv head h // g)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash: Hq={Hq} not a multiple of Hkv={Hkv}")
    rows = _q_positions(q_pos, q_start, Tq, q.device)[:, None]
    cols = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if local_window > 0:
        mask &= cols > rows - local_window
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * _scale(
        D, softmax_scale)
    return s.masked_fill(~mask, NEG_INF)


def flash_fwd_plain(q, k, v, *, causal=True, local_window: int = 0,
                    q_pos=None, q_start=0, softmax_scale=None):
    """Plain PyTorch version of the forward kernel (see the module doc)."""
    B, Hq, Tq, _ = q.shape
    s = _scores(q, k, causal=causal, local_window=local_window, q_pos=q_pos,
                q_start=q_start, softmax_scale=softmax_scale)
    m = s.amax(-1).clamp(min=M_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    ls = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / ls[..., None]
    lse = m + torch.log(ls)
    return (out.reshape(B, Hq, Tq, v.shape[-1]).to(q.dtype),
            lse.reshape(B, Hq, Tq))


def _probs_and_ds(q, k, v, dout, lse, delta, **kw):
    """p and ds [B, Hkv, g, Tq, Tk] fp32 of the backward passes."""
    s = _scores(q, k, **kw)
    B, Hkv, g, Tq, _ = s.shape
    p = torch.exp(s - lse.float().reshape(B, Hkv, g, Tq, 1))
    dp = torch.einsum("bhgqd,bhkd->bhgqk",
                      dout.float().reshape(B, Hkv, g, Tq, -1), v.float())
    return p, p * (dp - delta.float().reshape(B, Hkv, g, Tq, 1))


def flash_dq_plain(q, k, v, dout, lse, delta, *, causal=True,
                   local_window: int = 0, q_pos=None, q_start=0,
                   softmax_scale=None):
    """Plain PyTorch version of the dQ kernel (see the module doc)."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal=causal,
                          local_window=local_window, q_pos=q_pos,
                          q_start=q_start, softmax_scale=softmax_scale)
    D = q.shape[-1]
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * _scale(
        D, softmax_scale)
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, *, causal=True,
                    local_window: int = 0, q_pos=None, q_start=0,
                    softmax_scale=None):
    """Plain PyTorch version of the dK/dV kernel (see the module doc)."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal=causal,
                          local_window=local_window, q_pos=q_pos,
                          q_start=q_start, softmax_scale=softmax_scale)
    B, Hkv, g, Tq, _ = p.shape
    D = q.shape[-1]
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(B, Hkv, g, Tq, D)) * _scale(
        D, softmax_scale)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p,
                      dout.float().reshape(B, Hkv, g, Tq, -1))
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- wrappers

def _check(what, q, k, v, *, q_start):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: needs one dtype among "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] or Tq == 0 \
            or k.shape[2] == 0:
        raise ValueError(f"{what}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if q_start is not None and q_start < 0:
        raise ValueError(f"{what}: q_start must be >= 0 or None, "
                         f"got {q_start}")
    _check_aligned(what, q, k, v)


def _check_aligned(what, *ts):
    # the bf16 kernels copy 16-byte chunks of each row with cp.async
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: bfloat16 inputs must start on a 16-byte "
                         f"boundary")


def _check_bwd(what, q, dout, lse, delta):
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"{what}: dout must be a contiguous "
                         f"{tuple(q.shape)} {q.dtype} tensor on {q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{tuple(q.shape[:3])} float32 tensor on "
                             f"{q.device}")
    _check_aligned(what, dout)


def _launch_args(what, q, k, q_pos, q_start, causal, local_window,
                 softmax_scale):
    """(q positions tensor, the C entry's trailing scalar arguments)."""
    B, Hq, Tq, D = q.shape
    qp = _q_positions(q_pos, q_start, Tq, q.device).contiguous()
    if qp.shape != (Tq,):
        raise ValueError(f"{what}: q_pos shape {tuple(qp.shape)} != ({Tq},)")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return qp, (B, Hq, k.shape[1], Tq, k.shape[2], D, DTYPES[q.dtype],
                int(bool(causal)), int(local_window),
                -1 if q_start is None else int(q_start),
                float(_scale(D, softmax_scale)), stream)


def _on_cuda(what, q):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return True


def flash_fwd(q, k, v, *, causal=True, local_window: int = 0, q_pos=None,
              q_start=0, softmax_scale=None):
    """Flash forward -> (out, lse).  A CUDA tensor launches
    ``csrc/flash_fwd.cu`` (or raises); a CPU tensor takes
    ``flash_fwd_plain``."""
    if not _on_cuda("flash_fwd", q):
        return flash_fwd_plain(q, k, v, causal=causal,
                               local_window=local_window, q_pos=q_pos,
                               q_start=q_start, softmax_scale=softmax_scale)
    _check("flash_fwd", q, k, v, q_start=q_start)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fn = build.function("repro_flash_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        qp, args = _launch_args("flash_fwd", q, k, q_pos, q_start, causal,
                                local_window, softmax_scale)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                out.data_ptr(), lse.data_ptr(), *args)
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal=True,
             local_window: int = 0, q_pos=None, q_start=0,
             softmax_scale=None):
    """dQ pass of the flash backward -> dq.  A CUDA tensor launches
    ``repro_flash_dq`` of ``csrc/flash_bwd.cu`` (or raises); a CPU tensor
    takes ``flash_dq_plain``."""
    kw = dict(causal=causal, local_window=local_window, q_pos=q_pos,
              q_start=q_start, softmax_scale=softmax_scale)
    if not _on_cuda("flash_dq", q):
        return flash_dq_plain(q, k, v, dout, lse, delta, **kw)
    _check("flash_dq", q, k, v, q_start=q_start)
    _check_bwd("flash_dq", q, dout, lse, delta)
    dq = torch.empty_like(q)
    fn = build.function("repro_flash_dq", _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        qp, args = _launch_args("flash_dq", q, k, q_pos, q_start, causal,
                                local_window, softmax_scale)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), qp.data_ptr(),
                dq.data_ptr(), *args)
    build.check(rc, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal=True,
              local_window: int = 0, q_pos=None, q_start=0,
              softmax_scale=None):
    """dK/dV pass of the flash backward -> (dk, dv).  A CUDA tensor launches
    ``repro_flash_dkv`` of ``csrc/flash_bwd.cu`` (or raises); a CPU tensor
    takes ``flash_dkv_plain``."""
    kw = dict(causal=causal, local_window=local_window, q_pos=q_pos,
              q_start=q_start, softmax_scale=softmax_scale)
    if not _on_cuda("flash_dkv", q):
        return flash_dkv_plain(q, k, v, dout, lse, delta, **kw)
    _check("flash_dkv", q, k, v, q_start=q_start)
    _check_bwd("flash_dkv", q, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = build.function("repro_flash_dkv", _DKV_ARGTYPES)
    with torch.cuda.device(q.device):
        qp, args = _launch_args("flash_dkv", q, k, q_pos, q_start, causal,
                                local_window, softmax_scale)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), qp.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), *args)
    build.check(rc, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash``
    custom_vjp): the forward kernel saves (q, k, v, out, lse); the backward
    forms delta = rowsum(dout * out) in fp32, as ``_bwd_call`` does, then
    runs the dQ pass and the dK/dV pass.

        out = FlashAttention.apply(q, k, v, causal, local_window, q_pos,
                                   q_start, softmax_scale)
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, local_window, q_pos, q_start,
                softmax_scale):
        ctx.kw = dict(causal=causal, local_window=local_window, q_pos=q_pos,
                      q_start=q_start, softmax_scale=softmax_scale)
        out, lse = flash_fwd(q, k, v, **ctx.kw)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1)
        dq = flash_dq(q, k, v, dout, lse, delta, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
