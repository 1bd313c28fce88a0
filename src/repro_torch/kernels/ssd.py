"""Mamba2 SSD intra-chunk pass: the Hopper kernel's wrapper and its plain
version.

Counterpart of ``repro/kernels/ssd.py`` (``_kernel`` / ``ssd_intra``).  The
kernel is ``csrc/ssd.cu``; ``ssd_intra_plain`` is the reference's
``ref.py::ssd_intra_ref`` in torch einsums, written as the inline einsum
path of the reference's ``ssd_chunked`` (the decay matrix from
``segsum``), and serves the CPU tests,
``use_pallas=False`` and ``chip_smoke.py``'s comparison.

Contract of both (the reference's): x [B, nc, Q, H, P]; log_a [B, nc, Q, H];
Bm/Cm [B, nc, Q, N] (one group: B and C are shared by all heads).  With
cs = cumsum(log_a) within each chunk, per chunk and head h:

    Y[i, h]  = sum_{j <= i} (C_i . B_j) * exp(cs_i - cs_j) * x[j, h]
    S_c[h]   = sum_j exp(cs_{Q-1} - cs_j) * x[j, h] (x) B_j

Returns (Y [B, nc, Q, H, P] float32, S_c [B, nc, H, P, N] float32).

``ssd_intra`` has no backward, as the reference's has none: its Pallas
kernel has no ``custom_vjp``, so ``jax.grad`` through
``ssd_chunked(..., use_pallas=True)`` fails.  It refuses inputs that need
a gradient (``NoGradError``), on every device, so that a CPU test cannot
pass where the card's launch would silently drop the gradient through Y
and S_c.  The reference trains on its einsum path (``use_pallas=False``),
which ``ssd_intra_plain`` is.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ops import LAUNCHES

HEAD_DIMS = (16, 64)            # P values the kernel is compiled for
MAX_CHUNK = 256                 # largest Q the kernel takes

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def segsum(log_a):
    """[..., Q] -> [..., Q, Q] lower-triangular pairwise sums:
    out[i, j] = cs[i] - cs[j] = sum_{j < k <= i} log_a[k], -inf above the
    diagonal (the reference's ``models/ssm.py::segsum``)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                 device=log_a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_intra_plain(x, log_a, Bm, Cm):
    """Plain PyTorch version of the SSD intra-chunk kernel (module doc)."""
    la = log_a.transpose(2, 3)                                # [B,nc,H,Q]
    L = torch.exp(segsum(la))                                 # [B,nc,H,Q,Q]
    scores = torch.einsum("bcin,bcjn->bcij", Cm, Bm)          # [B,nc,Q,Q]
    W = scores[:, :, None] * L                                # [B,nc,H,Q,Q]
    Y = torch.einsum("bchij,bcjhp->bcihp", W, x)
    cs = torch.cumsum(la, dim=-1)
    tail = cs[..., -1:] - cs                                  # [B,nc,H,Q]
    xw = x * torch.exp(tail).transpose(2, 3)[..., None]
    S_c = torch.einsum("bcjhp,bcjn->bchpn", xw, Bm)
    return Y.float(), S_c.float()


def _check(x, log_a, Bm, Cm):
    dev = x.device
    if any(t.device != dev for t in (log_a, Bm, Cm)):
        raise ValueError("ssd_intra: tensors on different devices")
    if any(t.dtype != torch.float32 for t in (x, log_a, Bm, Cm)):
        raise TypeError(f"ssd_intra: the kernel takes float32, got "
                        f"{x.dtype}, {log_a.dtype}, {Bm.dtype}, {Cm.dtype}")
    if x.ndim != 5:
        raise ValueError(f"ssd_intra: x must be [B, nc, Q, H, P], got "
                         f"{tuple(x.shape)}")
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if (log_a.shape != (B, nc, Q, H) or Bm.shape != (B, nc, Q, N)
            or Cm.shape != Bm.shape or min(B, nc, Q, H, N) < 1):
        raise ValueError(
            f"ssd_intra: bad shapes x{tuple(x.shape)} "
            f"log_a{tuple(log_a.shape)} Bm{tuple(Bm.shape)} "
            f"Cm{tuple(Cm.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_intra: head dim {P} not in {HEAD_DIMS}")
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_intra: chunk {Q} > {MAX_CHUNK}, the most the "
                         f"kernel's shared-memory score tile holds")
    if not all(t.is_contiguous() for t in (x, log_a, Bm, Cm)):
        raise ValueError("ssd_intra: inputs must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("ssd_intra: x must be 16-byte aligned (the kernel "
                         "reads it 16 bytes at a time)")


NO_GRAD_REASON = (
    "ssd_intra has no backward: the reference's Pallas kernel has no "
    "custom_vjp, so jax.grad through ssd_chunked(use_pallas=True) fails "
    "('Linearization failed'); train with use_pallas=False, the "
    "reference's einsum path")


class NoGradError(NotImplementedError):
    """A gradient was asked of ``ssd_intra`` (``NO_GRAD_REASON``)."""


def ssd_intra(x, log_a, Bm, Cm):
    """Intra-chunk Y and chunk-end states.  A CUDA tensor launches
    ``csrc/ssd.cu`` (or raises); a CPU tensor takes ``ssd_intra_plain``.
    Raises ``NoGradError`` on any device when grad mode is on and an input
    requires grad (module doc)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, log_a, Bm, Cm)):
        raise NoGradError(NO_GRAD_REASON)
    if x.device.type == "cpu":
        return ssd_intra_plain(x, log_a, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra: unsupported device {x.device}")
    _check(x, log_a, Bm, Cm)
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    s = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.function("repro_ssd_intra", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), s.data_ptr(), B * nc, Q, H, P,
                N, stream)
    build.check(rc, "ssd_intra")
    LAUNCHES["ssd_intra"] += 1
    return y, s
