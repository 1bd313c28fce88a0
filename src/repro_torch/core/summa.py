"""Tesseract matrix multiplication, forward (counterpart of
``repro.core.summa``).

Layout (per-rank local blocks on the [data, depth, row, col] mesh):

    activations A : [..., E_loc, F_loc]   E over (data, depth, row),
                                          F over col
    weights     W : [F_loc, G_loc]        F over row, G over col,
                                          replicated over (data, depth)
    output      C : [..., E_loc, G_loc]   the layout of A

Two schedules compute the same C (``ParallelContext.matmul_schedule``):

``fused`` — the paper's q broadcasts of A along each row of the [q, q] grid
fuse into one all-gather over col, and the q broadcasts of W along each
column into one all-gather over row; then kernel #1 (``tesseract_mm``)
contracts the gathered [T, E, F] x [T, F, G] in one launch, with E the
flattened leading dims, and rounds its fp32 sums to A's dtype in its
epilogue.  ``all_gather_into_tensor`` leaves the gathered A as a
contiguous [T * E, F], which is already [T, E, F]: no copy.  At one rank
there is nothing to gather, and kernel #1 runs on A and W as they are.

``ring`` — Cannon's skewed double ring: one skew per operand over (row,
col), then q steps, each contracting the resident (A, W) pair into one fp32
accumulator with kernel #2 (``tesseract_mm_stream``) while the next pair is
shifted around the col and row rings; the accumulator is cast to A's
dtype once, after the last step.

Either way C is the fp32 sum rounded once to A's dtype, as the
reference's fp32-accumulated ``_einsum(..., out_dtype=a.dtype)`` is.  The
backward at one rank is the reference's dA = dC W^T and dW = A^T dC, which
it computes outside any Pallas kernel, so ``torch.matmul`` does it; across
ranks the backward (its psum-scatters and the depth reduction of dW) comes
with training across ranks (ROADMAP Queue A).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..kernels.tesseract_mm import tesseract_mm, tesseract_mm_stream
from . import collectives as col
from .api import ParallelContext
from .mesh import Mesh


def effective_schedule(ctx: ParallelContext, e_loc: int) -> str:
    """Resolve ``matmul_schedule`` for one op from its local token rows:
    "auto" takes the ring only where each of its q steps has enough rows to
    hide a shift (q >= 4), so decode-sized blocks stay fused."""
    s = ctx.matmul_schedule
    if s != "auto":
        return s
    return "ring" if ctx.q >= 4 and e_loc >= 2 * ctx.q * ctx.seq else "fused"


# Permutations over the [q, q] (row, col) grid, as (src, dst) pairs of the
# linear index i * q + j.  The skews give rank (i, j) the blocks with
# feature index t = (i + j) % q, so after s synchronized shifts both
# resident operands carry t = (i + j + s) % q: Cannon's initial alignment.

@lru_cache(maxsize=None)
def _perm_shift(q):
    """Ring step: receive from the next rank ((j + 1) -> j)."""
    return tuple((j, (j - 1) % q) for j in range(q))


@lru_cache(maxsize=None)
def _perm_skew_a(q):
    """dst (i, j) <- src (i, (i + j) % q): row i rotates left by i."""
    return tuple((i * q + (i + j) % q, i * q + j)
                 for i in range(q) for j in range(q))


@lru_cache(maxsize=None)
def _perm_skew_w(q):
    """dst (i, j) <- src ((i + j) % q, j): column j rotates up by j."""
    return tuple((((i + j) % q) * q + j, i * q + j)
                 for i in range(q) for j in range(q))


_RC = ("row", "col")


def _ring_fwd(mesh: Mesh, a2, w):
    """C = sum_t A_t W_t over the skewed double ring, fp32 accumulator;
    each step's shifts are in flight while kernel #2 contracts."""
    q = mesh.sizes["col"]
    a_cur = col.ppermute(mesh, a2, _RC, _perm_skew_a(q))
    w_cur = col.ppermute(mesh, w, _RC, _perm_skew_w(q))
    acc = torch.zeros(a2.shape[0], w.shape[1], dtype=torch.float32,
                      device=a2.device)
    for s in range(q):
        works = []
        if s < q - 1:
            a_nxt, wa = col.ppermute(mesh, a_cur, "col", _perm_shift(q),
                                     wait=False)
            w_nxt, ww = col.ppermute(mesh, w_cur, "row", _perm_shift(q),
                                     wait=False)
            works = wa + ww
        tesseract_mm_stream(a_cur, w_cur, acc)
        for work in works:
            work.wait()
        if s < q - 1:
            a_cur, w_cur = a_nxt, w_nxt
    return acc.to(a2.dtype)


def _fused_fwd(mesh: Mesh, a2, w):
    if mesh.size == 1:
        return tesseract_mm(a2, w, out_dtype=a2.dtype)
    ag = col.all_gather_inv(mesh, a2, "col")          # [T, E, F_loc]
    wg = col.all_gather_inv(mesh, w, "row")           # [T, F_loc, G_loc]
    return tesseract_mm(ag, wg, out_dtype=a2.dtype)


def _forward(ctx: ParallelContext, mesh: Mesh, a2, w):
    """C [E, G] in A's dtype from a2 [E, F_loc] and w [F_loc, G_loc]."""
    if effective_schedule(ctx, a2.shape[0]) == "ring":
        return _ring_fwd(mesh, a2, w)
    return _fused_fwd(mesh, a2, w)


class _TesseractMatmul(torch.autograd.Function):

    @staticmethod
    def forward(fctx, ctx, mesh, a2, w):
        fctx.mesh = mesh
        fctx.save_for_backward(a2, w)
        return _forward(ctx, mesh, a2, w)

    @staticmethod
    def backward(fctx, dc):
        if fctx.mesh.size > 1:
            raise NotImplementedError(
                "the backward of tesseract_matmul across ranks (its "
                "psum-scatters and the depth reduction of dW) is not ported "
                "yet (ROADMAP Queue A: training across ranks)")
        a2, w = fctx.saved_tensors
        return None, None, torch.matmul(dc, w.t()), torch.matmul(a2.t(), dc)


def tesseract_matmul(ctx: ParallelContext, mesh: Mesh, a, w):
    """Distributed C = A @ W per Tesseract Algorithm 3 (local blocks; see
    the module doc) on ``mesh``, the schedule from ``ctx``.
    Differentiable at one rank; without autograd (serving) it skips the
    autograd node, whose host cost each of a step's projections pays."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    w = w.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        c = _TesseractMatmul.apply(ctx, mesh, a2, w)
    else:
        c = _forward(ctx, mesh, a2, w)
    return c.reshape(*lead, w.shape[-1])
