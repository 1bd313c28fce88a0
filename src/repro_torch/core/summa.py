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
reference's fp32-accumulated ``_einsum(..., out_dtype=a.dtype)`` is.

Backward (the reference's ``_tess_bwd`` and ``_ring_bwd``), the paper's
A' = C' W^T and W' = A^T C'.  At one rank ``torch.matmul`` forms both.
Across ranks:

``fused`` — gather A over col and W over row again (unless the forward
kept them: ``cache_act_gather``, ``cache_weight_gather``), form the dA
partials [T, E, F_loc] and psum-scatter them over col, and the fp32 dW
partials [T, F_loc, G_loc] and psum-scatter them over row;

``ring`` — two passes on shift-and-add accumulator rings: dA on the col
ring while W streams on the row ring, then dW on the row ring while A
streams on the col ring; each ends with one shift and the unskew.

With ``reduce_dgrad_in_op`` dW is then psum'd over (data, depth) inside the
op (the paper's per-op all-reduce; else the step's ``sync_grads`` does it
once per leaf).  With ``dgrad_rs_bf16`` the dW pieces are rounded to bf16
and every dW reduction (the reduce-scatter or the ring's adds, and the
in-op psum) runs in bf16, on both schedules, as the reference's
``rs_dtype``; dA is unchanged.  The reference forms these products in
``_einsum``, outside any Pallas kernel, and their layouts (W^T, A^T) are
not kernel #1's, so ``torch.mm`` forms them at the reference's precision
(``mm_f32``): operands in the compute dtype summed in fp32, dA rounded
once to dC's dtype, dW kept in fp32 (or bf16, above) until its
reductions end.
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
def _perm_unskew_a(q):
    return tuple((i * q + j, i * q + (i + j) % q)
                 for i in range(q) for j in range(q))


@lru_cache(maxsize=None)
def _perm_skew_w(q):
    """dst (i, j) <- src ((i + j) % q, j): column j rotates up by j."""
    return tuple((((i + j) % q) * q + j, i * q + j)
                 for i in range(q) for j in range(q))


@lru_cache(maxsize=None)
def _perm_unskew_w(q):
    return tuple((i * q + j, ((i + j) % q) * q + j)
                 for i in range(q) for j in range(q))


_RC = ("row", "col")
# Axes W is replicated over, which its in-op dW all-reduce covers (the
# reference's ``_dgrad_axes`` without a seq axis).
DGRAD_AXES = ("data", "depth")


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
    return tesseract_mm(*_gathers(mesh, a2, w), out_dtype=a2.dtype)


def _gathers(mesh: Mesh, a2, w):
    """A gathered over col [T, E, F_loc] and W over row [T, F_loc, G_loc]."""
    return col.all_gather_inv(mesh, a2, "col"), col.all_gather_inv(mesh, w,
                                                                    "row")


def _forward(ctx: ParallelContext, mesh: Mesh, a2, w):
    """C [E, G] in A's dtype from a2 [E, F_loc] and w [F_loc, G_loc]."""
    if effective_schedule(ctx, a2.shape[0]) == "ring":
        return _ring_fwd(mesh, a2, w)
    return _fused_fwd(mesh, a2, w)


def mm_f32(a, b):
    """a @ b [m, n] float32 from operands in their (one) dtype, summed in
    fp32: the reference's ``preferred_element_type=float32`` product.  A
    bf16 product on the card runs on the tensor cores with an fp32 result;
    on the CPU (tests only) the bf16 operands are widened, which is exact."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _fused_bwd(ctx: ParallelContext, mesh: Mesh, ar, wr, dc):
    ag = ar if ctx.cache_act_gather else col.all_gather_inv(mesh, ar, "col")
    wg = wr if ctx.cache_weight_gather else col.all_gather_inv(mesh, wr,
                                                               "row")
    # dA_t = dC W_t^T for every block t of A's features; member t of the
    # col group keeps the sum of the dA_t
    da = torch.stack([mm_f32(dc, wt.t()) for wt in wg]).to(dc.dtype)
    da = col.psum_scatter_dim(mesh, da, "col", 0)[0]
    # dW_t = A_t^T dC, in fp32 (or bf16, dgrad_rs_bf16) through the
    # reduce-scatter over row
    dw = torch.stack([mm_f32(at.t(), dc) for at in ag]).to(_rs_dtype(ctx))
    return da, col.psum_scatter_dim(mesh, dw, "row", 0)[0]


def _rs_dtype(ctx: ParallelContext):
    """The dW reduction's wire dtype: bf16 with ``dgrad_rs_bf16``, else
    fp32 (the reference's ``rs_dtype``)."""
    return torch.bfloat16 if ctx.dgrad_rs_bf16 else torch.float32


def _ring_bwd(mesh: Mesh, a2, w, dc, rs_dtype):
    """dA and dW on the forward's rings, in two passes (the reference's
    ``_ring_bwd``).  Each step's piece is added to the accumulator that
    arrives from the next rank, so each rank ends with its own block after
    one more shift and the unskew.  A step's two shifts (the streamed
    operand and the accumulator) are in flight while its product runs; every
    rank posts them in the same order."""
    q = mesh.sizes["col"]

    def ring(stream, stream_axis, acc_axis, piece):
        acc = None
        for s in range(q):
            works = []
            if s < q - 1:
                nxt, wk = col.ppermute(mesh, stream, stream_axis,
                                       _perm_shift(q), wait=False)
                works += wk
            if acc is not None:
                arrived, wk = col.ppermute(mesh, acc, acc_axis,
                                           _perm_shift(q), wait=False)
                works += wk
            p = piece(stream)
            for work in works:          # the sent blocks stay alive till here
                work.wait()
            acc = p if acc is None else arrived + p
            if s < q - 1:
                stream = nxt
        return col.ppermute(mesh, acc, acc_axis, _perm_shift(q))

    # pass 1: W streams on the row ring, dA pieces ride the col ring
    da = ring(col.ppermute(mesh, w, _RC, _perm_skew_w(q)), "row", "col",
              lambda wt: mm_f32(dc, wt.t()).to(dc.dtype))
    da = col.ppermute(mesh, da, _RC, _perm_unskew_a(q))
    # pass 2: A streams on the col ring, dW pieces (fp32, or bf16 with
    # dgrad_rs_bf16, summed in that dtype) ride the row ring
    dw = ring(col.ppermute(mesh, a2, _RC, _perm_skew_a(q)), "col", "row",
              lambda at: mm_f32(at.t(), dc).to(rs_dtype))
    return da, col.ppermute(mesh, dw, _RC, _perm_unskew_w(q))


class _TesseractMatmul(torch.autograd.Function):

    @staticmethod
    def forward(fctx, ctx, mesh, a2, w):
        fctx.ctx, fctx.mesh = ctx, mesh
        if mesh.size == 1 or effective_schedule(ctx, a2.shape[0]) == "ring":
            fctx.save_for_backward(a2, w)
            return _forward(ctx, mesh, a2, w)
        ag, wg = _gathers(mesh, a2, w)
        fctx.save_for_backward(ag if ctx.cache_act_gather else a2,
                               wg if ctx.cache_weight_gather else w)
        return tesseract_mm(ag, wg, out_dtype=a2.dtype)

    @staticmethod
    def backward(fctx, dc):
        ar, wr = fctx.saved_tensors
        ctx, mesh = fctx.ctx, fctx.mesh
        if mesh.size == 1:
            dw = torch.matmul(ar.t(), dc)
            if ctx.dgrad_rs_bf16:    # the reference rounds it at one rank too
                dw = dw.to(torch.bfloat16).to(wr.dtype)
            return None, None, torch.matmul(dc, wr.t()), dw
        dc = dc.contiguous()
        if effective_schedule(ctx, dc.shape[0]) == "ring":
            da, dw = _ring_bwd(mesh, ar, wr, dc, _rs_dtype(ctx))
        else:
            da, dw = _fused_bwd(ctx, mesh, ar, wr, dc)
        if ctx.reduce_dgrad_in_op:
            dw = col.psum(mesh, dw, DGRAD_AXES)
        return None, None, da, dw.to(wr.dtype)


def tesseract_matmul(ctx: ParallelContext, mesh: Mesh, a, w):
    """Distributed C = A @ W per Tesseract Algorithm 3 (local blocks; see
    the module doc) on ``mesh``, the schedule from ``ctx``.  Without
    autograd (serving) it skips the autograd node, whose host cost each of
    a step's projections pays."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    w = w.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        c = _TesseractMatmul.apply(ctx, mesh, a2, w)
    else:
        c = _forward(ctx, mesh, a2, w)
    return c.reshape(*lead, w.shape[-1])
