"""Operation sets the models are written against (PyTorch port of
``repro.core.ops``).

Each wraps every primitive in the collectives of the [data, depth, row,
col] mesh (``core/mesh.py``), on per-rank local blocks.  ``TesseractOps``,
the paper's 2.5-D scheme (summa2d at depth 1):

    activations : [B_loc, S_loc, h/q]   tokens over (data, depth, row) —
                                        the sequence over (depth, row) on
                                        the seq-sharded prefill plan — and
                                        features over col
    weights     : [F/q, G/q]            (row, col), replicated over
                                        (data, depth)

``MegatronOps``, the paper's 1-D baseline (Megatron-LM: rows = depth = 1,
cols = p):

    activations : [B_loc, S_loc, h]     tokens over data — the sequence
                                        over col on the seq-sharded
                                        prefill plan (Megatron-SP) — and
                                        features whole
    weights     : up [F, G/p], down [G/p, F]   (col on the out / in dim)

At one rank every collective is the identity and each method is its local
math.  ``Plan`` and ``kv_group_axes`` keep the reference's names so the
serve code reads the same.

Where the reference's steps leave an output sharded for the host to
assemble (its ``out_specs``), the port's ranks each run the whole host loop
(multi-controller), so the outputs the host reads are made whole on every
rank: ``head_logits`` returns every token's row of the mesh, and
``host_block`` cuts each rank's block out of a host-layout input (the
reference's ``in_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from . import collectives as col
from . import remat
from .api import ParallelContext
from .mesh import Mesh
from .summa import mm_f32, tesseract_matmul


@dataclass(frozen=True)
class Plan:
    kind: str = "train"          # train | prefill | decode
    seq_sharded: bool = False    # shard sequence (not batch) over (depth,row)

    @staticmethod
    def for_shape(kind: str, *, global_batch: int = 0, batch_shards: int = 1,
                  data: int = 1) -> "Plan":
        if kind == "train":
            return Plan("train", seq_sharded=False)
        if kind == "prefill":
            return Plan("prefill", seq_sharded=True)
        if kind in ("decode", "long_decode", "decode_dp"):
            if kind == "decode" and global_batch and global_batch < batch_shards:
                if data > 1 and global_batch >= data and global_batch % data == 0:
                    kind = "decode_dp"      # batch shards over data only
                else:
                    kind = "long_decode"    # batch too small to shard (b=1)
            return Plan(kind, seq_sharded=False)
        raise ValueError(kind)


def kv_group_axes(ctx: ParallelContext, plan: Plan) -> tuple:
    """Mesh axes sharding the decode-layout KV pool (see the reference);
    the paged pool has one KV group per coordinate along them."""
    if plan.kind == "decode":
        return ctx.token_axes
    if plan.kind == "decode_dp":
        return (ctx.axis_data,)
    return ()                                 # long_decode: replicated pool


class _OpSet:
    """What both op sets share: the host layout's blocks, the sequence
    shards of the prefill plan (over ``ctx.seq_shard_axes``: (depth, row)
    in Tesseract, col in Megatron) and the vocab-sharded head."""

    def __init__(self, ctx: ParallelContext, mesh: Mesh, plan: Plan):
        self.ctx = ctx            # layout and knobs (matmul_schedule)
        self.mesh = mesh          # this rank's place and process groups
        self.plan = plan

    def host_block(self, t, axes_per_dim):
        """This rank's block of a host-layout tensor, each dim cut over its
        axes (lexicographic, first axis outermost)."""
        for dim, axes in enumerate(axes_per_dim):
            n = self.mesh.axis_size(axes) if axes else 1
            if n > 1:
                m = t.shape[dim] // n
                t = t.narrow(dim, self.mesh.index(axes) * m, m)
        return t

    # ---------------- token/seq info ----------------
    def seq_shard_index(self) -> int:
        return self.mesh.index(self.ctx.seq_shard_axes)

    def positions(self, seq_loc: int, device=None):
        """Global position ids [seq_loc] of this rank's sequence block."""
        pos = torch.arange(seq_loc, device=device)
        if self.plan.seq_sharded:
            pos = pos + self.seq_shard_index() * seq_loc
        return pos

    def gather_seq(self, x, axis: int):
        """Gather a seq-sharded tensor to full length."""
        if not self.plan.seq_sharded:
            return x
        return col.all_gather_cat(self.mesh, x, self.ctx.seq_shard_axes,
                                  axis=axis)

    # ---------------- heads ----------------
    def _row_axes(self, tokens_sharded: bool) -> tuple:
        """Axes the head's token rows are gathered over so every rank holds
        every row of the mesh: all the token axes of the decode plan, else
        the data axis the batch is split over (none on long_decode)."""
        if tokens_sharded:
            return self.ctx.token_axes
        if self.plan.kind == "long_decode":
            return ()
        return (self.ctx.axis_data,)

    def _sharded_logits(self, x, w_head, vocab_real, tokens_sharded):
        """Per-shard logits [B_all, v_loc] float32 (padded vocab at -inf) of
        every token row of the mesh, and this shard's global vocab offset.
        The single head implementation that head_sample's distributed
        argmax and head_logits' gathered rows both reduce.  The products
        run in fp32 like the reference's fp32-accumulated head einsum with
        a float32 result."""
        mesh, ctx = self.mesh, self.ctx
        xg = self._head_features(x[:, 0, :])
        rows = self._row_axes(tokens_sharded)
        if rows:
            xg = col.all_gather_cat(mesh, xg, rows, axis=0)
        logits = torch.matmul(xg.float(), w_head.float().t())
        v_loc = w_head.shape[0]
        v_off = mesh.index(ctx.model_axes) * v_loc
        vmask = (v_off + torch.arange(v_loc, device=x.device)) < vocab_real
        return logits.masked_fill(~vmask[None, :], float("-inf")), v_off

    def head_sample(self, x, w_head, *, vocab_real: int,
                    tokens_sharded: bool | None = None):
        """Greedy next-token ids [B_all] int32 of every token row of the
        mesh from x [B_loc, 1, h_loc]: the distributed argmax over the
        vocab shards, ties to the smallest index."""
        if tokens_sharded is None:
            tokens_sharded = self.plan.kind == "decode"
        logits, v_off = self._sharded_logits(x, w_head, vocab_real,
                                             tokens_sharded)
        return col.distributed_argmax(self.mesh, logits, v_off,
                                      self.ctx.model_axes)

    def head_logits(self, x, w_head, *, vocab_real: int,
                    tokens_sharded: bool | None = None):
        """Full-vocab logits [B_all, v_pad] float32 of every token row of
        the mesh from x [B_loc, 1, h_loc], the same on every rank; padded
        vocab entries are -inf.  ``tokens_sharded``: whether x's rows are
        sharded over the token axes (decode plan) or replicated over the
        sequence shards (prefill last token, long_decode)."""
        if tokens_sharded is None:
            tokens_sharded = self.plan.kind == "decode"
        logits, _ = self._sharded_logits(x, w_head, vocab_real,
                                         tokens_sharded)
        # vocab shards are laid out lexicographically over (depth, row,
        # col), matching all_gather_cat's concatenation order
        return col.all_gather_cat(self.mesh, logits, self.ctx.model_axes,
                                  axis=1)

    def _chunks(self, x, labels, label_mask, loss_chunk):
        """The CE loss's token rows [E, h_loc], this rank's labels and mask
        weights [E], and the chunk length: ``loss_chunk`` shrunk to divide
        E, as the reference does."""
        E = x.shape[0] * x.shape[1]
        lab = self.shard_tokens(labels).reshape(E).long()
        lm = (torch.ones(E, dtype=torch.float32, device=x.device)
              if label_mask is None
              else self.shard_tokens(label_mask).reshape(E).to(
                  torch.float32))
        c = max(1, min(loss_chunk, E))
        while E % c:
            c -= 1
        return x.reshape(E, x.shape[-1]), lab, lm, c


class TesseractOps(_OpSet):
    """The Tesseract op set on one rank's local blocks."""

    mode_family = "tesseract"

    def vocab_pad_multiple(self) -> int:
        return self.ctx.depth * self.ctx.rows * self.ctx.cols

    # ---------------- host layout ----------------
    def tokens_in_axes(self) -> tuple:
        """Per-dim mesh axes of host-layout ids [B, S] (``spec_tokens_in``):
        the row factor of the token sharding is applied by ``embed``."""
        if self.plan.kind == "long_decode":
            return ((), ())
        if self.plan.kind == "decode_dp":
            return (("data",), ())
        if self.plan.seq_sharded:
            return (("data",), ("depth",))
        return (("data", "depth"), ())

    # ---------------- core ops ----------------
    def linear(self, x, w, b=None, *, keep=True):
        """Tesseract C = x @ w (``core/summa.py``: kernel #1 on the fused
        schedule, kernel #2 on the ring), the weight in the reference's
        [in, out] layout; a bf16 product accumulates in fp32 and rounds
        once, as the reference's fp32-accumulated einsum cast back to x's
        dtype does.  ``keep``: whether remat="dots" keeps the product
        (``core/remat.py``)."""
        y = tesseract_matmul(self.ctx, self.mesh, x, w, keep=keep)
        if b is not None:
            y = y + b
        return y

    # in tesseract the canonical activation is already feature-sharded, so
    # both directions are the same op
    linear_up = linear
    linear_down = linear

    def seq_gather_in(self, x):
        """The Megatron-SP entry gather's hook: Tesseract activations stay
        sharded through the blocks."""
        return x

    def positions_q(self, t: int, device=None):
        """Positions of the q rows out of ``seq_gather_in`` and
        ``linear_up``: this rank's sequence block."""
        return self.positions(t, device=device)

    def linear_to_replicated(self, x, w, b=None):
        """[.., F_loc] x [F_loc, G] -> psum(col) -> [.., G] replicated over
        col (small outputs every rank needs whole: replicated GQA KV heads
        when num_kv_heads % q != 0, the ssm mixer's B and C).  The local
        product is no SUMMA contraction: ``local_matmul`` accumulates in
        fp32 and rounds once, as the reference's ``_f32_einsum(...,
        out_dtype=x.dtype)`` does.  The psum'd product is invariant over
        col and meets the col-varying q heads, so it is ``pvary``'d there
        (before the bias, which is a leaf of its own)."""
        y = col.psum(self.mesh, local_matmul(x, w), "col")
        y = col.pvary(self.mesh, y, "col")
        if b is not None:
            y = y + b
        return y

    def _scatter_dim(self):
        # which token dim the row factor is applied to
        return 1 if self.plan.seq_sharded else 0

    def embed(self, ids, table):
        """ids: this rank's host-layout block [B', S'] (``host_block``),
        replicated over (row, col); table: local [v_pad/q, h/q] (vocab over
        row, h over col).  Returns the canonical activation [B_loc, S_loc,
        h/q]; ids outside the vocab give zero rows."""
        v_loc = table.shape[0]
        local = ids - self.mesh.coords["row"] * v_loc
        valid = (local >= 0) & (local < v_loc)
        emb = table[local.clamp(0, v_loc - 1)]
        emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
        if self.plan.kind in ("long_decode", "decode_dp"):
            # tokens not sharded over (depth, row): sum vocab-shard partials
            return col.psum(self.mesh, emb, "row")
        # reduce-scatter over row: sums the vocab-shard partials and applies
        # the final row factor of the token sharding
        return col.psum_scatter_dim(self.mesh, emb, "row",
                                    self._scatter_dim())

    def shard_tokens(self, t):
        """Slice host-layout ids [B', S'] to this rank's token block (the
        non-summing analogue of embed's reduce-scatter)."""
        if self.plan.kind in ("long_decode", "decode_dp"):
            return t
        dim = self._scatter_dim()
        n = t.shape[dim] // self.ctx.rows
        return t.narrow(dim, self.mesh.coords["row"] * n, n)

    def rmsnorm(self, x, scale, eps=1e-5):
        """RMS norm scaled by ``1 + scale`` (zero-initialised scale), in
        fp32: partial sums of squares psum'd over col; the col-invariant
        ``inv`` is ``pvary``'d where it meets the col-varying x."""
        xf = x.float()
        ssq = col.psum(self.mesh, (xf * xf).sum(-1, keepdim=True), "col")
        h = x.shape[-1] * self.ctx.cols
        inv = col.pvary(self.mesh, torch.rsqrt(ssq / h + eps), "col")
        return ((xf * inv) * (1.0 + scale.float())).to(x.dtype)

    def layernorm(self, x, scale, bias, eps=1e-5):
        xf = x.float()
        s1 = col.psum(self.mesh, xf.sum(-1, keepdim=True), "col")
        s2 = col.psum(self.mesh, (xf * xf).sum(-1, keepdim=True), "col")
        h = x.shape[-1] * self.ctx.cols
        mean = s1 / h
        var = s2 / h - mean * mean
        inv = col.pvary(self.mesh, torch.rsqrt(var + eps), "col")
        y = (xf - col.pvary(self.mesh, mean, "col")) * inv * scale.float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    def kv_full(self, k, axis: int = 1):
        """K/V (as produced by the projections) -> full-sequence K/V."""
        return self.gather_seq(k, axis)

    # ---------------- losses / heads ----------------
    def ce_loss(self, x, w_head, labels, *, vocab_real: int,
                loss_chunk: int = 512, label_mask=None):
        """Chunked cross-entropy -> (loss_sum, count), fp32 scalars.

        x: canonical activation [B_loc, S_loc, h/q]; w_head: this rank's
        vocab shard [v_pad / (d q^2), h] (over (depth, row, col)) in the
        compute dtype (cast once per step by the caller); labels: host
        layout [B', S'] per (data, depth) group, cut by ``shard_tokens``;
        label_mask: optional weights of the same layout (default all
        ones).  Each chunk of ``loss_chunk`` local tokens (shrunk to divide
        them, as the reference does) forms its fp32 logits as the
        reference's fp32-accumulated head einsum does, with the padded
        vocab at -inf, and is recomputed in the backward (the reference's
        ``@jax.checkpoint``), so the [tokens, vocab] logits never exist
        whole.  The sums are invariant over the model axes and still vary
        over data (the caller psums them there)."""
        xf, lab, lm, c = self._chunks(x, labels, label_mask, loss_chunk)
        if self.mesh.size > 1:
            return self._ce_loss_mesh(xf, w_head, lab, lm, c, vocab_real)
        # fp32 products of the compute-dtype values: the reference's
        # preferred_element_type=float32 accumulation, without rounding
        w32 = w_head.float()
        vmask = torch.arange(w_head.shape[0], device=x.device) < vocab_real
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, xf.shape[0], c):
            ls, cs = checkpoint(_chunk_loss, xf[i:i + c], w32, lab[i:i + c],
                                lm[i:i + c], vmask, use_reentrant=False)
            loss_sum = loss_sum + ls
            count = count + cs
        return loss_sum, count

    def _ce_loss_mesh(self, xf, w_head, lab, lm, c, vocab_real):
        """``ce_loss`` over the vocab-sharded head (``repro/core/ops.py``
        ``ce_loss``): each chunk's tokens are gathered over (depth, row)
        and its features over col, every model rank forms the logits of its
        vocab shard, ``m`` is the pmax of a stop-gradient max, the sum of
        exps and the owner's label logit are psum'd over the model axes,
        and each rank keeps its own token slice before one psum over
        (depth, row)."""
        # the fp32 copy the backward's dX product reads (ROADMAP Queue C:
        # dlogits is fp32), made once per step rather than once per chunk
        w32 = w_head.detach().float()
        loss_sum = count = None
        for i in range(0, xf.shape[0], c):
            ls, cs = checkpoint(self._ce_chunk_mesh, xf[i:i + c], w_head,
                                w32, lab[i:i + c], lm[i:i + c], vocab_real,
                                use_reentrant=False)
            loss_sum = ls if loss_sum is None else loss_sum + ls
            count = cs if count is None else count + cs
        return loss_sum, count

    def _ce_chunk_mesh(self, x_chunk, w_head, w32, l_chunk, m_chunk,
                       vocab_real):
        mesh, ctx = self.mesh, self.ctx
        rows = (ctx.axis_depth, ctx.axis_row)
        model = ctx.model_axes
        xg = col.all_gather_cat(mesh, x_chunk, rows, axis=0)
        xg = col.all_gather_inv(mesh, xg, ctx.axis_col, tiled=True, axis=1)
        lg = col.all_gather_cat(mesh, l_chunk, rows, axis=0)
        v_loc = w_head.shape[0]
        v_off = mesh.index(model) * v_loc
        logits = _HeadLogits.apply(xg, w_head, w32)       # [C, v_loc] fp32
        vmask = (v_off + torch.arange(v_loc, device=xg.device)) < vocab_real
        logits = logits.masked_fill(~vmask[None, :], float("-inf"))
        m = col.pmax(mesh, logits.detach().amax(-1), model)
        se = col.psum(mesh, torch.exp(logits - m[:, None]).sum(-1), model)
        lse = torch.log(se) + m
        idx = lg - v_off
        valid = (idx >= 0) & (idx < v_loc)
        ll = logits.gather(1, idx.clamp(0, v_loc - 1)[:, None])[:, 0]
        ll = col.psum(mesh, torch.where(valid, ll, torch.zeros_like(ll)),
                      model)
        # lse and ll are invariant over the model axes; the slice below
        # takes this rank's own tokens, which vary over (depth, row): the
        # reference's implied pvary there, whose backward hands every rank
        # the cotangents of the chunk's tokens
        loss = col.pvary(mesh, lse, rows) - col.pvary(mesh, ll, rows)
        mine = loss.narrow(0, mesh.index(rows) * x_chunk.shape[0],
                           x_chunk.shape[0])
        return (col.psum(mesh, (mine * m_chunk).sum(), rows),
                col.psum(mesh, m_chunk.sum(), rows))

    def _head_features(self, x):
        """The head's rows [B_loc, h/q] with their features gathered over
        col."""
        return col.all_gather_inv(self.mesh, x, self.ctx.axis_col,
                                  tiled=True, axis=1)


class MegatronOps(_OpSet):
    """The Megatron-LM 1-D op set (``repro/core/ops.py:448 MegatronOps``)
    on one rank's local blocks: column-parallel up-projections, row-parallel
    down-projections whose partial sums are all-reduced over the model axes
    (reduce-scattered over col along the sequence on the seq-sharded
    prefill plan: Megatron-SP, which gathers the sequence back before the
    block's up-projections, ``seq_gather_in``), and the embed and head
    vocab-sharded over col.  depth and row have size 1, so a reduction
    over the model axes is one over col.

    Its products are ``local_matmul`` (``torch.mm``), fp32-accumulated
    and rounded once to the activations' dtype, as the reference's
    ``_f32_einsum`` (a plain einsum outside any Pallas kernel) is: no
    SUMMA contraction, so no kernel #1.

    Gradients.  The residual stream is replicated over col, and each
    rank's cotangent of it is that rank's partial: the reductions into the
    stream are ``psum_v`` (all-reduce forward and backward), so the norm
    scales and the replicated biases get partial gradients, which the
    train step's ``sync_grads`` sums over col.  The reference types the
    stream invariant and pvary's it where it meets a varying param (the
    next norm's scale, a down-bias); both give the same gradients."""

    mode_family = "megatron"

    def vocab_pad_multiple(self) -> int:
        return self.ctx.cols

    # ---------------- host layout ----------------
    def tokens_in_axes(self) -> tuple:
        """Per-dim mesh axes of host-layout ids [B, S]: the batch over data
        (decode_dp is decode in 1-D), whole on long_decode; the sequence
        shards of the prefill plan are cut by ``embed``'s reduce-scatter."""
        if self.plan.kind == "long_decode":
            return ((), ())
        return (("data",), ())

    # ---------------- core ops ----------------
    def seq_gather_in(self, x):
        """Megatron-SP's entry gather, once before a block's
        up-projections: the sequence shards gathered over col."""
        return self.gather_seq(x, 1)

    def positions_q(self, t: int, device=None):
        """Positions of the q rows out of ``seq_gather_in`` and
        ``linear_up``: Megatron-SP projects the gathered sequence."""
        return torch.arange(t, device=device)

    def linear_up(self, x, w, b=None, *, keep=True):
        """Column-parallel: [.., F] x [F, G/p] -> [.., G/p]."""
        y = local_matmul(x, w, keep=keep)
        if b is not None:
            y = y + b
        return y

    def linear_down(self, h, w, b=None, *, keep=True):
        """Row-parallel: [.., G/p] x [G/p, F] -> the partial sums
        all-reduced over the model axes (``psum_v``), or on the seq-sharded
        plan reduce-scattered over col along the sequence -> [.., F]."""
        y = local_matmul(h, w, keep=keep)
        if self.plan.seq_sharded:
            y = col.psum_scatter_dim(self.mesh, y, self.ctx.axis_col, 1)
        else:
            y = col.psum_v(self.mesh, y, self.ctx.model_axes)
        if b is not None:
            y = y + b
        return y

    def linear_to_replicated(self, x, w, b=None):
        """[.., F] x [F, G] with the weight replicated: a local product
        (replicated GQA KV heads when num_kv_heads % p != 0)."""
        y = local_matmul(x, w)
        if b is not None:
            y = y + b
        return y

    def embed(self, ids, table):
        """ids: this rank's host-layout block [B', S'] (``host_block``);
        table: this rank's vocab shard [v_pad/p, h] (over col).  Returns the
        canonical activation [B_loc, S_loc, h]: the vocab shards' partial
        rows all-reduced over the model axes (``psum_v``), or on the
        seq-sharded plan reduce-scattered over col along the sequence.  Ids
        outside the vocab give zero rows."""
        v_loc = table.shape[0]
        local = ids - self.mesh.coords["col"] * v_loc
        valid = (local >= 0) & (local < v_loc)
        emb = table[local.clamp(0, v_loc - 1)]
        emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
        if self.plan.seq_sharded:
            return col.psum_scatter_dim(self.mesh, emb, self.ctx.axis_col, 1)
        return col.psum_v(self.mesh, emb, self.ctx.model_axes)

    def shard_tokens(self, t):
        """Slice host-layout ids [B', S'] to this rank's token block: its
        sequence shard on the seq-sharded plan."""
        if not self.plan.seq_sharded:
            return t
        n = t.shape[1] // self.ctx.cols
        return t.narrow(1, self.mesh.coords["col"] * n, n)

    def rmsnorm(self, x, scale, eps=1e-5):
        """RMS norm scaled by ``1 + scale`` in fp32, over the whole
        features every rank holds (no collective)."""
        xf = x.float()
        ssq = (xf * xf).sum(-1, keepdim=True)
        inv = torch.rsqrt(ssq / x.shape[-1] + eps)
        return ((xf * inv) * (1.0 + scale.float())).to(x.dtype)

    def layernorm(self, x, scale, bias, eps=1e-5):
        xf = x.float()
        h = x.shape[-1]
        mean = xf.sum(-1, keepdim=True) / h
        var = (xf * xf).sum(-1, keepdim=True) / h - mean * mean
        y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    def kv_full(self, k, axis: int = 1):
        """K/V are full-length already: Megatron-SP projects the gathered
        sequence."""
        return k

    # ---------------- losses / heads ----------------
    def ce_loss(self, x, w_head, labels, *, vocab_real: int,
                loss_chunk: int = 512, label_mask=None):
        """Chunked cross-entropy -> (loss_sum, count), fp32 scalars, over
        the head's vocab shard [v_pad/p, h] (the reference's Megatron
        ``ce_loss``): every rank forms the fp32 logits of its vocab shard
        for each chunk's tokens (on a seq-sharded plan the chunk is
        gathered over col first), ``m`` is the pmax of a stop-gradient
        max, and the sum of exps and the owner's label logit are psum'd
        over the model axes.  Each chunk is recomputed in the backward.
        The sums are invariant over the model axes and still vary over
        data (the caller psums them there)."""
        xf, lab, lm, c = self._chunks(x, labels, label_mask, loss_chunk)
        # the fp32 copy the backward's dX product reads, made once per step
        w32 = w_head.detach().float()
        loss_sum = count = None
        for i in range(0, xf.shape[0], c):
            ls, cs = checkpoint(self._ce_chunk, xf[i:i + c], w_head, w32,
                                lab[i:i + c], lm[i:i + c], vocab_real,
                                use_reentrant=False)
            loss_sum = ls if loss_sum is None else loss_sum + ls
            count = cs if count is None else count + cs
        return loss_sum, count

    def _ce_chunk(self, x_chunk, w_head, w32, l_chunk, m_chunk, vocab_real):
        mesh, ctx = self.mesh, self.ctx
        tp = ctx.model_axes
        sp = self.plan.seq_sharded
        if sp:
            # the col ranks hold different tokens: gather the chunk before
            # the vocab-sharded product (the mask stays local)
            x_chunk = col.all_gather_cat(mesh, x_chunk, ctx.axis_col, axis=0)
            l_chunk = col.all_gather_cat(mesh, l_chunk, ctx.axis_col, axis=0)
        v_loc = w_head.shape[0]
        v_off = mesh.index(tp) * v_loc
        logits = _HeadLogits.apply(x_chunk, w_head, w32)  # [C, v_loc] fp32
        vmask = (v_off + torch.arange(v_loc, device=x_chunk.device)
                 ) < vocab_real
        logits = logits.masked_fill(~vmask[None, :], float("-inf"))
        m = col.pmax_v(mesh, logits.detach().amax(-1), tp)
        # lse and ll meet no varying value (the loss is invariant over the
        # model axes), so the reference's psum_v leaves them unpvary'd: a
        # plain psum, whose backward is the identity
        se = col.psum(mesh, torch.exp(logits - m[:, None]).sum(-1), tp)
        lse = torch.log(se) + m
        idx = l_chunk - v_off
        valid = (idx >= 0) & (idx < v_loc)
        ll = logits.gather(1, idx.clamp(0, v_loc - 1)[:, None])[:, 0]
        ll = col.psum(mesh, torch.where(valid, ll, torch.zeros_like(ll)), tp)
        loss = lse - ll
        if not sp:
            return (loss * m_chunk).sum(), m_chunk.sum()
        # this rank's own tokens of the gathered chunk (they vary over col)
        n = m_chunk.shape[0]
        mine = col.pvary(mesh, loss, ctx.axis_col).narrow(
            0, mesh.index(ctx.axis_col) * n, n)
        return (col.psum(mesh, (mine * m_chunk).sum(), ctx.axis_col),
                col.psum(mesh, m_chunk.sum(), ctx.axis_col))

    def _head_features(self, x):
        """The head's rows [B_loc, h]: features whole already."""
        return x


def _local_mm(a2, w):
    return torch.mm(a2, w)


class _LocalMatmul(torch.autograd.Function):
    """C = A @ W on this rank's blocks with ``torch.matmul``'s backward (dA
    = dC W^T, dW = A^T dC): its own node, so that remat="dots" keeps C in a
    block's forward and hands it back in the recompute (``core/remat.py``),
    as ``core/summa.py``'s SUMMA product does."""

    @staticmethod
    def forward(fctx, a2, w, keep):
        fctx.save_for_backward(a2, w)
        return remat.product(lambda: _local_mm(a2, w), keep)

    @staticmethod
    def backward(fctx, dc):
        a2, w = fctx.saved_tensors
        return torch.matmul(dc, w.t()), torch.matmul(a2.t(), dc), None


def local_matmul(x, w, *, keep: bool = True):
    """[.., F] x [F, G] -> [.., G] on this rank's blocks, no collective
    (``torch.mm`` on the flattened rows: fp32-accumulated, rounded once to
    x's dtype, the reference's ``_f32_einsum(..., out_dtype=x.dtype)``);
    an autograd node only when a gradient is wanted."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        c = _LocalMatmul.apply(x2, w, keep)
    else:
        c = _local_mm(x2, w)
    return c.reshape(*lead, w.shape[-1])


class _HeadLogits(torch.autograd.Function):
    """logits [C, v] float32 = x [C, h] @ w [v, h]^T, the operands in the
    compute dtype summed in fp32 (``mm_f32``).  ``torch.mm`` with an fp32
    result from bf16 operands has no autograd formula, so the backward is
    written out: dX = dlogits W in fp32 from ``w32`` (w's fp32 copy),
    rounded to x's dtype, and dW = dlogits^T X, rounded to w's dtype."""

    @staticmethod
    def forward(fctx, x, w, w32):
        fctx.save_for_backward(x, w32)
        fctx.w_dtype = w.dtype
        return mm_f32(x, w.t())

    @staticmethod
    def backward(fctx, g):
        x, w32 = fctx.saved_tensors
        dx = torch.mm(g, w32).to(x.dtype)
        dw = torch.mm(g.t(), x.float()).to(fctx.w_dtype)
        return dx, dw, None


def _chunk_loss(x_chunk, w32, labels, mask, vmask):
    """One CE chunk: (sum of mask * (lse - logit[label]), sum of mask)."""
    logits = torch.matmul(x_chunk.float(), w32.t())
    logits = logits.masked_fill(~vmask[None, :], float("-inf"))
    m = logits.amax(-1).detach()
    lse = torch.log(torch.exp(logits - m[:, None]).sum(-1)) + m
    ll = logits.gather(1, labels[:, None])[:, 0]
    return ((lse - ll) * mask).sum(), mask.sum()


def ops_last_token(ops: TesseractOps, x):
    """[B, S_loc, f] -> [B, 1, f]: the true last token, replicated over the
    sequence-sharding axes (the last shard holds it)."""
    lt = x[:, -1:]
    if not ops.plan.seq_sharded:
        return lt
    return col.all_gather_inv(ops.mesh, lt, ops.ctx.seq_shard_axes)[-1]


def make_ops(ctx: ParallelContext, mesh: Mesh, plan: Plan):
    if ctx.mode in ("tesseract", "summa2d"):
        return TesseractOps(ctx, mesh, plan)
    if ctx.mode == "megatron1d":
        return MegatronOps(ctx, mesh, plan)
    raise ValueError(f"no op set for mode {ctx.mode!r}")
