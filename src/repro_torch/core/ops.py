"""Operation set the models are written against (PyTorch port of
``repro.core.ops``).

The reference's ``TesseractOps`` wraps every primitive in the collectives of
the [data, depth, row, col] mesh.  The port runs the one-device layout only
(``core/api.py::require_single_device``), where every one of those
collectives is the identity, so each method below is the local math alone:
no fake collectives.  ``Plan`` and ``kv_group_axes`` keep the reference's
names so the serve code reads the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .api import ParallelContext, require_single_device


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


class TesseractOps:
    """One-device Tesseract op set: the local math of each reference op."""

    mode_family = "tesseract"

    def __init__(self, ctx: ParallelContext, plan: Plan):
        require_single_device(ctx)
        self.ctx = ctx
        self.plan = plan

    def vocab_pad_multiple(self) -> int:
        return self.ctx.depth * self.ctx.rows * self.ctx.cols

    def linear(self, x, w, b=None):
        """x @ w with the weight in the reference's [in, out] layout.  A bf16
        product accumulates in fp32 and rounds once, as the reference's
        fp32-accumulated einsum cast back to x's dtype does."""
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        return y

    linear_up = linear
    linear_down = linear
    # [.., F] x [F, G] -> [.., G] replicated over col: the reference psums
    # the col shards' partial products, which at one device is the product
    linear_to_replicated = linear

    def embed(self, ids, table):
        """ids [B, S] -> rows of ``table`` [v_pad, h]; ids outside the table
        give zero rows, as the reference's vocab-shard mask does."""
        valid = (ids >= 0) & (ids < table.shape[0])
        emb = table[ids.clamp(0, table.shape[0] - 1)]
        return torch.where(valid[..., None], emb, torch.zeros_like(emb))

    def rmsnorm(self, x, scale, eps=1e-5):
        """RMS norm scaled by ``1 + scale`` (zero-initialised scale), in fp32."""
        xf = x.float()
        inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return ((xf * inv) * (1.0 + scale.float())).to(x.dtype)

    def layernorm(self, x, scale, bias, eps=1e-5):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    def positions(self, seq_loc: int, device=None):
        """Global position ids [seq_loc]: the single shard starts at 0."""
        return torch.arange(seq_loc, device=device)

    def head_logits(self, x, w_head, *, vocab_real: int):
        """Full-vocab logits [B, v_pad] float32 from x [B, 1, h]; padded vocab
        entries are -inf.  The product runs in fp32 like the reference's
        fp32-accumulated head einsum with a float32 result."""
        logits = torch.matmul(x[:, 0, :].float(), w_head.float().t())
        vmask = torch.arange(w_head.shape[0], device=x.device) < vocab_real
        return logits.masked_fill(~vmask[None, :], float("-inf"))

    def head_sample(self, x, w_head, *, vocab_real: int):
        """Greedy next-token ids [B] int32 from x [B, 1, h]: the argmax of
        ``head_logits`` (padded vocab at -inf), ties to the smallest index
        as the reference's distributed argmax (torch.argmax returns the
        first maximum)."""
        logits = self.head_logits(x, w_head, vocab_real=vocab_real)
        return logits.argmax(-1).to(torch.int32)

    def ce_loss(self, x, w_head, labels, *, vocab_real: int,
                loss_chunk: int = 512, label_mask=None):
        """Chunked cross-entropy -> (loss_sum, count), fp32 scalars.

        x: [B, S, h] final hidden states; w_head: [v_pad, h] in the compute
        dtype (cast once per step by the caller); labels: [B, S] ids;
        label_mask: optional [B, S] weights (default all ones).  Each chunk
        of ``loss_chunk`` tokens (shrunk to divide B*S, as the reference
        does) forms fp32 logits as the reference's fp32-accumulated head
        einsum does, with the padded vocab at -inf, and is recomputed in the
        backward (the reference's ``@jax.checkpoint``), so the [tokens,
        vocab] fp32 logits never exist whole."""
        E = x.shape[0] * x.shape[1]
        xf = x.reshape(E, x.shape[-1])
        lab = labels.reshape(E).long()
        lm = (torch.ones(E, dtype=torch.float32, device=x.device)
              if label_mask is None
              else label_mask.reshape(E).to(torch.float32))
        c = max(1, min(loss_chunk, E))
        while E % c:
            c -= 1
        # fp32 products of the compute-dtype values: the reference's
        # preferred_element_type=float32 accumulation, without rounding
        w32 = w_head.float()
        vmask = torch.arange(w_head.shape[0], device=x.device) < vocab_real
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, E, c):
            ls, cs = checkpoint(_chunk_loss, xf[i:i + c], w32, lab[i:i + c],
                                lm[i:i + c], vmask, use_reentrant=False)
            loss_sum = loss_sum + ls
            count = count + cs
        return loss_sum, count


def _chunk_loss(x_chunk, w32, labels, mask, vmask):
    """One CE chunk: (sum of mask * (lse - logit[label]), sum of mask)."""
    logits = torch.matmul(x_chunk.float(), w32.t())
    logits = logits.masked_fill(~vmask[None, :], float("-inf"))
    m = logits.amax(-1).detach()
    lse = torch.log(torch.exp(logits - m[:, None]).sum(-1)) + m
    ll = logits.gather(1, labels[:, None])[:, 0]
    return ((lse - ll) * mask).sum(), mask.sum()


def ops_last_token(x):
    """[B, S, f] -> [B, 1, f]: the last token.  At one device the single
    sequence shard holds it, so the reference's gather over the
    sequence-sharding axes is the identity."""
    return x[:, -1:]


def make_ops(ctx: ParallelContext, plan: Plan):
    return TesseractOps(ctx, plan)
