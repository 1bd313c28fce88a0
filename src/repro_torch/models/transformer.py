"""Dense decoder-only LM (llama/yi/smollm/nemotron family): PyTorch port of
``repro.models.transformer.DenseLM``, serving path only.

Covers GQA, GLU / squared-ReLU MLPs, rmsnorm/layernorm and RoPE at the
one-device layout (no head or vocab padding arises there: q = 1).  Weights
keep the reference's [in, out] layout (``x @ w``), so params carried over
from the JAX package load by reshaping alone (convert.py).  The layer stack
is a Python loop over ``blocks`` in place of ``lax.scan``.

Serving entry points: ``prefill`` (bucketed, right-padded prompts with true
``lengths``) and ``decode_paged`` (one token per slot against the paged
pool, updated in place).  Training, the dense static decode loop and the
chunked-prefill path are not ported yet (ROADMAP Queue A).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, RunConfig, round_up
from ..core.api import ParallelContext, require_single_device
from ..core.ops import Plan, make_ops
from . import common as cm

WINIT_SCALE = 0.02     # reference common.winit


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One layer's parameters, named as the reference's ``blocks`` dict."""

    def __init__(self, cfg: ModelConfig, Hp: int, D: int, dtype, device):
        super().__init__()
        h, ff, kv = cfg.d_model, cfg.d_ff, cfg.num_kv_heads
        P = lambda *shape: _param(shape, dtype, device)
        self.ln1, self.ln2 = P(h), P(h)
        self.wq, self.wk, self.wv = P(h, Hp * D), P(h, kv * D), P(h, kv * D)
        self.wo, self.w_down = P(Hp * D, h), P(ff, h)
        self.w_up = P(h, ff)
        if cfg.mlp_glu:
            self.w_gate = P(h, ff)
        if cfg.use_bias:
            self.bq, self.bv, self.bo = P(Hp * D), P(kv * D), P(h)
            self.b_up, self.b_down = P(ff), P(h)
        if cfg.norm == "layernorm":
            self.ln1b, self.ln2b = P(h), P(h)


class DenseLM(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: ParallelContext, run: RunConfig,
                 *, device: torch.device, generator: torch.Generator):
        super().__init__()
        require_single_device(ctx)
        self.cfg, self.ctx, self.run = cfg, ctx, run
        self.device = device
        self.Hp = round_up(cfg.num_heads, ctx.cols)
        self.D = cfg.resolved_head_dim
        probe = make_ops(ctx, Plan.for_shape("train"))
        self.v_pad = round_up(cfg.vocab_size, probe.vocab_pad_multiple())
        self.pdt = getattr(torch, run.param_dtype)
        self.cdt = getattr(torch, run.compute_dtype)
        h = cfg.d_model
        self.embed = _param((self.v_pad, h), self.pdt, device)
        self.head = _param((self.v_pad, h), self.pdt, device)
        self.ln_f = _param((h,), self.pdt, device)
        if cfg.norm == "layernorm":
            self.ln_fb = _param((h,), self.pdt, device)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, self.Hp, self.D, self.pdt, device)
            for _ in range(cfg.num_layers))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init scales: weights N(0, 0.02), biases zero, norm
        scales zero for rmsnorm's (1 + scale) and one for layernorm."""
        layernorm = self.cfg.norm == "layernorm"
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "ln_f"):
                p.fill_(1.0 if layernorm else 0.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                p.normal_(0.0, WINIT_SCALE, generator=generator)

    # ------------------------------------------------------------ helpers
    def _w(self, p):
        """Matrices in param dtype are cast to the compute dtype per call,
        as the reference does; vectors (norms, biases) are not."""
        return p.to(self.cdt) if p is not None and p.ndim > 1 else p

    def _norm(self, ops, x, scale, bias=None):
        if self.cfg.norm == "layernorm":
            return ops.layernorm(x, scale, bias, self.cfg.norm_eps)
        return ops.rmsnorm(x, scale, self.cfg.norm_eps)

    def _qkv(self, blk, x, ops, positions):
        """Project and rope. Returns q [B,T,Hq,D], k/v [B,T,Hkv,D]."""
        cfg, D = self.cfg, self.D
        B, T = x.shape[:2]
        q = ops.linear_up(x, self._w(blk.wq), getattr(blk, "bq", None))
        k = ops.linear_up(x, self._w(blk.wk))
        v = ops.linear_up(x, self._w(blk.wv), getattr(blk, "bv", None))
        q = q.reshape(B, T, self.Hp, D)
        k = k.reshape(B, T, cfg.num_kv_heads, D)
        v = v.reshape(B, T, cfg.num_kv_heads, D)
        if cfg.use_rope:
            q = cm.apply_rope(q, positions, cfg.rope_theta)
            k = cm.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_out(self, blk, out, ops):
        B, T = out.shape[:2]
        out = out.reshape(B, T, self.Hp * self.D)
        return ops.linear_down(out, self._w(blk.wo), getattr(blk, "bo", None))

    def _mlp(self, blk, x, ops):
        cfg = self.cfg
        act = cm.mlp_act(cfg.mlp_act)
        b_up = getattr(blk, "b_up", None)
        if cfg.mlp_glu:
            g = ops.linear_up(x, self._w(blk.w_gate))
            u = ops.linear_up(x, self._w(blk.w_up), b_up)
            h = act(g) * u
        else:
            h = act(ops.linear_up(x, self._w(blk.w_up), b_up))
        return ops.linear_down(h, self._w(blk.w_down),
                               getattr(blk, "b_down", None))

    def _final(self, ops, x):
        return self._norm(ops, x, self.ln_f, getattr(self, "ln_fb", None))

    def _logits(self, ops, x):
        return ops.head_logits(x, self._w(self.head),
                               vocab_real=self.cfg.vocab_size)

    # ------------------------------------------------------------ prefill
    def _block_prefill(self, blk, x, ops, qpos):
        """Attention + MLP sublayers (residuals included); also returns this
        layer's K/V for the cache."""
        h = self._norm(ops, x, blk.ln1, getattr(blk, "ln1b", None))
        q, k, v = self._qkv(blk, h, ops, qpos)
        # the Tesseract prefill plan is seq-sharded even at one device, so,
        # as in the reference, no static q offset: the flash kernel walks
        # every KV tile under the causal mask
        q_start = None if ops.plan.seq_sharded else 0
        out = cm.attention(q, k, v, q_pos=qpos, causal=True,
                           local_window=self.cfg.local_window,
                           impl=self.ctx.attn_impl, q_start=q_start)
        x = x + self._attn_out(blk, out, ops)
        h2 = self._norm(ops, x, blk.ln2, getattr(blk, "ln2b", None))
        x = x + self._mlp(blk, h2, ops)
        return x, (k.to(self.cdt), v.to(self.cdt))

    @torch.no_grad()
    def prefill(self, tokens, lengths):
        """Process right-padded prompts tokens [B, S] with true ``lengths``
        [B].  Returns (full-vocab logits [B, v_pad] float32 at each
        request's last position, cache {"k", "v": [L, B, S, Hkv, D]})."""
        ops = make_ops(self.ctx, Plan.for_shape("prefill"))
        x = ops.embed(tokens, self.embed).to(self.cdt)
        qpos = ops.positions(x.shape[1], device=x.device)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = self._block_prefill(blk, x, ops, qpos)
            ks.append(k)
            vs.append(v)
        x = self._final(ops, x)
        return (self._logits(ops, last_token_at(x, lengths)),
                {"k": torch.stack(ks), "v": torch.stack(vs)})

    # ------------------------------------------------------------- decode
    def paged_cache_shape(self, num_blocks: int, block_size: int):
        """Shape and dtype of each of the pool's "k" and "v" tensors,
        [L, P, bs, Hkv, D] in the compute dtype."""
        cfg = self.cfg
        return ((cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
                 self.D), self.cdt)

    def _block_decode_paged(self, blk, x, pool_l, table, pos, ops, *, idx,
                            kv_map):
        h = self._norm(ops, x, blk.ln1, getattr(blk, "ln1b", None))
        q, k, v = self._qkv(blk, h, ops, pos[:, None])
        cm.paged_update(pool_l, k, v, idx)
        out = cm.paged_attention(q[:, 0], pool_l["k"], pool_l["v"], table,
                                 pos, kv_map=kv_map,
                                 local_window=self.cfg.local_window,
                                 impl=self.ctx.attn_impl)
        x = x + self._attn_out(blk, out[:, None], ops)
        h2 = self._norm(ops, x, blk.ln2, getattr(blk, "ln2b", None))
        return x + self._mlp(blk, h2, ops)

    @torch.no_grad()
    def decode_paged(self, pool, table, ids, pos):
        """One continuous-batching step against the paged block pool.

        pool: {"k", "v": [L, P, bs, Hkv, D]}, updated in place with each
        slot's new K/V; table: [B, nb] int32 block ids; ids: [B, 1] input
        tokens; pos: [B] int32 positions.  Returns full-vocab logits
        [B, v_pad] float32."""
        ops = make_ops(self.ctx, Plan.for_shape(
            "decode", global_batch=ids.shape[0],
            batch_shards=self.ctx.batch_shards, data=self.ctx.data))
        x = ops.embed(ids, self.embed).to(self.cdt)
        # position-only work, shared by every layer
        idx = cm.paged_step_indices(table, pos, pool["k"].shape[2])
        kv_map = cm.contiguous_kv_map(self.Hp, self.cfg.num_kv_heads,
                                      x.device)
        for i, blk in enumerate(self.blocks):
            pool_l = {"k": pool["k"][i], "v": pool["v"][i]}
            x = self._block_decode_paged(blk, x, pool_l, table, pos, ops,
                                         idx=idx, kv_map=kv_map)
        return self._logits(ops, self._final(ops, x))


def last_token_at(x, lengths):
    """[B, S, f] + true lengths [B] -> [B, 1, f] hidden states at position
    lengths - 1 (the bucketed prefill right-pads prompts)."""
    idx = (lengths.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return x.gather(1, idx)
