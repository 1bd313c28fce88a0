"""Mamba2 (SSD, state-space duality) LM: PyTorch port of
``repro.models.ssm``, the serve and train paths, on one rank or across the
Tesseract mesh.

The SSD state recurrence is chunked: within a chunk of Q tokens the output
is a masked Q x Q product (``kernels/ssd.py``: the Hopper kernel when
``RunConfig.use_pallas``, else its plain version, beside which ``segsum``
lives), and the chunk-end states are chained across chunks by a linear
scan (a Python loop over chunks in place of ``lax.scan``).  B and C have
one group, shared by all heads.

On the mesh (``tesseract`` and ``summa2d``) the parameters are one rank's
local blocks of the reference's global tree, cut by its partition specs
(``ssm_param_specs``): the projections w_z, w_x, w_dt and w_out are SUMMA
weights, the heads (and so d_inner, the state's heads and conv_x's
channels) go over col, and B and C stay replicated over col.  The
prefill plan shards the sequence over (depth, row), so a shard needs
what the shards before it hold: the causal conv's left halo
(``collectives.halo_exchange_left``) and the SSD state entering it
(``collectives.distributed_linear_scan_carry``, then the correction
y += (C_t . h_in) exp(cumsum log_a)); the cache takes the last shard's
final states and conv tails (``collectives.last_shard_value``).  Megatron
(``megatron1d``) refuses, as the reference does.

Serving entry points, both without autograd, each taking host-layout
inputs every rank passes alike: ``prefill(tokens)`` gives the greedy
next ids of every prompt (on every rank) and the cache (per-layer SSM
states and the causal conv's tails) with the batch over data;
``decode(cache, ids, pos)`` advances every sequence by one token through
the state recurrence, on the cache layout of ``decode_plan`` (the batch
over (data, depth, row), over data, or whole: ``cache_batch_axes``).
``runtime/serve_steps.py`` holds the static steps around them and the
prefill-to-decode reshard.  ``MambaLM`` has no paged decode path, so
``InferenceEngine`` refuses it (the reference's guard).

Training entry point: ``loss(batch)``, the reference's ``MambaLM.loss`` on
the train plan (the sequence whole on every rank, so no halo and no state
chain; across ranks the only new collectives of the backward are the
transposes of ``linear_to_replicated``'s psum and pvary over col).  It
runs the reference's einsum path: ``ssd_intra`` has no backward, as the
reference's has none (``kernels/ssd.py``), so ``runtime/steps.py``
refuses to train a model built with ``use_pallas=True``.  As in the
reference, the model shards no sequence and has no pipeline stages.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, RunConfig, round_up
from ..core import collectives as col
from ..core.api import ParallelContext
from ..core.mesh import Mesh
from ..core.ops import Plan, make_ops, ops_last_token
from ..kernels.ssd import ssd_intra, ssd_intra_plain
from .transformer import (WINIT_SCALE, alloc_local_params,
                          draw_local_params, mean_ce_loss, run_blocks)

CONV_INIT_SCALE = 0.2    # reference: winit(..., 0.2) for conv_x/B/C


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def silu(x):
    """jax.nn.silu: x * 1 / (1 + exp(-x)), each step rounded to x's dtype
    (F.silu rounds once, which differs from it in bf16)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ssm_param_specs(cfg: ModelConfig, ctx: ParallelContext):
    """The reference's ``MambaLM`` specs (``repro/models/ssm.py:155-170``
    for the blocks, ``DenseLM.specs`` for embed, head and ln_f) under the
    Tesseract op set, in ``dense_param_specs``'s form: (top-level params,
    per-layer params), each {name: (logical shape, padded global shape,
    per-dim mesh axes)}, in the modules' registration order."""
    if ctx.mode == "megatron1d":
        raise NotImplementedError("ssm arch runs in tesseract modes")
    h, N, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    di = cfg.ssm_expand * h
    H = di // cfg.ssm_head_dim
    v_pad = round_up(cfg.vocab_size,
                     make_ops(ctx, None, Plan()).vocab_pad_multiple())
    w2d = (("row",), ("col",))                 # spec_w2d, spec_w_down
    to_rep = (("col",), ())                    # spec_w_to_replicated
    vec = (("col",),)                          # spec_vec, spec_norm

    def same(shape, spec):
        return (shape, shape, spec)

    top = {"embed": ((cfg.vocab_size, h), (v_pad, h), w2d),
           "head": ((cfg.vocab_size, h), (v_pad, h),
                    (("depth", "row", "col"), ())),
           "ln_f": same((h,), vec)}
    block = {"ln": same((h,), vec),
             "w_z": same((h, di), w2d), "w_x": same((h, di), w2d),
             "w_B": same((h, N), to_rep), "w_C": same((h, N), to_rep),
             "w_dt": same((h, H), w2d),
             "dt_bias": same((H,), vec), "A_log": same((H,), vec),
             "Dskip": same((H,), vec),
             # [K, C]: the channels over col (replicated for B and C)
             "conv_x": same((K, di), ((), ("col",))),
             "conv_B": same((K, N), ((), ())),
             "conv_C": same((K, N), ((), ())),
             "ln_y": same((di,), vec),
             "w_out": same((di, h), w2d)}
    return top, block


def ssd_chunked(x, log_a, Bm, Cm, chunk: int, use_pallas: bool = False):
    """SSD scan.  x: [B, T, H, P]; log_a: [B, T, H]; Bm/Cm: [B, T, N].
    Returns (y [B, T, H, P] in x's dtype, h_last [B, H, P, N] float32,
    a_prod [B, H] = exp(sum_t log_a), the sequence's decay product, which
    chains a sequence shard's state to the next).

    The chunk shrinks to divide T, as the reference's does (T = 1000 gives
    Q = 250)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    nc = T // Q
    # the kernel reads contiguous inputs (a no-op for the mixer's, which
    # are fresh tensors)
    xr = x.reshape(Bsz, nc, Q, H, P).contiguous()
    lar = log_a.reshape(Bsz, nc, Q, H).contiguous()
    Br = Bm.reshape(Bsz, nc, Q, N).contiguous()
    Cr = Cm.reshape(Bsz, nc, Q, N).contiguous()
    intra = ssd_intra if use_pallas else ssd_intra_plain
    Yd, S_c = intra(xr, lar, Br, Cr)      # [B,nc,Q,H,P], [B,nc,H,P,N]

    cum = torch.cumsum(lar, dim=2)                          # [B,nc,Q,H]
    A_c = torch.exp(cum[:, :, -1, :])                       # chunk decay
    # inter-chunk state scan H_{c+1} = A_c H_c + S_c, keeping the state
    # entering each chunk
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = A_c[:, c, :, None, None] * h + S_c[:, c]
    h_ins = torch.stack(h_ins, dim=1)                       # [B,nc,H,P,N]
    # inter-chunk contribution: y_i += C_i . (decay_in[i] * H_in)
    Yi = torch.einsum("bcin,bchpn->bcihp", Cr, h_ins)
    Yi = Yi * torch.exp(cum)[..., None]
    y = (Yd + Yi).reshape(Bsz, T, H, P)
    a_prod = torch.exp(torch.sum(log_a, dim=1))             # [B,H]
    return y.to(x.dtype), h, a_prod


def chain_shard(y, h_last, a_prod, log_a, Cm, h_in):
    """A sequence shard's SSD output and final state once the state h_in
    [B, H, P, N] entering it is known (``ssd_chunked`` started it from
    zero): y [B, T, H, P] gains (C_t . h_in) exp(cumsum_t log_a) and
    h_last gains a_prod h_in, in fp32 (the reference's seq-sharded branch,
    ``repro/models/ssm.py:216-229``).  Cm: the post-conv C [B, T, N]."""
    cum = torch.cumsum(log_a, dim=1)                        # [B,T,H]
    corr = torch.einsum("btn,bhpn->bthp", Cm.float(), h_in)
    y = (y.float() + corr * torch.exp(cum)[..., None]).to(y.dtype)
    return y, a_prod[..., None, None] * h_in + h_last


class MambaLM(nn.Module):
    """Mamba2 LM: embed, ``num_layers`` SSD blocks, the final rmsnorm and
    an untied head, on one rank's blocks of the mesh of ``ctx``."""

    supports_pipeline = False   # custom loss not stage-decomposed
    supports_seq_shard = False  # SSM scan crosses seq-shard boundaries

    def __init__(self, cfg: ModelConfig, ctx: ParallelContext, run: RunConfig,
                 *, device: torch.device, generator: torch.Generator,
                 mesh: Mesh | None = None):
        super().__init__()
        if ctx.mode == "megatron1d":
            # the reference's refusal (repro/models/ssm.py:110)
            raise NotImplementedError("ssm arch runs in tesseract modes")
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.n_heads = self.d_inner // cfg.ssm_head_dim
        if self.n_heads % ctx.cols:
            raise ValueError("ssm heads must divide cols")
        self.cfg, self.ctx, self.run = cfg, ctx, run
        self.device = device
        self.pdt = getattr(torch, run.param_dtype)
        self.cdt = getattr(torch, run.compute_dtype)
        self.heads_loc = self.n_heads // ctx.cols
        self.N = cfg.ssm_state
        alloc_local_params(self, cfg, ctx, mesh, ssm_param_specs, self.pdt,
                           device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """The reference's init scales: matrices N(0, 0.02), conv weights
        N(0, 0.2), norm scales, dt_bias and A_log zero, Dskip one
        (``draw_local_params``)."""

        def rule(name, p):
            if name == "Dskip":
                p.fill_(1.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                return (CONV_INIT_SCALE if name.startswith("conv_")
                        else WINIT_SCALE)
            return None

        draw_local_params(self, generator, rule)

    def tess_weight_names(self) -> set:
        """The block params that flow only through ``tesseract_matmul``
        (the reference's ``tess_weight_names``)."""
        return {"w_z", "w_x", "w_dt", "w_out"}

    # ------------------------------------------------------------ helpers
    def _cast(self, blk):
        """A layer's params in the compute dtype.  Unlike the dense path,
        the reference casts every leaf in the param dtype, vectors (norm
        scales, dt_bias, A_log, Dskip) included."""
        return {n: (p.to(self.cdt) if p.dtype == self.pdt else p)
                for n, p in blk.named_parameters()}

    def _norm(self, ops, x, scale):
        return ops.rmsnorm(x, scale, self.cfg.norm_eps)

    def decode_plan(self, batch: int) -> Plan:
        """The decode plan of a global batch: ``decode`` (the batch over
        (data, depth, row)), or ``decode_dp`` / ``long_decode`` for a batch
        too small to split over them."""
        return Plan.for_shape("decode", global_batch=batch,
                              batch_shards=self.ctx.batch_shards,
                              data=self.ctx.data)

    def cache_batch_axes(self, plan: Plan) -> tuple:
        """Mesh axes the cache's batch dim is split over under ``plan``
        (the reference's ``cache_abstract`` and ``prefill_cache_specs``):
        the prefill cache over data, the decode cache over the plan's
        token axes."""
        if plan.kind == "decode":
            return self.ctx.token_axes
        if plan.kind in ("prefill", "decode_dp"):
            return (self.ctx.axis_data,)
        return ()

    def cache_abstract(self, batch: int, plan: Plan | None = None):
        """(shape, dtype) of this rank's block of each cache leaf for a
        global ``batch`` under ``plan`` (default ``decode_plan(batch)``):
        "state" [L, b, H_loc, P, N] float32 and the conv tails "conv_x"
        [L, b, K-1, d_inner_loc], "conv_B" / "conv_C" [L, b, K-1, N] in
        the compute dtype; b is the batch over ``cache_batch_axes``, the
        heads and d_inner over col."""
        cfg = self.cfg
        plan = plan or self.decode_plan(batch)
        b = batch // self.mesh.axis_size(self.cache_batch_axes(plan))
        L, K = cfg.num_layers, cfg.ssm_conv
        return {
            "state": ((L, b, self.heads_loc, cfg.ssm_head_dim, self.N),
                      torch.float32),
            "conv_x": ((L, b, K - 1, self.d_inner // self.ctx.cols),
                       self.cdt),
            "conv_B": ((L, b, K - 1, self.N), self.cdt),
            "conv_C": ((L, b, K - 1, self.N), self.cdt),
        }

    # ------------------------------------------------------------- mixer
    @staticmethod
    def _causal_conv(x, w, halo=None):
        """Depthwise causal conv along seq, then silu.  x: [B, T, C];
        w: [K, C]; halo: the K-1 positions before this sequence shard
        [B, K-1, C] (zeros before the sequence when None)."""
        K, T = w.shape[0], x.shape[1]
        if halo is None:
            halo = x.new_zeros(x.shape[0], K - 1, x.shape[2])
        xp = torch.cat([halo, x], 1)
        y = sum(xp[:, K - 1 - j: T + K - 1 - j, :] * w[K - 1 - j]
                for j in range(K))
        return silu(y)

    def _conv_halo(self, x, ops):
        """The previous sequence shard's last K-1 rows of ``x`` (zeros on
        the first), or None off the seq-sharded plan."""
        if not ops.plan.seq_sharded:
            return None
        return col.halo_exchange_left(self.mesh, x, self.ctx.seq_shard_axes,
                                      self.cfg.ssm_conv - 1, 1)

    def _mixer(self, p, x, ops):
        """Prefill mixer.  x: [B, T_loc, h/q] -> (out [B, T_loc, h/q], this
        shard's final state [B, H_loc, P, N] float32 (the sequence's once
        the shards are chained), the pre-conv projections (xin, Bm, Cm)
        whose last K-1 rows are the decode conv's cache)."""
        cfg = self.cfg
        B, T = x.shape[:2]
        H, P_ = self.heads_loc, cfg.ssm_head_dim
        z = ops.linear(x, p["w_z"])                          # [B,T,di/q]
        xin = ops.linear(x, p["w_x"])
        Bm = ops.linear_to_replicated(x, p["w_B"])           # [B,T,N]
        Cm = ops.linear_to_replicated(x, p["w_C"])
        dt_raw = ops.linear(x, p["w_dt"])                    # [B,T,H/q]
        dt = softplus(dt_raw.float() + p["dt_bias"])
        xc = self._causal_conv(xin, p["conv_x"], self._conv_halo(xin, ops))
        Bc = self._causal_conv(Bm, p["conv_B"], self._conv_halo(Bm, ops))
        Cc = self._causal_conv(Cm, p["conv_C"], self._conv_halo(Cm, ops))
        xh = xc.reshape(B, T, H, P_)
        A = -torch.exp(p["A_log"].float())                   # [H/q]
        log_a = dt * A                                       # [B,T,H/q]
        x_dt = xh.float() * dt[..., None]
        y, h_last, a_prod = ssd_chunked(x_dt, log_a, Bc.float(), Cc.float(),
                                        cfg.ssm_chunk,
                                        use_pallas=self.run.use_pallas)
        axes = self.ctx.seq_shard_axes
        if ops.plan.seq_sharded and self.mesh.axis_size(axes) > 1:
            # chain the states across the sequence shards; the correction
            # takes the post-conv C
            h_in = col.distributed_linear_scan_carry(self.mesh, a_prod,
                                                     h_last, axes)
            y, h_last = chain_shard(y, h_last, a_prod, log_a, Cc, h_in)
        y = y + xh * p["Dskip"].to(x.dtype)[None, None, :, None]
        y = y.reshape(B, T, H * P_)
        y = ops.rmsnorm((y * silu(z)).to(x.dtype), p["ln_y"], cfg.norm_eps)
        # remat="dots" keeps no w_out output: only the residual add reads it
        return (ops.linear(y, p["w_out"], keep=False), h_last,
                (xin, Bm, Cm))

    def _mixer_decode(self, p, x, cache_l, ops):
        """Single-token state update.  x: [B, 1, h/q]; cache_l: this
        layer's {"state", "conv_x", "conv_B", "conv_C"} -> (out [B, 1,
        h/q], the layer's new cache)."""
        cfg = self.cfg
        B = x.shape[0]
        H, P_ = self.heads_loc, cfg.ssm_head_dim
        z = ops.linear(x, p["w_z"])[:, 0]
        xin = ops.linear(x, p["w_x"])[:, 0]                  # [B,di/q]
        Bm = ops.linear_to_replicated(x, p["w_B"])[:, 0]
        Cm = ops.linear_to_replicated(x, p["w_C"])[:, 0]
        dt_raw = ops.linear(x, p["w_dt"])[:, 0]
        dt = softplus(dt_raw.float() + p["dt_bias"])         # [B,H/q]

        def conv_step(cstate, new, w):
            xp = torch.cat([cstate, new[:, None, :]], dim=1)  # [B,K,C]
            y = torch.einsum("bkc,kc->bc", xp, w)
            return silu(y), xp[:, 1:, :]

        xin_c, ncx = conv_step(cache_l["conv_x"], xin, p["conv_x"])
        Bc, ncB = conv_step(cache_l["conv_B"], Bm, p["conv_B"])
        Cc, ncC = conv_step(cache_l["conv_C"], Cm, p["conv_C"])
        xh = xin_c.reshape(B, H, P_).float()
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt * A)                                # [B,H/q]
        hnew = (a[..., None, None] * cache_l["state"]
                + torch.einsum("bhp,bn->bhpn", xh * dt[..., None],
                               Bc.float()))
        y = torch.einsum("bn,bhpn->bhp", Cc.float(), hnew)
        y = y + xh * p["Dskip"].float()[:, None]
        y = y.reshape(B, H * P_).to(x.dtype)
        y = ops.rmsnorm(y * silu(z), p["ln_y"], cfg.norm_eps)
        out = ops.linear(y[:, None, :], p["w_out"])
        return out, {"state": hnew,
                     "conv_x": ncx.to(cache_l["conv_x"].dtype),
                     "conv_B": ncB.to(cache_l["conv_B"].dtype),
                     "conv_C": ncC.to(cache_l["conv_C"].dtype)}

    # -------------------------------------------------------------- train
    def _block(self, blk, x, ops):
        """One layer of the train path: x + mixer(norm(x)) on the layer's
        params cast to the compute dtype (the reference's ``_block`` on
        ``cast(bp)``)."""
        p = self._cast(blk)
        return x + self._mixer(p, self._norm(ops, x, p["ln"]), ops)[0]

    def loss(self, batch):
        """Mean next-token cross-entropy of ``batch`` = {"tokens", "labels":
        [B, S] int, optional "mask": [B, S]}, host layout, the same on every
        rank (the reference's ``MambaLM.loss``): embed, the blocks, the
        final norm and the chunked CE over the compute-dtype head,
        loss_sum / max(count, 1), the sums psum'd over data.

        What the backward keeps of each block (``run.remat``, the
        reference's ``maybe_remat``): "none", every activation autograd
        saves; "full", only the block input; "dots", the block input and
        the outputs of the products w_z, w_x, w_B, w_C and w_dt, the
        reference's ``dots_with_no_batch_dims_saveable`` set (the SSD
        einsums have batch dims and are recomputed; w_out's output, which
        only the residual add reads, is not kept), the products handed
        back in the recompute without a launch (``core/remat.py``)."""
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("train"))
        cut = ops.tokens_in_axes()
        x = ops.embed(ops.host_block(batch["tokens"], cut),
                      self.embed).to(self.cdt)
        x = run_blocks(self.blocks, x,
                       lambda blk, x: self._block(blk, x, ops),
                       self.run.remat)
        return mean_ce_loss(self, ops, self._norm(ops, x, self.ln_f), batch,
                            cut)

    # -------------------------------------------------------------- serve
    def _sample(self, ops, x):
        x = self._norm(ops, x, self.ln_f)
        return ops.head_sample(x, self.head.to(self.cdt),
                               vocab_real=self.cfg.vocab_size)

    @torch.no_grad()
    def prefill(self, tokens):
        """Process prompts tokens [B, T] (host layout, the same on every
        rank; all of length T, B over data, T over the sequence shards,
        each of which needs at least K-1 tokens).  Returns (greedy next
        ids [B, 1] int32, the same on every rank; this rank's block of the
        cache, ``cache_abstract(B, plan)`` of the prefill plan: the final
        SSM state of every layer and the last K-1 rows of each layer's
        pre-conv x, B and C projections, the batch over data)."""
        K = self.cfg.ssm_conv
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("prefill"))
        axes = self.ctx.seq_shard_axes
        shards = self.mesh.axis_size(axes)
        B, T = tokens.shape
        if T % shards or T // shards < K - 1:
            raise ValueError(
                f"prefill needs at least K-1 = {K - 1} tokens per sequence "
                f"shard for the conv cache and its halo: {T} tokens over "
                f"{shards} shards")
        if B % self.ctx.data:
            raise ValueError(f"prefill batch {B} does not split over data "
                             f"= {self.ctx.data}")
        x = ops.embed(ops.host_block(tokens, ops.tokens_in_axes()),
                      self.embed).to(self.cdt)
        states, tails = [], {"conv_x": [], "conv_B": [], "conv_C": []}
        for blk in self.blocks:
            p = self._cast(blk)
            y, h_last, pre = self._mixer(p, self._norm(ops, x, p["ln"]), ops)
            x = x + y
            states.append(h_last)
            for name, t in zip(tails, pre):
                tails[name].append(t[:, -(K - 1):, :].to(self.cdt))
        ids = self._sample(ops, ops_last_token(ops, x))
        # only the last sequence shard holds the true final states and tails
        cache = {"state": torch.stack(states)}
        cache.update({k: torch.stack(v) for k, v in tails.items()})
        cache = {k: col.last_shard_value(self.mesh, v, axes)
                 for k, v in cache.items()}
        return ids[:, None], cache

    @torch.no_grad()
    def decode(self, cache, ids, pos=None):
        """One greedy step for every sequence: ids [B, 1] (host layout, the
        same on every rank) -> (next ids [B, 1] int32, the same on every
        rank; the new cache).  ``cache`` is this rank's block under
        ``decode_plan(B)`` (``runtime/serve_steps.py`` reshards a prefill
        cache to it).  ``pos`` is unused, as in the reference (the state
        carries the position)."""
        ops = make_ops(self.ctx, self.mesh, self.decode_plan(ids.shape[0]))
        want = self.cache_abstract(ids.shape[0], ops.plan)["state"][0]
        if tuple(cache["state"].shape) != want:
            raise ValueError(
                f"decode: cache state {tuple(cache['state'].shape)} is not "
                f"this rank's block {want} of the {ops.plan.kind} layout")
        x = ops.embed(ops.host_block(ids, ops.tokens_in_axes()),
                      self.embed).to(self.cdt)
        new = {k: [] for k in cache}
        for i, blk in enumerate(self.blocks):
            p = self._cast(blk)
            y, nc = self._mixer_decode(p, self._norm(ops, x, p["ln"]),
                                       {k: v[i] for k, v in cache.items()},
                                       ops)
            x = x + y
            for k in new:
                new[k].append(nc[k])
        ids = self._sample(ops, x)
        return ids[:, None], {k: torch.stack(v) for k, v in new.items()}
