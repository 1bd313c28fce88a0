"""Mamba2 (SSD, state-space duality) LM: PyTorch port of
``repro.models.ssm``, the serve path at the one-device layout.

The SSD state recurrence is chunked: within a chunk of Q tokens the output
is a masked Q x Q product (``kernels/ssd.py``: the Hopper kernel when
``RunConfig.use_pallas``, else its plain version, beside which ``segsum``
lives), and the chunk-end states are chained across chunks by a linear
scan (a Python loop over chunks in place of ``lax.scan``).  B and C have
one group, shared by all heads.

Serving entry points, both without autograd: ``prefill(tokens)`` gives the
greedy next ids and the cache (per-layer SSM states and the causal conv's
tails), and ``decode(cache, ids, pos)`` advances every sequence by one
token through the state recurrence.  ``MambaLM`` has no paged decode path,
so ``InferenceEngine`` refuses it (the reference's guard); it is served by
these static steps, as the reference's ``build_prefill_step`` /
``build_decode_step`` serve it.

At one device the reference's sequence-sharded prefill branches are the
identity: the halo of the causal conv is zeros, the state entering the
single shard is zero, and the last shard's state is this shard's.  The
port keeps the local math only: across ranks ``MambaLM`` raises (ROADMAP
Queue A: the ssm family across ranks).  Not ported yet (ROADMAP Queue A,
item A3): ``loss`` and ssm training.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, RunConfig, round_up
from ..core.api import ParallelContext
from ..core.mesh import Mesh
from ..core.ops import Plan, make_ops, ops_last_token
from ..kernels.ssd import ssd_intra, ssd_intra_plain
from .transformer import WINIT_SCALE, _param

CONV_INIT_SCALE = 0.2    # reference: winit(..., 0.2) for conv_x/B/C


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def silu(x):
    """jax.nn.silu: x * 1 / (1 + exp(-x)), each step rounded to x's dtype
    (F.silu rounds once, which differs from it in bf16)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ssd_chunked(x, log_a, Bm, Cm, chunk: int, use_pallas: bool = False):
    """SSD scan.  x: [B, T, H, P]; log_a: [B, T, H]; Bm/Cm: [B, T, N].
    Returns (y [B, T, H, P] in x's dtype, h_last [B, H, P, N] float32).

    The chunk shrinks to divide T, as the reference's does (T = 1000 gives
    Q = 250).  The reference's third output, the shard's decay product for
    the cross-device chain, comes back with that chain (ROADMAP A1)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    nc = T // Q
    xr = x.reshape(Bsz, nc, Q, H, P)
    lar = log_a.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N)
    Cr = Cm.reshape(Bsz, nc, Q, N)
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
    return y.to(x.dtype), h


class MambaBlock(nn.Module):
    """One layer's parameters, named as the reference's ``blocks`` dict."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        h, N, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
        di = cfg.ssm_expand * h
        H = di // cfg.ssm_head_dim
        P = lambda *shape: _param(shape, dtype, device)
        self.ln = P(h)
        self.w_z, self.w_x = P(h, di), P(h, di)
        self.w_B, self.w_C = P(h, N), P(h, N)
        self.w_dt = P(h, H)
        self.dt_bias, self.A_log, self.Dskip = P(H), P(H), P(H)
        self.conv_x, self.conv_B, self.conv_C = P(K, di), P(K, N), P(K, N)
        self.ln_y = P(di)
        self.w_out = P(di, h)


class MambaLM(nn.Module):
    """Mamba2 LM on one device: embed, ``num_layers`` SSD blocks, the final
    rmsnorm and an untied head."""

    def __init__(self, cfg: ModelConfig, ctx: ParallelContext, run: RunConfig,
                 *, device: torch.device, generator: torch.Generator,
                 mesh: Mesh | None = None):
        super().__init__()
        if ctx.size > 1 or ctx.mode == "megatron1d":
            raise NotImplementedError(
                "MambaLM runs at one rank on the Tesseract op set (ROADMAP "
                "Queue A, item A1: the ssm family across ranks, with the "
                "seq-sharded prefill branches)")
        self.mesh = mesh if mesh is not None else Mesh(ctx)
        self.cfg, self.ctx, self.run = cfg, ctx, run
        self.device = device
        probe = make_ops(self.ctx, self.mesh, Plan.for_shape("train"))
        self.v_pad = round_up(cfg.vocab_size, probe.vocab_pad_multiple())
        self.pdt = getattr(torch, run.param_dtype)
        self.cdt = getattr(torch, run.compute_dtype)
        self.d_inner = cfg.ssm_expand * cfg.d_model
        self.n_heads = self.d_inner // cfg.ssm_head_dim
        self.N = cfg.ssm_state
        h = cfg.d_model
        self.embed = _param((self.v_pad, h), self.pdt, device)
        self.head = _param((self.v_pad, h), self.pdt, device)
        self.ln_f = _param((h,), self.pdt, device)
        self.blocks = nn.ModuleList(MambaBlock(cfg, self.pdt, device)
                                    for _ in range(cfg.num_layers))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init scales: matrices N(0, 0.02), conv weights
        N(0, 0.2), norm scales, dt_bias and A_log zero, Dskip one."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "Dskip":
                p.fill_(1.0)
            elif p.ndim == 1:
                p.zero_()
            elif leaf.startswith("conv_"):
                p.normal_(0.0, CONV_INIT_SCALE, generator=generator)
            else:
                p.normal_(0.0, WINIT_SCALE, generator=generator)

    # ------------------------------------------------------------ helpers
    def _cast(self, blk):
        """A layer's params in the compute dtype.  Unlike the dense path,
        the reference casts every leaf in the param dtype, vectors (norm
        scales, dt_bias, A_log, Dskip) included."""
        return {n: (p.to(self.cdt) if p.dtype == self.pdt else p)
                for n, p in blk.named_parameters()}

    def _norm(self, ops, x, scale):
        return ops.rmsnorm(x, scale, self.cfg.norm_eps)

    def cache_abstract(self, batch: int):
        """(shape, dtype) of each cache leaf: "state" [L, B, H, P, N] float32
        and the conv tails "conv_x" [L, B, K-1, d_inner], "conv_B" /
        "conv_C" [L, B, K-1, N] in the compute dtype."""
        cfg = self.cfg
        L, K = cfg.num_layers, cfg.ssm_conv
        return {
            "state": ((L, batch, self.n_heads, cfg.ssm_head_dim, self.N),
                      torch.float32),
            "conv_x": ((L, batch, K - 1, self.d_inner), self.cdt),
            "conv_B": ((L, batch, K - 1, self.N), self.cdt),
            "conv_C": ((L, batch, K - 1, self.N), self.cdt),
        }

    # ------------------------------------------------------------- mixer
    @staticmethod
    def _causal_conv(x, w):
        """Depthwise causal conv along seq, then silu.  x: [B, T, C];
        w: [K, C]; the K-1 positions before the sequence are zeros."""
        K, T = w.shape[0], x.shape[1]
        xp = torch.cat([x.new_zeros(x.shape[0], K - 1, x.shape[2]), x], 1)
        y = sum(xp[:, K - 1 - j: T + K - 1 - j, :] * w[K - 1 - j]
                for j in range(K))
        return silu(y)

    def _mixer(self, p, x, ops):
        """Prefill mixer.  x: [B, T, h] -> (out [B, T, h], final state
        [B, H, P, N] float32, the pre-conv projections (xin, Bm, Cm) whose
        last K-1 rows are the decode conv's cache)."""
        cfg = self.cfg
        B, T = x.shape[:2]
        H, P_ = self.n_heads, cfg.ssm_head_dim
        z = ops.linear(x, p["w_z"])                          # [B,T,di]
        xin = ops.linear(x, p["w_x"])
        Bm = ops.linear_to_replicated(x, p["w_B"])           # [B,T,N]
        Cm = ops.linear_to_replicated(x, p["w_C"])
        dt_raw = ops.linear(x, p["w_dt"])                    # [B,T,H]
        dt = softplus(dt_raw.float() + p["dt_bias"])
        xc = self._causal_conv(xin, p["conv_x"])
        Bc = self._causal_conv(Bm, p["conv_B"])
        Cc = self._causal_conv(Cm, p["conv_C"])
        xh = xc.reshape(B, T, H, P_)
        A = -torch.exp(p["A_log"].float())                   # [H]
        log_a = dt * A                                       # [B,T,H]
        x_dt = xh.float() * dt[..., None]
        y, h_last = ssd_chunked(x_dt, log_a, Bc.float(), Cc.float(),
                                cfg.ssm_chunk, use_pallas=self.run.use_pallas)
        y = y + xh * p["Dskip"].to(x.dtype)[None, None, :, None]
        y = y.reshape(B, T, H * P_)
        y = ops.rmsnorm((y * silu(z)).to(x.dtype), p["ln_y"], cfg.norm_eps)
        return ops.linear(y, p["w_out"]), h_last, (xin, Bm, Cm)

    def _mixer_decode(self, p, x, cache_l, ops):
        """Single-token state update.  x: [B, 1, h]; cache_l: this layer's
        {"state", "conv_x", "conv_B", "conv_C"} -> (out [B, 1, h], the
        layer's new cache)."""
        cfg = self.cfg
        B = x.shape[0]
        H, P_ = self.n_heads, cfg.ssm_head_dim
        z = ops.linear(x, p["w_z"])[:, 0]
        xin = ops.linear(x, p["w_x"])[:, 0]                  # [B,di]
        Bm = ops.linear_to_replicated(x, p["w_B"])[:, 0]
        Cm = ops.linear_to_replicated(x, p["w_C"])[:, 0]
        dt_raw = ops.linear(x, p["w_dt"])[:, 0]
        dt = softplus(dt_raw.float() + p["dt_bias"])         # [B,H]

        def conv_step(cstate, new, w):
            xp = torch.cat([cstate, new[:, None, :]], dim=1)  # [B,K,C]
            y = torch.einsum("bkc,kc->bc", xp, w)
            return silu(y), xp[:, 1:, :]

        xin_c, ncx = conv_step(cache_l["conv_x"], xin, p["conv_x"])
        Bc, ncB = conv_step(cache_l["conv_B"], Bm, p["conv_B"])
        Cc, ncC = conv_step(cache_l["conv_C"], Cm, p["conv_C"])
        xh = xin_c.reshape(B, H, P_).float()
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt * A)                                # [B,H]
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

    # -------------------------------------------------------------- steps
    def _sample(self, ops, x):
        x = self._norm(ops, x, self.ln_f)
        return ops.head_sample(x, self.head.to(self.cdt),
                               vocab_real=self.cfg.vocab_size)

    @torch.no_grad()
    def prefill(self, tokens):
        """Process prompts tokens [B, T] (T >= K-1, all of length T).
        Returns (greedy next ids [B, 1] int32, cache as ``cache_abstract``:
        the final SSM state of every layer and the last K-1 rows of each
        layer's pre-conv x, B and C projections)."""
        K = self.cfg.ssm_conv
        if tokens.shape[1] < K - 1:
            raise ValueError(f"prefill needs at least K-1 = {K - 1} tokens "
                             f"for the conv cache, got {tokens.shape[1]}")
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("prefill"))
        x = ops.embed(tokens, self.embed).to(self.cdt)
        states, tails = [], {"conv_x": [], "conv_B": [], "conv_C": []}
        for blk in self.blocks:
            p = self._cast(blk)
            y, h_last, pre = self._mixer(p, self._norm(ops, x, p["ln"]), ops)
            x = x + y
            states.append(h_last)
            for name, t in zip(tails, pre):
                tails[name].append(t[:, -(K - 1):, :].to(self.cdt))
        ids = self._sample(ops, ops_last_token(ops, x))
        cache = {"state": torch.stack(states)}
        cache.update({k: torch.stack(v) for k, v in tails.items()})
        return ids[:, None], cache

    @torch.no_grad()
    def decode(self, cache, ids, pos=None):
        """One greedy step for every sequence: ids [B, 1] -> (next ids
        [B, 1] int32, the new cache).  ``pos`` is unused, as in the
        reference (the state carries the position)."""
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("decode"))
        x = ops.embed(ids, self.embed).to(self.cdt)
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
