"""Dense decoder-only LM (llama/yi/smollm/nemotron family): PyTorch port of
``repro.models.transformer.DenseLM``, serving and training paths.

Covers GQA (KV heads sharded over col, or replicated when
``num_kv_heads % q != 0``), GLU / squared-ReLU MLPs, rmsnorm/layernorm,
RoPE and head padding when ``num_heads % q != 0``, on either op set
(``core/ops.py``: Tesseract, or Megatron's 1-D baseline with its
sequence-parallel prefill).  The parameters are one rank's local blocks of
the reference's global tree, cut by the reference's partition specs of
the op set (``dense_param_specs``); weights keep the reference's
[in, out] layout (``x @ w``), so params carried over from the JAX package
load by slicing alone (convert.py).  The layer stack is a Python loop over
``blocks`` in place of ``lax.scan``.

Serving entry points, without autograd, each taking the host-layout inputs
every rank of the mesh passes alike: ``prefill`` (bucketed, right-padded
prompts with true ``lengths``; the sequence sharded over the op set's
sequence axes, ``ctx.seq_shard_axes``), ``decode_paged`` (one token per
slot against the rank's KV group's partition of the paged pool, updated
in place), and ``prefill_chunk_paged`` / ``verify_chunk_paged`` (C
positions per slot written into the pool and attended there: chunked
prefill, the prefix cache and speculative verify).  Training entry point,
on one rank or across the mesh: ``loss`` (the mean next-token
cross-entropy of a batch, differentiable in every local parameter; the
step syncs the gradients of replicated leaves, ``runtime/steps.py``).  The
dense static decode loop (the reference's ``build_prefill_step`` /
``build_decode_step`` path, ``runtime/serve_steps.py``): ``prefill``
without ``lengths`` (greedy next ids and the cache, the batch over data)
and ``decode`` (one greedy step for every sequence against a dense cache
[L, b, S, Hkv_loc, D], written in place), whose attention views the cache
as a contiguous page pool and runs the paged decode kernel (#6) on it.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, RunConfig, round_up
from ..core import collectives as col
from ..core import remat
from ..core.api import ParallelContext
from ..core.mesh import Mesh, local_block
from ..core.ops import Plan, kv_group_axes, make_ops, ops_last_token
from . import common as cm

WINIT_SCALE = 0.02     # reference common.winit


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def dense_param_specs(cfg: ModelConfig, ctx: ParallelContext):
    """The reference's ``DenseLM.specs`` (``repro/models/transformer.py:
    103-137``) under the op set of ``ctx`` (``TesseractOps``,
    ``repro/core/ops.py:86-125``, or ``MegatronOps``, ``:461-494``) as a
    table: (top-level params, per-layer params), each {name: (logical
    shape, padded global shape, per-dim mesh axes)}, in the modules'
    registration order.  A dim's axes split it lexicographically, first
    axis outermost; padded rows (vocab, q heads) are zeros, as the
    reference's ``winit_padded`` leaves them."""
    h, ff, kv = cfg.d_model, cfg.d_ff, cfg.num_kv_heads
    H, D = cfg.num_heads, cfg.resolved_head_dim
    Hp = round_up(H, ctx.cols)
    v_pad = round_up(cfg.vocab_size,
                     make_ops(ctx, None, Plan()).vocab_pad_multiple())
    kv_shard = kv % ctx.cols == 0
    if ctx.mode == "megatron1d":
        up = ((), ("col",))                       # spec_w2d: out over col
        down = (("col",), ())                     # spec_w_down: in over col
        vec = (("col",),)                         # spec_bias_up
        norm = ((),)                              # spec_norm, spec_bias_down
        kv_rep = ((), ())                         # spec_w_to_replicated
        embed = head = (("col",), ())             # spec_embed, spec_head
    else:
        up = down = (("row",), ("col",))          # spec_w2d
        vec = norm = (("col",),)                  # spec_vec / spec_norm
        kv_rep = (("col",), ())                   # spec_w_to_replicated
        embed, head = up, (("depth", "row", "col"), ())
    kv_w = up if kv_shard else kv_rep
    kv_b = vec if kv_shard else ((),)             # spec_vec_replicated

    def same(shape, spec):
        return (shape, shape, spec)

    top = {"embed": ((cfg.vocab_size, h), (v_pad, h), embed),
           "head": ((cfg.vocab_size, h), (v_pad, h), head),
           "ln_f": same((h,), norm)}
    if cfg.norm == "layernorm":
        top["ln_fb"] = same((h,), norm)
    block = {"ln1": same((h,), norm), "ln2": same((h,), norm),
             "wq": ((h, H * D), (h, Hp * D), up),
             "wk": same((h, kv * D), kv_w), "wv": same((h, kv * D), kv_w),
             "wo": ((H * D, h), (Hp * D, h), down),
             "w_down": same((ff, h), down), "w_up": same((h, ff), up)}
    if cfg.mlp_glu:
        block["w_gate"] = same((h, ff), up)
    if cfg.use_bias:
        block.update(bq=((H * D,), (Hp * D,), vec), bv=same((kv * D,), kv_b),
                     bo=same((h,), norm), b_up=same((ff,), vec),
                     b_down=same((h,), norm))
    if cfg.norm == "layernorm":
        block.update(ln1b=same((h,), norm), ln2b=same((h,), norm))
    return top, block


def local_shape(shape, spec, mesh: Mesh):
    return tuple(n // (mesh.axis_size(a) if a else 1)
                 for n, a in zip(shape, spec))


class Block(nn.Module):
    """One layer's local params, named as the reference's ``blocks``."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, dtype, device))


def alloc_local_params(model: nn.Module, cfg: ModelConfig,
                       ctx: ParallelContext, mesh: Mesh | None, param_specs,
                       dtype, device):
    """Sets ``model.mesh`` (``mesh``, or a new one of ``ctx``; it must fit
    ``ctx``'s layout), ``top_specs``, ``block_specs`` and ``v_pad``, and
    registers uninitialised local blocks of the spec table
    ``param_specs(cfg, ctx)`` (top-level params, then ``cfg.num_layers``
    ``Block``s)."""
    model.mesh = mesh if mesh is not None else Mesh(ctx)
    if not model.mesh.fits(ctx):
        raise ValueError(f"mesh {model.mesh.sizes} does not match the "
                         f"context's layout")
    model.top_specs, model.block_specs = param_specs(cfg, ctx)
    model.v_pad = model.top_specs["head"][1][0]
    for name, (_, shape, spec) in model.top_specs.items():
        setattr(model, name, _param(local_shape(shape, spec, model.mesh),
                                    dtype, device))
    shapes = {n: local_shape(s, sp, model.mesh)
              for n, (_, s, sp) in model.block_specs.items()}
    model.blocks = nn.ModuleList(Block(shapes, dtype, device)
                                 for _ in range(cfg.num_layers))


@torch.no_grad()
def draw_local_params(model: nn.Module, generator: torch.Generator, rule):
    """Initialises the blocks ``alloc_local_params`` registered: for each
    leaf in registration order ``rule(name, p)`` either sets the vector
    ``p`` in place and returns None, or returns the std of a matrix's
    N(0, std) draw.  Every rank draws every global matrix at its logical
    shape in the same order, zero-pads it to the padded shape (vocab
    rows, q heads) and keeps its block, so every layout of the mesh holds
    blocks of the same global weights."""
    items = [(n, p, model.top_specs[n])
             for n, p in model.named_parameters(recurse=False)]
    for blk in model.blocks:
        items += [(n, p, model.block_specs[n])
                  for n, p in blk.named_parameters()]
    for name, p, (logical, padded, spec) in items:
        std = rule(name, p)
        if std is None:
            continue
        w = torch.empty(logical, dtype=p.dtype, device=p.device)
        w.normal_(0.0, std, generator=generator)
        if logical != padded:
            w = torch.nn.functional.pad(w, [
                x for lg, pd in zip(reversed(logical), reversed(padded))
                for x in (0, pd - lg)])
        p.copy_(local_block(w, spec, model.mesh.sizes, model.mesh.coords))


class DenseLM(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: ParallelContext, run: RunConfig,
                 *, device: torch.device, generator: torch.Generator,
                 mesh: Mesh | None = None):
        super().__init__()
        self.cfg, self.ctx, self.run = cfg, ctx, run
        self.device = device
        q = ctx.cols
        self.Hp = round_up(cfg.num_heads, q)
        self.kv_shard = cfg.num_kv_heads % q == 0
        self.D = cfg.resolved_head_dim
        self.Hq_loc = self.Hp // q
        self.Hkv_loc = (cfg.num_kv_heads // q if self.kv_shard
                        else cfg.num_kv_heads)
        self.pdt = getattr(torch, run.param_dtype)
        self.cdt = getattr(torch, run.compute_dtype)
        alloc_local_params(self, cfg, ctx, mesh, dense_param_specs, self.pdt,
                           device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """The reference's init scales: weights N(0, 0.02), biases zero,
        norm scales zero for rmsnorm's (1 + scale) and one for layernorm
        (``draw_local_params``)."""
        layernorm = self.cfg.norm == "layernorm"

        def rule(name, p):
            if name in ("ln1", "ln2", "ln_f"):
                p.fill_(1.0 if layernorm else 0.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                return WINIT_SCALE
            return None

        draw_local_params(self, generator, rule)

    # ------------------------------------------------------------ helpers
    def _w(self, p):
        """Matrices in param dtype are cast to the compute dtype per call,
        as the reference does; vectors (norms, biases) are not."""
        return p.to(self.cdt) if p is not None and p.ndim > 1 else p

    def _norm(self, ops, x, scale, bias=None):
        if self.cfg.norm == "layernorm":
            return ops.layernorm(x, scale, bias, self.cfg.norm_eps)
        return ops.rmsnorm(x, scale, self.cfg.norm_eps)

    def _global_heads(self, device):
        """[Hq_loc] global indices of this rank's q heads (col block)."""
        return (self.mesh.coords["col"] * self.Hq_loc
                + torch.arange(self.Hq_loc, device=device))

    def _head_mask(self, device):
        """[Hq_loc] 1 for real heads, 0 for padded (smollm 15 -> 16)."""
        if self.Hp == self.cfg.num_heads:
            return None
        return (self._global_heads(device) < self.cfg.num_heads).to(self.cdt)

    def _kv_map(self, device):
        """[Hq_loc] int32 q head -> kv head of the local K/V: contiguous GQA
        over the sharded KV heads, or the global q head's kv head when the
        KV heads are replicated."""
        if self.kv_shard:
            return cm.contiguous_kv_map(self.Hq_loc, self.Hkv_loc, device)
        cfg = self.cfg
        group = max(1, cfg.num_heads // cfg.num_kv_heads)
        return torch.clamp(self._global_heads(device) // group,
                           max=cfg.num_kv_heads - 1).to(torch.int32)

    def _qkv(self, blk, x, ops, positions):
        """Project and rope. Returns q [B,T,Hq_loc,D], k/v [B,T,Hkv_loc,D]."""
        cfg, D = self.cfg, self.D
        B, T = x.shape[:2]
        q = ops.linear_up(x, self._w(blk.wq), getattr(blk, "bq", None))
        kv_op = ops.linear_up if self.kv_shard else ops.linear_to_replicated
        k = kv_op(x, self._w(blk.wk))
        v = kv_op(x, self._w(blk.wv), getattr(blk, "bv", None))
        q = q.reshape(B, T, self.Hq_loc, D)
        k = k.reshape(B, T, self.Hkv_loc, D)
        v = v.reshape(B, T, self.Hkv_loc, D)
        if cfg.use_rope:
            q = cm.apply_rope(q, positions, cfg.rope_theta)
            k = cm.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_out(self, blk, out, ops):
        B, T = out.shape[:2]
        mask = self._head_mask(out.device)
        if mask is not None:
            out = out * mask[None, None, :, None]
        out = out.reshape(B, T, self.Hq_loc * self.D)
        return ops.linear_down(out, self._w(blk.wo), getattr(blk, "bo", None))

    def _mlp(self, blk, x, ops):
        cfg = self.cfg
        x = ops.seq_gather_in(x)
        act = cm.mlp_act(cfg.mlp_act)
        b_up = getattr(blk, "b_up", None)
        if cfg.mlp_glu:
            g = ops.linear_up(x, self._w(blk.w_gate))
            u = ops.linear_up(x, self._w(blk.w_up), b_up)
            h = act(g) * u
        else:
            h = act(ops.linear_up(x, self._w(blk.w_up), b_up))
        # remat="dots" does not keep the down projection: only the residual
        # add reads it, and its backward reads no operand
        return ops.linear_down(h, self._w(blk.w_down),
                               getattr(blk, "b_down", None), keep=False)

    def _final(self, ops, x):
        return self._norm(ops, x, self.ln_f, getattr(self, "ln_fb", None))

    def _logits(self, ops, x, **kw):
        return ops.head_logits(x, self._w(self.head),
                               vocab_real=self.cfg.vocab_size, **kw)

    # ------------------------------------------------- prefill and train
    def _block(self, blk, x, ops):
        """Attention + MLP sublayers (residuals included); also returns this
        layer's full-sequence K/V for the cache."""
        h = self._norm(ops, x, blk.ln1, getattr(blk, "ln1b", None))
        # Megatron-SP projects the sequence gathered over col
        h = ops.seq_gather_in(h)
        qpos = ops.positions_q(h.shape[1], device=h.device)
        q, k, v = self._qkv(blk, h, ops, qpos)
        # seq-sharded Tesseract plans gather K/V to full length (positions
        # 0..S-1); Megatron's are full-length already
        kf, vf = ops.kv_full(k, axis=1), ops.kv_full(v, axis=1)
        ka, va = kf, vf
        if not self.kv_shard:
            kv_map = self._kv_map(x.device).long()
            ka, va = kf[:, :, kv_map], vf[:, :, kv_map]
        # the Tesseract prefill plan is seq-sharded, so, as in the
        # reference, no static q offset: the flash kernel walks every KV
        # tile under the causal mask of the q rows' positions.  The train
        # plan and every Megatron plan (whose q rows are the whole
        # sequence) take q_start = 0, which turns the kernels' causal tile
        # skipping on.
        q_start = (0 if not ops.plan.seq_sharded
                   or ops.mode_family == "megatron" else None)
        out = cm.attention(q, ka, va, q_pos=qpos, causal=True,
                           local_window=self.cfg.local_window,
                           impl=self.ctx.attn_impl, q_start=q_start)
        x = x + self._attn_out(blk, out, ops)
        h2 = self._norm(ops, x, blk.ln2, getattr(blk, "ln2b", None))
        x = x + self._mlp(blk, h2, ops)
        return x, (kf.to(self.cdt), vf.to(self.cdt))

    @torch.no_grad()
    def prefill(self, tokens, lengths=None):
        """Process right-padded prompts tokens [B, S] with true ``lengths``
        [B] (host layout, the same on every rank; B over data, S over the
        sequence axes).  Returns (full-vocab logits [B, v_pad] float32 at
        each request's last position, the same on every rank; cache {"k",
        "v": [L, B, S, Hkv_loc, D]}, every request's full-sequence K/V of
        this rank's KV heads).

        Without ``lengths`` (the static serve steps: prompts of one length
        S) it returns (greedy next ids [B, 1] int32 at the last column, the
        same on every rank; this rank's block of the cache,
        ``cache_abstract(B, S, prefill plan)``: the batch over data)."""
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("prefill"))
        ids = ops.host_block(tokens, ops.tokens_in_axes())
        x = ops.embed(ids, self.embed).to(self.cdt)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = self._block(blk, x, ops)
            ks.append(k)
            vs.append(v)
        x = self._final(ops, x)
        if lengths is None:
            ids = ops.head_sample(ops_last_token(ops, x), self._w(self.head),
                                  vocab_real=self.cfg.vocab_size)
            return ids[:, None], {"k": torch.stack(ks), "v": torch.stack(vs)}
        lens = ops.host_block(lengths, (("data",),))
        # every rank gets every request's K/V: a request's blocks may live
        # in a KV group of another data coordinate
        cache = {name: col.all_gather_cat(self.mesh, torch.stack(t), "data",
                                          axis=1)
                 for name, t in (("k", ks), ("v", vs))}
        return (self._logits(ops, last_token_at(ops, x, lens),
                             tokens_sharded=False), cache)

    def loss(self, batch):
        """Mean next-token cross-entropy of ``batch`` = {"tokens", "labels":
        [B, S] int, optional "mask": [B, S]}, host layout, the same on every
        rank: embed, the blocks at positions 0..S-1, the final norm and the
        chunked CE over the compute-dtype head, loss_sum / max(count, 1).

        What the backward keeps of each block (``run.remat``, the
        reference's ``maybe_remat``): "none", every activation autograd
        saves; "full", only the block input, the whole block recomputed
        in the backward (``torch.utils.checkpoint``); "dots", the block
        input and the outputs of its products but the last (q, k, v, the
        attention output projection, gate and up: seven tensors per layer,
        six without a GLU, the reference's
        ``dots_with_no_batch_dims_saveable`` set), the norms, rope,
        attention (kernel #3 runs again) and activations recomputed and the
        products handed back without a launch (``core/remat.py``).  Across
        ranks each rank cuts its (data, depth) block of the batch (the
        reference's ``spec_tokens_in``; embed and the loss apply the row
        factor) and the sums are psum'd over data, so the loss is the same
        on every rank."""
        ops = make_ops(self.ctx, self.mesh, Plan.for_shape("train"))
        cut = ops.tokens_in_axes()
        x = ops.embed(ops.host_block(batch["tokens"], cut),
                      self.embed).to(self.cdt)
        x = run_blocks(self.blocks, x,
                       lambda blk, x: self._block(blk, x, ops)[0],
                       self.run.remat)
        return mean_ce_loss(self, ops, self._final(ops, x), batch, cut)

    def tess_weight_names(self) -> set:
        """Names of the block params that flow only through
        ``tesseract_matmul``, whose dW the op reduces over (data, depth)
        when ``reduce_dgrad_in_op`` (the reference's
        ``tess_weight_names``): none in Megatron."""
        if self.ctx.mode == "megatron1d":
            return set()
        names = {"wq", "wo", "w_up", "w_down"}
        if self.cfg.mlp_glu:
            names.add("w_gate")
        if self.kv_shard:
            names.update({"wk", "wv"})
        return names

    # ------------------------------------------------------------- decode
    def paged_cache_shape(self, num_blocks: int, block_size: int):
        """Shape and dtype of this rank's "k" and "v" pool tensors,
        [L, num_blocks, bs, Hkv_loc, D] in the compute dtype, for a KV
        group's partition of ``num_blocks`` blocks."""
        return ((self.cfg.num_layers, num_blocks, block_size, self.Hkv_loc,
                 self.D), self.cdt)

    def decode_plan(self, n_slots: int) -> Plan:
        return Plan.for_shape("decode", global_batch=n_slots,
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

    def cache_abstract(self, batch: int, seq_len: int,
                       plan: Plan | None = None):
        """(shape, dtype) of this rank's block of each cache leaf for a
        global ``batch`` of ``seq_len`` positions under ``plan`` (default
        ``decode_plan(batch)``): "k" and "v" [L, b, seq_len, Hkv_loc, D] in
        the compute dtype, b the batch over ``cache_batch_axes``."""
        plan = plan or self.decode_plan(batch)
        b = batch // self.mesh.axis_size(self.cache_batch_axes(plan))
        shape = (self.cfg.num_layers, b, seq_len, self.Hkv_loc, self.D)
        return {"k": (shape, self.cdt), "v": (shape, self.cdt)}

    def _block_decode(self, blk, x, cache_l, pos, view, ops, kv_map):
        h = self._norm(ops, x, blk.ln1, getattr(blk, "ln1b", None))
        q, k, v = self._qkv(blk, h, ops, view[2][:1])
        cm.cache_update(cache_l, k, v, pos)
        out = cm.decode_attention(q[:, 0], cache_l["k"], cache_l["v"], view,
                                  kv_map=kv_map,
                                  local_window=self.cfg.local_window,
                                  impl=self.ctx.attn_impl)
        x = x + self._attn_out(blk, out[:, None], ops)
        h2 = self._norm(ops, x, blk.ln2, getattr(blk, "ln2b", None))
        return x + self._mlp(blk, h2, ops)

    @torch.no_grad()
    def decode(self, cache, ids, pos):
        """One greedy step for every sequence: ids [B, 1] (host layout, the
        same on every rank) at position ``pos`` (an int, the same for every
        sequence) -> (next ids [B, 1] int32, the same on every rank; the
        cache).  ``cache`` is this rank's block under ``decode_plan(B)``
        (``runtime/serve_steps.py`` moves a prefill cache there); each
        layer writes its K/V at ``pos`` in place."""
        ops = make_ops(self.ctx, self.mesh, self.decode_plan(ids.shape[0]))
        S = cache["k"].shape[2]
        want = self.cache_abstract(ids.shape[0], S, ops.plan)["k"][0]
        if tuple(cache["k"].shape) != want:
            raise ValueError(
                f"decode: cache {tuple(cache['k'].shape)} is not this "
                f"rank's block {want} of the {ops.plan.kind} layout")
        pos = int(pos)
        if not 0 <= pos < S:
            raise ValueError(f"decode: position {pos} outside the cache's "
                             f"{S} positions")
        x = ops.embed(ops.host_block(ids, ops.tokens_in_axes()),
                      self.embed).to(self.cdt)
        # position-only work, shared by every layer
        view = cm.dense_view(x.shape[0], S, pos, x.device)
        kv_map = self._kv_map(x.device)
        for i, blk in enumerate(self.blocks):
            cache_l = {"k": cache["k"][i], "v": cache["v"][i]}
            x = self._block_decode(blk, x, cache_l, pos, view, ops, kv_map)
        ids = ops.head_sample(self._final(ops, x), self._w(self.head),
                              vocab_real=self.cfg.vocab_size)
        return ids[:, None], cache

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

        Host layout, the same on every rank: table [n_slots, nb] int32
        GLOBAL block ids (each slot's entries in its own KV group's
        partition), ids [n_slots, 1] input tokens, pos [n_slots] int32
        positions.  pool: this rank's partition {"k", "v": [L, P_loc, bs,
        Hkv_loc, D]}, updated in place with the new K/V of its group's
        slots.  Returns full-vocab logits [n_slots, v_pad] float32, the
        same on every rank."""
        ops = make_ops(self.ctx, self.mesh, self.decode_plan(ids.shape[0]))
        gaxes = kv_group_axes(self.ctx, ops.plan)
        # the group's slots, with its partition's offset subtracted (the
        # reference's build_paged_decode_step)
        table = (ops.host_block(table, (gaxes, ()))
                 - self.mesh.index(gaxes) * pool["k"].shape[1])
        pos = ops.host_block(pos, (gaxes,))
        x = ops.embed(ops.host_block(ids, ops.tokens_in_axes()),
                      self.embed).to(self.cdt)
        # position-only work, shared by every layer
        idx = cm.paged_step_indices(table, pos, pool["k"].shape[2])
        kv_map = self._kv_map(x.device)
        for i, blk in enumerate(self.blocks):
            pool_l = {"k": pool["k"][i], "v": pool["v"][i]}
            x = self._block_decode_paged(blk, x, pool_l, table, pos, ops,
                                         idx=idx, kv_map=kv_map)
        return self._logits(ops, self._final(ops, x))

    def _block_chunk_paged(self, blk, x, pool_l, table, ops, *, positions,
                           idx, mask, kv_map):
        """Chunk analogue of ``_block_decode_paged``: write C new positions
        per slot into the pool, then attend the whole chunk against the
        slot's pages (update, then attend: a copy-on-write donor's stale
        tail is overwritten before it could be read, and the causal mask
        hides what the chunk did not reach)."""
        h = self._norm(ops, x, blk.ln1, getattr(blk, "ln1b", None))
        q, k, v = self._qkv(blk, h, ops, positions)
        cm.paged_update_chunk(pool_l, k, v, idx)
        kg, vg = cm.paged_gather(pool_l["k"], pool_l["v"], table, kv_map)
        out = cm.chunk_attention(q, kg, vg, mask=mask)
        del kg, vg
        x = x + self._attn_out(blk, out, ops)
        h2 = self._norm(ops, x, blk.ln2, getattr(blk, "ln2b", None))
        return x + self._mlp(blk, h2, ops)

    def _chunk_trunk(self, pool, table, ids, pos, lens):
        """The trunk of ``prefill_chunk_paged`` and ``verify_chunk_paged``:
        up to C positions per slot through every layer, their K/V written
        into the pool.  Returns (the op set, final-normed hidden states
        [B_loc, C, h_loc], this rank's lens).  The attention is
        ``chunk_attention`` on every device, as the reference's chunk
        trunk is its fp32 jnp path at any ``attn_impl``; the projections
        run kernel #1 (#2 on the ring)."""
        ops = make_ops(self.ctx, self.mesh, self.decode_plan(ids.shape[0]))
        gaxes = kv_group_axes(self.ctx, ops.plan)
        table = (ops.host_block(table, (gaxes, ()))
                 - self.mesh.index(gaxes) * pool["k"].shape[1])
        pos = ops.host_block(pos, (gaxes,))
        lens = ops.host_block(lens, (gaxes,))
        x = ops.embed(ops.host_block(ids, ops.tokens_in_axes()),
                      self.embed).to(self.cdt)
        C = x.shape[1]
        bs = pool["k"].shape[2]
        # position-only work, shared by every layer
        ar = torch.arange(C, device=x.device, dtype=pos.dtype)
        positions = pos[:, None] + ar
        valid = ar[None, :] < lens[:, None]
        idx = cm.paged_chunk_indices(table, positions, bs, valid)
        mask = (cm.chunk_pos_mask(positions, table.shape[1] * bs,
                                  self.cfg.local_window)
                & valid[:, :, None])
        kv_map = None if self.kv_shard else self._kv_map(x.device)
        for i, blk in enumerate(self.blocks):
            pool_l = {"k": pool["k"][i], "v": pool["v"][i]}
            x = self._block_chunk_paged(blk, x, pool_l, table, ops,
                                        positions=positions, idx=idx,
                                        mask=mask, kv_map=kv_map)
        return ops, self._final(ops, x), lens

    @torch.no_grad()
    def prefill_chunk_paged(self, pool, table, ids, pos, lens):
        """Prefill C positions per slot straight into the block pool.

        Host layout, the same on every rank: table [n_slots, nb] GLOBAL
        block ids; ids [n_slots, C] chunk tokens (0-padded); pos [n_slots]
        int32 chunk starts; lens [n_slots] int32 valid positions this
        chunk (0 = idle slot).  Returns full-vocab logits [n_slots, v_pad]
        float32 at each slot's last valid chunk position (meaningful for
        the slots whose prompt completes in this chunk), the same on every
        rank; the pool is updated in place."""
        ops, x, lens = self._chunk_trunk(pool, table, ids, pos, lens)
        last = (lens.long() - 1).clamp(0, x.shape[1] - 1)
        xi = x.gather(1, last[:, None, None].expand(-1, 1, x.shape[-1]))
        return self._logits(ops, xi)

    @torch.no_grad()
    def verify_chunk_paged(self, pool, table, ids, pos, lens):
        """Speculative verify: the chunk trunk of ``prefill_chunk_paged``
        with logits at every chunk position, [n_slots, C, v_pad].  Row c is
        the target distribution of the token at position pos + c + 1, the
        one a plain decode step would give after committing ids[:, :c+1].
        The accepted proposals' K/V are in the pool already; a rejected
        suffix needs no cleanup: the engine does not advance past it, so
        it is masked by position and overwritten later."""
        ops, x, _ = self._chunk_trunk(pool, table, ids, pos, lens)
        B, C, h = x.shape
        logits = self._logits(ops, x.reshape(B * C, 1, h))
        return logits.reshape(ids.shape[0], C, -1)


def run_blocks(blocks, x, block, remat_mode: str):
    """``x`` through ``block(blk, x)`` for each layer ``blk`` of ``blocks``
    under the reference's ``maybe_remat`` policy: "none" (autograd keeps
    what it saves), "full" (only each block's input, the block recomputed
    in the backward by ``torch.utils.checkpoint``) or "dots" (the block's
    products kept too, handed back in the recompute: ``core/remat.py``)."""
    for blk in blocks:
        if remat_mode == "full":
            x = checkpoint(block, blk, x, use_reentrant=False)
        elif remat_mode == "dots":
            x = checkpoint(block, blk, x, use_reentrant=False,
                           context_fn=remat.dots_contexts)
        else:
            x = block(blk, x)
    return x


def mean_ce_loss(model, ops, x, batch, cut):
    """The mean next-token cross-entropy of an LM's final hidden states
    ``x`` against ``batch["labels"]`` (weighted by ``batch["mask"]`` when
    given; host layout, cut by ``cut``): the chunked CE over the
    compute-dtype head, its sum and count psum'd over data, loss_sum /
    max(count, 1)."""
    mask = batch.get("mask")
    loss_sum, count = ops.ce_loss(
        x, model.head.to(model.cdt), ops.host_block(batch["labels"], cut),
        vocab_real=model.cfg.vocab_size, loss_chunk=model.run.loss_chunk,
        label_mask=None if mask is None else ops.host_block(mask, cut))
    loss_sum = col.psum(model.mesh, loss_sum, "data")
    count = col.psum(model.mesh, count, "data")
    return loss_sum / count.clamp(min=1.0)


def last_token_at(ops, x, lengths):
    """[B, S_loc, f] + true lengths [B] -> [B, 1, f] hidden states at
    position lengths - 1, replicated over the sequence-sharding axes (the
    bucketed prefill right-pads prompts): each seq shard contributes its
    own row (zeros elsewhere) and one psum replicates it."""
    idx = lengths.long() - 1
    if ops.plan.seq_sharded:
        idx = idx - ops.seq_shard_index() * x.shape[1]
    valid = (idx >= 0) & (idx < x.shape[1])
    safe = idx.clamp(0, x.shape[1] - 1)[:, None, None]
    xl = x.gather(1, safe.expand(-1, 1, x.shape[-1]))
    if not ops.plan.seq_sharded:
        return xl
    xl = torch.where(valid[:, None, None], xl, torch.zeros_like(xl))
    return col.psum(ops.mesh, xl, ops.ctx.seq_shard_axes)
