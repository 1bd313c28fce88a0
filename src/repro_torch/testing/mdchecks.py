"""Multi-rank checks of the port, one process per rank under ``torchrun``
(counterpart of ``repro.testing.mdchecks``):

    torchrun --nproc-per-node 4 -m repro_torch.testing.mdchecks \\
        collectives summa_exact serve_engine ssm_serve [--device cpu]

The mesh is [rows, cols, depth] = [2, 2, 1] at 4 ranks and [2, 2, 2] at 8
(``--layout data,depth,rows,cols`` sets another); ``--mode megatron1d``
runs the paper's 1-D baseline (``MegatronOps``) on cols = the world size,
or on ``--layout data,1,1,cols``.  Checks:

- ``collectives``: each collective of ``core/collectives.py`` (the
  sequence-sharded prefill's halo exchange, state carry and last-shard
  value among them) against a numpy model of the same ranks' inputs, the
  backward of each differentiable one against a numpy model of its
  transpose, and the
  token rows embed's reduce-scatter keeps against ``shard_tokens``; in
  Megatron also the loss of the seq-sharded plan (Megatron-SP) against the
  train plan's on the same tokens;
- ``summa_exact``: ``tesseract_matmul`` on the fused schedule (kernel #1)
  and the ring (kernel #2) against the unsharded product, fp32 within
  1e-5 of the product's largest entry (and bf16 within 1e-2 on the card);
  on the card at yi-6b's per-rank shapes, and only the schedule's kernel
  launched;
- ``serve_engine``: the engine on the mesh against the one-rank port on the
  same global weights, per case (fused and ring by default): greedy ids
  identical, and the prefill and paged-decode logits of one request within
  1e-4 of their largest magnitude; a case with ``"preempt": true`` must
  preempt in every KV group; the loss refuses to run across ranks.
  ``--cases FILE`` (JSON list; keys: name, schedule, arch, reduced, layers,
  kv_heads, params (an .npz of the reference's global tree, from
  ``convert.flatten_params``), n_slots, block_size, num_blocks, max_seq_len,
  preempt) gives other cases, and ``--out FILE`` receives every case's ids
  (rank 0 writes); the loss runs across ranks and equals one rank's;
- ``ssm_serve``: mamba2 on the mesh against the one-rank port on the
  same global weights, per case (by default fused and ring with a batch
  on the ``decode`` plan, and one on ``long_decode``, or ``decode_dp``
  where data > 1; A_log slowed so the state crosses the sequence shards;
  on the card full width at ``SSM_CARD_LAYERS`` layers): a prefill
  through the static steps, the reshard of its cache and greedy decode
  steps; ids identical, every cache leaf within 1e-4 of its max, the
  case's decode plan, and on the card the SSD kernel once per layer of
  the prefill and the schedule's SUMMA kernel in every projection.
  ``--cases FILE`` (keys: name, schedule, arch, reduced, layers, params,
  a_log, batch, prompt_len, steps, plan) and ``--out FILE`` as above;
- ``train_parity``: training on the mesh against the one-rank port on the
  same global weights and batch, for each arch case (on the CPU reduced
  yi-6b, KV heads sharded, and reduced smollm-360m, KV replicated and q
  heads padded; on the card yi-6b at full width, 2 layers), on the fused
  and the ring schedule, with ``reduce_dgrad_in_op`` on and off (and once
  with the fused backward's cache knobs flipped; Megatron has one run, and
  on the CPU a reduced yi-6b case with its KV heads sharded over col): the
  loss, every synced
  gradient leaf reassembled (``convert.unshard_params``), and the params
  after 2 AdamW steps; then ZeRO-1 against the replicated
  optimizer (params after 2 steps, and each leaf's state slice 1/zn of its
  block).  fp32; bounds in ``TRAIN_TOL``.  The bf16 wire formats, on
  both schedules (``grad_compression`` where data x depth > 1,
  ``dgrad_rs_bf16`` where q > 1): the loss, every gradient leaf within
  ``WIRE_HOPS_TOL`` of its max, and ZeRO-1's 2 steps.  The train features
  (``_feature_grid``, yi-6b, on a mesh without data or depth replicas:
  [2, 2, 1], or Megatron's cols = the world): remat="dots" on each
  schedule (the loss and
  every gradient leaf, and on the card each product's kernel launched once
  in the forward and never in the recompute), LAMB (2 steps against the
  one-rank LAMB step), and LAMB with ZeRO-1 refused on every rank;
- ``train_restart``: ``runtime/train_loop.train`` on the mesh through a
  NaN step, a damaged checkpoint and a crash (fused), and a NaN step and a
  crash without checkpoints (ring): each step's loss equals the
  uninterrupted run's, restarts / fallbacks / skips and launch counts as
  the plan implies; then the last checkpoint restores onto ``megatron1d``
  (cols = the mesh's ranks) and its next loss equals the uninterrupted
  run's;
- ``zero1_elastic`` (a mesh with data > 1, e.g. ``--layout 2,2,1,1``):
  ZeRO-1 training loses half its ranks (``train.step@4:device_loss``),
  ``runtime/elastic.replan`` halves data and doubles the accumulation,
  and ``train`` continues on a ``Mesh`` over the survivors from the last
  checkpoint, its state resliced to the new zn: the losses continue the
  uninterrupted run's.

Every rank takes the same decisions from the same values, so a failed
check fails on every rank at once: the error is reduced over the mesh
before it is judged.  The card runs fp32 with TF32 off.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import RunConfig
from ..configs.base import ShapeSpec
from ..convert import (grads_to_numpy, load_params, params_from_jax,
                       params_to_numpy, shard_params, unshard_params)
from ..core import collectives as col
from ..core.api import ParallelContext
from ..core.mesh import (AXES, GROUP_AXES, Mesh, init_distributed,
                         local_block, shutdown_distributed)
from ..core.ops import Plan, make_ops
from ..core.summa import _perm_shift, _perm_skew_a, _perm_skew_w
from ..core.summa import tesseract_matmul
from ..kernels import ops as kops
from ..models.registry import build_model, get_arch, get_reduced
from ..runtime.serve_steps import build_decode_step, build_prefill_step
from ..runtime.steps import (build_train_step, init_opt_state, leaf_layouts,
                             sync_grads)

LAYOUTS = {1: (1, 1, 1, 1), 4: (1, 1, 2, 2), 8: (1, 2, 2, 2)}
MODES = ("tesseract", "summa2d", "megatron1d")

# serve requests of the CPU cases: prompts in one prefill bucket (16) so
# the reference engine the tests compare with compiles few steps
PROMPT_LENS = (9, 12, 16, 10, 14, 11, 13, 15)
NEW_TOKENS = (6, 10, 4, 8, 5, 12, 3, 7)


class CheckFailed(AssertionError):
    pass


def _agree(mesh: Mesh, dev, ok: bool, msg: str) -> None:
    """Raise on every rank if the check failed on any."""
    bad = torch.tensor([0.0 if ok else 1.0], device=dev)
    bad = col.pmax(mesh, bad, AXES)
    if float(bad) > 0:
        raise CheckFailed(f"rank {mesh.rank}: {msg}" if not ok else
                          f"another rank failed ({msg})")


def log(mesh: Mesh, *a):
    if mesh.rank == 0:
        print(*a, flush=True)


# ----------------------------------------------------------- collectives

def _members(mesh: Mesh, axes):
    """Global ranks of this rank's group over ``axes``, in group order."""
    return [mesh.rank_at(**dict(zip(axes, c)))
            for c in itertools.product(*(range(mesh.sizes[a])
                                         for a in axes))]


def check_collectives(mesh: Mesh, dev, args):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((mesh.size, 4, 6)).astype(np.float32)
    x = torch.from_numpy(base[mesh.rank]).to(dev)
    n_checked = 0

    def same(got, want, what, tol=0.0):
        nonlocal n_checked
        want = np.asarray(want)
        ok = tuple(got.shape) == want.shape and bool(np.allclose(
            got.cpu().numpy(), want, rtol=tol, atol=tol))
        _agree(mesh, dev, ok, f"{what}: got {tuple(got.shape)} want "
                         f"{want.shape}")
        n_checked += 1

    def close(got, want, what):
        # sums of 2 to 8 fp32 terms in the backend's order
        same(got, want, what, tol=1e-6)

    for axes in GROUP_AXES:
        mem = _members(mesh, axes)
        blocks = base[mem]
        n, i = len(mem), mem.index(mesh.rank)
        same(col.all_gather_inv(mesh, x, axes), blocks,
             f"all_gather_inv stacked {axes}")
        same(col.all_gather_inv(mesh, x, axes, axis=1),
             np.moveaxis(blocks, 0, 1), f"all_gather_inv axis=1 {axes}")
        same(col.all_gather_inv(mesh, x, axes, axis=1, tiled=True),
             np.concatenate(list(blocks), axis=1),
             f"all_gather_inv tiled axis=1 {axes}")
        same(col.all_gather_cat(mesh, x, axes), np.concatenate(list(blocks)),
             f"all_gather_cat {axes}")
        close(col.psum(mesh, x, axes), blocks.sum(0), f"psum {axes}")
        close(col.psum_v(mesh, x, axes), blocks.sum(0), f"psum_v {axes}")
        same(col.pmax(mesh, x, axes), blocks.max(0), f"pmax {axes}")
        same(col.pmax_v(mesh, x, axes), blocks.max(0), f"pmax_v {axes}")
        same(col.pmin(mesh, x, axes), blocks.min(0), f"pmin {axes}")
        # reduce-scatter: member m's input holds n blocks along dim; member
        # i keeps block i of the sum
        big = rng.standard_normal((mesh.size, 4 * n, 6 * n)).astype(
            np.float32)
        for dim, cut in ((0, np.s_[:, :, :6]), (1, np.s_[:, :4, :])):
            inp = big[cut]
            total = inp[mem].sum(0)
            m = total.shape[dim] // n
            want = np.take(total, range(i * m, (i + 1) * m), axis=dim)
            close(col.psum_scatter_dim(
                mesh, torch.from_numpy(inp[mesh.rank]).to(dev), axes, dim),
                want, f"psum_scatter_dim dim={dim} {axes}")
        _agree(mesh, dev, col.axis_linear_index(mesh, axes) == i,
               f"axis_linear_index {axes}")
        # argmax over a vocab sharded over the group, with ties across
        # shards: the smallest global index wins
        vals = np.round(base[:, :, :3] * 2) / 2
        got = col.distributed_argmax(
            mesh, torch.from_numpy(vals[mesh.rank]).to(dev), i * 3, axes)
        full = np.concatenate([vals[r] for r in mem], axis=-1)
        same(got, full.argmax(-1).astype(np.int32),
             f"distributed_argmax {axes}")
        # the sequence-sharded prefill's three: the previous member's last
        # rows (zeros on the first), the recurrence h = a h + b entering
        # this member, the last member's value
        for dim in (0, 1):
            tail = np.take(base[mem[i - 1]], range(x.shape[dim] - 2,
                                                   x.shape[dim]), axis=dim)
            same(col.halo_exchange_left(mesh, x, axes, 2, dim),
                 tail if i else np.zeros_like(tail),
                 f"halo_exchange_left dim={dim} {axes}")
        a_all = (0.5 + base[:, 0, :3] ** 2).astype(np.float32)
        h = np.zeros((3, 6), np.float32)
        for j in range(i):
            h = a_all[mem[j]][:, None] * h + base[mem[j], :3]
        close(col.distributed_linear_scan_carry(
            mesh, torch.from_numpy(a_all[mesh.rank]).to(dev), x[:3], axes),
            h, f"distributed_linear_scan_carry {axes}")
        same(col.last_shard_value(mesh, x, axes), base[mem[-1]],
             f"last_shard_value {axes}")
    ctx = mesh.ctx
    megatron = ctx.mode == "megatron1d"
    # the ring's shifts: over (row, col) for the skews, one axis for steps
    # (a [q, q] grid; Megatron has none)
    q = mesh.sizes["col"]
    for name, perm, axes in (("skew_a", _perm_skew_a(q), ("row", "col")),
                             ("skew_w", _perm_skew_w(q), ("row", "col")),
                             ("shift col", _perm_shift(q), ("col",)),
                             ("shift row", _perm_shift(q), ("row",))):
        if megatron:
            break
        grp = _members(mesh, axes)
        src = [s for s, d in perm if d == grp.index(mesh.rank)][0]
        same(col.ppermute(mesh, x, axes, perm), base[grp[src]],
             f"ppermute {name}")
    # embed's reduce-scatter keeps the token rows shard_tokens cuts: with
    # table row v = v, each embedded row is its id.  The table is the
    # vocab over row and the features over col in Tesseract, the vocab over
    # col in Megatron.
    v_loc = 8 * ctx.tp // (ctx.cols if megatron else ctx.rows)
    vocab_axis = mesh.coords["col" if megatron else "row"]
    table = torch.arange(8 * ctx.tp, dtype=torch.float32, device=dev)
    table = table[vocab_axis * v_loc:(vocab_axis + 1) * v_loc, None].repeat(
        1, 2)
    seq = 4 * mesh.axis_size(ctx.seq_shard_axes)
    for plan, shape in ((Plan.for_shape("prefill"), (ctx.data, seq)),
                        (Plan.for_shape("decode"), (2 * ctx.batch_shards, 1))):
        ops = make_ops(ctx, mesh, plan)
        ids = torch.from_numpy(rng.integers(0, 8 * ctx.tp, shape)).to(dev)
        ids = ops.host_block(ids, ops.tokens_in_axes())
        same(ops.embed(ids, table)[..., 0], ops.shard_tokens(ids).float()
             .cpu().numpy(), f"embed vs shard_tokens ({plan.kind})")
    if megatron:
        n_checked += _check_sp_loss(mesh, dev, rng)
    t = col.broadcast_scalar(mesh, float(mesh.rank + 7), dev)
    _agree(mesh, dev, t == 7.0, "broadcast_scalar")
    # backward: member m's cotangent of the output is cot[m]; the gradient
    # of x is the transpose applied to the group's cotangents
    for axes in GROUP_AXES:
        mem = _members(mesh, axes)
        n, i = len(mem), mem.index(mesh.rank)
        cot = rng.standard_normal((mesh.size, 4 * n, 6)).astype(np.float32)

        def grad_of(fn, c):
            xr = x.clone().requires_grad_(True)
            (fn(xr) * torch.from_numpy(c).to(dev)).sum().backward()
            return xr.grad

        close(grad_of(lambda t: col.psum(mesh, t, axes),
                      cot[mesh.rank, :4]), cot[mesh.rank, :4],
              f"psum backward (identity) {axes}")
        close(grad_of(lambda t: col.pvary(mesh, t, axes),
                      cot[mesh.rank, :4]), cot[mem, :4].sum(0),
              f"pvary backward (psum) {axes}")
        close(grad_of(lambda t: col.psum_v(mesh, t, axes),
                      cot[mesh.rank, :4]), cot[mem, :4].sum(0),
              f"psum_v backward (psum) {axes}")
        close(grad_of(lambda t: col.all_gather_cat(mesh, t, axes),
                      cot[mesh.rank]),
              cot[mem, 4 * i:4 * (i + 1)].sum(0),
              f"all_gather_cat backward (reduce-scatter) {axes}")
        stacked = cot[:, :4 * n].reshape(mesh.size, n, 4, 6)
        close(grad_of(lambda t: col.all_gather_inv(mesh, t, axes, axis=1),
                      np.moveaxis(stacked[mesh.rank], 0, 1)),
              stacked[mem, i].sum(0),
              f"all_gather_inv axis=1 backward (reduce-scatter) {axes}")
        close(grad_of(lambda t: col.psum_scatter_dim(
                  mesh, t.repeat(1, n), axes, 1), cot[mesh.rank, :4]),
              np.concatenate([cot[r, :4] for r in mem], axis=1).reshape(
                  4, n, 6).sum(1),
              f"psum_scatter_dim backward (all-gather) {axes}")
    log(mesh, f"PASS collectives ({n_checked} comparisons on "
              f"{mesh.size} ranks)")


def _check_sp_loss(mesh: Mesh, dev, rng) -> int:
    """Megatron's CE loss on the seq-sharded plan (each col rank's
    sequence shard, the chunks gathered over col) against the train plan's
    (every col rank all the tokens) on the same hidden states, labels and
    vocab-sharded head: the sums within 1e-5 on every rank."""
    ctx = mesh.ctx
    B, S, h, v_loc = 2 * ctx.data, 4 * ctx.cols, 6, 5
    x = rng.standard_normal((B, S, h)).astype(np.float32)
    head = rng.standard_normal((v_loc * ctx.cols, h)).astype(np.float32)
    labels = rng.integers(0, v_loc * ctx.cols - 2, (B, S))
    w = torch.from_numpy(head).to(dev).narrow(
        0, mesh.coords["col"] * v_loc, v_loc)
    sums = []
    for plan in (Plan.for_shape("train"), Plan.for_shape("prefill")):
        ops = make_ops(ctx, mesh, plan)
        xb = ops.shard_tokens(ops.host_block(
            torch.from_numpy(x).to(dev), ops.tokens_in_axes()))
        lab = ops.host_block(torch.from_numpy(labels).to(dev),
                             ops.tokens_in_axes())
        ls, cnt = ops.ce_loss(xb, w, lab, vocab_real=v_loc * ctx.cols - 2,
                              loss_chunk=2)
        sums.append(np.array([float(ls), float(cnt)]))
    ok = bool(np.allclose(sums[1], sums[0], rtol=1e-5, atol=0))
    _agree(mesh, dev, ok, f"Megatron-SP loss {sums[1]} vs the train "
                          f"plan's {sums[0]}")
    return 1


# ----------------------------------------------------------- summa_exact

def _summa_inputs(E, F, G, lead, dev):
    """The global A [*lead, E, F] and W [F, G], the same on every rank."""
    gen = torch.Generator(device="cpu").manual_seed(E * 7 + F * 3 + G)
    A = torch.randn(*lead, E, F, generator=gen).to(dev)
    W = (torch.randn(F, G, generator=gen) / F ** 0.5).to(dev)
    return A, W


def _summa_case(mesh, dev, ctx, A, W, dtype, tol):
    """tesseract_matmul on this rank's blocks of A and W against its block
    of the unsharded product A @ W (float64); returns (error / max |C|,
    launches)."""
    E, F = A.shape[-2:]
    G = W.shape[1]
    tok = ("data", "depth", "row")
    Em, Fc = E // mesh.axis_size(tok), F // mesh.sizes["col"]
    Fr, Gc = F // mesh.sizes["row"], G // mesh.sizes["col"]
    e, ci, ri = mesh.index(tok), mesh.coords["col"], mesh.coords["row"]
    rows = A[..., e * Em:(e + 1) * Em, :]
    a_loc = rows[..., ci * Fc:(ci + 1) * Fc].to(dtype).contiguous()
    w_loc = W[ri * Fr:(ri + 1) * Fr, ci * Gc:(ci + 1) * Gc].to(dtype)
    # the product of the inputs as the kernel sees them (cast to dtype)
    want = (rows.to(dtype).double()
            @ W[:, ci * Gc:(ci + 1) * Gc].to(dtype).double())
    kops.reset_launches()
    got = tesseract_matmul(ctx, mesh, a_loc, w_loc.contiguous())
    if got.device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kops.LAUNCHES)
    scale = float(col.pmax(mesh, want.abs().max().float(), AXES))
    err = float(col.pmax(mesh, (got.double() - want).abs().max().float(),
                         AXES))
    ok = got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    _agree(mesh, dev, ok and err <= tol * scale,
           f"{ctx.matmul_schedule} {dtype} {tuple(A.shape)} x "
           f"{tuple(W.shape)}: err {err:.3g} vs max {scale:.3g} (tol {tol})")
    return err / scale, launches


def check_summa_exact(mesh: Mesh, dev, args):
    tok = mesh.axis_size(("data", "depth", "row"))
    q = mesh.sizes["col"]
    if dev.type == "cuda":
        # yi-6b's per-rank blocks: prefill (1024 rows at q = 2) and decode
        # (4 rows) through the gate/up (F 4096 -> G 11008) and the KV
        # projection (G 512)
        shapes = [(1024 * tok, 4096, 11008, ()), (4 * tok, 4096, 11008, ()),
                  (4 * tok, 4096, 512, ()), (1000 * tok, 4096, 512, ())]
        dtypes = ((torch.float32, 1e-5), (torch.bfloat16, 1e-2))
    else:
        shapes = [(12 * tok, 8 * q, 6 * q, ()), (3 * tok, 16 * q, 4 * q, (2,)),
                  (tok, 4 * q, 2 * q, ())]
        dtypes = ((torch.float32, 1e-5),)
    worst = 0.0
    for E, F, G, lead in shapes:
        A, W = _summa_inputs(E, F, G, lead, dev)
        for sched in ("fused", "ring"):
            ctx = mesh.ctx.replace(matmul_schedule=sched)
            for dtype, tol in dtypes:
                rel, launches = _summa_case(mesh, dev, ctx, A, W, dtype,
                                            tol)
                worst = max(worst, rel)
                if dev.type == "cuda":
                    # fused: one launch of #1; ring: q launches of #2
                    want = {"tesseract_mm": int(sched == "fused"),
                            "tesseract_mm_stream": q * (sched == "ring")}
                    got = {k: launches[k] for k in want}
                    _agree(mesh, dev, got == want, f"{sched} launches {got}, "
                                              f"want {want}")
        del A, W
    log(mesh, f"PASS summa_exact ({len(shapes)} shapes x fused/ring on "
              f"{mesh.size} ranks; worst error {worst:.3g} of max |C|)")


# ---------------------------------------------------------- serve_engine

def _default_cases(device, ctx):
    if device.type == "cuda":
        common = dict(arch="yi-6b", layers=4, n_slots=8, block_size=16,
                      num_blocks=1024, max_seq_len=2560,
                      prompt_lens=[128, 512, 1000, 2000] * 2, new_tokens=16)
    else:
        common = dict(arch="yi-6b", reduced=True, n_slots=4, block_size=4,
                      num_blocks=64, max_seq_len=64)
    # Megatron has no SUMMA grid to ring over
    scheds = ("fused",) if ctx.mode == "megatron1d" else ("fused", "ring")
    return [dict(common, name=s, schedule=s) for s in scheds]


def _prompts(case, vocab):
    lens = case.get("prompt_lens", PROMPT_LENS)
    rng = np.random.default_rng(4)
    return [rng.integers(0, min(vocab, 250) if case.get("reduced")
                         else vocab, (n,)).tolist() for n in lens]


def _new_tokens(case, n):
    if "new_tokens" in case:
        return [case["new_tokens"]] * n
    return [NEW_TOKENS[i % len(NEW_TOKENS)] for i in range(n)]


def _models(mesh, dev, case):
    """(the model on the mesh, the one-rank model) on the same global
    weights: the case's reference tree (``params``, an .npz of the
    reference's global params) or the seed's."""
    arch = (get_reduced(case["arch"]) if case.get("reduced")
            else get_arch(case["arch"])).model
    if "layers" in case:
        arch = dataclasses.replace(arch, num_layers=case["layers"])
    if "kv_heads" in case:
        arch = dataclasses.replace(arch, num_kv_heads=case["kv_heads"])
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="auto")
    ctx = mesh.ctx.replace(matmul_schedule=case["schedule"],
                           attn_impl="auto")
    model = build_model(arch, ctx, run, device=dev, seed=0, mesh=mesh)
    one = build_model(arch, ParallelContext(attn_impl="auto"), run,
                      device=dev, seed=0)
    if "params" in case:
        tree = load_params(case["params"])
        params_from_jax(tree, one)
        params_from_jax(shard_params(tree, arch, ctx, mesh.coords), model)
    return model, one


def _run_engine(model, case, prompts, new, device):
    from ..serve import EngineConfig, InferenceEngine, SamplingParams
    eng = InferenceEngine(model, EngineConfig(
        n_slots=case["n_slots"], block_size=case["block_size"],
        num_blocks=case["num_blocks"], max_seq_len=case["max_seq_len"]),
        device=device)
    per_group = [0] * eng.cache.n_groups
    preempt = eng.sched.preempt

    def counted(req):
        per_group[eng.sched.group_of_slot(req.slot)] += 1
        preempt(req)

    eng.sched.preempt = counted
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=n))
            for p, n in zip(prompts, new)]
    res = eng.run()
    return [res[r.rid] for r in reqs], eng.stats, per_group


def _logit_error(model, one, prompt, steps, bs, device):
    """One request through the mesh model and the one-rank model: the
    prefill at its bucket, then ``steps`` paged decode steps fed the mesh's
    greedy ids.  Returns (max |logits(mesh) - logits(one rank)| / max
    |logits|, whether the greedy ids agree).  The request sits in slot 0
    (KV group 0); the mesh's other slots, one per KV group, hold scratch."""
    from ..runtime.steps import paged_reshard
    seq_div = model.mesh.axis_size(model.ctx.seq_shard_axes)
    unit = bs * seq_div
    bucket = -(-len(prompt) // unit) * unit
    nb = -(-(bucket + steps) // bs)
    feed, outs = [], []
    for m in (model, one):
        # a prefill batch divides over data: the request, then copies
        # whose blocks all go to the scratch block
        n_pre, n_slots = m.ctx.data, m.ctx.batch_shards
        toks = torch.zeros(n_pre, bucket, dtype=torch.int32, device=device)
        toks[:, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        lengths = torch.full((n_pre,), len(prompt), dtype=torch.int32,
                             device=device)
        shape, dt = m.paged_cache_shape(nb + 1, bs)
        pool = {k: torch.zeros(shape, dtype=dt, device=device)
                for k in ("k", "v")}
        table = (torch.arange(n_slots, dtype=torch.int32, device=device)
                 * (nb + 1))[:, None].repeat(1, nb)
        table[0] = torch.arange(1, nb + 1, dtype=torch.int32)
        logits, pcache = m.prefill(toks, lengths)
        pre_table = torch.zeros(n_pre, bucket // bs, dtype=torch.int32,
                                device=device)
        pre_table[0] = table[0, :bucket // bs]
        paged_reshard(pool, pcache, pre_table,
                      block0=m.mesh.index(m.ctx.token_axes) * (nb + 1))
        seq = [logits[0]]
        for t in range(steps):
            if m is model:
                feed.append(int(seq[-1].argmax()))
            ids = torch.zeros(n_slots, 1, dtype=torch.int32, device=device)
            pos = torch.zeros(n_slots, dtype=torch.int32, device=device)
            ids[0, 0], pos[0] = feed[t], len(prompt) + t
            seq.append(m.decode_paged(pool, table, ids, pos)[0])
        # the real vocab: the mesh pads it to a multiple of its model group
        outs.append(torch.stack(seq)[:, :m.cfg.vocab_size])
    got, want = outs
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    return float((got - want).abs().max() / want.abs().max()), same


def check_serve_engine(mesh: Mesh, dev, args):
    cases = _default_cases(dev, mesh.ctx)
    if args.cases:
        with open(args.cases) as f:
            cases = json.load(f)
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        model, one = _models(mesh, dev, case)
        prompts = _prompts(case, model.cfg.vocab_size)
        new = _new_tokens(case, len(prompts))
        kops.reset_launches()
        got, stats, per_group = _run_engine(model, case, prompts, new, dev)
        launches = dict(kops.LAUNCHES)
        want, _, _ = _run_engine(one, case, prompts, new, dev)
        _agree(mesh, dev, got == want, f"{case['name']}: mesh ids differ from "
                                  f"one rank\n{got}\n{want}")
        if case.get("preempt"):
            _agree(mesh, dev, min(per_group) > 0,
                   f"{case['name']}: preemptions per KV group {per_group}")
        rel, same = _logit_error(model, one, prompts[0],
                                 case.get("logit_steps", 4),
                                 case["block_size"], dev)
        _agree(mesh, dev, same and rel <= 1e-4,
               f"{case['name']}: logits differ by {rel:.3g} of max (ids "
               f"same: {same})")
        if mesh.size > 1:
            # the loss runs across ranks and equals one rank's
            gen = torch.Generator(device="cpu").manual_seed(3)
            tokens = torch.randint(0, model.cfg.vocab_size,
                                   (model.ctx.batch_shards, 8),
                                   generator=gen).to(dev)
            b = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
            with torch.no_grad():
                d = abs(float(model.loss(b)) - float(one.loss(b)))
            _agree(mesh, dev, d <= TRAIN_TOL[dev.type]["loss"],
                   f"{case['name']}: loss across ranks off one rank's by "
                   f"{d:.3g}")
        out[case["name"]] = dict(ids=got, preemptions=per_group,
                                 logit_rel_err=rel, launches=launches,
                                 steps=stats.steps, tokens=stats.tokens)
        log(mesh, f"  serve_engine {case['name']}: ids identical to one rank "
                  f"({stats.tokens} tokens, {stats.steps} steps, "
                  f"preemptions per group {per_group}); logits within "
                  f"{rel:.2e} of max; launches {launches}; "
                  f"{time.perf_counter() - t0:.1f} s")
        del model, one
    if args.out and mesh.rank == 0:
        with open(args.out, "w") as f:
            json.dump(out, f)
    log(mesh, f"PASS serve_engine ({len(cases)} cases on {mesh.size} ranks)")


# ------------------------------------------------------------- ssm_serve

# full width on the card, at a depth that fits one call
SSM_CARD_LAYERS = 8
SSM_CACHE_TOL = 1e-4     # each cache leaf, of the leaf's largest |value|


def _ssm_cases(device, ctx):
    """The default cases: two prompt lengths per sequence shard, one giving
    each shard two whole chunks and one at which the chunk shrinks (the
    reduced chunk 8 to Q 5, the full 256 to Q 250), on the fused and the
    ring schedule with a batch that takes the ``decode`` plan, and a batch
    of 1 (``long_decode``; ``decode_dp`` where data > 1, whose prefill
    splits the batch over data).  A_log is -4 +- 1 (the seed's 0 decays
    the state by ~0.5 a token, which leaves nothing of one shard's state
    in the next one's outputs)."""
    shards = ctx.depth * ctx.rows
    bs = ctx.batch_shards
    if device.type == "cuda":
        common = dict(arch="mamba2-1.3b", layers=SSM_CARD_LAYERS, steps=8,
                      a_log=-4.0)
        lens = (512 * shards, 250 * shards)
    else:
        common = dict(arch="mamba2-1.3b", reduced=True, steps=4, a_log=-4.0)
        lens = (16 * shards, 10 * shards)
    cases = [dict(common, name="fused", schedule="fused", batch=2 * bs,
                  prompt_len=lens[0], plan="decode"),
             dict(common, name="ring", schedule="ring", batch=bs,
                  prompt_len=lens[1], plan="decode")]
    if ctx.data == 1:
        cases.append(dict(common, name="long_decode", schedule="fused",
                          batch=1, prompt_len=lens[1], plan="long_decode"))
    elif ctx.data < bs:
        cases.append(dict(common, name="decode_dp", schedule="fused",
                          batch=ctx.data, prompt_len=lens[0],
                          plan="decode_dp"))
    return cases


def ssm_tokens(case, vocab):
    """The case's prompts [batch, prompt_len] (numpy, from a seed)."""
    rng = np.random.default_rng((7, case["batch"], case["prompt_len"]))
    return rng.integers(0, vocab, (case["batch"], case["prompt_len"]))


def _ssm_models(mesh, dev, case):
    """(the model on the mesh, the one-rank model) on the same global
    weights (the case's reference tree, or the seed's), fp32, the SSD
    kernel's wrapper on."""
    cfg = (get_reduced(case["arch"]) if case.get("reduced")
           else get_arch(case["arch"])).model
    if "layers" in case:
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    use_pallas=True)
    ctx = mesh.ctx.replace(matmul_schedule=case["schedule"])
    model = build_model(cfg, ctx, run, device=dev, seed=0, mesh=mesh)
    one = build_model(cfg, ParallelContext(), run, device=dev, seed=0)
    if "params" in case:
        tree = load_params(case["params"])
        params_from_jax(tree, one)
        params_from_jax(shard_params(tree, cfg, ctx, mesh.coords), model)
    if "a_log" in case:
        # slow decay (A = -exp(A_log), spread over the heads), so that the
        # state entering a sequence shard carries into its outputs
        glob = torch.linspace(case["a_log"] - 1.0, case["a_log"] + 1.0,
                              one.n_heads)
        with torch.no_grad():
            for m in (model, one):
                vals = local_block(glob, (("col",),), m.mesh.sizes,
                                   m.mesh.coords)
                for blk in m.blocks:
                    blk.A_log.copy_(vals)
    return model, one


# the cache leaves' dim over col: the state's heads, conv_x's channels
_HEAD_DIM = {"state": 2, "conv_x": 3}


def _cache_err(model, got, want, batch_axes):
    """{leaf: max |block of got - its block of want| / max |want|}, the
    maximum over the mesh: ``want`` is the one-rank cache, whose block on
    this rank is its batch rows over ``batch_axes`` and, for the state and
    conv_x, its heads / channels over col."""
    out = {}
    for name, full in want.items():
        spec = [(), batch_axes] + [()] * (full.ndim - 2)
        if name in _HEAD_DIM:
            spec[_HEAD_DIM[name]] = ("col",)
        blk = local_block(full, spec, model.mesh.sizes, model.mesh.coords)
        ok = tuple(blk.shape) == tuple(got[name].shape)
        err = ((got[name].float() - blk.float()).abs().max() if ok
               else torch.tensor(float("inf"), device=full.device))
        err = float(col.pmax(model.mesh, err.reshape(1), AXES)[0])
        out[name] = err / max(float(full.float().abs().max()), 1e-30)
    return out


def check_ssm_serve(mesh: Mesh, dev, args):
    """The ssm family served on the mesh against one rank: per case a
    prefill through the static steps, the reshard to the decode plan's
    cache layout and ``steps`` greedy decode steps; the ids of every step
    identical to the one-rank model's, every cache leaf (after the prefill
    and after the last step) within ``SSM_CACHE_TOL`` of its max, the
    decode plan the case names, and on the card the SSD kernel once per
    layer of the prefill and the schedule's SUMMA kernel in every
    projection."""
    cases = _ssm_cases(dev, mesh.ctx)
    if args.cases:
        with open(args.cases) as f:
            cases = json.load(f)
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        model, one = _ssm_models(mesh, dev, case)
        B, T, steps = case["batch"], case["prompt_len"], case["steps"]
        tokens = torch.from_numpy(ssm_tokens(case, model.cfg.vocab_size)).to(
            dev)
        pre = build_prefill_step(model, ShapeSpec("p", T, B, "prefill"))
        dec = build_decode_step(model, ShapeSpec("d", T, B, "decode"))
        kops.reset_launches()
        ids, pcache = pre.fn(tokens)
        cache = dec.from_prefill(pcache)
        got = [ids]
        for t in range(steps):
            ids, cache = dec.fn(cache, ids, T + t)
            got.append(ids)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(kops.LAUNCHES)
        ids1, pcache1 = one.prefill(tokens)
        cache1 = pcache1
        want = [ids1]
        for t in range(steps):
            ids1, cache1 = one.decode(cache1, ids1, T + t)
            want.append(ids1)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        _agree(mesh, dev, same, f"ssm {case['name']}: mesh ids differ from "
                                f"one rank\n{got}\n{want}")
        _agree(mesh, dev, dec.plan.kind == case.get("plan", dec.plan.kind),
               f"ssm {case['name']}: decode plan {dec.plan.kind}, want "
               f"{case.get('plan')}")
        errs = _cache_err(model, pcache, pcache1, ("data",))
        errs.update({f"{k} after {steps} steps": v for k, v in _cache_err(
            model, cache, cache1, model.cache_batch_axes(dec.plan)).items()})
        bad = {k: v for k, v in errs.items() if not v <= SSM_CACHE_TOL}
        _agree(mesh, dev, not bad, f"ssm {case['name']}: cache leaves over "
                                   f"{SSM_CACHE_TOL} of max: {bad}")
        if dev.type == "cuda":
            L, fwd = model.cfg.num_layers, 1 + steps
            ring = case["schedule"] == "ring"
            want_l = {"ssd_intra": L,
                      "tesseract_mm": 0 if ring else 4 * L * fwd,
                      "tesseract_mm_stream": (mesh.sizes["col"] * 4 * L * fwd
                                              if ring else 0)}
            got_l = {k: launches[k] for k in want_l}
            _agree(mesh, dev, got_l == want_l, f"ssm {case['name']}: "
                   f"launches {got_l}, want {want_l}")
        worst = max(errs.values())
        out[case["name"]] = dict(ids=[g[:, 0].tolist() for g in got],
                                 plan=dec.plan.kind, cache_rel_err=worst,
                                 launches=launches)
        log(mesh, f"  ssm_serve {case['name']}: B={B} T={T} "
                  f"{case['schedule']}, decode plan {dec.plan.kind}: ids "
                  f"identical to one rank over {steps} steps; cache leaves "
                  f"within {worst:.3g} of max; launches {launches}; "
                  f"{time.perf_counter() - t0:.1f} s")
        del model, one, pcache, cache, pcache1, cache1
    if args.out and mesh.rank == 0:
        with open(args.out, "w") as f:
            json.dump(out, f)
    log(mesh, f"PASS ssm_serve ({len(cases)} cases on {mesh.size} ranks)")


# ---------------------------------------------------------- train_parity

# loss: absolute; grad, param: of each leaf's largest |value|; zero1: ZeRO-1
# against the replicated optimizer, of each leaf's largest |param|; step:
# the absolute floor of both param comparisons, as a share of the summed
# learning rates.  AdamW divides each element by its own running RMS, so
# an element whose gradient is a sum that nearly cancels turns fp32 noise
# into up to a whole step either way: at the reduced widths 1e-3 of the
# steps covers it (as tests/test_torch_train.py allows); at yi-6b's full
# width (8 M live embedding elements, fp32 on H100s) embedding elements
# ended 0.13-0.17 of a step apart, so on the card the floor is one step.
# The card keeps fp32 with TF32 off.
TRAIN_TOL = {"cpu": dict(loss=1e-5, grad=1e-5, param=1e-5, zero1=1e-6,
                         step=1e-3),
             "cuda": dict(loss=1e-4, grad=1e-3, param=1e-3, zero1=1e-6,
                          step=1.0)}
TRAIN_LR = 0.1          # large enough that the second step moves the params
LR_SUM = TRAIN_LR / 100  # cosine_lr of steps 0 and 1 (warmup 100)


def _train_cases(device, ctx):
    if device.type == "cuda":
        return [dict(arch="yi-6b", layers=2, batch=4, seq=256, chunk=128)]
    # Megatron at cols 4 replicates reduced yi-6b's 2 KV heads: one case
    # shards 4 over col
    sharded = ([dict(arch="yi-6b", reduced=True, batch=4, seq=16, chunk=8,
                     model=dict(num_kv_heads=4))]
               if ctx.mode == "megatron1d" else [])
    return sharded + [
            dict(arch="yi-6b", reduced=True, batch=4, seq=16, chunk=8),
            dict(arch="smollm-360m", reduced=True, batch=4, seq=16,
                 chunk=8),
            # layernorm (its mean and inv pvary'd) and biases (the KV
            # bias replicated over every axis), on one run and ZeRO-1
            dict(arch="smollm-360m", reduced=True, batch=4, seq=16, chunk=8,
                 model=dict(norm="layernorm", use_bias=True),
                 grid=[("fused", True, False, True)])]


def _train_cfg(case):
    """The model config of a train case."""
    cfg = (get_reduced(case["arch"]) if case.get("reduced")
           else get_arch(case["arch"])).model
    if "layers" in case:
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    return dataclasses.replace(cfg, **case.get("model", {}))


def _train_grid(device, ctx):
    """(schedule, in-op dW reduction, fused cache knobs flipped, ZeRO-1
    run) per mesh run.  The card, where every comparison moves a
    full-width tree through the host, runs the fused and the ring schedule
    with the in-op reduction and the fused one deferred, ZeRO-1 once.
    Megatron has no SUMMA product (no schedule, no in-op dW, no cached
    gathers): one run, then ZeRO-1."""
    if ctx.mode == "megatron1d":
        return [("fused", True, False, True)]
    if device.type == "cuda":
        return [("fused", True, False, True), ("ring", True, False, False),
                ("fused", False, False, False)]
    return [(s, i, False, True) for s, i in itertools.product(
        ("fused", "ring"), (True, False))] + [("fused", True, True, False)]


# The bf16 wire formats against the uncompressed one-rank step.  A value
# sent as bf16 is rounded once (at most u = 2^-8 of its magnitude) and each
# of the n - 1 additions of a reduction over n members rounds again (at
# most u of the partial sum), so an element reduced over n members is off
# by at most (2n - 1) u S, with S the largest partial sum on its way; a
# leaf's partial sums stay within twice its largest |gradient| here (a
# rank's share of a sum over the batch), so each leaf is held within
# WIRE_HOPS_TOL(n) of its max.  n: the data x depth members of the
# gradient sync (grad_compression="bf16"), or q, the row members of the
# SUMMA dW reduce-scatter and the ring's accumulator (dgrad_rs_bf16, with
# the in-op psum over data x depth = 1 on its mesh).
def WIRE_HOPS_TOL(n: int) -> float:
    return (2 * n - 1) * 2.0 ** -8 * 2


def _wire_grid(ctx):
    """(schedule, wire format, members n of its reduction) per compressed
    run, each on both schedules: the gradient sync in bf16 on a mesh of
    data x depth > 1 with q 1 (the in-op dW reduction off, so every leaf
    takes it), the SUMMA dW reductions in bf16 on a q > 1 grid with data x
    depth 1 (``--layout 2,2,1,1`` and ``1,1,2,2``; other layouts run
    none)."""
    if ctx.mode == "megatron1d":
        return []
    dd = ctx.data * ctx.depth
    if dd > 1 and ctx.cols == 1:
        return [(s, "grad_compression", dd) for s in ("fused", "ring")]
    if ctx.cols > 1 and dd == 1:
        return [(s, "dgrad_rs_bf16", ctx.cols) for s in ("fused", "ring")]
    return []


def _check_wire_formats(mesh, dev, cfg, run, case, shape, batch, want_loss,
                        want_grads, want_metrics, tol):
    """Each compressed run's loss (the forward does not change), every
    synced gradient leaf within WIRE_HOPS_TOL of its max, and, with ZeRO-1
    (whose reduce-scatter then runs in bf16 too), 2 steps' losses and
    grad norms.  Returns the worst leaf error as a share of its bound."""
    worst = 0.0
    for sched, wire, n in _wire_grid(mesh.ctx):
        t1 = time.perf_counter()
        bound = WIRE_HOPS_TOL(n)
        ctx = mesh.ctx.replace(matmul_schedule=sched, attn_impl="auto",
                               reduce_dgrad_in_op=wire == "dgrad_rs_bf16",
                               dgrad_rs_bf16=wire == "dgrad_rs_bf16")
        wrun = dataclasses.replace(
            run, grad_compression=("bf16" if wire == "grad_compression"
                                   else "none"))
        what = f"{case['arch']} {sched} {wire}"
        model = build_model(cfg, ctx, wrun, device=dev, seed=0, mesh=mesh)
        loss = model.loss(batch)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        sync_grads(mesh, grads, [leaf[1] for leaf in leaf_layouts(model)],
                   wrun.grad_compression)
        d_loss = abs(float(loss.detach()) - want_loss)
        g_err = _tree_err(unshard_params(
            _gather_tree(mesh, dev, grads_to_numpy(model)), cfg, ctx),
            want_grads)
        bad = {k: v for k, v in g_err.items() if v > bound}
        _agree(mesh, dev, d_loss <= tol["loss"] and not bad,
               f"{what}: loss off by {d_loss:.3g}, gradient leaves over "
               f"the bf16 bound {bound:.3g}: {bad}")
        # the fp32 wire would be exact to 1e-5 here: bf16 must show
        wire_moved = max(g_err.values()) > tol["grad"]
        _agree(mesh, dev, wire_moved, f"{what}: no gradient leaf moved "
                                      f"past fp32 noise: bf16 not on the "
                                      f"wire")
        worst = max(worst, max(g_err.values()) / bound)
        del model
        zrun = dataclasses.replace(wrun, zero1=True)
        zmodel = build_model(cfg, ctx, zrun, device=dev, seed=0, mesh=mesh)
        zmetrics, _ = _two_steps(zmodel, shape, cfg, case, dev)
        zl = max(abs(a["loss"] - b["loss"])
                 for a, b in zip(zmetrics, want_metrics))
        zg = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(zmetrics, want_metrics))
        _agree(mesh, dev, zl <= tol["loss"] and zg <= bound,
               f"{what} ZeRO-1: 2 steps' losses off by {zl:.3g}, grad "
               f"norms by {zg:.3g} of theirs (bound {bound:.3g})")
        del zmodel
        log(mesh, f"    {what} (n {n}): loss off by {d_loss:.3g}, "
                  f"gradients within {max(g_err.values()):.3g} of max "
                  f"(bound {bound:.3g}); ZeRO-1 2 steps: loss {zl:.3g}, "
                  f"grad norm {zg:.3g}; {time.perf_counter() - t1:.1f} s")
    return worst


def _feature_grid(ctx):
    """(schedule, remat, optimizer) per train-feature run: remat="dots" on
    the fused and the ring schedule (Megatron: its one run), LAMB on the
    fused one."""
    if ctx.mode == "megatron1d":
        return [("fused", "dots", "adamw"), ("fused", "full", "lamb")]
    return [("fused", "dots", "adamw"), ("ring", "dots", "adamw"),
            ("fused", "full", "lamb")]


def _check_train_features(mesh, dev, cfg, run, case, shape, batch, want_loss,
                          want_grads, tol):
    """remat="dots" and LAMB on the mesh against the one-rank port.  A dots
    run: the loss and every synced gradient leaf within ``tol`` (one rank's
    are the same under any remat), and on the card the schedule's SUMMA
    kernel launched once per product of the forward (#1 on fused, q x #2
    on the ring) and never in the recompute.  A LAMB run: 2 steps' losses,
    grad norms and params against 2 steps of the one-rank port's LAMB.
    Then LAMB with ZeRO-1 must be refused on every rank, as the reference
    refuses it.  Returns (the worst error as a share of max, the runs)."""
    worst = 0.0
    lrun = dataclasses.replace(run, optimizer="lamb")
    one = build_model(cfg, ParallelContext(attn_impl="auto"), lrun,
                      device=dev, seed=0)
    want_metrics, _ = _two_steps(one, shape, cfg, case, dev)
    want_params = params_to_numpy(one)
    del one
    for sched, remat, opt in _feature_grid(mesh.ctx):
        t1 = time.perf_counter()
        what = f"{case['arch']} {sched} remat={remat} optimizer={opt}"
        ctx = mesh.ctx.replace(matmul_schedule=sched, attn_impl="auto")
        frun = dataclasses.replace(run, remat=remat, optimizer=opt)
        model = build_model(cfg, ctx, frun, device=dev, seed=0, mesh=mesh)
        if opt == "lamb":
            metrics, _ = _two_steps(model, shape, cfg, case, dev)
            params = unshard_params(_gather_tree(mesh, dev,
                                                 params_to_numpy(model)),
                                    cfg, ctx)
            bad = _param_err(params, want_params, tol["param"],
                             tol["step"] * LR_SUM)
            err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                      for a, b in zip(metrics, want_metrics)
                      for k in ("loss", "grad_norm"))
            _agree(mesh, dev, not bad and err <= tol["param"],
                   f"{what}: after 2 steps, loss / grad norm off by "
                   f"{err:.3g} of one rank's LAMB, params over: {bad}")
            worst = max([worst, err]
                        + list(_tree_err(params, want_params).values()))
            log(mesh, f"    {what}: 2 steps within {err:.3g} of one rank's "
                      f"LAMB; {time.perf_counter() - t1:.1f} s")
            del model
            continue
        kops.reset_launches()
        loss = model.loss(batch)
        n_fwd = dict(kops.LAUNCHES)
        loss.backward()
        n_all = dict(kops.LAUNCHES)
        grads = [p.grad for p in model.parameters()]
        sync_grads(mesh, grads, [leaf[1] for leaf in leaf_layouts(model)])
        d_loss = abs(float(loss.detach()) - want_loss)
        g_err = _tree_err(unshard_params(
            _gather_tree(mesh, dev, grads_to_numpy(model)), cfg, ctx),
            want_grads)
        bad = {k: v for k, v in g_err.items() if v > tol["grad"]}
        _agree(mesh, dev, d_loss <= tol["loss"] and not bad,
               f"{what}: loss off by {d_loss:.3g}, gradient leaves over "
               f"{tol['grad']}: {bad}")
        if dev.type == "cuda" and ctx.mode != "megatron1d":
            kernel, per = (("tesseract_mm_stream", ctx.cols) if sched == "ring"
                           else ("tesseract_mm", 1))
            want_n = 7 * cfg.num_layers * per
            _agree(mesh, dev, n_fwd[kernel] == n_all[kernel] == want_n,
                   f"{what}: {kernel} launched {n_fwd[kernel]} times in the "
                   f"forward and {n_all[kernel]} in all, want {want_n} and "
                   f"none in the recompute")
        worst = max([worst, d_loss] + list(g_err.values()))
        launched = {k: (n_fwd[k], n) for k, n in n_all.items() if n}
        log(mesh, f"    {what}: loss off by {d_loss:.3g}, gradients within "
                  f"{max(g_err.values()):.3g} of max; launches (forward, "
                  f"in all) {launched}; {time.perf_counter() - t1:.1f} s")
        del model
    zrun = dataclasses.replace(lrun, zero1=True)
    zmodel = build_model(cfg, mesh.ctx.replace(attn_impl="auto"), zrun,
                         device=dev, seed=0, mesh=mesh)
    try:
        build_train_step(zmodel, shape)
        refused = False
    except NotImplementedError as e:
        refused = "trust ratios need unsharded per-leaf norms" in str(e)
    _agree(mesh, dev, refused, "optimizer='lamb' with ZeRO-1 was not "
                               "refused as the reference refuses it")
    del zmodel
    return worst, len(_feature_grid(mesh.ctx))


def _gather_tree(mesh: Mesh, dev, tree):
    """Every rank's tree of numpy leaves, in rank order, on every rank."""
    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        got = col.all_gather_inv(mesh, torch.from_numpy(t).to(dev), AXES)
        return list(got.cpu().numpy())
    per_leaf = rec(tree)

    def pick(t, r):
        return ({k: pick(v, r) for k, v in t.items()} if isinstance(t, dict)
                else t[r])
    return [pick(per_leaf, r) for r in range(mesh.size)]


def _tree_err(got, want):
    """{leaf: max |got - want| / max |want|} over a tree (blocks joined)."""
    out = {}
    for name, w in want.items():
        if isinstance(w, dict):
            out.update({f"{name}.{k}": v for k, v in
                        _tree_err(got[name], w).items()})
        else:
            out[name] = float(np.abs(got[name] - w).max()
                              / max(float(np.abs(w).max()), 1e-30))
    return out


def _train_batch(cfg, case, step):
    rng = np.random.default_rng((11, step))
    tok = rng.integers(0, cfg.vocab_size, (case["batch"], case["seq"]))
    return {"tokens": torch.from_numpy(tok),
            "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}


def _two_steps(model, shape, cfg, case, dev):
    """(metrics of 2 train steps, the optimizer state) from the model's
    params and a fresh state."""
    step = build_train_step(model, shape)
    opt = init_opt_state(model)
    metrics = [step(opt, {k: v.to(dev) for k, v in
                          _train_batch(cfg, case, i).items()})
               for i in range(2)]
    return metrics, opt


def check_train_parity(mesh: Mesh, dev, args):
    tol = TRAIN_TOL[dev.type]
    worst = dict(loss=0.0, grad=0.0, param=0.0, zero1=0.0, wire=0.0,
                 features=0.0)
    n_runs = 0
    for case in _train_cases(dev, mesh.ctx):
        t0 = time.perf_counter()
        cfg = _train_cfg(case)
        run = RunConfig(param_dtype="float32", compute_dtype="float32",
                        attn_impl="auto", loss_chunk=case["chunk"],
                        lr=TRAIN_LR)
        shape = ShapeSpec("train", case["seq"], case["batch"], "train")
        batch = {k: v.to(dev) for k, v in _train_batch(cfg, case, 0).items()}
        # the one-rank oracle: loss, gradients, params after 2 steps
        one = build_model(cfg, ParallelContext(attn_impl="auto"), run,
                          device=dev, seed=0)
        init = params_to_numpy(one)
        want_loss = one.loss(batch)
        want_loss.backward()
        want_loss, want_grads = float(want_loss.detach()), grads_to_numpy(one)
        want_metrics, _ = _two_steps(one, shape, cfg, case, dev)
        want_params = params_to_numpy(one)
        del one
        if case["arch"] == "yi-6b" and "model" not in case:
            worst["wire"] = _check_wire_formats(
                mesh, dev, cfg, run, case, shape, batch, want_loss,
                want_grads, want_metrics, tol)
        if (case["arch"] == "yi-6b" and "model" not in case
                and mesh.ctx.data * mesh.ctx.depth == 1):
            worst["features"], runs = _check_train_features(
                mesh, dev, cfg, run, case, shape, batch, want_loss,
                want_grads, tol)
            n_runs += runs
        grid = case.get("grid") or _train_grid(dev, mesh.ctx)
        for k, (sched, inop, flip, zero1) in enumerate(grid):
            t1 = time.perf_counter()
            # flip: the fused backward keeps A from the forward and
            # gathers W again
            what = (f"{case['arch']}{' ' if 'model' in case else ''}"
                    f"{case.get('model', '')} {sched} in-op dW {inop}"
                    + (" (A cached, W regathered)" if flip else ""))
            ctx = mesh.ctx.replace(matmul_schedule=sched,
                                   reduce_dgrad_in_op=inop, attn_impl="auto",
                                   cache_act_gather=flip,
                                   cache_weight_gather=not flip)
            model = build_model(cfg, ctx, run, device=dev, seed=0, mesh=mesh)
            if k == 0:
                got = unshard_params(_gather_tree(mesh, dev,
                                                  params_to_numpy(model)),
                                     cfg, ctx)
                same = all(v == 0 for v in _tree_err(got, init).values())
                _agree(mesh, dev, same, f"{what}: the mesh's weights are "
                                        f"not the one-rank model's")
                del got
            loss = model.loss(batch)
            loss.backward()
            grads = [p.grad for p in model.parameters()]
            sync_grads(mesh, grads, [leaf[1] for leaf in
                                     leaf_layouts(model)])
            d_loss = abs(float(loss.detach()) - want_loss)
            g_err = _tree_err(unshard_params(
                _gather_tree(mesh, dev, grads_to_numpy(model)), cfg, ctx),
                want_grads)
            bad = {k: v for k, v in g_err.items() if v > tol["grad"]}
            _agree(mesh, dev, d_loss <= tol["loss"] and not bad,
                   f"{what}: loss off by {d_loss:.3g}, gradient leaves "
                   f"over {tol['grad']}: {bad}")
            worst["loss"] = max(worst["loss"], d_loss)
            worst["grad"] = max([worst["grad"]] + list(g_err.values()))
            n_runs += 1
            log(mesh, f"    {what}: loss off by {d_loss:.3g}, gradients "
                      f"within {max(g_err.values()):.3g} of max")
            if flip:
                continue
            model.zero_grad(set_to_none=True)
            metrics, _ = _two_steps(model, shape, cfg, case, dev)
            params = unshard_params(_gather_tree(mesh, dev,
                                                 params_to_numpy(model)),
                                    cfg, ctx)
            p_err = _param_err(params, want_params, tol["param"],
                               tol["step"] * LR_SUM)
            m_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                        for a, b in zip(metrics, want_metrics)
                        for k in ("loss", "grad_norm"))
            _agree(mesh, dev, not p_err and m_err <= tol["param"],
                   f"{what}: after 2 steps, loss / grad norm off by "
                   f"{m_err:.3g} of one rank's, params over: {p_err}")
            worst["param"] = max([worst["param"], m_err] + [
                v for v in _tree_err(params, want_params).values()])
            del model
            if not zero1:
                log(mesh, f"    {what}: {time.perf_counter() - t1:.1f} s")
                continue
            # ZeRO-1 against the replicated optimizer, on the same mesh
            zrun = dataclasses.replace(run, zero1=True)
            zmodel = build_model(cfg, ctx, zrun, device=dev, seed=0,
                                 mesh=mesh)
            zmetrics, zopt = _two_steps(zmodel, shape, cfg, case, dev)
            _check_zero_state(mesh, dev, zmodel, zopt, what)
            zparams = unshard_params(_gather_tree(mesh, dev,
                                                  params_to_numpy(zmodel)),
                                     cfg, ctx)
            z_err = _tree_err(zparams, params)
            bad = _param_err(zparams, params, tol["zero1"],
                             tol["step"] * LR_SUM if dev.type == "cuda"
                             else 0.0)
            zm = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for a, b in zip(zmetrics, metrics)
                     for k in ("loss", "grad_norm"))
            _agree(mesh, dev, not bad and zm <= tol["zero1"],
                   f"{what}: ZeRO-1 off the replicated optimizer: metrics "
                   f"{zm:.3g}, params over {tol['zero1']}: {bad}")
            worst["zero1"] = max([worst["zero1"], zm] + list(z_err.values()))
            n_runs += 1
            del zmodel, zopt
            log(mesh, f"    {what}: {time.perf_counter() - t1:.1f} s")
        log(mesh, f"  train_parity {case['arch']}: loss {want_loss:.5f}; "
                  f"{time.perf_counter() - t0:.1f} s")
    log(mesh, f"PASS train_parity ({n_runs} runs on {mesh.size} ranks; "
              f"worst: loss {worst['loss']:.3g}, grad {worst['grad']:.3g}, "
              f"param {worst['param']:.3g} of max, ZeRO-1 "
              f"{worst['zero1']:.3g}, bf16 wire formats "
              f"{worst['wire']:.3g} of their bound, remat dots and LAMB "
              f"{worst['features']:.3g} of max)")


def _param_err(got, want, rel, atol):
    """{leaf: max |got - want|} over the leaves off by more than ``rel`` of
    their largest |value| plus ``atol`` (TRAIN_TOL's step floor)."""
    bad = {}
    for name, w in want.items():
        if isinstance(w, dict):
            bad.update({f"{name}.{k}": v for k, v in _param_err(
                got[name], w, rel, atol).items()})
            continue
        err = float(np.abs(got[name] - w).max())
        if err > rel * float(np.abs(w).max()) + atol:
            bad[name] = err
    return bad


def _check_zero_state(mesh, dev, model, opt, what):
    """Each leaf's m and v are its [k] slice: the local block split zn ways
    over the data and depth axes it is replicated on."""
    ok = True
    for p, m, v, (spec, _, lay, _) in zip(model.parameters(), opt["m"],
                                          opt["v"], leaf_layouts(model)):
        used = {a for dim in spec for a in dim}
        zn = mesh.axis_size(tuple(a for a in ("data", "depth")
                                  if a not in used))
        ok &= (lay.zn == zn and m.numel() == v.numel() == lay.k
               == -(-p.numel() // zn))
    _agree(mesh, dev, ok, f"{what}: ZeRO-1 state slices are not 1/zn of "
                          f"their blocks")


# ------------------------------------------- train_restart, zero1_elastic

RESTART_STEPS = 6       # steps of a faulted run
RESTART_LR = 1e-3


def _restart_case(device):
    """The train_parity case of yi-6b (full width, 2 layers, on the card;
    reduced on the CPU)."""
    return [c for c in _train_cases(device, ParallelContext())
            if c["arch"] == "yi-6b" and "model" not in c][0]


def _restart_model(case, dev, ctx, mesh, **run_kw):
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="auto", loss_chunk=case["chunk"],
                    lr=RESTART_LR, **run_kw)
    return build_model(_train_cfg(case), ctx, run, device=dev, seed=0,
                       mesh=mesh)


def _shared_dir(mesh: Mesh) -> str:
    """A fresh directory made by rank 0, its path on every rank."""
    path = [tempfile.mkdtemp(prefix="mdchecks-ckpt-")
            if mesh.rank == 0 else None]
    if mesh.world > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def _drop_dir(mesh: Mesh, path: str) -> None:
    if mesh.world > 1:
        dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(path, ignore_errors=True)


def _crash_once(at: int):
    fired = []

    def hook(step):
        if step == at and not fired:
            fired.append(step)
            raise RuntimeError(f"injected crash before step {at}")
    return hook


def _by_step(res) -> dict:
    """The last loss of each step (a replayed step's replay)."""
    return dict(zip(res.loss_steps, res.losses))


def check_train_restart(mesh: Mesh, dev, args):
    """Restart parity on the mesh: per schedule, an uninterrupted run of
    RESTART_STEPS + 1 steps, then a faulted run of RESTART_STEPS through
    ``train``: on the fused schedule with checkpoints every 2 steps, a NaN
    at step 2 (one retry), the step-3 checkpoint damaged (bit flip) and a
    crash before step 5, which restores step 1 and replays 2-4; on the ring
    (kernel #2 on the card) a NaN at step 2 and a crash before step 4 with
    no checkpoint, which starts again from the initial weights.  Each
    step's loss equals the uninterrupted run's within TRAIN_TOL's loss,
    restarts / fallbacks / NaN skips are (1, 1, 1) and (1, 0, 1), and the
    faulted run launched each kernel the uninterrupted run's count per
    step execution times its executions.  Then the fused run's last
    checkpoint restores onto the 1-D baseline (``megatron1d``, cols = the
    mesh's ranks), whose next step's loss equals the uninterrupted run's
    last."""
    from ..checkpoint.ckpt import CheckpointManager, load_state
    from ..data.pipeline import SyntheticLMStream
    from ..optim.zero import make_ckpt_converter
    from ..runtime.train_loop import train
    tol = TRAIN_TOL[dev.type]["loss"]
    case = _restart_case(dev)
    shape = ShapeSpec("train", case["seq"], case["batch"], "train")
    N = RESTART_STEPS
    root = _shared_dir(mesh)
    worst = 0.0
    try:
        for sched in ("fused", "ring"):
            t0 = time.perf_counter()
            ctx = mesh.ctx.replace(matmul_schedule=sched, attn_impl="auto")
            model = _restart_model(case, dev, ctx, mesh)
            kops.reset_launches()
            want = train(model, shape, steps=N + 1, log_every=0).losses
            per_step = dict(kops.LAUNCHES)
            del model
            fused = sched == "fused"
            plan = "train.grads@2:nan" + (
                ";ckpt.write@3:corrupt(0,bit_flip)" if fused else "")
            model = _restart_model(case, dev, ctx, mesh, fault_plan=plan,
                                   fault_seed=3)
            kops.reset_launches()
            res = train(model, shape, steps=N, log_every=0,
                        ckpt_dir=os.path.join(root, sched) if fused
                        else None, ckpt_every=2,
                        fault_hook=_crash_once(5 if fused else 4))
            launches = dict(kops.LAUNCHES)
            del model
            got = _by_step(res)
            err = max(abs(got[s] - want[s]) for s in range(N))
            counts = (res.restarts, res.ckpt_fallbacks, res.nan_skips)
            want_counts = (1, 1 if fused else 0, 1)
            execs = len(res.losses) + res.nan_skips
            bad_l = {k: (v, per_step[k]) for k, v in launches.items()
                     if v * (N + 1) != per_step[k] * execs}
            _agree(mesh, dev, err <= tol and counts == want_counts
                   and not bad_l and sorted(got) == list(range(N)),
                   f"train_restart {sched}: losses off by {err:.3g}, "
                   f"(restarts, fallbacks, nan skips) {counts}, want "
                   f"{want_counts}, launches off the per-step count "
                   f"{bad_l}")
            worst = max(worst, err)
            log(mesh, f"  train_restart {sched}: steps run "
                      f"{res.loss_steps} (+{res.nan_skips} skipped), losses "
                      f"within {err:.3g} of the uninterrupted run's; "
                      f"(restarts, fallbacks, nan skips) {counts}; "
                      f"launches {launches}; {time.perf_counter() - t0:.1f} s")
        if mesh.ctx.mode == "megatron1d" or mesh.size == 1:
            log(mesh, f"PASS train_restart (worst loss {worst:.3g})")
            return
        t0 = time.perf_counter()
        mctx = ParallelContext(mode="megatron1d", data=mesh.ctx.data,
                               cols=mesh.size // mesh.ctx.data,
                               attn_impl="auto")
        mmesh = Mesh(mctx)
        model = _restart_model(case, dev, mctx, mmesh)
        mgr = CheckpointManager(os.path.join(root, "fused"), mesh=mmesh,
                                device=dev)
        leaves, last = mgr.restore_latest(make_ckpt_converter(None))
        opt = load_state(model, leaves)
        del leaves
        batch = SyntheticLMStream(model.cfg.vocab_size, shape.global_batch,
                                  shape.seq_len).batch(N)
        metrics = build_train_step(model, shape)(
            opt, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        err = abs(metrics["loss"] - want[N])
        _agree(mesh, dev, last == N - 1 and opt["step"] == N + 1
               and err <= tol,
               f"train_restart: step {last} (opt step {opt['step']}) onto "
               f"megatron1d cols {mctx.cols}: next loss off by {err:.3g}")
        del model, opt
        mmesh._groups.clear()
        log(mesh, f"  train_restart: the fused run's step-{last} checkpoint "
                  f"onto megatron1d cols {mctx.cols}: step {N} loss within "
                  f"{err:.3g}; {time.perf_counter() - t0:.1f} s")
        log(mesh, f"PASS train_restart (worst loss {max(worst, err):.3g})")
    finally:
        _drop_dir(mesh, root)


def check_zero1_elastic(mesh: Mesh, dev, args):
    """Elastic recovery with ZeRO-1 (on a mesh with data > 1, e.g.
    ``--layout 2,2,1,1``): an uninterrupted run of RESTART_STEPS steps,
    then a run that checkpoints every 2 steps and loses half its ranks
    before step 4 (``train.step@4:device_loss``), which ``train`` raises
    past its restart budget; ``replan`` keeps the TP group and halves data
    with twice the accumulation, and ``train`` runs again on a ``Mesh``
    over the surviving ranks (the others wait at a barrier): it restores
    the step-3 checkpoint, every leaf's optimizer state resliced to the
    new zn, and its losses continue the uninterrupted run's within
    TRAIN_TOL's loss."""
    from ..runtime import faults
    from ..runtime.elastic import replan
    from ..runtime.train_loop import train
    tol = TRAIN_TOL[dev.type]["loss"]
    case = _restart_case(dev)
    shape = ShapeSpec("train", case["seq"], case["batch"], "train")
    N, ctx = RESTART_STEPS, mesh.ctx.replace(attn_impl="auto")
    survivors = mesh.size // 2
    root = _shared_dir(mesh)
    try:
        t0 = time.perf_counter()
        model = _restart_model(case, dev, ctx, mesh, zero1=True)
        want = train(model, shape, steps=N, log_every=0).losses
        zn = {n: lay.zn for (n, _), (_, _, lay, _) in zip(
            model.named_parameters(), leaf_layouts(model))}
        del model
        model = _restart_model(
            case, dev, ctx, mesh, zero1=True,
            fault_plan=f"train.step@4:device_loss({survivors})")
        inj = faults.injector_from_run(model.run, sites=("train", "ckpt"))
        lost = None
        try:
            train(model, shape, steps=N, log_every=0, ckpt_dir=root,
                  ckpt_every=2, injector=inj)
        except faults.DeviceLostError as e:
            lost = e
        del model
        _agree(mesh, dev, lost is not None and lost.n_surviving == survivors
               and lost.partial_result.last_step == 3,
               f"zero1_elastic: no device loss after step 3 ({lost!r})")
        rp = replan(lost.n_surviving, ctx, global_batch=shape.global_batch)
        small = Mesh(rp.ctx)             # every rank takes part in its groups
        ok, msg = True, ""
        if small.active:
            model = _restart_model(case, dev, rp.ctx, small, zero1=True)
            zn2 = {n: lay.zn for (n, _), (_, _, lay, _) in zip(
                model.named_parameters(), leaf_layouts(model))}
            res = train(model, shape, steps=N, log_every=0, ckpt_dir=root,
                        accum_steps=rp.accum_steps, injector=inj)
            err = max(abs(a - b) for a, b in zip(res.losses, want[4:]))
            ok = (res.loss_steps == list(range(4, N)) and err <= tol
                  and zn2 != zn)
            msg = (f"zero1_elastic on {rp.n_used} ranks: steps "
                   f"{res.loss_steps}, losses off by {err:.3g}")
            log(small, f"  zero1_elastic: device loss before step 4, replan "
                       f"{mesh.size} -> {rp.n_used} ranks (data "
                       f"{ctx.data} -> {rp.ctx.data}, accum "
                       f"{rp.accum_steps}); restored step 3, embed state zn "
                       f"{zn['embed']} -> {zn2['embed']}; steps "
                       f"{res.loss_steps} losses within {err:.3g} of the "
                       f"uninterrupted run's; "
                       f"{time.perf_counter() - t0:.1f} s")
            del model
        small._groups.clear()
        dist.barrier()                   # the idle ranks wait here
        _agree(mesh, dev, ok, msg)
        log(mesh, "PASS zero1_elastic")
    finally:
        _drop_dir(mesh, root)


CHECKS = {"collectives": check_collectives, "summa_exact": check_summa_exact,
          "serve_engine": check_serve_engine,
          "ssm_serve": check_ssm_serve,
          "train_parity": check_train_parity,
          "train_restart": check_train_restart,
          "zero1_elastic": check_zero1_elastic}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checks", nargs="+", choices=sorted(CHECKS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layout", default="",
                    help="data,depth,rows,cols (default by world size)")
    ap.add_argument("--mode", default="tesseract", choices=MODES,
                    help="op set: megatron1d is the 1-D baseline (rows = "
                         "depth = 1; default layout 1,1,1,world)")
    ap.add_argument("--cases", default="",
                    help="JSON list of serve_engine or ssm_serve cases")
    ap.add_argument("--out", default="",
                    help="serve_engine or ssm_serve ids (JSON)")
    args = ap.parse_args(argv)
    dev = init_distributed(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ.get("WORLD_SIZE", 1))
    default = ((1, 1, 1, world) if args.mode == "megatron1d"
               else LAYOUTS[world])
    data, depth, rows, cols = (tuple(int(v) for v in args.layout.split(","))
                               if args.layout else default)
    ctx = ParallelContext(mode=args.mode, data=data, depth=depth, rows=rows,
                          cols=cols)
    mesh = Mesh(ctx)
    log(mesh, f"mdchecks: {world} ranks, {args.mode}, data={data} "
              f"depth={depth} rows={rows} cols={cols}, {dev.type}"
              + (f" ({torch.cuda.get_device_name(dev)})"
                 if dev.type == "cuda" else ""))
    try:
        for name in args.checks:
            CHECKS[name](mesh, dev, args)
    finally:
        shutdown_distributed(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
