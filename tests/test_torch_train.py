"""The port's training path vs the JAX package's, on the CPU.

Parameters come from the reference's ``model.init`` and cross through numpy
(repro_torch.convert); tokens come from seeded numpy (the same step-keyed
synthetic stream in both packages).  The port runs attn_impl="pallas",
which on CPU tensors takes the flash kernels' plain versions, forward and
backward (the dQ and dK/dV passes); the reference runs its jnp attention,
the oracle its own tests hold its Pallas kernels to (its Pallas kernels do
not run inside shard_map under the installed jax, ROADMAP Queue C).
Everything is float32, where only the summation order differs: the loss
agrees within 1e-5 and each gradient leaf within 1e-5 of that leaf's
largest |gradient|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.runtime.train_loop as ref_loop
from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.collectives import shard_map
from repro.core.mesh import logical_mesh
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build, get_reduced
from repro.optim import adamw as ref_adamw
from repro.runtime.steps import batch_abstract, make_plan
from repro_torch.configs.base import RunConfig
from repro_torch.convert import (grads_to_numpy, params_from_jax,
                                 params_to_numpy)
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.steps import build_train_step
from repro_torch.runtime.train_loop import train

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's torch ops run on one thread: the suite's xdist workers
    share the machine's cores, and torch's default of a thread per core in
    every worker oversubscribes them (a test file then burns several times
    its CPU time spinning, beside the suite's longest file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_model(arch, **run_kw):
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8, **run_kw)
    return ref_build(arch.model, ctx, run), logical_mesh(ctx)


def _port_model(arch, params_np, **run_kw):
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas", **run_kw)
    model = build_model(arch.model, ParallelContext(attn_impl="pallas"), run,
                        device="cpu")
    return params_from_jax(params_np, model)


def _compiled(jitted, *args):
    """``jitted`` compiled for ``args`` with LLVM's optimisation off: an
    oracle runs a few times on tiny shapes, and optimising its code costs
    more CPU than the runs (the same HLO; the fp32 results may differ
    by rounding, far inside the tolerances)."""
    return jitted.lower(*args).compile({"xla_backend_optimization_level": 0})


def _leaves(tree):
    """(name, array) pairs of a reference-layout tree, blocks flattened."""
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    out += [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]
    return out


def _assert_tree_close(got, want, rel, what, atol=1e-12):
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        w = np.asarray(w)
        err = float(np.abs(got[name] - w).max())
        assert err <= rel * float(np.abs(w).max()) + atol, \
            f"{what} {name}: max |diff| {err:.3g}, max |ref| " \
            f"{float(np.abs(w).max()):.3g}"


@pytest.mark.parametrize("arch_name", ["yi-6b", "smollm-360m"])
def test_loss_and_grads_match_reference(arch_name):
    """DenseLM.loss and every gradient leaf vs jax.value_and_grad of the
    reference's model.loss under shard_map at one device."""
    arch = get_reduced(arch_name)
    B, S = 2, 16
    model, mesh = _ref_model(arch, loss_chunk=8, remat="none")
    params = model.init(jax.random.PRNGKey(0))
    shape = ShapeSpec("t", S, B, "train")
    ops = ref_make_ops(model.ctx, make_plan(model.ctx, shape))
    specs = model.specs(ops)
    _, bspecs = batch_abstract(ops, shape, model.ctx)
    tok = np.random.default_rng(5).integers(
        0, arch.model.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    fn = shard_map(jax.value_and_grad(lambda p, b: model.loss(p, b, ops)),
                   mesh=mesh, in_specs=(specs, bspecs),
                   out_specs=(P(), specs))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = _compiled(jax.jit(fn), params, jbatch)(
        params, jbatch)

    port = _port_model(arch, jax.tree.map(np.asarray, params), loss_chunk=8,
                       remat="none")
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _assert_tree_close(grads_to_numpy(port),
                       jax.tree.map(np.asarray, want_grads), REL, "grad")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_matches_reference(monkeypatch, accum):
    """train() over 4 steps vs the reference's train() on the same stream
    and init: losses and grad norms per step, and the final params.  The
    reference's step bundle is wrapped to record its metrics and params.
    AdamW divides each gradient element by its own running RMS, so an
    element whose gradient sits at fp32 rounding noise may move its param
    by up to lr either way: params also get 1e-3 of the summed learning
    rates as an absolute tolerance."""
    arch = get_reduced("yi-6b")
    shape = ShapeSpec("t", 16, 4, "train")
    run_kw = dict(loss_chunk=16, lr=0.1)      # lr large enough to move
    model, mesh = _ref_model(arch, **run_kw)
    seen = []
    build = ref_loop.build_train_step

    def recording(*a, **kw):
        bundle = build(*a, **kw)
        step = []

        def fn(params, opt, batch):
            if not step:
                step.append(_compiled(bundle.fn, params, opt, batch))
            out = step[0](params, opt, batch)
            seen.append((out[0], out[2]))
            return out
        return dataclasses.replace(bundle, fn=fn)

    monkeypatch.setattr(ref_loop, "build_train_step", recording)
    want = ref_loop.train(model, mesh, shape, steps=4, seed=0, log_every=0,
                          accum_steps=accum)
    init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    port = _port_model(arch, init, **run_kw)
    got = train(port, shape, steps=4, seed=0, log_every=0,
                accum_steps=accum)
    assert len(seen) == 4 and got.last_step == 3 and got.nan_skips == 0
    np.testing.assert_allclose(got.losses, want.losses, rtol=REL)
    np.testing.assert_allclose(
        got.grad_norms, [float(m["grad_norm"]) for _, m in seen], rtol=REL)
    lr_sum = sum(float(m["lr"]) for _, m in seen)
    _assert_tree_close(params_to_numpy(port),
                       jax.tree.map(np.asarray, seen[-1][0]), REL, "param",
                       atol=1e-3 * lr_sum)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(param_dtype):
    """Three AdamW updates on a random tree (bf16 params carry an fp32
    master), and cosine_lr over warmup and decay, vs the reference.  bf16
    params are the fp32 masters rounded once, so they agree within one bf16
    rounding of the masters' difference."""
    rng = np.random.default_rng(9)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    master = param_dtype == "bfloat16"
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)
    rp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    rst = ref_adamw.adamw_init(rp, master=master)
    tp = [torch.from_numpy(p0[k]).to(tdt) for k in shapes]
    tst = adamw.adamw_init(tp, master=master)
    for step, g in enumerate(grads):
        lr = ref_adamw.cosine_lr(jnp.int32(step + 1), base_lr=0.5,
                                 warmup=2, total=10)
        rp, rst = ref_adamw.adamw_update(
            rp, {k: jnp.asarray(v) for k, v in g.items()}, rst, lr=lr,
            weight_decay=0.1)
        adamw.adamw_update(tp, [torch.from_numpy(g[k]) for k in shapes], tst,
                           lr=adamw.cosine_lr(step + 1, base_lr=0.5,
                                              warmup=2, total=10),
                           weight_decay=0.1)
    assert tst["step"] == int(rst["step"]) == 3
    for i, k in enumerate(shapes):
        for name in ("m", "v") + (("master",) if master else ()):
            np.testing.assert_allclose(tst[name][i].numpy(),
                                       np.asarray(rst[name][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name}.{k}")
        np.testing.assert_allclose(
            tp[i].float().numpy(), np.asarray(rp[k]).astype(np.float32),
            rtol=2 ** -7 if master else 1e-6, atol=1e-7, err_msg=k)
    for s in (0, 1, 50, 99, 100, 101, 5000, 10000, 20000):
        want = float(ref_adamw.cosine_lr(jnp.int32(s), base_lr=3e-4,
                                         warmup=100, total=10000))
        assert float(adamw.cosine_lr(s, base_lr=3e-4, warmup=100,
                                     total=10000)) == pytest.approx(
            want, rel=1e-6)


def _tiny(remat="none", param_dtype="float32", **kw):
    arch = get_reduced("yi-6b")
    run = RunConfig(param_dtype=param_dtype, compute_dtype="float32",
                    attn_impl="pallas", loss_chunk=16, remat=remat, **kw)
    model = build_model(arch.model, ParallelContext(attn_impl="pallas"), run,
                        device="cpu", seed=3)
    tok = np.random.default_rng(2).integers(
        0, arch.model.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}
    return model, batch, ShapeSpec("t", 16, 4, "train")


def test_nonfinite_guard_leaves_state_bit_identical():
    """A step whose scaled loss overflows skips its update: params, m, v
    and the step count come back bit-identical, and skipped reads 1."""
    model, batch, shape = _tiny()
    params = list(model.parameters())
    opt = adamw.adamw_init(params)
    step = build_train_step(model, shape)
    assert step(opt, batch)["skipped"] == 0.0           # state moves on
    before = ([p.detach().clone() for p in params],
              [t.clone() for t in opt["m"] + opt["v"]], opt["step"])
    metrics = build_train_step(model, shape, loss_scale=1e38)(opt, batch)
    assert metrics["skipped"] == 1.0
    assert not np.isfinite(metrics["grad_norm"])
    assert opt["step"] == before[2]
    for a, b in zip(params, before[0]):
        assert torch.equal(a.detach(), b)
    for a, b in zip(opt["m"] + opt["v"], before[1]):
        assert torch.equal(a, b)


def test_grad_norm_is_fp32_with_bf16_params():
    """With bf16 params (and bf16 grads) the step's grad norm is the fp32
    sum of squares the reference takes, not a combination of per-leaf norms
    rounded to bf16."""
    model, batch, shape = _tiny(param_dtype="bfloat16")
    params = list(model.parameters())
    model.loss(batch).backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in params)
    want = float(sum((p.grad.double() ** 2).sum() for p in params) ** 0.5)
    opt = adamw.adamw_init(params, master=True)
    metrics = build_train_step(model, shape)(opt, batch)
    assert metrics["skipped"] == 0.0
    assert metrics["grad_norm"] == pytest.approx(want, rel=1e-6)


def test_loss_scale_backoff_recovers():
    """The train loop's ladder: an overflowing loss scale is halved until
    the step goes through, and training then matches an unscaled run."""
    model, _, shape = _tiny(loss_scale=2.0 ** 126, nan_skip_limit=0)
    init = params_to_numpy(model)
    res = train(model, shape, steps=2, log_every=0)
    assert res.loss_scale_backoffs >= 1
    assert res.nan_skips == res.loss_scale_backoffs
    ref, _, _ = _tiny()
    params_from_jax(init, ref)
    want = train(ref, shape, steps=2, log_every=0)
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-5)


def test_remat_full_matches_none():
    """Recomputing each block in the backward gives the same gradients."""
    grads = []
    for remat in ("none", "full"):
        model, batch, _ = _tiny(remat=remat)
        model.loss(batch).backward()
        grads.append(grads_to_numpy(model))
    _assert_tree_close(grads[1], grads[0], 1e-6, "grad")


def test_train_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                "--steps", "2", "--seq", "16", "--batch", "2", "--accum",
                "2"])
    assert len(res.losses) == 2 and np.all(np.isfinite(res.losses))
    assert "final loss" in capsys.readouterr().out
