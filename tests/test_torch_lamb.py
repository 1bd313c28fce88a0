"""LAMB in the port (``optim/adamw.py::lamb_update``, and
``RunConfig(optimizer="lamb")`` through ``build_train_step`` and
``train``) against the JAX package's, on the CPU.

The reference takes LAMB's trust ratio per leaf of its tree, whose block
leaves are stacked over the layers; the port keeps one tensor per layer
and groups them back (``leaf_groups``).  Tolerances, all fp32 where only
the summation order differs: moments within 1e-6 relative (1e-7
absolute); fp32 params and master copies within 1e-6 of each leaf's
largest |value| (the trust ratios' norms sum in another order); bf16
params within one bf16 rounding of the masters' difference (2^-7
relative); ``train`` as
``tests/test_torch_train.py`` holds AdamW: losses and grad norms within
1e-5 relative, params within 1e-5 of each leaf's max plus 1e-3 of the
summed learning rates (an element whose gradient sits at rounding noise
moves by up to lr times its trust ratio, which is at most 1 here, either
way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.train_loop as ref_loop
from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.optim import adamw as ref_adamw
from repro.runtime.steps import build_train_step as ref_build_train_step
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.steps import build_train_step, lamb_update_fn
from repro_torch.runtime.train_loop import train

L = 3
# a stacked tree: the block leaves are [L, ...]; ln1 and bias start at
# zero (||p|| = 0), and bias also gets zero gradients (||u|| = 0)
SHAPES = {"embed": (13, 6), "ln_f": (6,),
          "blocks": {"wq": (L, 6, 8), "ln1": (L, 6), "bias": (L, 8)}}
ZERO_P = ("ln1", "bias")


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


def _tree(rng, zero=()):
    top = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items() if k != "blocks"}
    top["blocks"] = {k: (np.zeros(s, np.float32) if k in zero else
                         rng.standard_normal(s).astype(np.float32))
                     for k, s in SHAPES["blocks"].items()}
    return top


def _port_leaves(tree):
    """The port's order (``SHAPES``'s; a tree out of jax has its keys
    sorted): top-level leaves, then each layer's block leaves, with the
    group (reference leaf) of each."""
    names = [k for k in SHAPES if k != "blocks"]
    leaves = [tree[k] for k in names]
    groups = list(range(len(names)))
    for i in range(L):
        for j, k in enumerate(SHAPES["blocks"]):
            leaves.append(tree["blocks"][k][i])
            groups.append(len(names) + j)
    return leaves, groups


def _run_both(param_dtype, grouped=True):
    """Three LAMB updates of the reference (stacked tree) and of the port
    (per-layer leaves) on the same params and gradients."""
    rng = np.random.default_rng(17)
    p0 = _tree(rng, zero=ZERO_P)
    grads = []
    for _ in range(3):
        g = _tree(rng)
        g["blocks"]["bias"][:] = 0.0
        grads.append(g)
    master = param_dtype == "bfloat16"
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p0)
    rst = ref_adamw.adamw_init(rp, master=master)
    leaves, groups = _port_leaves(p0)
    tp = [torch.from_numpy(np.array(a)).to(tdt) for a in leaves]
    tst = adamw.adamw_init(tp, master=master)
    ref_update = jax.jit(lambda p, g, st, lr: ref_adamw.lamb_update(
        p, g, st, lr=lr, weight_decay=0.1))
    for step, g in enumerate(grads):
        lr = ref_adamw.cosine_lr(jnp.int32(step + 1), base_lr=0.5,
                                 warmup=2, total=10)
        rp, rst = ref_update(rp, jax.tree.map(jnp.asarray, g), rst, lr)
        adamw.lamb_update(tp, [torch.from_numpy(np.array(a))
                               for a in _port_leaves(g)[0]], tst,
                          lr=adamw.cosine_lr(step + 1, base_lr=0.5,
                                             warmup=2, total=10),
                          weight_decay=0.1,
                          leaf_groups=groups if grouped else None)
    return rp, rst, tp, tst


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lamb_update_matches_reference(param_dtype):
    """Three LAMB updates on a stacked tree (bf16 params carry an fp32
    master), with leaves of zero ||p|| and of zero ||p|| and ||u|| (trust
    1), against the reference's ``lamb_update``: moments, master copies and
    params."""
    rp, rst, tp, tst = _run_both(param_dtype)
    master = param_dtype == "bfloat16"
    assert tst["step"] == int(rst["step"]) == 3
    for name in ("m", "v"):
        got = _port_leaves(rst[name])[0]
        for i, (g, w) in enumerate(zip(tst[name], got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name}[{i}]")
    # the trust ratios' norms sum in another order: each updated leaf
    # within 1e-6 of its largest |value|
    pf = tst["master"] if master else tp
    for i, (g, w) in enumerate(zip(pf, _port_leaves(
            rst["master"] if master else rp)[0])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"p[{i}]")
    if master:
        for i, (g, w) in enumerate(zip(tp, _port_leaves(rp)[0])):
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w).astype(np.float32),
                rtol=2 ** -7, atol=1e-7, err_msg=f"bf16 p[{i}]")
    # the zero-gradient, zero-param leaf stays exactly zero
    bias = [tp[2 + 3 * i + 2] for i in range(L)]
    assert all(float(t.abs().max()) == 0.0 for t in bias)


def test_trust_ratio_spans_the_stacked_leaf():
    """Without the grouping (one trust ratio per layer) the port leaves the
    reference's function: the norms are those of the stacked leaves."""
    rp, _, tp, _ = _run_both("float32", grouped=False)
    wq = _port_leaves(rp)[0][2]
    assert not np.allclose(tp[2].numpy(), np.asarray(wq), rtol=1e-6,
                           atol=1e-7)


def _ref_model(arch, mode, **run_kw):
    ctx = RefCtx(mode=mode, attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8, **run_kw)
    return ref_build(arch.model, ctx, run), logical_mesh(ctx)


def _port_model(arch, mode, params_np, **run_kw):
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas", **run_kw)
    model = build_model(arch.model, ParallelContext(mode=mode,
                                                    attn_impl="pallas"),
                        run, device="cpu")
    return params_from_jax(params_np, model)


def _leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


@pytest.mark.parametrize("mode,remat", [("tesseract", "full"),
                                        ("megatron1d", "dots")])
def test_train_lamb_matches_reference(monkeypatch, mode, remat):
    """``train`` with optimizer="lamb" over 4 steps against the reference's
    ``train`` on the same stream and init, on both op sets (the 1-D one
    under remat="dots" on both sides): losses and grad norms per step, and
    the final params (the reference's step bundle records them)."""
    arch = get_reduced("yi-6b")
    shape = ShapeSpec("t", 16, 4, "train")
    run_kw = dict(loss_chunk=16, lr=0.1, optimizer="lamb", remat=remat)
    model, mesh = _ref_model(arch, mode, **run_kw)
    seen = []
    build = ref_loop.build_train_step

    def recording(*a, **kw):
        bundle = build(*a, **kw)

        def fn(params, opt, batch):
            out = bundle.fn(params, opt, batch)
            seen.append((out[0], out[2]))
            return out
        return dataclasses.replace(bundle, fn=fn)

    monkeypatch.setattr(ref_loop, "build_train_step", recording)
    want = ref_loop.train(model, mesh, shape, steps=4, seed=0, log_every=0)
    init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    port = _port_model(arch, mode, init, **run_kw)
    got = train(port, shape, steps=4, seed=0, log_every=0)
    assert len(seen) == 4 and got.last_step == 3 and got.nan_skips == 0
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(
        got.grad_norms, [float(m["grad_norm"]) for _, m in seen], rtol=1e-5)
    atol = 1e-3 * sum(float(m["lr"]) for _, m in seen)
    params = dict(_leaves(params_to_numpy(port)))
    for name, w in _leaves(jax.tree.map(np.asarray, seen[-1][0])):
        err = float(np.abs(params[name] - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()) + atol, (name, err)


def test_lamb_with_zero1_raises_as_the_reference_does():
    """The reference refuses LAMB with ZeRO-1 when it builds the step (the
    trust ratios need unsharded per-leaf norms); so does the port, with
    the same message."""
    arch = get_reduced("yi-6b")
    shape = ShapeSpec("t", 16, 4, "train")
    model, mesh = _ref_model(arch, "tesseract", optimizer="lamb",
                             zero1=True)
    with pytest.raises(NotImplementedError) as want:
        ref_build_train_step(model, mesh, shape)
    port = build_model(arch.model, ParallelContext(),
                       RunConfig(optimizer="lamb", zero1=True), device="cpu")
    with pytest.raises(NotImplementedError) as got:
        build_train_step(port, shape)
    assert str(got.value) == str(want.value)


def test_lamb_groups_follow_the_reference_leaves():
    """``lamb_update_fn`` puts every layer's copy of a block param in one
    group and every top-level param in its own, in the reference's leaf
    order of first appearance."""
    model = build_model(get_reduced("yi-6b").model, ParallelContext(),
                        RunConfig(optimizer="lamb"), device="cpu")
    groups = lamb_update_fn(model, None).keywords["leaf_groups"]
    names = [n for n, _ in model.named_parameters()]
    keys = {}
    for name, g in zip(names, groups):
        key = "blocks." + name.split(".")[-1] if name.startswith(
            "blocks.") else name
        assert keys.setdefault(key, g) == g, name
    assert sorted(keys.values()) == list(range(len(keys)))
    assert len(keys) == 3 + len(model.block_specs)


def test_optimizer_must_be_adamw_or_lamb():
    assert RunConfig(optimizer="lamb").optimizer == "lamb"
    with pytest.raises(ValueError, match="optimizer must be 'adamw' or "
                                         "'lamb'"):
        RunConfig(optimizer="sgd")
