"""Training across ranks: the parts the CPU checks here without a spawn.

The multi-rank parity itself runs in the torchrun spawns of
``tests/test_torch_summa.py`` (``mdchecks train_parity`` on [2, 2, 1],
[2, 2, 2] and data 2 x depth 2, and the collectives' backward in
``mdchecks collectives``), held to the port's one-rank step, which
``tests/test_torch_train.py`` holds to the reference's
``jax.value_and_grad``.  Here:

(a) ``optim/zero.py``'s layouts against ``repro.optim.zero.build_layouts``
    on the reference's own specs and abstract params: the same zaxes, k,
    local shape and padding;
(b) ``convert.unshard_params`` inverts ``convert.shard_params``;
(c) the train step's leaf table: which leaves the op reduces, and the axes
    each leaf's gradient is psum'd over, replicated and under ZeRO-1;
(d) at one rank ZeRO-1 (every slice the whole leaf) runs the replicated
    optimizer's update bit for bit;
(e) the refusals that stay name ROADMAP A3 (ssm training among them).
"""
import dataclasses
import itertools
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.ops import Plan as RefPlan
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.optim import zero as ref_zero
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.convert import params_to_numpy, shard_params, unshard_params
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model, get_reduced
from repro_torch.optim import zero
from repro_torch.runtime.steps import (build_train_step, init_opt_state,
                                       leaf_layouts)

LAYOUTS = [(1, 1, 2, 2), (2, 2, 1, 1), (1, 2, 2, 2), (2, 1, 2, 2)]


def _ref_tree(arch, layout, kv=0):
    cfg = ref_reduced(arch).model
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    data, depth, rows, cols = layout
    ctx = RefCtx(mode="tesseract", data=data, depth=depth, rows=rows,
                 cols=cols)
    model = ref_build(cfg, ctx, RefRun(param_dtype="float32"))
    specs = model.specs(ref_make_ops(ctx, RefPlan.for_shape("train")))
    return cfg, model, specs


def _items(tree):
    top = [(k, v) for k, v in tree.items() if k != "blocks"]
    return top + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


@pytest.mark.parametrize("arch,layout", list(itertools.product(
    ["yi-6b", "smollm-360m"], LAYOUTS)))
def test_zero_layouts_match_reference(arch, layout):
    """The port's ``build_layouts`` on the reference's specs (as per-dim
    axis tuples) and shapes gives the reference's layouts leaf by leaf."""
    cfg, model, specs = _ref_tree(arch, layout)
    sizes = dict(zip(("data", "depth", "row", "col"), layout))
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = ref_zero.build_layouts(specs, abstract, sizes)
    port_specs = jax.tree.map(ref_zero.spec_dim_axes, specs,
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
    shapes = jax.tree.map(lambda a: tuple(a.shape), abstract)
    got = zero.build_layouts(port_specs, shapes, sizes)
    for (name, g), (_, w) in zip(_items(got), _items(want)):
        assert g.zaxes == w.zaxes, name
        assert g.local_shape == w.local_shape, name
        assert (g.zn, g.k) == (w.zn, w.k), name
        assert g.k * g.zn - int(np.prod(g.local_shape)) == \
            w.k * w.zn - int(np.prod(w.local_shape)), name


@pytest.mark.parametrize("arch,kv,layout", [
    ("yi-6b", 0, (1, 1, 2, 2)), ("yi-6b", 1, (1, 2, 2, 2)),
    ("smollm-360m", 0, (2, 1, 2, 2)), ("smollm-360m", 0, (2, 2, 1, 1))])
def test_unshard_params_inverts_shard_params(arch, kv, layout):
    """Every rank's blocks of the reference's one-device tree, put back
    together, give that tree (the layout's padding cut off)."""
    cfg, _, _ = _ref_tree(arch, (1, 1, 1, 1), kv)
    one = ref_build(cfg, RefCtx(mode="tesseract"),
                    RefRun(param_dtype="float32"))
    tree = jax.tree.map(np.asarray, one.init(jax.random.PRNGKey(0)))
    data, depth, rows, cols = layout
    ctx = ParallelContext(data=data, depth=depth, rows=rows, cols=cols)
    blocks = [shard_params(tree, cfg, ctx, dict(zip(
        ("data", "depth", "row", "col"), c)))
        for c in itertools.product(*(range(n) for n in layout))]
    got = unshard_params(blocks, cfg, ctx)
    for (name, g), (_, w) in zip(_items(got), _items(tree)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _tiny(ctx=None, **run_kw):
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas", loss_chunk=16, **run_kw)
    return build_model(get_reduced("yi-6b").model,
                       ctx or ParallelContext(attn_impl="pallas"), run,
                       device="cpu", seed=3)


@pytest.mark.parametrize("inop,zero1", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_leaf_table(inop, zero1):
    """Which leaves the SUMMA op reduces (``tess_weight_names``: every
    projection when the KV heads are sharded) and the axes the step psums
    each gradient over: a leaf's replication axes, none for a weight
    reduced in the op, and without data and depth under ZeRO-1, whose
    reduce-scatter covers them."""
    model = _tiny(ParallelContext(attn_impl="pallas",
                                  reduce_dgrad_in_op=inop), zero1=zero1)
    assert model.tess_weight_names() == {"wq", "wk", "wv", "wo", "w_up",
                                         "w_down", "w_gate"}
    table = dict(zip((n for n, _ in model.named_parameters()),
                     leaf_layouts(model)))
    dd = () if zero1 else ("data", "depth")
    want = {"embed": dd, "head": () if zero1 else ("data",),
            "ln_f": dd + ("row",), "blocks.0.ln1": dd + ("row",),
            "blocks.0.wq": () if inop else dd,
            "blocks.1.w_down": () if inop else dd}
    for name, axes in want.items():
        spec, got, lay, in_op = table[name]
        assert got == axes, name
        assert in_op == (inop and name.split(".")[-1] in
                         model.tess_weight_names()), name
        assert lay.zaxes == tuple(a for a in ("data", "depth")
                                  if a not in {x for d in spec for x in d})


def test_one_rank_zero1_is_the_replicated_update():
    """At one rank each ZeRO-1 slice is the whole leaf (zn 1): two steps
    give the replicated optimizer's losses, and its grad norms, params and
    moments within fp32 rounding (the ZeRO norm sums squares per slice,
    the replicated one takes the norm of the leaves' norms)."""
    tok = np.random.default_rng(2).integers(0, 503, (4, 16))
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}
    shape = ShapeSpec("t", 16, 4, "train")
    out = []
    for zero1 in (False, True):
        model = _tiny(zero1=zero1, lr=0.1)
        step, opt = build_train_step(model, shape), init_opt_state(model)
        metrics = [step(opt, batch) for _ in range(2)]
        out.append((metrics, params_to_numpy(model),
                    [m.reshape(-1) for m in opt["m"]]))
    (m0, p0, s0), (m1, p1, s1) = out
    assert [m["loss"] for m in m0] == [m["loss"] for m in m1]
    np.testing.assert_allclose([m["grad_norm"] for m in m1],
                               [m["grad_norm"] for m in m0], rtol=1e-6)
    for (name, a), (_, b) in zip(_items(p0), _items(p1)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)
    for a, b in zip(s0, s1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("flag", [["--pipe", "2"], ["--seq-shards", "2"],
                                  ["--arch", "mamba2-1.3b", "--ckpt",
                                   "ckpt"],
                                  ["--arch", "mamba2-1.3b", "--fault-plan",
                                   "train.grads@1:nan"]])
def test_launcher_refuses_unported_flags(flag):
    """The pipeline and sequence-shard flags raise; checkpoints and fault
    plans run, but not past the ssm family's refusal to train (before the
    checkpoint directory is made)."""
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A, item A3"):
        main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
              "--steps", "1"] + flag)
    assert not pathlib.Path("ckpt").exists()


def test_unported_gradient_formats_refuse():
    """Both of the reference's gradient wire formats are ported; any other
    is refused, and ssm training stays refused (ROADMAP A3)."""
    assert RunConfig(grad_compression="bf16").grad_compression == "bf16"
    assert _tiny(ParallelContext(dgrad_rs_bf16=True)).ctx.dgrad_rs_bf16
    with pytest.raises(ValueError, match="grad_compression"):
        RunConfig(grad_compression="fp8")
    ssm = build_model(get_reduced("mamba2-1.3b").model, ParallelContext(),
                      RunConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item A3: ssm training"):
        build_train_step(ssm, ShapeSpec("t", 16, 2, "train"))
