"""Training across ranks: the parts the CPU checks here without a spawn.

The multi-rank parity itself runs in the torchrun spawns of
``tests/test_torch_summa.py`` (``mdchecks train_parity`` on [2, 2, 1],
[2, 2, 2] and data 2 x depth 2, and the collectives' backward in
``mdchecks collectives``), held to the port's one-rank step, which
``tests/test_torch_train.py`` holds to the reference's
``jax.value_and_grad``.  Here:

(c) the train step's leaf table: which leaves the op reduces, and the axes
    each leaf's gradient is psum'd over, replicated and under ZeRO-1;
(d) at one rank ZeRO-1 (every slice the whole leaf) runs the replicated
    optimizer's update bit for bit;
(e) the refusals that stay name ROADMAP A3, or, for the ssm family, give
    the reference's reasons; ssm training with ``use_pallas=True`` is
    refused.

(a) and (b), the layout tables, are in ``tests/test_torch_train_layouts.py``.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.convert import params_to_numpy
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model, get_reduced
from repro_torch.runtime.steps import (build_train_step, init_opt_state,
                                       leaf_layouts)


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


def _items(tree):
    top = [(k, v) for k, v in tree.items() if k != "blocks"]
    return top + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


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
                                   "ckpt", "--pipe", "2"],
                                  ["--arch", "mamba2-1.3b", "--fault-plan",
                                   "train.grads@1:nan", "--ckpt", "ckpt",
                                   "--seq-shards", "2"]])
def test_launcher_refuses_unported_flags(flag):
    """The pipeline and sequence-shard flags raise before the checkpoint
    directory is made: ROADMAP A3 for the dense family, and for the ssm
    family, which trains with checkpoints and fault plans, the reference's
    reasons (its MambaLM has neither)."""
    from repro_torch.launch.train import main
    match = ("ROADMAP Queue A, item A3" if "mamba2-1.3b" not in flag else
             "supports_pipeline=False" if "--pipe" in flag else
             "supports_seq_shard=False")
    with pytest.raises(NotImplementedError, match=match):
        main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
              "--steps", "1"] + flag)
    assert not pathlib.Path("ckpt").exists()


def test_unported_gradient_formats_refuse():
    """Both of the reference's gradient wire formats are ported; any other
    is refused.  ssm training builds its step, except with
    ``use_pallas=True``: the SSD kernel has no backward, as the
    reference's has none."""
    assert RunConfig(grad_compression="bf16").grad_compression == "bf16"
    assert _tiny(ParallelContext(dgrad_rs_bf16=True)).ctx.dgrad_rs_bf16
    with pytest.raises(ValueError, match="grad_compression"):
        RunConfig(grad_compression="fp8")
    shape = ShapeSpec("t", 16, 2, "train")
    for use_pallas in (False, True):
        ssm = build_model(get_reduced("mamba2-1.3b").model,
                          ParallelContext(), RunConfig(use_pallas=use_pallas),
                          device="cpu")
        if not use_pallas:
            build_train_step(ssm, shape)
            continue
        with pytest.raises(NotImplementedError, match="no custom_vjp"):
            build_train_step(ssm, shape)
