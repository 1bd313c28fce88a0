"""remat="dots" in the port (``core/remat.py``, ``DenseLM.loss``) against
the JAX package's ``dots_with_no_batch_dims_saveable`` policy, on the CPU.

(a) the loss and every gradient leaf against the reference's
    ``jax.value_and_grad`` under remat="dots" at one device (fp32: the
    loss within 1e-5, each leaf within 1e-5 of its largest |gradient|, as
    ``tests/test_torch_train.py`` holds remat="none");
(b) bit-equal to the port's own remat="none" and "full" (every kernel's
    plain version is deterministic, and dots hands back the very values);
(c) the saved set: the products the record context keeps for a block,
    plus the block input the checkpoint keeps, have the shapes that
    ``jax.ad_checkpoint.print_saved_residuals`` lists for one layer of the
    reference (seven with a GLU, six without), on both op sets;
(d) each product is computed once per layer in the forward and never in
    the recompute (``core/summa.py::_forward`` and
    ``core/ops.py::_local_mm`` counted; the plain versions add nothing to
    ``kernels.ops.LAUNCHES``), where remat="full" computes each twice.
"""
import dataclasses
import re

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.collectives import shard_map
from repro.core.mesh import logical_mesh
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.runtime.steps import batch_abstract, make_plan
from repro_torch.configs.base import RunConfig
from repro_torch.convert import grads_to_numpy, params_from_jax
from repro_torch.core import ops as port_ops
from repro_torch.core import remat, summa
from repro_torch.core.api import ParallelContext
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, get_reduced

B, S = 2, 16
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


def _cfgs(arch, head_dim=None):
    """The reference's and the port's reduced config of ``arch`` (both at
    ``head_dim`` when given, so q's width differs from d_model's)."""
    kw = {} if head_dim is None else dict(head_dim=head_dim)
    return (dataclasses.replace(ref_reduced(arch).model, **kw),
            dataclasses.replace(get_reduced(arch).model, **kw))


def _ref(cfg, mode, remat_mode):
    ctx = RefCtx(mode=mode, attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8, loss_chunk=8,
                 remat=remat_mode)
    model = ref_build(cfg, ctx, run)
    ops = ref_make_ops(ctx, make_plan(ctx, ShapeSpec("t", S, B, "train")))
    _, bspecs = batch_abstract(ops, ShapeSpec("t", S, B, "train"), ctx)
    return model, ops, bspecs, logical_mesh(ctx)


def _port(cfg, mode, remat_mode, params=None, compute="float32"):
    run = RunConfig(param_dtype="float32", compute_dtype=compute,
                    attn_impl="pallas", loss_chunk=8, remat=remat_mode)
    model = build_model(cfg, ParallelContext(mode=mode, attn_impl="pallas"),
                        run, device="cpu", seed=3)
    return model if params is None else params_from_jax(params, model)


def _batch(vocab):
    tok = np.random.default_rng(5).integers(0, vocab, (B, S)).astype(
        np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def _leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


@pytest.mark.parametrize("arch,mode", [("yi-6b", "tesseract"),
                                       ("smollm-360m", "tesseract"),
                                       ("nemotron-4-340b", "tesseract"),
                                       ("yi-6b", "megatron1d")])
def test_dots_loss_and_grads_match_reference(arch, mode):
    """(a) DenseLM.loss under remat="dots" and every gradient leaf vs
    jax.value_and_grad of the reference's loss under remat="dots"."""
    rcfg, pcfg = _cfgs(arch)
    model, ops, bspecs, mesh = _ref(rcfg, mode, "dots")
    params = model.init(jax.random.PRNGKey(0))
    specs = model.specs(ops)
    batch = _batch(rcfg.vocab_size)
    fn = shard_map(jax.value_and_grad(lambda p, b: model.loss(p, b, ops)),
                   mesh=mesh, in_specs=(specs, bspecs),
                   out_specs=(P(), specs))
    want_loss, want_grads = jax.jit(fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(pcfg, mode, "dots", jax.tree.map(np.asarray, params))
    loss = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    got = dict(_leaves(grads_to_numpy(port)))
    for name, w in _leaves(jax.tree.map(np.asarray, want_grads)):
        err = float(np.abs(got[name] - w).max())
        assert err <= REL * float(np.abs(w).max()) + 1e-12, (name, err)


@pytest.mark.parametrize("mode,compute", [("tesseract", "float32"),
                                          ("tesseract", "bfloat16"),
                                          ("megatron1d", "float32"),
                                          ("megatron1d", "bfloat16")])
def test_dots_is_bit_equal_to_none_and_full(mode, compute):
    """(b) The same loss and gradients, bit for bit, under every remat."""
    _, cfg = _cfgs("yi-6b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    out = {}
    for r in ("none", "full", "dots"):
        model = _port(cfg, mode, r, compute=compute)
        loss = model.loss(batch)
        loss.backward()
        out[r] = [loss.detach()] + [p.grad for p in model.parameters()]
    for r in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out[r], out["none"])), r


_AVAL = re.compile(r"^(?:f32|float32)\[([0-9,]+)\]")


def _ref_saved_per_layer(cfg, mode, capsys):
    """The shapes ``print_saved_residuals`` lists for the reference's loss
    under remat="dots" that are stacked over the layers ([L, B, S, w]
    under the layer scan), one layer's each, as (token rows, width)."""
    model, ops, bspecs, mesh = _ref(cfg, mode, "dots")
    params = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
    fn = shard_map(lambda p, b: model.loss(p, b, ops), mesh=mesh,
                   in_specs=(model.specs(ops), bspecs), out_specs=P())
    capsys.readouterr()
    jax.ad_checkpoint.print_saved_residuals(fn, params, batch)
    shapes = []
    for line in capsys.readouterr().out.splitlines():
        m = _AVAL.match(line.strip())
        if m and "from the argument" not in line:
            dims = tuple(int(d) for d in m.group(1).split(","))
            if len(dims) == 4 and dims[:3] == (cfg.num_layers, B, S):
                shapes.append((B * S, dims[3]))
    return sorted(shapes)


@pytest.mark.parametrize("arch,mode", [("yi-6b", "tesseract"),
                                       ("yi-6b", "megatron1d"),
                                       ("nemotron-4-340b", "tesseract"),
                                       ("nemotron-4-340b", "megatron1d")])
def test_dots_saved_set_matches_reference(arch, mode, capsys, monkeypatch):
    """(c) The per-layer saved set: the block input and the outputs of q,
    k, v, the attention output projection, and gate and up (up alone
    without a GLU), not the down projection's.  head_dim 24 gives q a
    width of its own, so each shape names one tensor."""
    rcfg, pcfg = _cfgs(arch, head_dim=24)
    want = _ref_saved_per_layer(rcfg, mode, capsys)
    assert len(want) == (7 if pcfg.mlp_glu else 6)
    stashes, inputs = [], []

    class Recorded(remat.DotsStash):
        def __init__(self):
            super().__init__()
            stashes.append(self)

    real = transformer.checkpoint

    def keeping(fn, blk, x, **kw):
        inputs.append(tuple(x.shape))
        return real(fn, blk, x, **kw)

    monkeypatch.setattr(remat, "DotsStash", Recorded)
    monkeypatch.setattr(transformer, "checkpoint", keeping)
    model = _port(pcfg, mode, "dots")
    model.loss({k: torch.from_numpy(v)
                for k, v in _batch(pcfg.vocab_size).items()})
    assert len(stashes) == len(inputs) == pcfg.num_layers
    for stash, x in zip(stashes, inputs):
        # (token rows, width): a product keeps its [B * S, w] output
        got = sorted([tuple(t.shape) for t in stash.kept()]
                     + [(x[0] * x[1], x[2])])
        assert got == want
        assert len(stash.outs) == len(stash.kept()) + 1   # down: shape only


@pytest.mark.parametrize("mode", ["tesseract", "megatron1d"])
def test_products_are_not_recomputed(mode, monkeypatch):
    """(d) Seven products per layer in the forward; under remat="dots" none
    in the backward, under "full" all seven again."""
    _, cfg = _cfgs("yi-6b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    count = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            count[0] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(summa, "_forward", counting(summa._forward))
    monkeypatch.setattr(port_ops, "_local_mm", counting(port_ops._local_mm))
    per_layer = 7 * cfg.num_layers
    for r, again in (("dots", 0), ("full", per_layer)):
        model = _port(cfg, mode, r)
        count[0] = 0
        loss = model.loss(batch)
        assert count[0] == per_layer, r
        loss.backward()
        assert count[0] == per_layer + again, r


def test_remat_must_be_none_full_or_dots():
    assert RunConfig(remat="dots").remat == "dots"
    with pytest.raises(ValueError, match="remat must be"):
        RunConfig(remat="selective")


def test_launcher_takes_optimizer_and_remat(capsys):
    """``launch/train.py``'s ``main`` takes both as keywords (the
    reference's launcher has no flag for them) and names them in its
    summary line."""
    from repro_torch.launch.train import main
    res = main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                "--steps", "2", "--seq", "16", "--batch", "2"],
               optimizer="lamb", remat="dots")
    assert len(res.losses) == 2 and np.all(np.isfinite(res.losses))
    assert "optimizer=lamb remat=dots" in capsys.readouterr().out
