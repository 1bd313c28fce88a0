"""The port's ssm training (``MambaLM.loss`` and the train path around it)
against the JAX package's, on the CPU.

Reduced mamba2 (2 layers), fp32, the reference's params from
``model.init`` crossed through numpy with A_log moved to -5..-3 over the
heads (the init's 0 decays the state by ~0.5 a token, which leaves nothing
of one chunk's state in the next chunk's outputs, so a broken inter-chunk
gradient would not show).  The reference runs its einsum path
(``use_pallas=False``), the only one ``jax.grad`` goes through: its
``ssd_intra`` has no ``custom_vjp``.  Its oracles are computed once for
the module (``ref``).

(a) the loss within 1e-5 and every gradient leaf within 1e-5 of that
    leaf's max, against ``jax.value_and_grad`` of the reference's
    ``MambaLM.loss``, at seq 32 (four chunks of 8) and 20 (the chunk
    shrinks to 5);
(b) remat "full" and "dots" bit-equal to "none"; dots keeps the block
    input and the outputs of w_z, w_x, w_B, w_C and w_dt, the shapes
    ``jax.ad_checkpoint.print_saved_residuals`` lists for the reference's
    block, and no product runs again in the recompute;
(c) two AdamW steps and one LAMB step through ``build_train_step``
    against the reference's step (losses and grad norms within 1e-5,
    params within 1e-5 of each leaf's max plus 1e-3 of the summed learning
    rates, as ``tests/test_torch_train.py`` holds the dense path); the
    ssm leaves' sync axes; accumulation and the loss-scale back-off;
(d) training with ``use_pallas=True`` refused at build time, and
    ``ssd_intra`` refusing a gradient on the CPU;
(e) a 3-step ``train()`` whose checkpoint the reference restores bit for
    bit, the reference's checkpoint restored by the port bit for bit (one
    written under [2, 2, 1] too), and a NaN fault, a damaged checkpoint
    and a crash that leave the trajectory bit-identical;
(f) the launcher on the CPU, and its refusals for the ssm family.

The mesh runs (every layout of ``tests/test_torch_summa.py``'s spawns, and
the refusal on Megatron's) are ``mdchecks train_parity``'s mamba2 case.
"""
import contextlib
import io

import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint.ckpt import CheckpointManager as RefCkpt
from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.collectives import shard_map
from repro.core.mesh import logical_mesh
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime.steps import batch_abstract, make_plan
from repro.runtime.steps import build_train_step as ref_build_train_step
from repro_torch.checkpoint.ckpt import CheckpointManager, load_state
from repro_torch.configs.base import RunConfig
from repro_torch.convert import (grads_to_numpy, params_from_jax,
                                 params_to_numpy)
from repro_torch.core import ops as port_ops
from repro_torch.core import remat, summa
from repro_torch.core.api import ParallelContext
from repro_torch.kernels import ssd as kssd
from repro_torch.models import transformer
from repro_torch.models.registry import build_model, get_reduced
from repro_torch.runtime.steps import (build_train_step, init_opt_state,
                                       leaf_layouts)
from repro_torch.runtime.train_loop import train

ARCH = "mamba2-1.3b"
B, SEQ, SEQ_SHRUNK = 4, 32, 20       # chunk 8: Q 8 at 32, Q 5 at 20
LR = 0.1                             # large enough that a step moves
REL = 1e-5
SHAPE = ShapeSpec("t", SEQ, B, "train")
PRODUCTS = 6                         # per layer: 4 SUMMA, 2 local (B, C)


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


def _batch(seq, step=0):
    tok = np.random.default_rng((5, seq, step)).integers(
        0, ref_reduced(ARCH).model.vocab_size, (B, seq)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def _tbatch(seq, step=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seq, step).items()}


def _ref_run(**kw):
    return RefRun(param_dtype="float32", compute_dtype="float32",
                  attn_impl="jnp", loss_chunk=8, lr=LR, use_pallas=False,
                  **kw)


def _compiled(jitted, *args):
    """``jitted`` compiled for ``args`` with LLVM's optimisation off: each
    oracle runs a few times on tiny shapes, and optimising its code costs
    more CPU than the runs (the same HLO; the fp32 results may differ
    by rounding, far inside the tolerances)."""
    return jitted.lower(*args).compile({"xla_backend_optimization_level": 0})


def _leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


def _close(got, want, what, atol=1e-12):
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        w = np.asarray(w)
        err = float(np.abs(got[name] - w).max())
        assert err <= REL * float(np.abs(w).max()) + atol, (what, name, err)


def _equal(got, want, what):
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        np.testing.assert_array_equal(got[name], np.asarray(w),
                                      err_msg=f"{what} {name}")


class _Ref:
    """The reference's oracles, each computed once, when first asked."""

    def __init__(self):
        self.cfg = ref_reduced(ARCH).model
        self.ctx = RefCtx(mode="tesseract", attn_impl="jnp")
        self.mesh = logical_mesh(self.ctx)
        self.model = ref_build(self.cfg, self.ctx, _ref_run())
        tree = jax.tree.map(np.asarray,
                            self.model.init(jax.random.PRNGKey(0)))
        H = self.cfg.ssm_expand * self.cfg.d_model // self.cfg.ssm_head_dim
        tree["blocks"]["A_log"] = np.broadcast_to(
            np.linspace(-5.0, -3.0, H, dtype=np.float32),
            tree["blocks"]["A_log"].shape).copy()
        self.init = tree
        self._memo = {}

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def _ops(self, seq):
        shape = ShapeSpec("t", seq, B, "train")
        ops = ref_make_ops(self.ctx, make_plan(self.ctx, shape))
        return ops, batch_abstract(ops, shape, self.ctx)[1]

    def loss_and_grads(self, seq):
        def run():
            ops, bspecs = self._ops(seq)
            specs = self.model.specs(ops)
            fn = shard_map(jax.value_and_grad(
                lambda p, b: self.model.loss(p, b, ops)), mesh=self.mesh,
                in_specs=(specs, bspecs), out_specs=(P(), specs))
            batch = jax.tree.map(jnp.asarray, _batch(seq))
            loss, grads = _compiled(jax.jit(fn), self.init, batch)(
                self.init, batch)
            return float(loss), jax.tree.map(np.asarray, grads)
        return self._once(("grad", seq), run)

    def saved_per_layer(self):
        """(token rows, width) of each residual that
        ``print_saved_residuals`` lists stacked over the layers ([L, B, S,
        w]) for the loss under remat="dots"."""
        def run():
            model = ref_build(self.cfg, self.ctx, _ref_run(remat="dots"))
            ops, bspecs = self._ops(SEQ)
            fn = shard_map(lambda p, b: model.loss(p, b, ops),
                           mesh=self.mesh, in_specs=(model.specs(ops),
                                                     bspecs), out_specs=P())
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jax.ad_checkpoint.print_saved_residuals(
                    fn, self.init, jax.tree.map(jnp.asarray, _batch(SEQ)))
            shapes = []
            for line in buf.getvalue().splitlines():
                head = line.strip().split(" ")[0]
                if (head.startswith("f32[") and "from the argument"
                        not in line):
                    dims = tuple(int(d) for d in head[4:-1].split(","))
                    if len(dims) == 4 and dims[:3] == (
                            self.cfg.num_layers, B, SEQ):
                        shapes.append((B * SEQ, dims[3]))
            return sorted(shapes)
        return self._once("saved", run)

    def bundle(self, optimizer):
        return self._once(("bundle", optimizer), lambda: ref_build_train_step(
            ref_build(self.cfg, self.ctx, _ref_run(optimizer=optimizer)),
            self.mesh, SHAPE))

    def steps(self, optimizer, n):
        """[(params, opt, metrics)] after each of n steps from ``init`` on
        the batches of steps 0..n-1."""
        def run():
            params = jax.tree.map(jnp.asarray, self.init)
            opt = ref_adamw_init(params)
            batches = [jax.tree.map(jnp.asarray, _batch(SEQ, i))
                       for i in range(n)]
            fn = _compiled(self.bundle(optimizer).fn, params, opt,
                           batches[0])
            out = []
            for batch in batches:
                params, opt, m = fn(params, opt, batch)
                out.append((params, opt, {k: float(v) for k, v in
                                          m.items()}))
            return out
        return self._once(("steps", optimizer, n), run)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _port(ref, **run_kw):
    run = RunConfig(**{"param_dtype": "float32", "compute_dtype": "float32",
                       "loss_chunk": 8, "lr": LR, **run_kw})
    model = build_model(get_reduced(ARCH).model, ParallelContext(), run,
                        device="cpu")
    return params_from_jax(ref.init, model)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("seq", [SEQ, SEQ_SHRUNK])
def test_loss_and_grads_match_reference(ref, seq):
    """MambaLM.loss and every gradient leaf against jax.value_and_grad of
    the reference's loss on its einsum path."""
    want_loss, want_grads = ref.loss_and_grads(seq)
    port = _port(ref)
    loss = port.loss(_tbatch(seq))
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5
    _close(grads_to_numpy(port), want_grads, "grad")


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_remat_full_and_dots_are_bit_equal_to_none(ref, compute):
    out = {}
    for r in ("none", "full", "dots"):
        model = _port(ref, compute_dtype=compute, remat=r)
        loss = model.loss(_tbatch(SEQ))
        loss.backward()
        out[r] = [loss.detach()] + [p.grad for p in model.parameters()]
    for r in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out[r], out["none"])), r


def test_dots_saved_set_matches_reference(ref, monkeypatch):
    """Per layer: the block input and the outputs of w_z, w_x, w_B, w_C and
    w_dt (w_out's only as its shape), the shapes the reference saves."""
    want = ref.saved_per_layer()
    assert len(want) == 6
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
    model = _port(ref, remat="dots")
    model.loss(_tbatch(SEQ))
    assert len(stashes) == len(inputs) == model.cfg.num_layers
    for stash, x in zip(stashes, inputs):
        got = sorted([tuple(t.shape) for t in stash.kept()]
                     + [(x[0] * x[1], x[2])])
        assert got == want
        assert len(stash.outs) == len(stash.kept()) + 1   # w_out: shape


def test_products_are_not_recomputed(ref, monkeypatch):
    """Six products per layer in the forward; under remat="dots" none in
    the backward, under "full" all six again."""
    count = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            count[0] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(summa, "_forward", counting(summa._forward))
    monkeypatch.setattr(port_ops, "_local_mm", counting(port_ops._local_mm))
    for r, again in (("dots", 0), ("full", 1)):
        model = _port(ref, remat=r)
        per_layer = PRODUCTS * model.cfg.num_layers
        count[0] = 0
        loss = model.loss(_tbatch(SEQ))
        assert count[0] == per_layer, r
        loss.backward()
        assert count[0] == per_layer * (1 + again), r


# ------------------------------------------------------------------ (c)

def _port_steps(model, n, **kw):
    step = build_train_step(model, SHAPE, **kw)
    opt = init_opt_state(model)
    return [step(opt, _tbatch(SEQ, i)) for i in range(n)], opt


@pytest.mark.parametrize("optimizer,n", [("adamw", 2), ("lamb", 1)])
def test_train_steps_match_reference(ref, optimizer, n):
    want = ref.steps(optimizer, n)
    port = _port(ref, optimizer=optimizer)
    metrics, _ = _port_steps(port, n)
    for got, (_, _, m) in zip(metrics, want):
        assert got["skipped"] == m["skipped"] == 0.0
        for k in ("loss", "grad_norm", "lr"):
            assert got[k] == pytest.approx(m[k], rel=REL), k
    lr_sum = sum(m["lr"] for _, _, m in want)
    _close(params_to_numpy(port), jax.tree.map(np.asarray, want[-1][0]),
           "param", atol=1e-3 * lr_sum)


def test_accumulation_and_loss_scale_backoff(ref):
    """Two microbatches give the one-batch step's metrics and params; an
    overflowing loss scale is halved until the step goes through, and the
    run then matches an unscaled one."""
    one, _ = _port_steps(_port(ref), 1)
    acc_model = _port(ref)
    two, _ = _port_steps(acc_model, 1, accum_steps=2)
    for k in ("loss", "grad_norm"):
        assert two[0][k] == pytest.approx(one[0][k], rel=REL), k
    scaled = train(_port(ref, loss_scale=2.0 ** 126, nan_skip_limit=0),
                   SHAPE, steps=2, log_every=0)
    assert scaled.loss_scale_backoffs >= 1
    assert scaled.nan_skips == scaled.loss_scale_backoffs
    plain = train(_port(ref), SHAPE, steps=2, log_every=0)
    np.testing.assert_allclose(scaled.losses, plain.losses, rtol=REL)


def test_ssm_leaves_sync_over_their_replicated_axes(ref):
    """``leaf_layouts`` on the ssm leaves: the SUMMA weights reduced in the
    op sync over nothing; every other leaf over the axes its spec leaves
    out (conv_B / conv_C replicated everywhere, w_B / w_C, the head
    vectors and the norms over (data, depth, row))."""
    model = _port(ref)
    want = {"w_z": (), "w_x": (), "w_dt": (), "w_out": (),
            "conv_B": ("data", "depth", "row", "col"),
            "conv_C": ("data", "depth", "row", "col"),
            "conv_x": ("data", "depth", "row"),
            "w_B": ("data", "depth", "row"), "w_C": ("data", "depth", "row"),
            "dt_bias": ("data", "depth", "row"),
            "A_log": ("data", "depth", "row"),
            "Dskip": ("data", "depth", "row"),
            "ln": ("data", "depth", "row"), "ln_y": ("data", "depth", "row"),
            "embed": ("data", "depth"), "head": ("data",),
            "ln_f": ("data", "depth", "row")}
    seen = set()
    for (name, _), (_, axes, _, in_op) in zip(model.named_parameters(),
                                              leaf_layouts(model)):
        base = name.rsplit(".", 1)[-1]
        assert axes == want[base], (name, axes)
        assert in_op == (base in model.tess_weight_names()), name
        seen.add(base)
    assert seen == set(want)


# ------------------------------------------------------------------ (d)

def test_use_pallas_training_is_refused(ref):
    model = _port(ref, use_pallas=True)
    with pytest.raises(NotImplementedError, match="no custom_vjp"):
        build_train_step(model, SHAPE)
    with pytest.raises(NotImplementedError, match="no custom_vjp"):
        train(model, SHAPE, steps=1, log_every=0)


def test_ssd_intra_refuses_a_gradient_on_the_cpu():
    """Under grad, on the CPU as on the card; without grad (the serve
    path) it returns the plain version's values."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 2, 4, 2, 16), (1, 2, 4, 2), (1, 2, 4, 8),
                      (1, 2, 4, 8))]
    args[1] = -args[1].abs()
    y, s = kssd.ssd_intra(*args)
    wy, ws = kssd.ssd_intra_plain(*args)
    assert torch.equal(y, wy) and torch.equal(s, ws)
    args[0].requires_grad_(True)
    with pytest.raises(kssd.NoGradError, match="Linearization failed"):
        kssd.ssd_intra(*args)
    with torch.no_grad():
        kssd.ssd_intra(*args)


# ------------------------------------------------------------------ (e)

def _ref_state(ref, optimizer="adamw"):
    b = ref.bundle(optimizer)
    abs_p, abs_o, _ = b.abstract_inputs
    return ({"params": abs_p, "opt": abs_o},
            {"params": b.in_shardings[0], "opt": b.in_shardings[1]})


def test_port_checkpoint_restores_in_reference(ref, tmp_path):
    """Three steps of ``train`` checkpoint after the last; the reference's
    CheckpointManager restores the params bit for bit.  The same run with
    a NaN at step 1, that step's checkpoint damaged after its write and a
    crash before step 2 skips the NaN step's update once (retrying the
    same batch), falls back over the damaged checkpoint to step 0's,
    replays, and ends bit-identical to the clean run."""
    port = _port(ref)
    res = train(port, SHAPE, steps=3, log_every=0, ckpt_dir=tmp_path / "a")
    assert res.last_step == 2 and res.nan_skips == 0
    mgr = RefCkpt(tmp_path / "a")
    state = mgr.restore(mgr.latest_step(), *_ref_state(ref))
    _equal(params_to_numpy(port), jax.tree.map(np.asarray, state["params"]),
           "params")
    assert int(state["opt"]["step"]) == 3
    crashed = []

    def crash(step):
        if step == 2 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected crash before step 2")

    faulty = _port(ref, fault_plan="train.grads@1:nan;"
                                   "ckpt.write@1:corrupt(0,bit_flip)")
    fres = train(faulty, SHAPE, steps=3, log_every=0,
                 ckpt_dir=tmp_path / "b", ckpt_every=1, fault_hook=crash)
    assert (fres.nan_skips, fres.restarts, fres.ckpt_fallbacks) == (1, 1, 1)
    assert fres.fault_log == [("train.grads", 1, "nan"),
                              ("ckpt.write", 1, "corrupt")]
    assert fres.loss_steps == [0, 1, 1, 2]
    assert dict(zip(fres.loss_steps, fres.losses)) == dict(
        enumerate(res.losses))
    _equal(params_to_numpy(faulty), params_to_numpy(port), "faulted run")


def test_reference_checkpoint_restores_in_port(ref, tmp_path):
    """The reference's state after two AdamW steps, saved by its
    CheckpointManager as its train loop saves it, loads into the port
    bit for bit (params, and the optimizer state that steps on).  And a
    reference state written under [2, 2, 1] (its embed and head padded to
    that layout's vocab multiple, 252 rows for 251) restores onto one rank,
    cut to the logical shape: the reshard-on-restore of the ssm leaves."""
    params, opt, _ = ref.steps("adamw", 2)[-1]
    mgr = RefCkpt(tmp_path / "a")
    mgr.save(1, {"params": params, "opt": opt}, blocking=True)
    mgr.wait()
    port = _port(ref)
    leaves, last = CheckpointManager(tmp_path / "a").restore_latest()
    assert last == 1
    popt = load_state(port, leaves)
    _equal(params_to_numpy(port), jax.tree.map(np.asarray, params),
           "params")
    assert popt["step"] == int(opt["step"]) == 2
    names = [n for n, _ in port.named_parameters()]
    for group in ("m", "v"):
        got = {n: t.numpy() for n, t in zip(names, popt[group])}
        for name, w in _leaves(jax.tree.map(np.asarray, opt[group])):
            if name.startswith("blocks."):
                for i in range(port.cfg.num_layers):
                    np.testing.assert_array_equal(
                        got[f"blocks.{i}.{name[7:]}"], w[i])
            else:
                np.testing.assert_array_equal(got[name], w)
    wide = ref_build(ref.cfg, RefCtx(mode="tesseract", rows=2, cols=2),
                     _ref_run()).init(jax.random.PRNGKey(1))
    assert wide["embed"].shape[0] == ref.cfg.vocab_size + 1
    mgr = RefCkpt(tmp_path / "b")
    mgr.save(0, {"params": wide, "opt": ref_adamw_init(wide)},
             blocking=True)
    mgr.wait()
    load_state(port, CheckpointManager(tmp_path / "b").restore_latest()[0])
    cut = jax.tree.map(np.asarray, wide)
    for name in ("embed", "head"):
        cut[name] = cut[name][:ref.cfg.vocab_size]
    _equal(params_to_numpy(port), cut, "params from [2, 2, 1]")


# ------------------------------------------------------------------ (f)

def test_train_launcher_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch.train import main
    res = main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                "2", "--seq", "16", "--batch", "2"], remat="dots")
    assert len(res.losses) == 2 and np.all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "final loss" in out and "SSD einsums" in out


@pytest.mark.parametrize("flags,match", [
    (["--mode", "megatron1d", "--cols", "1"],
     "ssm arch runs in tesseract modes"),
    (["--seq-shards", "2"], "supports_seq_shard=False"),
    (["--pipe", "2"], "supports_pipeline=False")])
def test_train_launcher_refuses_as_the_reference(flags, match):
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match=match):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
              "1", *flags])
