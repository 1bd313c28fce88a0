"""The port's fault-tolerant training loop against the JAX package's, on
one CPU rank.

(a) The prefetcher and the straggler monitor on the cases of
    ``tests/test_resilience.py``.
(b) Training on reduced yi-6b (fp32, the reference's init): a crash
    (``fault_hook``), an injected NaN and a damaged checkpoint each
    continue with the reference's uninterrupted losses within 1e-5, as do
    the restart-budget, persistent save failure and device loss cases of
    ``tests/test_train_loop.py`` and ``tests/test_chaos.py``; and a
    checkpoint written by either package restores in the other, whose
    continued losses equal the reference's uninterrupted run's within
    1e-5.

The fault plans, checkpoint format and corruption are held to the
reference's in ``tests/test_torch_faults.py``; ZeRO-1's reslicing and
``replan`` in ``tests/test_torch_reslice.py``.
"""
import shutil
import time

import jax
import numpy as np
import pytest
import torch

import repro.runtime.train_loop as ref_loop
from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.data.pipeline import Prefetcher, SyntheticLMStream
from repro_torch.models.registry import build_model
from repro_torch.runtime import faults
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.runtime.train_loop import train

SHAPE = ShapeSpec("t", seq_len=16, global_batch=4, kind="train")
STEPS = 8
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


class _FailingStream(SyntheticLMStream):
    def __init__(self, fail_at, *a):
        super().__init__(*a)
        self.fail_at = fail_at

    def batch(self, step):
        if step == self.fail_at:
            raise ValueError(f"injected producer failure at step {step}")
        return super().batch(step)


def test_prefetcher_propagates_producer_error_promptly():
    pf = Prefetcher(_FailingStream(2, 50, 2, 4), "cpu")
    try:
        assert pf.next(timeout=30)[0] == 0
        assert pf.next(timeout=30)[0] == 1
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="injected producer failure"):
            pf.next(timeout=30)
        assert time.monotonic() - t0 < 10
        with pytest.raises(ValueError, match="injected producer failure"):
            pf.next(timeout=30)
    finally:
        pf.stop()


def test_prefetcher_orders_steps_and_stops():
    stream = SyntheticLMStream(50, 2, 4)
    pf = Prefetcher(stream, "cpu", start_step=3)
    try:
        for want in (3, 4, 5):
            step, dev = pf.next(timeout=30)
            assert step == want and set(dev) == {"tokens", "labels"}
            np.testing.assert_array_equal(dev["tokens"].numpy(),
                                          stream.batch(want)["tokens"])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_prefetcher_timeout_is_a_timeout_error():
    class _Hang(SyntheticLMStream):
        def batch(self, step):
            time.sleep(3600)

    pf = Prefetcher(_Hang(50, 2, 4), "cpu")
    try:
        with pytest.raises(TimeoutError):
            pf.next(timeout=0.5)
    finally:
        pf._stop.set()   # the sleeping thread is a daemon


def test_straggler_quiet_fleet_not_flagged():
    mon = StragglerMonitor(min_samples=3)
    rng = np.random.default_rng(0)
    for h in range(16):
        for _ in range(5):
            mon.record(h, 0.100 + rng.normal(0, 1e-6))
    assert mon.stragglers() == []


def test_straggler_real_outlier_flagged():
    mon = StragglerMonitor(min_samples=3)
    for h in range(8):
        for _ in range(5):
            mon.record(h, 0.100 + 1e-4 * h)
    for _ in range(5):
        mon.record(99, 0.250)
    assert mon.stragglers() == [99]


def test_straggler_small_absolute_skew_not_flagged():
    mon = StragglerMonitor(min_samples=3)
    for h in range(8):
        for _ in range(5):
            mon.record(h, 1.000)
    for _ in range(5):
        mon.record(9, 1.002)
    assert mon.stragglers() == []


# ------------------------------------------------------------ train

REF_CTX = RefCtx(mode="tesseract", attn_impl="jnp")
REF_RUN = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", loss_chunk=16, q_chunk=8, kv_chunk=8,
                 lr=1e-3)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's uninterrupted run (losses; its checkpoints after
    steps 3 and 7 in ``ckpt``) and its init params."""
    arch = get_reduced("yi-6b")
    model = ref_build(arch.model, REF_CTX, REF_RUN)
    mesh = logical_mesh(REF_CTX)
    ckpt = tmp_path_factory.mktemp("ref_ckpt")
    res = ref_loop.train(model, mesh, SHAPE, steps=STEPS, log_every=0,
                         ckpt_dir=ckpt, ckpt_every=4)
    init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    return dict(losses=res.losses, init=init, model=model, mesh=mesh,
                ckpt=ckpt)


def _port(ref_run, **run_kw):
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas", loss_chunk=16, lr=1e-3, **run_kw)
    model = build_model(get_reduced("yi-6b").model,
                        ParallelContext(attn_impl="pallas"), run,
                        device="cpu")
    return params_from_jax(ref_run["init"], model)


def _by_step(res):
    """The last loss of each step (a replayed step's replay)."""
    return dict(zip(res.loss_steps, res.losses))


def _crash_at(*steps):
    fired = set()

    def hook(step):
        if step in steps and step not in fired:
            fired.add(step)
            raise RuntimeError(f"injected crash at {step}")
    return hook


def test_crash_restart_continues_reference_losses(ref_run, tmp_path):
    res = train(_port(ref_run), SHAPE, steps=STEPS, ckpt_dir=tmp_path,
                ckpt_every=4, log_every=0, fault_hook=_crash_at(5))
    assert res.restarts == 1 and res.ckpt_fallbacks == 0
    assert res.loss_steps == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    got = _by_step(res)
    np.testing.assert_allclose([got[s] for s in range(STEPS)],
                               ref_run["losses"], rtol=REL)


def test_nan_and_corrupt_checkpoint_continue_reference_losses(ref_run,
                                                              tmp_path):
    """A NaN step retried, the newest checkpoint damaged, then a crash:
    the loop falls back to the older checkpoint and rejoins the
    reference's losses."""
    model = _port(ref_run, fault_plan="train.grads@3:nan;ckpt.write@3:"
                  "corrupt(0,bit_flip)", fault_seed=7)
    res = train(model, SHAPE, steps=STEPS, ckpt_dir=tmp_path, ckpt_every=2,
                log_every=0, fault_hook=_crash_at(5))
    assert (res.nan_skips, res.restarts, res.ckpt_fallbacks) == (1, 1, 1)
    assert res.fault_log == [("train.grads", 3, "nan"),
                             ("ckpt.write", 3, "corrupt")]
    assert res.loss_steps[-6:] == [2, 3, 4, 5, 6, 7]
    got = _by_step(res)
    np.testing.assert_allclose([got[s] for s in range(STEPS)],
                               ref_run["losses"], rtol=REL)


def test_persistent_nan_backs_off_then_restarts_bounded(ref_run):
    """NaN past the retry budget halves the loss scale; past every rung
    with no checkpoint and no restart budget it is a FloatingPointError."""
    res = train(_port(ref_run, fault_plan="train.grads@1:nanx4",
                      loss_scale=4.0, nan_skip_limit=1), SHAPE, steps=4,
                log_every=0)
    assert (res.nan_skips, res.loss_scale_backoffs) == (4, 2)
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    with pytest.raises(FloatingPointError):
        train(_port(ref_run, fault_plan="train.grads@1:nanx100",
                    nan_skip_limit=1), SHAPE, steps=4, log_every=0,
              max_restarts=0)


def test_restart_budget_exhausted(ref_run, tmp_path):
    def always(step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent failure"):
        train(_port(ref_run), SHAPE, steps=4, ckpt_dir=tmp_path,
              max_restarts=2, log_every=0, fault_hook=always)


def test_restart_budget_resets_after_checkpoint(ref_run, tmp_path):
    res = train(_port(ref_run), SHAPE, steps=STEPS, ckpt_dir=tmp_path,
                ckpt_every=2, log_every=0, max_restarts=1,
                fault_hook=_crash_at(2, 5, 7))
    assert res.restarts == 3 and res.last_step == STEPS - 1
    got = _by_step(res)
    np.testing.assert_allclose([got[s] for s in range(STEPS)],
                               ref_run["losses"], rtol=REL)


def test_persistent_save_failure_still_trips_budget(ref_run, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(
        CheckpointManager, "_write",
        lambda self, step, host, meta=None: (_ for _ in ()).throw(
            OSError("disk full (injected)")))
    fires = {"n": 0}

    def fault(step):
        if step == 3:
            fires["n"] += 1
            assert fires["n"] <= 10, "restart loop never tripped the budget"
            raise RuntimeError("recurring fault")

    with pytest.raises(RuntimeError):
        train(_port(ref_run), SHAPE, steps=6, ckpt_dir=tmp_path,
              ckpt_every=2, log_every=0, max_restarts=2, fault_hook=fault)
    assert fires["n"] == 3


def test_device_loss_bypasses_restart_budget(ref_run, tmp_path):
    model = _port(ref_run, fault_plan="train.step@2:device_loss(4)")
    with pytest.raises(faults.DeviceLostError) as ei:
        train(model, SHAPE, steps=6, ckpt_dir=tmp_path, ckpt_every=2,
              log_every=0, max_restarts=100)
    assert ei.value.n_surviving == 4
    assert ei.value.partial_result.last_step == 1


def test_reference_checkpoint_restores_in_port(ref_run, tmp_path):
    """The reference's checkpoint after step 3 restores in the port, which
    trains on: the reference's uninterrupted losses."""
    shutil.copytree(ref_run["ckpt"] / "step_00000003",
                    tmp_path / "step_00000003")
    res = train(_port(ref_run), SHAPE, steps=STEPS, ckpt_dir=tmp_path,
                log_every=0)
    assert res.loss_steps == list(range(4, STEPS))
    np.testing.assert_allclose(res.losses, ref_run["losses"][4:], rtol=REL)


def test_port_checkpoint_restores_in_reference(ref_run, tmp_path):
    """The port trains 4 steps and checkpoints; the reference's
    CheckpointManager.restore reads it (inside its train loop) and the
    reference trains on: its own uninterrupted losses."""
    train(_port(ref_run), SHAPE, steps=4, ckpt_dir=tmp_path, log_every=0)
    res = ref_loop.train(ref_run["model"], ref_run["mesh"], SHAPE,
                         steps=STEPS, ckpt_dir=tmp_path, log_every=0)
    assert res.last_step == STEPS - 1 and len(res.losses) == STEPS - 4
    np.testing.assert_allclose(res.losses, ref_run["losses"][4:], rtol=REL)
