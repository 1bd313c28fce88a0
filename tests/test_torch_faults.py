"""The port's fault plans, injector and checkpoint format against the JAX
package's, on the CPU.

The fault-plan grammar, its random plans and the injector string for
string the reference's (``repro.runtime.faults``); the port's checkpoints
in the reference's format (the reference reads them), damaged byte for
byte as the reference's ``corrupt_checkpoint`` damages them, each kind of
damage detected, the fallback across damaged checkpoints, and a failed
async write re-raised.
"""
import itertools
import shutil

import numpy as np
import pytest

from repro.checkpoint.ckpt import CheckpointManager as RefManager
from repro.runtime import faults as ref_faults
from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,
                                         CheckpointManager)
from repro_torch.configs.base import RunConfig
from repro_torch.runtime import faults

PLANS = ["train.grads@5:nan;ckpt.write@9:corrupt(bit_flip);"
         "serve.logits@3:nan(1)x2;train.step@7:device_loss(4);"
         "serve.step@2:pool_exhaust(3)",
         "ckpt.write@4:corrupt(2,truncate);train.grads@1:infx3;"
         "serve.prefix@6:flush;train.step@0:straggler(0.25)"]
RATES = [{"train.grads/nan": 0.1},
         {"train.grads/nan": 0.05, "ckpt.write/corrupt": 0.2,
          "serve.step/drop_step": 0.3, "train.step/device_loss": 0.02}]


def _fields(spec):
    return (spec.site, spec.step, spec.kind, spec.arg, spec.mode,
            spec.attempts)


@pytest.mark.parametrize("text", PLANS)
def test_plan_parse_compact_roundtrip(text):
    got = faults.FaultPlan.parse(text, seed=11)
    want = ref_faults.FaultPlan.parse(text, seed=11)
    assert [_fields(s) for s in got.specs] == [_fields(s)
                                               for s in want.specs]
    assert got.compact() == want.compact()
    assert faults.FaultPlan.parse(got.compact(), seed=11) == got
    assert got.sites() == want.sites()
    with pytest.raises(ValueError):
        faults.FaultSpec(site="train.grads", step=0, kind="device_loss")
    with pytest.raises(ValueError):
        RunConfig(fault_plan="bogus@0:nan")


@pytest.mark.parametrize("seed,rates", list(itertools.product(
    [0, 3, 17, 2024], RATES)))
def test_random_plan_equals_reference(seed, rates):
    """The same seed and rates give the reference's plan, string for
    string, and a longer horizon keeps the earlier draws."""
    got = faults.FaultPlan.random(seed, 60, rates)
    assert got.compact() == ref_faults.FaultPlan.random(
        seed, 60, rates).compact()
    longer = faults.FaultPlan.random(seed, 90, rates)
    assert [s for s in longer.specs if s.step < 60] == list(got.specs)


def test_injector_fires_once_per_occurrence_like_reference():
    text = "train.grads@2:nan;serve.logits@3:inf(1)x2;ckpt.write@2:corrupt"
    seq = [("train.grads", 2), ("serve.logits", 3), ("train.grads", 2),
           ("serve.logits", 3), ("serve.logits", 3), ("ckpt.write", 2),
           ("ckpt.write", 2)]
    got = faults.FaultInjector(faults.FaultPlan.parse(text))
    want = ref_faults.FaultInjector(ref_faults.FaultPlan.parse(text))
    for site, step in seq:
        assert [_fields(s) for s in got.fire(site, step)] == \
            [_fields(s) for s in want.fire(site, step)]
    assert got.fired == want.fired and got.exhausted
    run = RunConfig(fault_plan="train.grads@1:nan;serve.step@1:drop_step",
                    fault_seed=5)
    ti = faults.injector_from_run(run, sites=("train", "ckpt"))
    assert [s.site for s in ti.plan.specs] == ["train.grads"]
    assert ti.plan.seed == 5
    assert faults.injector_from_run(RunConfig()) is None


def _leaf_state(rng):
    return {"params": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "opt": {"step": np.int32(3),
                    "m": {"w": rng.standard_normal((8, 8)).astype(
                        np.float32)}}}


@pytest.mark.parametrize("mode", ["bit_flip", "truncate", "manifest"])
def test_corruption_matches_reference_and_is_detected(tmp_path, mode):
    """The port writes the reference's format (the reference reads it),
    damages the same byte as the reference's ``corrupt_checkpoint`` for
    the same seed, and detects the damage."""
    state = _leaf_state(np.random.default_rng(0))
    mgr = CheckpointManager(tmp_path / "a", keep=5)
    mgr.save(4, state, blocking=True)
    got = RefManager(tmp_path / "a")._load_leaf(
        4, "params/w", RefManager(tmp_path / "a")._manifest(4)["leaves"][
            "params/w"])
    np.testing.assert_array_equal(got, state["params"]["w"])
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    mgr.verify(4)
    assert mgr.latest_valid_step() == 4
    pa = faults.corrupt_checkpoint(tmp_path / "a", 4, mode=mode,
                                   leaf_index=2, seed=3)
    pb = ref_faults.corrupt_checkpoint(tmp_path / "b", 4, mode=mode,
                                       leaf_index=2, seed=3)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    with pytest.raises(CheckpointCorruptError):
        mgr.verify(4)
    assert mgr.latest_valid_step() is None


def test_restore_latest_falls_back_to_durable(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    base = np.arange(16, dtype=np.float32)
    for s in range(3):
        mgr.save(s, {"w": base + s}, blocking=True)
    faults.corrupt_checkpoint(tmp_path, 2, mode="bit_flip", seed=1)
    faults.corrupt_checkpoint(tmp_path, 1, mode="truncate")
    leaves, step = mgr.restore_latest()
    assert step == 0 and mgr.last_fallbacks == 2
    np.testing.assert_array_equal(leaves["w"].numpy(), base)
    faults.corrupt_checkpoint(tmp_path, 0, mode="manifest")
    assert mgr.restore_latest() == (None, None)
    assert mgr.last_fallbacks == 3


def test_async_checkpoint_failure_is_reraised(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    state = {"w": np.arange(8, dtype=np.float32)}
    mgr.save(0, state, blocking=True)
    real_write = mgr._write

    def failing_write(step, host, meta=None):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(mgr, "_write", failing_write)
    mgr.save(1, state)
    with pytest.raises(RuntimeError, match="step 1 failed.*disk full"):
        mgr.wait()
    mgr.wait()                  # cleared once raised
    assert mgr.latest_step() == 0
    monkeypatch.setattr(mgr, "_write", real_write)
    mgr.save(2, state)
    mgr.wait()
    assert mgr.latest_step() == 2
    monkeypatch.setattr(mgr, "_write", failing_write)
    mgr.save(3, state)
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        mgr.save(4, state)
