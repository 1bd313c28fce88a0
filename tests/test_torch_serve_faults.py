"""The serve engine's fault sites and elastic re-plan in the port against
the JAX package's engine.

Both engines run reduced yi-6b (2 layers, d_model 64) on the reference's
``model.init`` weights (carried over by repro_torch.convert), one device,
attn_impl "jnp", float32.  For each seeded plan of the ``serve.step`` and
``serve.logits`` sites (a NaN row, a dropped step, KV-pool exhaustion, a
device loss that re-plans onto the one device, and the reference's chaos
mix sized for one device) the port's engine and the reference's give the
same greedy ids, the same fired schedule and the same fault counts; and
the same with the prefix cache on (its ``serve.prefix`` evictions carried
through the re-plan) and with speculation (k 2, n-gram and a reduced
smollm-360m draft).  The reference's counts for the chaos mix equal
``mdchecks.ONE_DEVICE_RUNS``'s, which ``chip_smoke.py`` holds the card's
runs to.  Right after the re-plan the prefix index is empty and
every ``draft_cached`` is 0.  Persistent poison in one slot fails only
that request; the engine takes a plan of every ``serve.*`` site from its
model's RunConfig; the launcher's ``--fault-plan`` and ``--replan-to``.
The mesh runs (a 4 -> 2 re-plan across gloo ranks) are in
tests/test_torch_resilience_mesh.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.runtime.faults import FaultInjector as RefInjector
from repro.runtime.faults import FaultPlan as RefPlan
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.serve import EngineConfig, InferenceEngine, SamplingParams
from repro_torch.serve.scheduler import FAILED
from repro_torch.testing.mdchecks import (ONE_DEVICE_CHAOS, ONE_DEVICE_ENGINE,
                                         ONE_DEVICE_RUNS, fault_workload)

SEED = 17
CHAOS = ONE_DEVICE_CHAOS
PLANS = {"nan": "serve.logits@2:nan(1)", "drop": "serve.step@3:drop_step",
         "exhaust": "serve.step@2:pool_exhaust(4)",
         "loss": "serve.step@4:device_loss(1)", "chaos": CHAOS}
# the chaos mix with the cache (an eviction before the loss) and with
# speculation: chip_smoke.py's one-card runs
FEATURED = {name: dict(run["features"], workload=run["workload"],
                       plan=run["plan"])
            for name, run in ONE_DEVICE_RUNS.items() if run["features"]}
FEATURED["draft"] = dict(FEATURED["ngram"], spec_mode="draft")
ENGINE = ONE_DEVICE_ENGINE
STATS = ("nan_quarantines", "dropped_steps", "pool_exhaust_events",
         "preemptions", "batch_shrinks", "failed", "health", "steps")
CACHE_STATS = ("prefix_lookups", "prefix_hits", "prefix_tokens_reused",
               "prefix_tokens_total", "cow_splits", "cache_evictions")
SPEC_STATS = ("spec_rounds", "spec_proposed", "spec_accepted",
              "spec_committed", "spec_slot_rounds")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's torch ops run on one thread: the suite's xdist workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, key):
    """(reference model, its params, the port's model on them)."""
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    ref = ref_build(cfg, ctx, run)
    params = ref.init(jax.random.PRNGKey(key))
    model = build_model(
        cfg, ParallelContext(mode="tesseract", attn_impl="jnp"),
        RunConfig(param_dtype="float32", compute_dtype="float32",
                  attn_impl="jnp"), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, params), model)
    return ref, params, model


@pytest.fixture(scope="module")
def models():
    target = get_reduced("yi-6b").model
    draft = dataclasses.replace(get_reduced("smollm-360m").model,
                                vocab_size=target.vocab_size)
    return ({"target": _pair(target, 0), "draft": _pair(draft, 7)},
            logical_mesh(RefCtx(mode="tesseract", attn_impl="jnp")))


def _run(engine, sampling, workload):
    prompts, new = fault_workload(workload)
    reqs = [engine.add_request(p, sampling(max_new_tokens=n))
            for p, n in zip(prompts, new)]
    res = engine.run()
    return [res[r.rid] for r in reqs], reqs


def _features(spec):
    return {k: spec[k] for k in ("prefix_cache", "spec_k", "spec_mode")
            if k in spec}


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's (ids, fired, stats) per run, each computed
    once for the module."""
    pairs, mesh = models
    done = {}

    def get(name):
        if name not in done:
            spec = FEATURED.get(name, dict(plan=PLANS.get(name)))
            draft = pairs["draft"] if spec.get("spec_mode") == "draft" \
                else None
            inj = (RefInjector(RefPlan.parse(spec["plan"], seed=SEED))
                   if spec["plan"] else None)
            ref, params, _ = pairs["target"]
            eng = RefEngine(ref, mesh, params,
                            RefEngineConfig(**ENGINE, **_features(spec)),
                            injector=inj,
                            draft_model=draft[0] if draft else None,
                            draft_params=draft[1] if draft else None)
            ids, _ = _run(eng, RefSampling, spec.get("workload", "chaos"))
            done[name] = ids, list(inj.fired if inj else []), eng.stats
        return done[name]

    return get


def _port(models, spec, snapshots=None):
    """The port's engine for a run spec; ``snapshots`` receives the prefix
    index size, the carried evictions and the draft marks right after each
    re-plan."""
    pairs, _ = models
    inj = (FaultInjector(FaultPlan.parse(spec["plan"], seed=SEED))
           if spec.get("plan") else None)
    eng = InferenceEngine(
        pairs["target"][2], EngineConfig(**ENGINE, **_features(spec)),
        device="cpu", injector=inj,
        draft_model=(pairs["draft"][2] if spec.get("spec_mode") == "draft"
                     else None))
    if snapshots is not None:
        replan = eng.replan_to

        def recorded(n):
            rp = replan(n)
            snapshots.append(dict(
                cached=len(eng.prefix) if eng.prefix is not None else 0,
                carry=eng._evict_carry,
                draft_cached=[r.draft_cached for r in eng.requests]))
            return rp

        eng.replan_to = recorded
    return eng


def _stats(stats, names):
    return {k: getattr(stats, k) for k in names}


@pytest.mark.parametrize("name", list(PLANS))
def test_fault_plan_matches_reference(models, reference, name):
    """One plan at a time: ids, the fired schedule and every fault count
    equal the reference engine's; nothing fails."""
    want, fired, ref_stats = reference(name)
    eng = _port(models, dict(plan=PLANS[name]))
    got, _ = _run(eng, SamplingParams, "chaos")
    assert got == want
    assert list(eng.injector.fired) == fired and fired
    assert _stats(eng.stats, STATS) == _stats(ref_stats, STATS)
    assert eng.stats.failed == 0
    if name == "chaos":
        want_counts = ONE_DEVICE_RUNS["plain"]["counts"]
        assert _stats(ref_stats, want_counts) == want_counts


def test_chaos_ids_equal_fault_free(models, reference):
    """The chaos mix keeps the fault-free run's ids (quarantine and
    preemption replay, the dropped step, the re-plan), with at least one
    quarantine, one dropped step and one exhaustion; a second run from the
    same seed fires the same schedule."""
    eng = _port(models, dict(plan=None))
    clean, _ = _run(eng, SamplingParams, "chaos")
    runs = []
    for _ in range(2):
        eng = _port(models, dict(plan=CHAOS))
        ids, _ = _run(eng, SamplingParams, "chaos")
        runs.append((ids, list(eng.injector.fired)))
        s = eng.stats
        assert (s.nan_quarantines >= 1 and s.dropped_steps == 1
                and s.pool_exhaust_events == 1 and s.failed == 0)
    assert runs[0][0] == clean and runs[1] == runs[0]


@pytest.mark.parametrize("name", list(FEATURED))
def test_featured_chaos_matches_reference(models, reference, name):
    """The chaos mix with the prefix cache (an eviction before the loss)
    or speculation: ids, schedule and counts equal the reference's, the
    cache's and speculation's statistics too; right after the re-plan the
    prefix index is empty, the evictions carried and every draft mark 0."""
    spec = FEATURED[name]
    want, fired, ref_stats = reference(name)
    snaps = []
    eng = _port(models, spec, snaps)
    got, _ = _run(eng, SamplingParams, spec["workload"])
    names = STATS + (CACHE_STATS if spec.get("prefix_cache") else
                     SPEC_STATS)
    assert got == want
    assert list(eng.injector.fired) == fired
    assert _stats(eng.stats, names) == _stats(ref_stats, names)
    want_counts = ONE_DEVICE_RUNS.get(name,
                                      ONE_DEVICE_RUNS["ngram"])["counts"]
    assert _stats(ref_stats, want_counts) == want_counts
    assert len(snaps) == 1 and snaps[0]["cached"] == 0
    assert all(d == 0 for d in snaps[0]["draft_cached"])
    if spec.get("prefix_cache"):
        assert 0 < snaps[0]["carry"] <= eng.stats.cache_evictions
        assert eng.stats.prefix_hits > 0
    else:
        assert eng.stats.spec_rounds > 0


def test_nan_retries_bounded(models):
    """Persistent poison in slot 1 fails only its request after
    nan_retry_limit re-prefills; the other requests keep the fault-free
    ids."""
    clean, _ = _run(_port(models, dict(plan=None)), SamplingParams, "chaos")
    plan = ";".join(f"serve.logits@{s}:nan(1)x99" for s in range(40))
    eng = _port(models, dict(plan=plan))
    got, reqs = _run(eng, SamplingParams, "chaos")
    failed = [r for r in reqs if r.state == FAILED]
    assert len(failed) == 1 and "logits" in failed[0].fail_reason
    assert eng.stats.failed == 1
    assert eng.stats.nan_quarantines > eng.cfg.nan_retry_limit
    assert all(g == c for g, c, r in zip(got, clean, reqs)
               if r.state != FAILED)


def test_engine_takes_every_serve_site_from_run(models):
    """A RunConfig plan naming serve.step, serve.logits and serve.prefix
    (and a train site, which the engine filters out) drives the engine: the
    straggler sleeps, the +Inf row quarantines its slot, the flush runs."""
    target = models[0]["target"][2]
    plan = ("serve.step@1:straggler(0.01);serve.logits@2:inf(0);"
            "serve.prefix@3:flush;train.grads@2:nan")
    model = build_model(
        target.cfg, target.ctx,
        dataclasses.replace(target.run, fault_plan=plan, fault_seed=3),
        device="cpu")
    model.load_state_dict(target.state_dict())
    eng = InferenceEngine(model, EngineConfig(**ENGINE, prefix_cache=True),
                          device="cpu")
    _run(eng, SamplingParams, "shared")
    assert [f[:2] for f in eng.injector.fired] == [
        ("serve.step", 1), ("serve.logits", 2), ("serve.prefix", 3)]
    assert eng.stats.nan_quarantines == 1 and eng.stats.failed == 0


def test_serve_launcher_faults_and_replan(capsys):
    """The launcher's --fault-plan, --fault-seed and --replan-to on the
    CPU: two steps, the re-plan, then the faulted run to its end."""
    from repro_torch.launch.serve import main
    eng = main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                "--requests", "6", "--prompt-lens", "5,9", "--new-tokens",
                "6", "--block-size", "4", "--num-blocks", "32",
                "--max-seq-len", "64", "--n-slots", "2", "--fault-plan",
                "serve.logits@3:nan(1);serve.step@5:drop_step",
                "--fault-seed", "4", "--replan-to", "1"])
    s = eng.stats
    assert s.tokens >= 36 and s.failed == 0
    assert s.nan_quarantines == 1 and s.dropped_steps == 1
    out = capsys.readouterr().out
    assert "replanned to 1 devices: data=1" in out
    assert "dropped_steps=1" in out
