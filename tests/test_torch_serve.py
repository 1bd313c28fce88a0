"""The port's serve engine vs the JAX package's (the sampler's masks:
``tests/test_torch_sampling.py``).

Both engines run the same yi-6b reduced weights (the reference's init,
carried over by repro_torch.convert), the one-device layout and
attn_impl="jnp", in float32.  Greedy tokens must be identical, with and
without a pool small enough to force preemption and re-prefill.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.serve import (EngineConfig, InferenceEngine, QueueFullError,
                               SamplingParams)
from repro_torch.serve.scheduler import FAILED

PROMPT_LENS = (5, 9, 16, 12, 7, 3, 21, 10)
NEW_TOKENS = (6, 10, 4, 8, 5, 12, 3, 7)


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


@pytest.fixture(scope="module")
def models():
    arch = get_reduced("yi-6b")
    ref_ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    ref_run = RefRun(param_dtype="float32", compute_dtype="float32",
                     attn_impl="jnp", q_chunk=8, kv_chunk=8)
    mesh = logical_mesh(ref_ctx)
    ref_model = ref_build(arch.model, ref_ctx, ref_run)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(
        arch.model, ParallelContext(mode="tesseract", attn_impl="jnp"),
        RunConfig(param_dtype="float32", compute_dtype="float32",
                  attn_impl="jnp"), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, params), model)
    return (ref_model, mesh, params), model


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 250, (n,)).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def reference_tokens(models):
    """The reference engine's greedy tokens for the mixed prompts (ample
    pool; its own tests show a tight pool gives the same tokens)."""
    ref_model, mesh, params = models[0]
    ref = RefEngine(ref_model, mesh, params, RefEngineConfig(
        n_slots=4, block_size=4, num_blocks=64, max_seq_len=64))
    reqs = [ref.add_request(p, RefSampling(max_new_tokens=n))
            for p, n in zip(_prompts(), NEW_TOKENS)]
    res = ref.run()
    return [res[r.rid] for r in reqs]


@pytest.mark.parametrize("num_blocks", [64, 9])
def test_engine_greedy_tokens_match_reference(models, reference_tokens,
                                              num_blocks):
    """Mixed prompt lengths through 4 slots; num_blocks=9 cannot hold the
    concurrent residents and forces eviction + re-prefill."""
    model = models[1]
    eng = InferenceEngine(model, EngineConfig(
        n_slots=4, block_size=4, num_blocks=num_blocks, max_seq_len=64),
        device="cpu")
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=n))
            for p, n in zip(_prompts(), NEW_TOKENS)]
    got = eng.run()
    assert [got[r.rid] for r in reqs] == reference_tokens
    assert (eng.stats.preemptions > 0) == (num_blocks == 9)


def test_nan_logits_quarantine_one_slot(models, reference_tokens,
                                        monkeypatch):
    """A NaN row from one decode step quarantines only that slot; its
    request re-prefills and the greedy tokens stay the reference's."""
    model = models[1]
    decode, calls = model.decode_paged, [0]

    def poisoned(pool, table, ids, pos):
        logits = decode(pool, table, ids, pos)
        calls[0] += 1
        if calls[0] == 3:
            logits[1] = float("nan")
        return logits

    monkeypatch.setattr(model, "decode_paged", poisoned)
    eng = InferenceEngine(model, EngineConfig(
        n_slots=4, block_size=4, num_blocks=64, max_seq_len=64),
        device="cpu")
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=n))
            for p, n in zip(_prompts(), NEW_TOKENS)]
    got = eng.run()
    assert eng.stats.nan_quarantines == 1 and eng.stats.failed == 0
    assert [got[r.rid] for r in reqs] == reference_tokens


def test_admission_bound_and_deadline_shedding(models):
    model = models[1]
    now = [0.0]
    eng = InferenceEngine(model, EngineConfig(
        n_slots=2, block_size=4, num_blocks=32, max_seq_len=64,
        max_waiting=2), device="cpu", clock=lambda: now[0])
    late = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=4),
                           deadline_s=1.0)
    ok = eng.add_request([4, 5, 6], SamplingParams(max_new_tokens=4))
    with pytest.raises(QueueFullError):
        eng.add_request([7, 8], SamplingParams(max_new_tokens=4))
    now[0] = 5.0                       # past the first request's deadline
    res = eng.run()
    assert late.state == FAILED and "deadline" in late.fail_reason
    assert eng.stats.shed == 1 and len(res[ok.rid]) == 4


def test_sampled_tokens_replay(models):
    """temperature > 0: two runs with the same seeds give the same tokens,
    also when a tight pool preempts and re-prefills mid-sequence."""
    _, model = models

    def run(num_blocks):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=4, block_size=4, num_blocks=num_blocks, max_seq_len=64),
            device="cpu")
        reqs = [eng.add_request(p, SamplingParams(
                    temperature=0.9, top_k=40, top_p=0.9, seed=i,
                    max_new_tokens=n))
                for i, (p, n) in enumerate(zip(_prompts(), NEW_TOKENS))]
        res = eng.run()
        return [res[r.rid] for r in reqs], eng.stats.preemptions

    first, _ = run(64)
    again, _ = run(64)
    tight, preempted = run(9)
    assert first == again == tight
    assert preempted > 0
    assert all(len(t) == n for t, n in zip(first, NEW_TOKENS))
