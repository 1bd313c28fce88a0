"""Speculative decoding in the port against the JAX package: the n-gram
proposer, the draft model's runner, rejection sampling and the verify
trunk, through the engine.

The engines run reduced yi-6b on the reference's ``model.init`` weights
(repro_torch.convert), one device, attn_impl="jnp", float32, on the
reference's repetitive prompts (its ``check_spec_decode``): (d) spec_k=3
with the n-gram proposer, (e) the same with reduced smollm-360m as the
draft (the reference's ``PRNGKey(7)`` init, vocab set to the target's),
(f) (d) in a pool small enough to preempt.  Greedy ids must equal the
reference engine's and the port's plain engine's, and the speculation
statistics the reference's.  ``verify_chunk_paged`` is held to the
reference's verify step within 5e-5 and each row to the port's plain
decode step at its position within 1e-5 of max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.runtime.steps import build_spec_verify_step
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, InferenceEngine, SamplingParams
from repro_torch.serve.sampling import spec_accept, spec_target_probs
from repro_torch.serve.spec import NgramProposer

ATOL = 5e-5
STATS = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_committed",
         "spec_slot_rounds", "preemptions")
RUNS = {"ngram": dict(num_blocks=128, spec_mode="ngram"),
        "draft": dict(num_blocks=128, spec_mode="draft"),
        "ngram_preempt": dict(num_blocks=32, spec_mode="ngram")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's torch ops run on one thread: the suite's xdist workers
    share the machine's cores, and torch's default of a thread per core in
    every worker oversubscribes them."""
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
    """{"target": ..., "draft": ...} pairs and the reference mesh."""
    target = get_reduced("yi-6b").model
    draft = dataclasses.replace(get_reduced("smollm-360m").model,
                                vocab_size=target.vocab_size)
    return ({"target": _pair(target, 0), "draft": _pair(draft, 7)},
            logical_mesh(RefCtx(mode="tesseract", attn_impl="jnp")))


def _workload():
    """The reference's repetitive prompts: something for the n-gram
    proposer to accept (parity holds whatever the acceptance)."""
    rng = np.random.RandomState(9)
    prompts, n_new = [], []
    for _ in range(8):
        base = rng.randint(0, 250, (rng.randint(3, 6),)).tolist()
        prompts.append((base * 6)[:rng.randint(6, 18)])
        n_new.append(int(rng.randint(4, 10)))
    return prompts, n_new


def _run(engine, sampling, **kw):
    prompts, n_new = _workload()
    reqs = [engine.add_request(p, sampling(max_new_tokens=n, **kw))
            for p, n in zip(prompts, n_new)]
    res = engine.run()
    return [res[r.rid] for r in reqs], engine.stats


def _port_engine(models, num_blocks=128, spec_k=0, spec_mode="auto",
                 **kw):
    pairs = models[0]
    return InferenceEngine(pairs["target"][2], EngineConfig(
        n_slots=8, block_size=4, num_blocks=num_blocks, max_seq_len=64,
        spec_k=spec_k, spec_mode=spec_mode, **kw), device="cpu",
        draft_model=pairs["draft"][2] if spec_mode == "draft" else None)


@pytest.fixture(scope="module")
def plain_ids(models):
    return _run(_port_engine(models), SamplingParams)[0]


def test_ngram_proposer():
    """The longest suffix n-gram's most recent earlier occurrence wins;
    nothing to match, no proposal."""
    ng = NgramProposer(max_n=3)
    assert ng.propose([1, 2, 3, 9, 1, 2, 3, 7, 1, 2, 3], 2) == [7, 1]
    assert ng.propose([5, 6, 7, 8], 3) == []
    assert ng.propose([4, 4, 4], 5) == [4]
    assert ng.propose([1, 2, 1, 2], 0) == []
    with pytest.raises(ValueError):
        NgramProposer(max_n=0)


def test_spec_accept_distribution():
    """Rejection sampling with a point-mass proposal commits tokens
    distributed as the plain sampler's (TV < 0.05 over 2500 draws, the
    reference's ``test_spec_rejection_sampling_distribution``); a proposal
    outside the nucleus is always rejected; the draws replay."""
    rng = np.random.RandomState(0)
    V = 8
    logits = torch.from_numpy((rng.randn(1, V) * 2.0).astype(np.float32))
    target = spec_target_probs(logits, 0.8, 0, 0.9)[0].numpy()
    N = 2500
    counts = np.zeros(V)
    d = int(np.argsort(target)[-2])        # plausible, not the top token
    for i in range(N):
        toks, _ = spec_accept(target[None, :], [d], None, seed=17, pos0=i)
        counts[toks[0]] += 1
    tv = 0.5 * np.abs(counts / N - target).sum()
    assert tv < 0.05, (tv, counts / N, target)
    d0 = int(np.argmin(target))
    assert target[d0] == 0.0
    for pos0 in range(20):
        toks, n_acc = spec_accept(target[None, :], [d0], None, seed=3,
                                  pos0=pos0)
        assert n_acc == 0 and target[toks[0]] > 0.0
    assert (spec_accept(target[None, :], [d], None, 5, 7)
            == spec_accept(target[None, :], [d], None, 5, 7))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_matches_reference(models, plain_ids, name):
    """(d) n-gram, (e) the draft model, (f) n-gram under preemption: ids
    equal the reference engine's and the port's plain engine's, and the
    speculation statistics the reference's."""
    pairs, mesh = models
    kw = RUNS[name]
    ref_model, ref_params, _ = pairs["target"]
    draft = kw["spec_mode"] == "draft"
    ref = RefEngine(ref_model, mesh, ref_params, RefEngineConfig(
        n_slots=8, block_size=4, max_seq_len=64, spec_k=3, **kw),
        draft_model=pairs["draft"][0] if draft else None,
        draft_params=pairs["draft"][1] if draft else None)
    want, ref_stats = _run(ref, RefSampling)
    eng = _port_engine(models, spec_k=3, **kw)
    got, stats = _run(eng, SamplingParams)
    assert got == want
    assert got == plain_ids
    assert ({k: getattr(stats, k) for k in STATS}
            == {k: getattr(ref_stats, k) for k in STATS})
    assert eng.spec_mode == kw["spec_mode"]
    assert stats.spec_rounds > 0 and stats.failed == 0
    assert (stats.preemptions > 0) == name.endswith("preempt")
    if draft:
        assert eng._draft.chunk_steps > 0 and eng._draft.decode_steps > 0


@pytest.mark.parametrize("num_blocks", [128, 32])
def test_sampled_spec_replays(models, num_blocks):
    """temperature > 0 with rejection sampling: two runs with the same
    seeds commit the same tokens, also when a tight pool preempts and
    re-prefills mid-sequence; every request gets its budget."""
    def run():
        eng = _port_engine(models, num_blocks, spec_k=3, spec_mode="ngram")
        prompts, n_new = _workload()
        reqs = [eng.add_request(p, SamplingParams(
                    temperature=0.8, top_k=40, top_p=0.9, seed=i,
                    max_new_tokens=n))
                for i, (p, n) in enumerate(zip(prompts, n_new))]
        res = eng.run()
        return [res[r.rid] for r in reqs], eng.stats

    first, stats = run()
    again, _ = run()
    assert first == again
    assert [len(t) for t in first] == _workload()[1]
    assert stats.spec_proposed > 0
    assert (stats.preemptions > 0) == (num_blocks == 32)


def test_prefix_cache_spec_refcounts(models):
    """The prefix cache with speculation over random accept/reject
    histories: committed sequences' full blocks are indexed, no
    rolled-back branch ever is, and every page returns to the freelist
    (the reference's ``test_prefix_cache_spec_refcounts_property``)."""
    model = models[0]["target"][2]
    rng = np.random.RandomState(3)
    for trial in range(2):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=2, block_size=4, num_blocks=32, max_seq_len=64,
            prefix_cache=True, spec_k=3, spec_mode="ngram"), device="cpu")
        reqs = []
        for i in range(4):
            base = rng.randint(0, 50, (4,)).tolist()
            prompt = (base * 4)[:int(rng.randint(8, 15))]
            sp = SamplingParams(temperature=0.7 if i % 2 else 0.0,
                                seed=trial * 10 + i,
                                max_new_tokens=int(rng.randint(4, 10)))
            reqs.append(eng.add_request(prompt, sp))
        eng.run()
        assert all(r.state == "finished" for r in reqs)
        assert eng.stats.spec_rounds > 0
        for r in reqs:
            seq = r.seq_tokens[:-1]
            hit = eng.prefix.lookup(0, seq, len(seq))
            assert hit.tokens >= len(seq) // 4 * 4, (trial, r.rid)

        def walk(node_map, prefix):
            for key, node in node_map.items():
                path = prefix + list(key)
                assert any(path == r.seq_tokens[:len(path)] for r in reqs)
                walk(node.children, path)

        walk(eng.prefix._roots[0], [])
        eng.prefix.flush()
        pool = eng.cache.pool
        assert all(pool.available(g) == pool.capacity(g)
                   for g in range(pool.n_groups))


def test_verify_logits_match_reference_and_decode(models):
    """``verify_chunk_paged`` against the reference's verify step on the
    same pool contents (two slots, one with a shorter proposal), within
    5e-5; row c against the port's plain decode step fed the same tokens
    up to c, within 1e-5 of max."""
    pairs, mesh = models
    ref_model, params, model = pairs["target"]
    n_slots, W, bs, nb, max_blocks = 2, 4, 4, 20, 8
    rng = np.random.default_rng(12)
    shape, _ = model.paged_cache_shape(nb, bs)
    pool0 = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    tables = np.array([list(range(1, 9)), list(range(9, 17))], np.int32)
    pos = np.array([6, 13], np.int32)
    lens = np.array([4, 3], np.int32)
    ids = rng.integers(0, 250, (n_slots, W)).astype(np.int32)
    step = build_spec_verify_step(ref_model, mesh, n_slots, W, nb, bs,
                                  max_blocks)
    want, _ = step.fn(params, {k: jnp.asarray(v) for k, v in pool0.items()},
                      jnp.asarray(tables), jnp.asarray(pos),
                      jnp.asarray(lens), jnp.asarray(ids))
    t = torch.from_numpy
    pool = {k: t(v.copy()) for k, v in pool0.items()}
    got = model.verify_chunk_paged(pool, t(tables), t(ids), t(pos), t(lens))
    v = model.cfg.vocab_size
    for s in range(n_slots):
        rows = slice(0, lens[s])
        np.testing.assert_allclose(got[s, rows, :v].numpy(),
                                   np.asarray(want)[s, rows, :v],
                                   atol=ATOL, rtol=0)
    dpool = {k: t(v.copy()) for k, v in pool0.items()}
    for c in range(W):
        live = c < lens
        dec = model.decode_paged(dpool, t(tables),
                                 t(np.where(live, ids[:, c], 0)[:, None]
                                   .astype(np.int32)),
                                 t((pos + c).astype(np.int32)))
        for s in np.flatnonzero(live):
            row, ref_row = got[s, c, :v], dec[s, :v]
            err = float((row - ref_row).abs().max() / ref_row.abs().max())
            assert err <= 1e-5, (s, c, err)


def test_serve_launcher_draft_spec(capsys):
    """The launcher's --spec-k with a --draft-config draft on the CPU: the
    draft takes the target's vocab, and the ids equal the plain run's."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "yi-6b", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-lens", "5,11", "--new-tokens", "5",
            "--block-size", "4", "--num-blocks", "32", "--max-seq-len", "32"]
    plain = main(argv)
    eng = main(argv + ["--spec-k", "3", "--draft-config", "smollm-360m"])
    assert eng.spec_mode == "draft"
    assert eng.draft_model.cfg.vocab_size == eng.model.cfg.vocab_size
    assert ([r.generated for r in eng.requests]
            == [r.generated for r in plain.requests])
    assert eng.stats.spec_rounds > 0 and eng.stats.failed == 0
    assert "spec: mode=draft k=3" in capsys.readouterr().out
