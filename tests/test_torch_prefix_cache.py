"""Shared-prompt serving in the port against the JAX package: the
refcounted block pool, the radix prefix cache with copy-on-write pages,
the chunked prefill trunk and the engine that runs them.

The engines run reduced yi-6b on the reference's ``model.init`` weights
(carried over by repro_torch.convert), one device, attn_impl="jnp", in
float32.  Greedy ids must be identical to the reference engine's and the
prefix-cache statistics equal, in three runs: (a) ``prefill_chunk=4``
with the cache off; (b) the reference's shared-system-prompt workload (a
10-token prefix, an identical twin, block size 4) with the cache on; (c)
a 16-block pool with 2 slots under ``serve.prefix`` evict and flush
faults.  The cache-on ids must also equal the port's own plain engine's.
The model's ``prefill_chunk_paged`` is held to the reference's chunk step
on the same pool contents within 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.runtime.faults import FaultInjector as RefInjector
from repro.runtime.faults import FaultPlan as RefPlan
from repro.runtime.steps import build_chunk_prefill_step
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.runtime.faults import FaultInjector, FaultPlan
from repro_torch.runtime.steps import page_copy
from repro_torch.serve import (BlockPool, EngineConfig, InferenceEngine,
                               SamplingParams)
from repro_torch.serve.prefix_cache import RadixPrefixCache

ATOL = 5e-5
STATS = ("prefix_lookups", "prefix_hits", "prefix_tokens_reused",
         "prefix_tokens_total", "cow_splits", "prefill_chunks",
         "cache_evictions", "preemptions")
FAULTS = "serve.prefix@3:evict(2);serve.prefix@6:flush"
RUNS = {
    "chunk": dict(n_slots=2, num_blocks=64, prefill_chunk=4),
    "shared": dict(n_slots=2, num_blocks=64, prefix_cache=True),
    "evict_faults": dict(n_slots=2, num_blocks=16, prefix_cache=True,
                         faults=FAULTS),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's torch ops run on one thread: the suite's xdist workers
    share the machine's cores, and torch's default of a thread per core in
    every worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """((reference model, mesh, params), the port's model on them)."""
    arch = get_reduced("yi-6b")
    ref_ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    ref_run = RefRun(param_dtype="float32", compute_dtype="float32",
                     attn_impl="jnp", q_chunk=8, kv_chunk=8)
    ref_model = ref_build(arch.model, ref_ctx, ref_run)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(
        arch.model, ParallelContext(mode="tesseract", attn_impl="jnp"),
        RunConfig(param_dtype="float32", compute_dtype="float32",
                  attn_impl="jnp"), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, params), model)
    return (ref_model, logical_mesh(ref_ctx), params), model


def _workload():
    """The reference's shared-system-prompt workload (its
    ``check_prefix_cache``): a 10-token system prompt and per-request
    suffixes (block size 4 puts the boundary 2 tokens into block 2, a
    copy-on-write donor on later hits), an identical twin (the
    whole-prompt-hit clamp) and a prompt that leaves another's suffix
    mid-way."""
    rng = np.random.RandomState(21)
    sys_prompt = rng.randint(0, 250, (10,)).tolist()
    prompts = [sys_prompt + rng.randint(0, 250, (n,)).tolist()
               for n in (5, 9, 2, 13, 5, 7)]
    prompts.append(list(prompts[0]))
    prompts.append(prompts[1][:12] + rng.randint(0, 250, (6,)).tolist())
    return prompts, [6, 4, 8, 5, 7, 3, 6, 5]


def _run(engine, sampling):
    prompts, n_new = _workload()
    reqs = [engine.add_request(p, sampling(max_new_tokens=n))
            for p, n in zip(prompts, n_new)]
    res = engine.run()
    return [res[r.rid] for r in reqs], engine.stats


def _port_engine(model, n_slots, num_blocks, faults=None, **kw):
    inj = (FaultInjector(FaultPlan.parse(faults, seed=5)) if faults
           else None)
    return InferenceEngine(model, EngineConfig(
        n_slots=n_slots, block_size=4, num_blocks=num_blocks,
        max_seq_len=64, **kw), device="cpu", injector=inj)


@pytest.fixture(scope="module")
def plain_ids(models):
    """The port's plain engine (monolithic prefill, no cache)."""
    return _run(_port_engine(models[1], 2, 64), SamplingParams)[0]


def test_block_pool_refcount_roundtrip():
    """A page returns to the freelist only when its last holder releases
    it; over-release and ref of a free page raise."""
    pool = BlockPool(n_groups=1, blocks_per_group=6)     # capacity 5
    a, b = pool.alloc(0, 2)
    assert pool.refcount(a) == 1
    pool.ref([a])
    assert pool.refcount(a) == 2
    pool.free([a])
    assert pool.refcount(a) == 1 and pool.available(0) == 3
    pool.free([a])
    assert pool.refcount(a) == 0 and pool.available(0) == 4
    with pytest.raises(ValueError):
        pool.free([a])
    with pytest.raises(ValueError):
        pool.ref([a])
    with pytest.raises(ValueError):
        pool.free([pool.scratch(0)])
    pool.free([b])
    assert pool.available(0) == pool.capacity(0)


def test_prefix_cache_cow_evict_flush():
    """A divergent prompt gets a cached block as a copy-on-write donor; the
    donor is never freed while protected or shared, eviction takes only
    refcount-1 leaves, and a flush returns every cache-held page."""
    pool = BlockPool(n_groups=1, blocks_per_group=8)     # capacity 7
    pc = RadixPrefixCache(pool, block_size=4)
    prompt = list(range(12))                             # 3 full blocks
    blocks = pool.alloc(0, 3)
    assert pc.insert(0, prompt, blocks) == 3
    assert [pool.refcount(x) for x in blocks] == [2, 2, 2]
    pool.free(blocks)                                    # request retires
    q = [0, 1, 2, 3, 4, 5, 99, 98, 97]
    hit = pc.lookup(0, q, len(q) - 1)
    assert (hit.tokens, hit.full_blocks) == (6, blocks[:1])
    assert (hit.cow_src, hit.cow_len) == (blocks[1], 2)
    # the whole-prompt hit is clamped to len - 1: the last full block
    # turns into a donor
    whole = pc.lookup(0, prompt, len(prompt) - 1)
    assert (whole.tokens, whole.cow_src, whole.cow_len) == (11, blocks[2], 3)
    pool.ref(hit.full_blocks)                            # request's hold
    assert pc.evict(0, 10, protect={hit.cow_src}) == 1
    assert [pool.refcount(x) for x in blocks] == [2, 1, 0]
    assert pc.evictions == 1 and len(pc) == 2
    pool.free(hit.full_blocks)
    assert pc.flush() == 2 and len(pc) == 0
    assert pool.available(0) == pool.capacity(0)


def test_page_copy_writes_only_its_group():
    """A copy-on-write pair lies in one KV group's partition: the rank of
    that group copies it (offset subtracted), every other rank leaves its
    partition alone."""
    pool = {k: torch.arange(2 * 8 * 2, dtype=torch.float32).reshape(
        2, 8, 2).clone() for k in ("k", "v")}
    want = {k: v.clone() for k, v in pool.items()}
    page_copy(pool, [3, 12], [5, 14], block0=8)    # the partition 8..15
    for k in pool:
        want[k][:, 6] = want[k][:, 4]
        assert torch.equal(pool[k], want[k])
    page_copy(pool, [1], [2], block0=8)            # another group's pair
    assert all(torch.equal(pool[k], want[k]) for k in pool)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_engine_matches_reference(models, plain_ids, name):
    """(a) chunked prefill, (b) the prefix cache, (c) a tight pool under
    forced evict/flush faults: ids and statistics equal the reference
    engine's, and the ids equal the port's plain engine's."""
    (ref_model, mesh, params), model = models
    kw = dict(RUNS[name])
    n_slots, num_blocks, faults = (kw.pop("n_slots"), kw.pop("num_blocks"),
                                   kw.pop("faults", None))
    ref = RefEngine(ref_model, mesh, params, RefEngineConfig(
        n_slots=n_slots, block_size=4, num_blocks=num_blocks,
        max_seq_len=64, **kw),
        injector=(RefInjector(RefPlan.parse(faults, seed=5)) if faults
                  else None))
    want, ref_stats = _run(ref, RefSampling)
    got, stats = _run(_port_engine(model, n_slots, num_blocks, faults,
                                   **kw), SamplingParams)
    assert got == want
    assert got == plain_ids
    assert ({k: getattr(stats, k) for k in STATS}
            == {k: getattr(ref_stats, k) for k in STATS})
    assert stats.failed == 0
    if kw.get("prefix_cache"):
        assert stats.prefix_hits > 0 and stats.cow_splits > 0
        assert 0 < stats.cache_hit_rate() < 1
    if faults:
        assert stats.cache_evictions >= 1
    else:
        assert stats.prefill_chunks > 0


def test_chunk_prefill_eviction_restart_and_stats(models):
    """A slot preempted mid-chunk-prefill restarts from the prefix-cache
    hit; replayed chunks do not count as prefill chunks and each prompt
    position enters prefix_tokens_total once (the reference's
    ``test_chunk_prefill_eviction_restart_and_stats`` on the port)."""
    model = models[1]

    def fresh():
        return _port_engine(model, 2, 32, prefix_cache=True,
                            prefill_chunk=4)

    shared = list(range(1, 25))               # 24 tokens = 6 full blocks
    long_p = shared + list(range(101, 109))   # 32 tokens
    ref = fresh()
    ra = ref.add_request(shared, SamplingParams(max_new_tokens=2))
    while not ra.finished:
        ref.step()
    rb = ref.add_request(long_p, SamplingParams(max_new_tokens=4))
    ref.run()
    want, chunks_ref = list(rb.generated), ref.stats.prefill_chunks

    eng = fresh()
    a = eng.add_request(shared, SamplingParams(max_new_tokens=2))
    while not a.finished:
        eng.step()
    base_chunks = eng.stats.prefill_chunks
    base_total = eng.stats.prefix_tokens_total
    b = eng.add_request(long_p, SamplingParams(max_new_tokens=4))
    eng.step()                                # admit (radix hit) + 1 chunk
    assert b.state == "running" and b.last_token is None
    assert b.num_cached > 20                  # restarted past the hit
    eng.sched.slots[b.slot] = None
    eng.sched.preempt(b)
    eng.run()
    assert b.preemptions == 1
    assert list(b.generated) == want
    assert (eng.stats.prefill_chunks - base_chunks
            == chunks_ref - base_chunks)
    assert eng.stats.chunk_steps > eng.stats.prefill_chunks
    assert eng.stats.prefix_tokens_total - base_total == len(long_p)


def test_ttft_stamped_at_completing_chunk(models):
    """Requests whose prefill completes in one chunk step share one
    first-token stamp, read after admission (the reference's
    ``test_ttft_stamped_at_completing_chunk`` on the port)."""
    t = [0.0]

    def tick():
        t[0] += 1.0
        return t[0]

    eng = InferenceEngine(models[1], EngineConfig(
        n_slots=2, block_size=4, num_blocks=32, max_seq_len=64,
        prefix_cache=True, prefill_chunk=8), device="cpu", clock=tick)
    rng = np.random.RandomState(9)
    p1, p2 = (rng.randint(0, 250, (8,)).tolist() for _ in range(2))
    r1 = eng.add_request(p1, SamplingParams(max_new_tokens=3))
    r2 = eng.add_request(p2, SamplingParams(max_new_tokens=3))
    assert r1.arrival_t < r2.arrival_t
    t_admitted = t[0]
    eng.run()
    assert r1.first_token_t == r2.first_token_t > t_admitted
    assert len(eng.stats.ttfts) == 2


def test_prefill_chunk_logits_match_reference(models):
    """``prefill_chunk_paged`` on the same pool contents as the reference's
    chunk step: two slots resuming mid-prompt (one idle row of the chunk
    padded), the logits at each slot's last valid position and the pages
    it writes within 5e-5."""
    (ref_model, mesh, params), model = models
    n_slots, C, bs, nb, max_blocks = 2, 4, 4, 20, 8
    rng = np.random.default_rng(11)
    shape, _ = model.paged_cache_shape(nb, bs)
    pool0 = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    tables = np.array([list(range(1, 9)), list(range(9, 17))], np.int32)
    pos = np.array([5, 9], np.int32)
    lens = np.array([4, 2], np.int32)
    ids = rng.integers(0, 250, (n_slots, C)).astype(np.int32)
    step = build_chunk_prefill_step(ref_model, mesh, n_slots, C, nb, bs,
                                    max_blocks)
    want, ref_pool = step.fn(params, {k: jnp.asarray(v)
                                      for k, v in pool0.items()},
                             jnp.asarray(tables), jnp.asarray(pos),
                             jnp.asarray(lens), jnp.asarray(ids))
    pool = {k: torch.from_numpy(v.copy()) for k, v in pool0.items()}
    t = lambda a: torch.from_numpy(a)
    got = model.prefill_chunk_paged(pool, t(tables), t(ids), t(pos),
                                    t(lens))
    v = model.cfg.vocab_size
    np.testing.assert_allclose(got[:, :v].numpy(), np.asarray(want)[:, :v],
                               atol=ATOL, rtol=0)
    for k in "kv":
        # the scratch block (local 0) takes the padded rows' garbage
        np.testing.assert_allclose(pool[k][:, 1:].numpy(),
                                   np.asarray(ref_pool[k])[:, 1:],
                                   atol=ATOL, rtol=0)
        assert not np.array_equal(pool[k][:, 1:].numpy(), pool0[k][:, 1:])


def test_serve_launcher_prefix_cache(capsys):
    """The launcher's --prefix-cache and --prefill-chunk on the CPU: one
    system prompt ahead of every request hits the cache."""
    from repro_torch.launch.serve import main
    eng = main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                "--requests", "6", "--system-prompt-len", "10",
                "--prompt-lens", "3,9", "--new-tokens", "4",
                "--block-size", "4", "--num-blocks", "64",
                "--max-seq-len", "64", "--n-slots", "2", "--prefix-cache",
                "--prefill-chunk", "8"])
    s = eng.stats
    assert s.tokens == 24 and s.failed == 0 and s.prefills == 0
    assert s.prefix_hits > 0 and s.cow_splits > 0
    assert "prefix: hit_rate=" in capsys.readouterr().out
