"""The dense static decode loop of the port against the JAX package.

Reduced yi-6b (2 layers) on the reference's ``model.init`` weights
(carried over by repro_torch.convert), one device, float32: the port's
``runtime/serve_steps`` prefill and decode steps on ``DenseLM`` against the
reference's ``build_prefill_step``, ``build_dense_cache_reshard`` and
``build_decode_step``: greedy ids identical at every step, and the cache
within 1e-5 of its largest magnitude after every step.  The same prompts
(one length) through the port's engine give the same ids.  The dense
cache's page view (``models/common.py``: ``decode_bs``, ``dense_view``,
``decode_attention``) against the reference's ``decode_attention``, at
page sizes of 125, 128, 100 and 91 and at one page per sequence (32, 7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.configs.base import ShapeSpec as RefShape
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models import common as ref_cm
from repro.models.registry import build_model as ref_build, get_reduced
from repro.runtime.steps import build_decode_step as ref_decode_step
from repro.runtime.steps import build_dense_cache_reshard
from repro.runtime.steps import build_prefill_step as ref_prefill_step
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_steps import (build_decode_step,
                                             build_prefill_step)
from repro_torch.serve import EngineConfig, InferenceEngine, SamplingParams

B, T, STEPS = 4, 16, 5
TOL = 1e-5
OPTS = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This file's torch ops run on one thread: the suite's xdist workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    return np.random.default_rng(6).integers(0, 250, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    """(params as numpy, the reference's ids and caches per step)."""
    arch = get_reduced("yi-6b").model
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    mesh = logical_mesh(ctx)
    model = ref_build(arch, ctx, run)
    params = model.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(_tokens())}
    pshape = RefShape("p", T, B, "prefill")
    pre = ref_prefill_step(model, mesh, pshape)
    ids, pcache = pre.fn.lower(params, batch).compile(
        compiler_options=OPTS)(params, batch)
    reshard, _ = build_dense_cache_reshard(model, mesh, pshape, T + STEPS)
    cache = reshard(pcache)
    dec = ref_decode_step(model, mesh, RefShape("d", T + STEPS, B, "decode"))
    fn = dec.fn.lower(params, cache, ids, jnp.int32(T)).compile(
        compiler_options=OPTS)
    out, caches = [np.asarray(ids)], []
    for t in range(STEPS):
        ids, cache = fn(params, cache, ids, jnp.int32(T + t))
        out.append(np.asarray(ids))
        caches.append({k: np.asarray(v) for k, v in cache.items()})
    return jax.tree.map(np.asarray, params), out, caches


@pytest.fixture(scope="module")
def port(reference):
    model = build_model(
        get_reduced("yi-6b").model, ParallelContext(attn_impl="jnp"),
        RunConfig(param_dtype="float32", compute_dtype="float32",
                  attn_impl="jnp"), device="cpu")
    params_from_jax(reference[0], model)
    return model


def test_static_steps_match_reference(reference, port):
    """Prefill, the cache's move to the decode layout (prompt positions
    first, zeros after) and STEPS greedy decode steps: ids identical, the
    cache within TOL of its max after every step."""
    _, want_ids, want_caches = reference
    pre = build_prefill_step(port, ShapeSpec("p", T, B, "prefill"))
    dec = build_decode_step(port, ShapeSpec("d", T + STEPS, B, "decode"))
    ids, cache = pre.fn(torch.from_numpy(_tokens()))
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (B, 1)
    np.testing.assert_array_equal(ids.numpy(), want_ids[0])
    cache = dec.from_prefill(cache)
    assert tuple(cache["k"].shape) == port.cache_abstract(
        B, T + STEPS, dec.plan)["k"][0]
    for t in range(STEPS):
        ids, cache = dec.fn(cache, ids, T + t)
        np.testing.assert_array_equal(ids.numpy(), want_ids[t + 1],
                                      err_msg=f"step {t}")
        for leaf in ("k", "v"):
            want = want_caches[t][leaf]
            err = np.abs(cache[leaf].numpy() - want).max()
            assert err <= TOL * np.abs(want).max(), (t, leaf, err)


def test_static_ids_equal_engine(reference, port):
    """The same prompts through the engine (greedy, STEPS + 1 tokens each)
    give the static loop's ids."""
    _, want_ids, _ = reference
    eng = InferenceEngine(port, EngineConfig(
        n_slots=B, block_size=4, num_blocks=64, max_seq_len=64),
        device="cpu")
    reqs = [eng.add_request(p.tolist(),
                            SamplingParams(max_new_tokens=STEPS + 1))
            for p in _tokens()]
    res = eng.run()
    static = np.concatenate(want_ids, axis=1)
    assert [res[r.rid] for r in reqs] == static.tolist()


def test_decode_rejects_foreign_cache_and_position(port):
    cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
             port.cache_abstract(B, 8).items()}
    ids = torch.zeros(B, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        port.decode(cache, ids, 8)
    with pytest.raises(ValueError, match="block"):
        port.decode(cache, torch.zeros(2 * B, 1, dtype=torch.int32), 0)


@pytest.mark.parametrize("S,bs", [(1000, 125), (32, 32), (300, 100), (7, 7),
                                  (1001, 91), (256, 128)])
def test_decode_attention_page_view_matches_reference(S, bs):
    """The dense caches viewed as a page pool of ``decode_bs(S)``-position
    pages (the reference's ``_decode_bs``) and attended through the paged
    decode's plain version, against the reference's jnp
    ``decode_attention``: positions at the first, a middle and the last
    page, GQA groups of 4, a window."""
    assert cm.decode_bs(S) == ref_cm._decode_bs(S) == bs
    rng = np.random.default_rng(S)
    Bq, Hq, Hkv, D = 3, 8, 2, 16
    q = rng.standard_normal((Bq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    kv_map = cm.contiguous_kv_map(Hq, Hkv)
    for pos in sorted({0, S // 2, S - 1}):
        for window in (0, 5):
            got = cm.decode_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                cm.dense_view(Bq, S, pos, "cpu"), kv_map=kv_map,
                local_window=window)
            want = ref_cm.decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur_pos=pos,
                local_window=window, impl="jnp")
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"S={S} pos={pos} w={window}")
