"""The port's DenseLM vs the JAX package's on the serve path.

Parameters come from the reference's ``model.init`` and cross through numpy
(repro_torch.convert); prompts and decode tokens come from a seeded numpy
generator.  The port runs with attn_impl="pallas", which on the CPU takes
the kernels' plain versions.  The reference runs its jnp attention paths
(the oracles its own tests hold its Pallas kernels to): its Pallas kernels
inside shard_map fail under the installed jax 0.9.0 (pallas_call's
out_shape carries no vma for check_vma), so the Pallas kernels themselves
are compared in test_torch_kernels.py.  Two layers in float32: logits agree
within 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.runtime.steps import (build_paged_decode_step, build_paged_reshard,
                                 build_prefill_step, make_plan)
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.runtime.steps import paged_reshard

ATOL = 5e-5
B, S, BS, NB_POOL, STEPS = 2, 16, 4, 24, 3


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


def _ref_run(arch, tokens, lengths, tables, dec_ids):
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    mesh = logical_mesh(ctx)
    model = ref_build(arch.model, ctx, run)
    params = model.init(jax.random.PRNGKey(0))
    pre = build_prefill_step(model, mesh, ShapeSpec("p", S, B, "prefill"),
                             with_lengths=True)
    logits, pcache = pre.fn(params, {"tokens": jnp.asarray(tokens),
                                     "lengths": jnp.asarray(lengths)})
    plan = make_plan(ctx, ShapeSpec("paged", 1, B, "decode"))
    pool_sds, _ = model.paged_cache_abstract(NB_POOL, BS, plan)
    pool = {k: jnp.zeros(s.shape, s.dtype) for k, s in pool_sds.items()}
    pool = build_paged_reshard(model, mesh, B, S, NB_POOL, BS, plan)(
        pool, pcache, jnp.asarray(tables[:, :S // BS]))
    dec = build_paged_decode_step(model, mesh, B, NB_POOL, BS,
                                  tables.shape[1])
    out = [np.asarray(logits)]
    for t in range(STEPS):
        lg, pool = dec.fn(params, pool, jnp.asarray(tables),
                          jnp.asarray(lengths + t), jnp.asarray(dec_ids[t]))
        out.append(np.asarray(lg))
    return jax.tree.map(np.asarray, params), out


def _port_run(arch, params_np, tokens, lengths, tables, dec_ids):
    ctx = ParallelContext(mode="tesseract", attn_impl="pallas")
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="pallas")
    model = build_model(arch.model, ctx, run, device="cpu")
    params_from_jax(params_np, model)
    logits, pcache = model.prefill(torch.from_numpy(tokens),
                                   torch.from_numpy(lengths))
    shape, dtype = model.paged_cache_shape(NB_POOL, BS)
    pool = {k: torch.zeros(shape, dtype=dtype) for k in ("k", "v")}
    paged_reshard(pool, pcache, torch.from_numpy(tables[:, :S // BS]))
    out = [logits.numpy()]
    for t in range(STEPS):
        lg = model.decode_paged(pool, torch.from_numpy(tables),
                                torch.from_numpy(dec_ids[t]),
                                torch.from_numpy(lengths + t))
        out.append(lg.numpy())
    return out


@pytest.mark.parametrize("arch_name", ["yi-6b", "smollm-360m"])
def test_dense_prefill_and_paged_decode_match_reference(arch_name):
    arch = get_reduced(arch_name)
    rng = np.random.default_rng(3)
    vocab = arch.model.vocab_size
    lengths = np.array([11, 16], np.int32)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tokens[0, lengths[0]:] = 0                        # right padding
    dec_ids = rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)
    # per-request pages (out of order), block 0 stays the scratch block
    max_blocks = (S + STEPS) // BS + 1
    tables = rng.permutation(np.arange(1, NB_POOL))[:B * max_blocks]
    tables = tables.reshape(B, max_blocks).astype(np.int32)
    params_np, want = _ref_run(arch, tokens, lengths, tables, dec_ids)
    got = _port_run(arch, params_np, tokens, lengths, tables, dec_ids)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                   err_msg=f"step {step}")
