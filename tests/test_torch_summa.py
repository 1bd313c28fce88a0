"""The port's SUMMA contraction and mesh against the JAX package's.

(a) The plain versions of kernels #1 (tesseract_mm) and #2
    (tesseract_mm_stream) against the reference's Pallas kernels in
    interpret mode at shapes their TPU blocks tile, and against
    ``ref.py::tesseract_mm_ref`` at ragged ones; fp32 within 1e-5 (the
    plain versions sum in float64, the references in fp32).
(b) One spawn of 4 CPU ranks ([2, 2, 1]) and one of 8 ([2, 2, 2], the only
    layout with all three Tesseract axes > 1) under torchrun with gloo: each
    collective and each differentiable collective's backward against a
    numpy model, and ``tesseract_matmul`` fused and ring against the
    unsharded product within 1e-5 (``repro_torch.testing.mdchecks
    collectives summa_exact``); and one of 4 ranks with data = depth = 2,
    q = 1, where a request's K/V blocks may belong to a KV group of the
    other data coordinate: the engine's ids against the port's one-rank
    engine (``serve_engine``).  All three train across ranks against the
    port's one-rank step (``train_parity``: reduced yi-6b, smollm-360m and
    mamba2, fp32, fused and ring, the in-op dW reduction on and off,
    ZeRO-1 against the replicated optimizer).  The spawns start with the
    module's first test and are read by its last two.
(c) ``convert.shard_params``: every rank's block of every leaf of the
    reference's param tree is the block its partition spec names, so the
    blocks reassemble to the tree.
"""
import dataclasses
import itertools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import ParallelContext as RefCtx
from repro.core.ops import Plan as RefPlan
from repro.core.ops import make_ops as ref_make_ops
from repro.configs.base import RunConfig as RefRun
from repro.kernels.ops import tesseract_mm_op, tesseract_mm_stream_op
from repro.kernels.ref import tesseract_mm_ref
from repro.models.registry import build_model as ref_build, get_reduced
from repro_torch.convert import shard_params
from repro_torch.core.api import ParallelContext
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tesseract_mm import (tesseract_mm,
                                              tesseract_mm_plain,
                                              tesseract_mm_stream,
                                              tesseract_mm_stream_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The rank processes run at a lower CPU priority (nice 5): the suite's
# longest file, tests/test_multidevice.py, runs beside them and sets
# its wall time.
NICE = ("nice", "-n", "5")
TOL = dict(rtol=1e-5, atol=1e-5)
# name: (ranks, data,depth,rows,cols, checks)
SPAWNS = {"q2": (4, "1,1,2,2", ("collectives", "summa_exact")),
          "q2d2": (8, "1,2,2,2", ("collectives", "summa_exact")),
          "dp2d2": (4, "2,2,1,1", ("collectives", "serve_engine"))}
TRAIN = "train_parity"          # the last check of every spawn
SPAWN_TIMEOUT_S = 300


def _mm_inputs(rng, T, E, F, G):
    return (rng.standard_normal((T, E, F)).astype(np.float32),
            rng.standard_normal((T, F, G)).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def spawns():
    """The 4- and 8-rank runs of the mesh checks, started together with the
    module's first test, so they run while the others do.  Yields
    ``result(name)``: the spawn's (return code, output), waited for once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "repro_torch.testing.mdchecks",
         *checks, TRAIN, "--device", "cpu", "--layout", layout],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (n, layout, checks) in SPAWNS.items()}
    done = {}

    def result(name):
        if name not in done:
            out, _ = procs[name].communicate(timeout=SPAWN_TIMEOUT_S)
            done[name] = (procs[name].returncode, out)
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.mark.parametrize("T,E,F,G", [(1, 16, 32, 8), (3, 8, 16, 24)])
def test_mm_plain_matches_pallas(T, E, F, G):
    rng = np.random.default_rng(T * 100 + E)
    a, b = _mm_inputs(rng, T, E, F, G)
    want = np.asarray(tesseract_mm_op(jnp.asarray(a), jnp.asarray(b)))
    got = tesseract_mm_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    c = rng.standard_normal((E, G)).astype(np.float32)
    want = np.asarray(tesseract_mm_stream_op(jnp.asarray(a[0]),
                                             jnp.asarray(b[0]),
                                             jnp.asarray(c)))
    got = tesseract_mm_stream_plain(torch.from_numpy(a[0]),
                                    torch.from_numpy(b[0]),
                                    torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mm_plain_matches_ref_at_ragged_shapes():
    """Shapes no TPU block tiles (E 3, F 5, G 7), T = 4, and T launches of
    the stream wrapper on CPU tensors: its accumulator updates in place,
    nothing is launched, and it sums to the fused result."""
    rng = np.random.default_rng(7)
    a, b = _mm_inputs(rng, 4, 3, 5, 7)
    want = np.asarray(tesseract_mm_ref(jnp.asarray(a), jnp.asarray(b)))
    kops.reset_launches()
    got = tesseract_mm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    acc = torch.zeros(3, 7)
    for t in range(4):
        out = tesseract_mm_stream(torch.from_numpy(a[t]),
                                  torch.from_numpy(b[t]), acc)
        assert out is acc
    np.testing.assert_allclose(acc.numpy(), want, **TOL)
    assert kops.LAUNCHES["tesseract_mm"] == 0
    assert kops.LAUNCHES["tesseract_mm_stream"] == 0


@pytest.mark.parametrize("two_d", [True, False])
def test_mm_wrapper_bf16_out_and_2d_form(two_d):
    """The fused schedule's call on CPU tensors: bf16 operands, C rounded
    to bf16 (``out_dtype``), and at one rank the [E, F] x [F, G] form
    (T = 1).  C is the plain fp32 C rounded once, and within one bf16 ulp
    (2^-8 relative) of the reference's fp32 ``tesseract_mm_ref`` rounded
    to bf16 (a near-tie may round either way); nothing is launched."""
    rng = np.random.default_rng(11)
    a, b = _mm_inputs(rng, 1 if two_d else 2, 6, 40, 24)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    ref = tesseract_mm_ref(jnp.asarray(ta.float().numpy()),
                           jnp.asarray(tb.float().numpy()))
    want = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    kops.reset_launches()
    if two_d:
        ta, tb = ta[0], tb[0]
    got = tesseract_mm(ta, tb, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (6, 24)
    assert torch.equal(got, tesseract_mm(ta, tb).to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=0)
    assert kops.LAUNCHES["tesseract_mm"] == 0
    with pytest.raises(TypeError):
        tesseract_mm(ta, tb, out_dtype=torch.float16)


def _ref_block(arr, spec, sizes, coords):
    """The block at ``coords`` of ``arr`` under a reference PartitionSpec
    (an axis name, a tuple of them, or None per dim)."""
    for dim, axes in enumerate(tuple(spec) + (None,) * arr.ndim):
        if axes is None or dim >= arr.ndim:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        m = arr.shape[dim] // n
        arr = np.take(arr, range(i * m, (i + 1) * m), axis=dim)
    return arr


@pytest.mark.parametrize("arch,kv,layout", [
    ("yi-6b", 0, (1, 1, 2, 2)), ("yi-6b", 1, (1, 2, 2, 2)),
    ("smollm-360m", 0, (2, 1, 2, 2))])
def test_shard_params_blocks_reassemble(arch, kv, layout):
    """Every rank's blocks of the reference's global tree (its own init for
    that layout: padded vocab and heads) are the blocks of the reference's
    partition specs (``DenseLM.specs``), and all the blocks of a leaf
    together hold each of its entries.  kv = 1 replicates the KV heads
    (``spec_w_to_replicated``); smollm pads its 15 heads to 16."""
    data, depth, rows, cols = layout
    cfg = get_reduced(arch).model
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    ref_ctx = RefCtx(mode="tesseract", data=data, depth=depth, rows=rows,
                     cols=cols)
    model = ref_build(cfg, ref_ctx, RefRun(param_dtype="float32"))
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    specs = model.specs(ref_make_ops(ref_ctx, RefPlan.for_shape("train")))
    ctx = ParallelContext(data=data, depth=depth, rows=rows, cols=cols)
    sizes = dict(data=data, depth=depth, row=rows, col=cols)

    def items(t):
        top = [(k, v) for k, v in t.items() if k != "blocks"]
        return top + [(f"blocks.{k}", v) for k, v in t["blocks"].items()]

    want, spec = dict(items(tree)), dict(items(specs))
    seen = {k: np.zeros(v.shape, bool) for k, v in want.items()}
    for c in itertools.product(range(data), range(depth), range(rows),
                               range(cols)):
        coords = dict(zip(("data", "depth", "row", "col"), c))
        for name, got in items(shard_params(tree, cfg, ctx, coords)):
            np.testing.assert_array_equal(
                got, _ref_block(want[name], spec[name], sizes, coords),
                err_msg=f"{name} at {coords}")
            idx = _ref_block(np.arange(want[name].size).reshape(
                want[name].shape), spec[name], sizes, coords)
            seen[name].reshape(-1)[idx.reshape(-1)] = True
    assert all(m.all() for m in seen.values())


@pytest.mark.parametrize("name", sorted(SPAWNS))
def test_collectives_and_summa_on_cpu_ranks(spawns, name):
    rc, out = spawns(name)
    assert rc == 0, out[-4000:]
    for check in SPAWNS[name][2]:
        assert f"PASS {check}" in out, out


@pytest.mark.parametrize("name", sorted(SPAWNS))
def test_train_parity_on_cpu_ranks(spawns, name):
    """Training on the spawn's mesh against the port's one-rank step
    (``mdchecks train_parity``): loss within 1e-5, each gradient leaf
    within 1e-5 of the leaf's max, the params after 2 AdamW steps within
    1e-5 of the leaf's max plus 1e-3 of the summed learning rates, ZeRO-1
    within 1e-6 of the replicated optimizer."""
    rc, out = spawns(name)
    assert rc == 0 and f"PASS {TRAIN}" in out, out[-4000:]
