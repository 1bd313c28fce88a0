"""The port's ssm family (mamba2) served across ranks on the Tesseract mesh
against the JAX package.

(a) ``ssm_param_specs`` is the reference's ``MambaLM.specs`` (its
    ``_block_specs`` and the dense family's embed, head and ln_f) on three
    layouts, and ``convert.shard_params`` / ``unshard_params`` carry the
    reference's reduced mamba2 tree to every rank's blocks and back.
(b) Three spawns of ``repro_torch.testing.mdchecks ssm_serve`` under
    torchrun with gloo, started together with the module's first test:
    4 ranks at [1, 1, 2, 2] (fused, ring, and a batch of 1 on the
    ``long_decode`` plan), 8 at [1, 2, 2, 2] (the reference's own [2, 2,
    2]: the sequence over depth and row, so a wrong shard order shows)
    and 4 at [2, 2, 1, 1] (the sequence over depth; a batch of 2 on
    ``decode_dp``).  Each case runs a prefill, the reshard to the decode
    plan's cache and 4 greedy decode steps; in the spawn the ids must be
    identical to the port's one-rank model and every cache leaf within
    1e-4 of its max.  Prompts give each sequence shard two chunks of the
    reduced chunk (8), or 10 tokens, at which the chunk shrinks to 5.
    Here the spawns' ids are held to the reference's one-device
    ``build_prefill_step`` / ``build_decode_step`` (fp32, the jnp path),
    computed while the spawns run.  The weights are the reference's
    ``model.init`` with A_log moved to -5..-3: the init's 0 decays the
    state by ~0.5 a token, so no shard's state would reach the next
    shard's outputs and a broken chain would not show.
(c) The collectives the prefill adds (``halo_exchange_left``,
    ``distributed_linear_scan_carry``, ``last_shard_value``) are held to
    their one-process formulas by ``mdchecks collectives``, which the
    spawns of ``tests/test_torch_summa.py`` run on the same layouts.
"""
import functools
import itertools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.core.ops import Plan as RefPlan
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.optim import zero as ref_zero
from repro.runtime.steps import build_decode_step, build_prefill_step
from repro_torch.convert import flatten_params, shard_params, unshard_params
from repro_torch.core.api import ParallelContext
from repro_torch.core.mesh import local_block
from repro_torch.models.ssm import ssm_param_specs
from repro_torch.testing.mdchecks import ssm_tokens

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The rank processes run at a lower CPU priority (nice 5): the suite's
# longest file, tests/test_multidevice.py, runs beside them and sets
# its wall time.
NICE = ("nice", "-n", "5")
ARCH = "mamba2-1.3b"
STEPS = 4
SPAWN_TIMEOUT_S = 300
# name: (ranks, data,depth,rows,cols, cases as (name, schedule, batch,
# prompt length, decode plan))
SPAWNS = {
    "q2": (4, "1,1,2,2", [("fused", "fused", 4, 32, "decode"),
                          ("ring", "ring", 2, 20, "decode"),
                          ("long_decode", "fused", 1, 20, "long_decode")]),
    "q2d2": (8, "1,2,2,2", [("fused", "fused", 4, 64, "decode"),
                            ("ring", "ring", 4, 40, "decode")]),
    "dp2d2": (4, "2,2,1,1", [("fused", "fused", 4, 32, "decode"),
                             ("decode_dp", "fused", 2, 20, "decode_dp")]),
}
LAYOUTS = [(1, 1, 2, 2), (1, 2, 2, 2), (2, 2, 1, 1)]


def _ref_model(layout=(1, 1, 1, 1)):
    data, depth, rows, cols = layout
    ctx = RefCtx(mode="tesseract", data=data, depth=depth, rows=rows,
                 cols=cols)
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 use_pallas=False)
    return ref_build(ref_reduced(ARCH).model, ctx, run), ctx


@functools.lru_cache(maxsize=None)
def _ref_params():
    """The reference's reduced mamba2 init, A_log moved to slow decay
    (computed once; callers do not modify it)."""
    model, _ = _ref_model()
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    a = params["blocks"]["A_log"]
    params["blocks"]["A_log"] = np.random.default_rng(9).uniform(
        -5.0, -3.0, a.shape).astype(np.float32)
    return model, params


def _ref_ids(model, params, batch, prompt_len):
    """The reference's one-device prefill and STEPS greedy decode steps on
    the case's prompts: ids [STEPS + 1, batch]."""
    mesh = logical_mesh(model.ctx)
    tokens = ssm_tokens(dict(batch=batch, prompt_len=prompt_len),
                        model.cfg.vocab_size).astype(np.int32)
    pre = build_prefill_step(model, mesh, ShapeSpec("p", prompt_len, batch,
                                                    "prefill"))
    ids, cache = pre.fn(params, {"tokens": jnp.asarray(tokens)})
    dec = build_decode_step(model, mesh, ShapeSpec("d", prompt_len, batch,
                                                   "decode"))
    out = [np.asarray(ids)[:, 0]]
    for t in range(STEPS):
        ids, cache = dec.fn(params, cache, ids, jnp.int32(prompt_len + t))
        out.append(np.asarray(ids)[:, 0])
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the spawns, compute the reference's ids of every case while
    they run; yields (``result(name)``: the spawn's return code, output
    and ids per case, waited for once; the reference's ids by (batch,
    prompt length))."""
    tmp = tmp_path_factory.mktemp("ssm_mesh")
    model, params = _ref_params()
    np.savez(tmp / "params.npz", **flatten_params(params))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, (n, layout, cases) in SPAWNS.items():
        (tmp / f"{name}.json").write_text(json.dumps([
            dict(name=c, schedule=s, batch=b, prompt_len=t, plan=p,
                 arch=ARCH, reduced=True, steps=STEPS,
                 params=str(tmp / "params.npz"))
            for c, s, b, t, p in cases]))
        procs[name] = subprocess.Popen(
            [*NICE, sys.executable, "-m", "torch.distributed.run",
             "--standalone", f"--nproc-per-node={n}", "-m",
             "repro_torch.testing.mdchecks",
             "ssm_serve", "--device", "cpu", "--layout", layout,
             "--cases", str(tmp / f"{name}.json"),
             "--out", str(tmp / f"{name}_out.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    done = {}

    def result(name):
        if name not in done:
            out, _ = procs[name].communicate(timeout=SPAWN_TIMEOUT_S)
            ids = (json.loads((tmp / f"{name}_out.json").read_text())
                   if procs[name].returncode == 0 else None)
            done[name] = (procs[name].returncode, out, ids)
        return done[name]

    try:
        shapes = sorted({(b, t) for _, _, cases in SPAWNS.values()
                         for _, _, b, t, _ in cases})
        want = {s: _ref_ids(model, params, *s) for s in shapes}
        yield result, want
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def _axes(spec):
    return tuple(ref_zero.spec_dim_axes(spec))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ssm_param_specs_match_reference(layout):
    """Every leaf's per-dim axes are the reference's specs (blocks stacked
    on a leading [L]), and its padded shape the reference's init shape."""
    model, ctx = _ref_model(layout)
    specs = model.specs(ref_make_ops(ctx, RefPlan.for_shape("train")))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    data, depth, rows, cols = layout
    top, block = ssm_param_specs(model.cfg, ParallelContext(
        data=data, depth=depth, rows=rows, cols=cols))
    assert set(top) | {"blocks"} == set(specs)
    assert set(block) == set(specs["blocks"])
    for name, (_, padded, spec) in top.items():
        assert spec == _axes(specs[name]), name
        assert padded == tuple(shapes[name].shape), name
    for name, (_, padded, spec) in block.items():
        assert ((),) + spec == _axes(specs["blocks"][name]), name
        assert (model.cfg.num_layers,) + padded == tuple(
            shapes["blocks"][name].shape), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ssm_shard_params_round_trip(layout):
    """Each rank's block of every leaf is the block the reference's spec
    names, and the blocks of every rank put back together give the tree."""
    model, params = _ref_params()
    ref_model, ref_ctx = _ref_model(layout)
    specs = ref_model.specs(ref_make_ops(ref_ctx,
                                         RefPlan.for_shape("train")))
    data, depth, rows, cols = layout
    ctx = ParallelContext(data=data, depth=depth, rows=rows, cols=cols)
    sizes = dict(zip(("data", "depth", "row", "col"), layout))
    blocks = []
    for c in itertools.product(*(range(n) for n in layout)):
        coords = dict(zip(("data", "depth", "row", "col"), c))
        got = shard_params(params, model.cfg, ctx, coords)
        for name, arr in got["blocks"].items():
            np.testing.assert_array_equal(arr, local_block(
                params["blocks"][name], _axes(specs["blocks"][name]), sizes,
                coords), err_msg=name)
        blocks.append(got)
    back = unshard_params(blocks, model.cfg, ctx)
    for name in ("embed", "head", "ln_f"):
        np.testing.assert_array_equal(back[name], params[name])
    for name, arr in params["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], arr,
                                      err_msg=name)


@pytest.mark.parametrize("spawn,case", [
    (name, c[0]) for name, (_, _, cases) in SPAWNS.items() for c in cases])
def test_ssm_mesh_matches_reference(runs, spawn, case):
    """The spawn passed (ids identical to one rank, caches within 1e-4 of
    max), its ids are the reference's one-device ids, and the case took
    its decode plan."""
    result, want = runs
    rc, out, got = result(spawn)
    assert rc == 0, out[-4000:]
    assert "PASS ssm_serve" in out, out[-4000:]
    spec = {c[0]: c for c in SPAWNS[spawn][2]}[case]
    _, _, batch, prompt_len, plan = spec
    assert got[case]["plan"] == plan
    np.testing.assert_array_equal(np.asarray(got[case]["ids"]),
                                  want[(batch, prompt_len)])
    assert got[case]["cache_rel_err"] <= 1e-4
