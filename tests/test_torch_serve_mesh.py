"""The port's engine on a [2, 2, 1] mesh of four CPU ranks (torchrun, gloo)
against the JAX package's one-device engine.

One spawn of ``repro_torch.testing.mdchecks serve_engine`` runs five cases
of reduced yi-6b in fp32 on the same 8 mixed-length requests (4 slots, so
2 per KV group): the fused and the ring SUMMA schedules; one KV head, which
q = 2 cannot shard (the replicated-KV ``linear_to_replicated`` path); a
pool of 16 blocks that preempts in both KV groups; and weights drawn from
the port's seed instead of the reference's.  In the spawn each case's
greedy ids must equal the port's one-rank engine on the same weights, and
one request's prefill and decode logits must agree within 1e-4 of their
max.  Here the ids of the cases on the reference's ``model.init`` params
must equal the reference's one-device ``InferenceEngine`` (jnp attention),
computed while the spawn runs.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model as ref_build, get_reduced
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.convert import flatten_params
from repro_torch.testing.mdchecks import _new_tokens, _prompts

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The rank processes run at a lower CPU priority (nice 5): the suite's
# longest file, tests/test_multidevice.py, runs beside them and sets
# its wall time.
NICE = ("nice", "-n", "5")
ENGINE = dict(n_slots=4, block_size=4, max_seq_len=64)
CASES = [
    dict(name="fused", schedule="fused", params="yi", num_blocks=64),
    dict(name="ring", schedule="ring", params="yi", num_blocks=64),
    dict(name="kv1", schedule="fused", params="yi_kv1", kv_heads=1,
         num_blocks=64),
    dict(name="preempt", schedule="fused", params="yi", num_blocks=16,
         preempt=True),
    dict(name="seeded", schedule="ring", num_blocks=64),
]


def _ref_params(kv_heads=None):
    cfg = get_reduced("yi-6b").model
    if kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    model = ref_build(cfg, ctx, run)
    return model, logical_mesh(ctx), model.init(jax.random.PRNGKey(0))


def _ref_ids(model, mesh, params):
    case = dict(reduced=True)
    prompts = _prompts(case, model.cfg.vocab_size)
    eng = RefEngine(model, mesh, params,
                    RefEngineConfig(num_blocks=64, **ENGINE))
    reqs = [eng.add_request(p, RefSampling(max_new_tokens=n))
            for p, n in zip(prompts, _new_tokens(case, len(prompts)))]
    res = eng.run()
    return [res[r.rid] for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the spawn's ids per case, the reference's ids per params set)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    refs = {"yi": _ref_params(), "yi_kv1": _ref_params(kv_heads=1)}
    for name, (_, _, params) in refs.items():
        np.savez(tmp / f"{name}.npz",
                 **flatten_params(jax.tree.map(np.asarray, params)))
    cases = [dict(c, arch="yi-6b", reduced=True, **ENGINE) for c in CASES]
    for c in cases:
        if "params" in c:
            c["params"] = str(tmp / f"{c['params']}.npz")
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.testing.mdchecks",
         "serve_engine", "--device", "cpu", "--layout", "1,1,2,2",
         "--cases", str(tmp / "cases.json"), "--out", str(tmp / "out.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        want = {name: _ref_ids(*ref) for name, ref in refs.items()}
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-4000:]
    return json.loads((tmp / "out.json").read_text()), want


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_mesh_engine_matches_reference(runs, case):
    got, want = runs
    spec = {c["name"]: c for c in CASES}[case]
    if "params" in spec:
        assert got[case]["ids"] == want[spec["params"]]
    if spec.get("preempt"):
        assert min(got[case]["preemptions"]) > 0, got[case]["preemptions"]
    assert got[case]["logit_rel_err"] <= 1e-4
