"""The port's engine on a [2, 2, 1] mesh of four CPU ranks (torchrun, gloo)
against the JAX package's one-device engine.

One spawn of ``repro_torch.testing.mdchecks serve_engine`` runs seven
cases of reduced yi-6b in fp32 (4 slots, so 2 per KV group).  On the same
8 mixed-length requests: the fused and the ring SUMMA schedules; one KV
head, which q = 2 cannot shard (the replicated-KV ``linear_to_replicated``
path); a pool of 16 blocks that preempts in both KV groups; and weights
drawn from the port's seed instead of the reference's.  With the engine's
features: ``shared`` (fused, the prefix cache with chunked prefill of 4 on
12 requests behind one system prompt, so that both KV groups hit the
cache and split a page copy-on-write) and ``spec`` (ring, spec_k 3 with
reduced smollm-360m drafting, whose 3 q heads pad to 4 over col and whose
one KV head takes the replicated-KV path, on the reference's repetitive
prompts).  In the spawn each case's greedy ids must equal the port's
one-rank engine on the same weights (and the feature cases' the one-rank
plain engine's); the plain cases' prefill and decode logits of one request
must agree within 1e-4 of their max.  Here the ids of the cases on the
reference's ``model.init`` params must equal the reference's one-device
``InferenceEngine`` (jnp attention) with the same features, computed while
the spawn runs.  The same spawn runs ``decode_parity``: the dense static
decode loop (``runtime/serve_steps`` on DenseLM) on the mesh against one
rank, fused and ring, 3 steps from a zero cache (B 8, S 32) and 3 after an
8 x 16 prefill, ids identical.
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
    dict(name="shared", schedule="fused", params="yi", num_blocks=64,
         workload="shared", prefix_cache=True, prefill_chunk=4),
    dict(name="spec", schedule="ring", params="yi", num_blocks=64,
         workload="repetitive", spec_k=3, spec_mode="draft",
         draft="smollm-360m", draft_params="smollm"),
]
FEATURES = ("prefix_cache", "prefill_chunk", "spec_k", "spec_mode")


def _ref_params(kv_heads=None, arch="yi-6b", vocab=None, key=0):
    cfg = get_reduced(arch).model
    if kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    model = ref_build(cfg, ctx, run)
    return model, logical_mesh(ctx), model.init(jax.random.PRNGKey(key))


def _ref_ids(model, mesh, params, spec=None, draft=None):
    """The reference's one-device engine on a case's prompts, with its
    features (``draft``: the reference's draft model and params)."""
    case = dict(spec or {}, reduced=True)
    prompts = _prompts(case, model.cfg.vocab_size)
    kw = {k: case[k] for k in FEATURES if k in case}
    eng = RefEngine(model, mesh, params,
                    RefEngineConfig(num_blocks=64, **ENGINE, **kw),
                    draft_model=draft[0] if draft else None,
                    draft_params=draft[2] if draft else None)
    reqs = [eng.add_request(p, RefSampling(max_new_tokens=n))
            for p, n in zip(prompts, _new_tokens(case, len(prompts)))]
    res = eng.run()
    return [res[r.rid] for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the spawn's ids per case, the reference's ids per params set)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    refs = {"yi": _ref_params(), "yi_kv1": _ref_params(kv_heads=1)}
    vocab = refs["yi"][0].cfg.vocab_size
    draft = _ref_params(arch="smollm-360m", vocab=vocab, key=7)
    for name, (_, _, params) in [*refs.items(), ("smollm", draft)]:
        np.savez(tmp / f"{name}.npz",
                 **flatten_params(jax.tree.map(np.asarray, params)))
    cases = [dict(c, arch="yi-6b", reduced=True, **ENGINE) for c in CASES]
    for c in cases:
        for key in ("params", "draft_params"):
            if key in c:
                c[key] = str(tmp / f"{c[key]}.npz")
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.testing.mdchecks",
         "serve_engine", "decode_parity", "--device", "cpu", "--layout",
         "1,1,2,2",
         "--cases", str(tmp / "cases.json"), "--out", str(tmp / "out.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        want = {name: _ref_ids(*ref) for name, ref in refs.items()}
        for c in CASES:
            if any(k in c for k in FEATURES):
                want[c["name"]] = _ref_ids(
                    *refs[c["params"]], spec=c,
                    draft=draft if c.get("draft") else None)
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-4000:]
    return json.loads((tmp / "out.json").read_text()), want, out


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_mesh_engine_matches_reference(runs, case):
    got, want, _ = runs
    spec = {c["name"]: c for c in CASES}[case]
    if case in want:
        assert got[case]["ids"] == want[case]
    elif "params" in spec:
        assert got[case]["ids"] == want[spec["params"]]
    if spec.get("preempt"):
        assert min(got[case]["preemptions"]) > 0, got[case]["preemptions"]
    if spec.get("prefix_cache"):
        assert min(got[case]["hits"]) > 0 and min(got[case]["cow"]) > 0
    if spec.get("spec_k"):
        assert got[case]["spec_rounds"] > 0
        assert min(got[case]["draft_steps"]) > 0
    if not any(k in spec for k in FEATURES):
        assert got[case]["logit_rel_err"] <= 1e-4


def test_static_decode_on_mesh_matches_one_rank(runs):
    out = runs[2]
    assert "PASS decode_parity" in out, out[-4000:]
    for sched in ("fused", "ring"):
        assert (f"decode_parity {sched}: plan decode, 3 steps from a zero "
                f"cache and 3 after a 8 x 16 prefill: ids identical to one "
                f"rank" in out)

