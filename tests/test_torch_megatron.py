"""The port's Megatron 1-D baseline (``MegatronOps``, ``--mode megatron1d``)
against the JAX package's.

(a) ``convert.shard_params`` on the Megatron table: every rank's block of
    every leaf of the reference's param tree is the block of the
    reference's Megatron partition specs (``model.specs(MegatronOps)``),
    every element covered, and ``unshard_params`` puts them back together;
    the train step's leaf table (each leaf's gradient synced over the axes
    it is replicated on, nothing reduced in an op).
(b) A spawn of 4 CPU ranks (torchrun, gloo) of ``mdchecks collectives
    serve_engine train_parity --mode megatron1d --layout 1,1,1,4``: the
    collectives (with ``psum_v``/``pmax_v`` and Megatron-SP's loss), the
    engine on reduced yi-6b at 2 KV heads (replicated over col: the
    ``linear_to_replicated`` path), at 4 (sharded: one per rank, the case
    the reference's Megatron engine fails on), on a pool small enough to
    preempt, and on the port's seeded weights, each against the port's
    one-rank engine (greedy ids identical, logits within 1e-4 of max); and
    training against the port's one-rank step (loss within 1e-5, each
    gradient leaf within 1e-5 of its max, ZeRO-1 within 1e-6; mamba2
    refused, "ssm arch runs in tesseract modes", as the reference refuses
    it).  A spawn of 8 ranks trains on ``--layout 2,1,1,4`` (ZeRO-1 over
    data).
(c) The spawn's greedy ids on the reference's ``model.init`` params equal
    the reference's own ``megatron1d, cols=4`` engine (KV 2, run in a
    subprocess with 4 fake CPU devices) and, at KV 4, the reference's
    one-device engine.
(d) The port's train launcher on 4 ranks (``--mode megatron1d --cols 4
    --params``) from the reference's Megatron init: its 3 losses within
    1e-5 of the reference's launcher's on the same batches (the same
    subprocess).

The spawns and the reference's subprocess start with the module's first
test and run while it computes the rest.
"""
import dataclasses
import itertools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.core.ops import Plan as RefPlan
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build, get_reduced
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSampling
from repro_torch.configs.base import RunConfig
from repro_torch.convert import flatten_params, shard_params, unshard_params
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.models.registry import get_reduced as port_reduced
from repro_torch.runtime.steps import leaf_layouts
from repro_torch.testing.mdchecks import _new_tokens, _prompts

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The rank processes run at a lower CPU priority (nice 5): the suite's
# longest file, tests/test_multidevice.py, runs beside them and sets
# its wall time.
NICE = ("nice", "-n", "5")
ENGINE = dict(n_slots=4, block_size=4, max_seq_len=64)
CASES = [
    dict(name="kv2", params="kv2", num_blocks=64),
    dict(name="kv4", params="kv4", kv_heads=4, num_blocks=64),
    dict(name="preempt", params="kv2", num_blocks=16, preempt=True),
    dict(name="seeded", num_blocks=64),
]
CHECKS = ("collectives", "serve_engine", "train_parity")
TRAIN = ["--arch", "yi-6b", "--reduced", "--mode", "megatron1d", "--cols",
         "4", "--steps", "3", "--seq", "32", "--batch", "4"]
TIMEOUT_S = 300

# The reference's Megatron engine (KV 2) and its train launcher, on 4 fake
# devices: argv[1] is the output directory.
REF_SCRIPT = """
import json, pathlib, sys
import jax
from repro.configs.base import RunConfig
from repro.core.api import ParallelContext
from repro.core.mesh import logical_mesh
from repro.models.registry import build_model, get_reduced
from repro.serve import EngineConfig, InferenceEngine, SamplingParams
import repro.runtime.train_loop as loop
from repro_torch.testing.mdchecks import _new_tokens, _prompts
out = pathlib.Path(sys.argv[1])
ctx = ParallelContext(mode="megatron1d", cols=4, attn_impl="jnp")
run = RunConfig(param_dtype="float32", compute_dtype="float32",
                attn_impl="jnp", q_chunk=8, kv_chunk=8)
model = build_model(get_reduced("yi-6b").model, ctx, run)
eng = InferenceEngine(model, logical_mesh(ctx),
                      model.init(jax.random.PRNGKey(0)),
                      EngineConfig(num_blocks=64, **json.loads(sys.argv[2])))
case = dict(reduced=True)
prompts = _prompts(case, model.cfg.vocab_size)
reqs = [eng.add_request(p, SamplingParams(max_new_tokens=n))
        for p, n in zip(prompts, _new_tokens(case, len(prompts)))]
res = eng.run()
losses = []
train = loop.train
def recording(*a, **kw):
    result = train(*a, **kw)
    losses.extend(float(x) for x in result.losses)
    return result
loop.train = recording
sys.argv = ["train"] + sys.argv[3:]
from repro.launch.train import main
main()
(out / "ref.json").write_text(json.dumps(
    {"ids": [res[r.rid] for r in reqs], "losses": losses}))
"""


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


def _ref_tree(cfg, ctx):
    model = ref_build(cfg, ctx, RefRun(param_dtype="float32"))
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _cut_vocab(tree, vocab):
    """The tree at the logical vocab: the rows the reference pads with
    zeros cut off (``shard_params`` pads them back for a layout)."""
    for name in ("embed", "head"):
        assert not tree[name][vocab:].any()
    return dict(tree, embed=tree["embed"][:vocab], head=tree["head"][:vocab])


def _ref_ids(kv_heads):
    """The reference's one-device engine (jnp attention) on its init."""
    cfg = dataclasses.replace(get_reduced("yi-6b").model,
                              num_kv_heads=kv_heads)
    ctx = RefCtx(mode="tesseract", attn_impl="jnp")
    run = RefRun(param_dtype="float32", compute_dtype="float32",
                 attn_impl="jnp", q_chunk=8, kv_chunk=8)
    model = ref_build(cfg, ctx, run)
    eng = RefEngine(model, logical_mesh(ctx),
                    model.init(jax.random.PRNGKey(0)),
                    RefEngineConfig(num_blocks=64, **ENGINE))
    case = dict(reduced=True)
    prompts = _prompts(case, cfg.vocab_size)
    reqs = [eng.add_request(p, RefSampling(max_new_tokens=n))
            for p, n in zip(prompts, _new_tokens(case, len(prompts)))]
    res = eng.run()
    return [res[r.rid] for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Start the port's spawns and the reference's subprocess together;
    yields ``result(name)``: (return code, output) of a spawn, or of "ref",
    waited for once; and the reference's one-device ids at KV 4."""
    tmp = tmp_path_factory.mktemp("megatron")
    cfg = get_reduced("yi-6b").model
    _, kv2 = _ref_tree(cfg, RefCtx(mode="megatron1d", cols=4))
    _, kv4 = _ref_tree(dataclasses.replace(cfg, num_kv_heads=4), RefCtx())
    for name, tree in (("kv2", _cut_vocab(kv2, cfg.vocab_size)),
                       ("kv4", kv4)):
        np.savez(tmp / f"{name}.npz", **flatten_params(tree))
    cases = [dict(c, arch="yi-6b", reduced=True, schedule="fused", **ENGINE)
             for c in CASES]
    for c in cases:
        if "params" in c:
            c["params"] = str(tmp / f"{c['params']}.npz")
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)

    def torchrun(n, *args):
        return [*NICE, sys.executable, "-m", "torch.distributed.run",
                "--standalone", f"--nproc-per-node={n}", "-m", *args]

    cmds = {
        "dp1": torchrun(4, "repro_torch.testing.mdchecks", *CHECKS,
                        "--device", "cpu", "--mode", "megatron1d",
                        "--layout", "1,1,1,4", "--cases",
                        str(tmp / "cases.json"), "--out",
                        str(tmp / "out.json")),
        "dp2": torchrun(8, "repro_torch.testing.mdchecks", "train_parity",
                        "--device", "cpu", "--mode", "megatron1d",
                        "--layout", "2,1,1,4"),
        "launcher": torchrun(4, "repro_torch.launch.train", *TRAIN,
                             "--device", "cpu", "--params",
                             str(tmp / "kv2.npz"), "--out",
                             str(tmp / "train.json")),
        "ref": [*NICE, sys.executable, "-c", REF_SCRIPT, str(tmp),
                json.dumps(ENGINE), *TRAIN],
    }
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {name: subprocess.Popen(
        cmd, cwd=ROOT, env=ref_env if name == "ref" else env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cmd in cmds.items()}
    done = {}

    def result(name):
        if name not in done:
            out, _ = procs[name].communicate(timeout=TIMEOUT_S)
            done[name] = (procs[name].returncode, out)
        return done[name]

    try:
        yield result, tmp, _ref_ids(4)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def _ref_block(arr, spec, sizes, coords):
    """The block at ``coords`` of ``arr`` under a reference PartitionSpec."""
    for dim, axes in enumerate(tuple(spec)[:arr.ndim]):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        m = arr.shape[dim] // n
        arr = np.take(arr, range(i * m, (i + 1) * m), axis=dim)
    return arr


def _items(tree):
    top = [(k, v) for k, v in tree.items() if k != "blocks"]
    return top + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


LAYOUTS = [("yi-6b", {}, 1), ("yi-6b", dict(num_kv_heads=4), 1),
           ("yi-6b", {}, 2),
           ("smollm-360m", dict(norm="layernorm", use_bias=True), 1)]


@pytest.mark.parametrize("arch,model,data", LAYOUTS)
def test_shard_params_blocks_match_megatron_specs(arch, model, data):
    """Every rank's blocks of the reference's Megatron tree (its own init at
    cols 4: vocab padded to 4, smollm's 3 heads to 4) are the blocks of the
    reference's ``MegatronOps`` specs, and all the blocks of a leaf together
    hold each of its entries.  KV 2 replicates the KV projections
    (``spec_w_to_replicated``), KV 4 shards them."""
    cfg = dataclasses.replace(get_reduced(arch).model, **model)
    ref_ctx = RefCtx(mode="megatron1d", data=data, cols=4)
    ref_model, tree = _ref_tree(cfg, ref_ctx)
    specs = ref_model.specs(ref_make_ops(ref_ctx, RefPlan.for_shape("train")))
    ctx = ParallelContext(mode="megatron1d", data=data, cols=4)
    sizes = dict(data=data, depth=1, row=1, col=4)
    want, spec = dict(_items(tree)), dict(_items(specs))
    seen = {k: np.zeros(v.shape, bool) for k, v in want.items()}
    for d, c in itertools.product(range(data), range(4)):
        coords = dict(data=d, depth=0, row=0, col=c)
        for name, got in _items(shard_params(tree, cfg, ctx, coords)):
            np.testing.assert_array_equal(
                got, _ref_block(want[name], spec[name], sizes, coords),
                err_msg=f"{name} at {coords}")
            idx = _ref_block(np.arange(want[name].size).reshape(
                want[name].shape), spec[name], sizes, coords)
            seen[name].reshape(-1)[idx.reshape(-1)] = True
    assert all(m.all() for m in seen.values())


@pytest.mark.parametrize("arch,model,data", LAYOUTS)
def test_unshard_params_inverts_megatron_shards(arch, model, data):
    """Every rank's Megatron blocks of the reference's one-device tree, put
    back together, give that tree."""
    cfg = dataclasses.replace(get_reduced(arch).model, **model)
    _, tree = _ref_tree(cfg, RefCtx())
    ctx = ParallelContext(mode="megatron1d", data=data, cols=4)
    blocks = [shard_params(tree, cfg, ctx, dict(data=d, depth=0, row=0,
                                                col=c))
              for d, c in itertools.product(range(data), range(4))]
    for (name, g), (_, w) in zip(_items(unshard_params(blocks, cfg, ctx)),
                                 _items(tree)):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("zero1", [False, True])
def test_megatron_leaf_table(zero1):
    """No leaf is reduced in an op (no SUMMA product); each gradient is
    psum'd over the axes its Megatron spec replicates it on (the norms
    over every axis, the col-sharded projections, KV heads included at
    cols 1, and vocab shards over data, depth and row), without data and
    depth under ZeRO-1."""
    model = build_model(port_reduced("yi-6b").model,
                        ParallelContext(mode="megatron1d"),
                        RunConfig(param_dtype="float32", zero1=zero1),
                        device="cpu")
    assert model.tess_weight_names() == set()
    table = dict(zip((n for n, _ in model.named_parameters()),
                     leaf_layouts(model)))
    dd = () if zero1 else ("data", "depth")
    want = {"embed": dd + ("row",), "head": dd + ("row",),
            "ln_f": dd + ("row", "col"), "blocks.0.ln1": dd + ("row", "col"),
            "blocks.0.wq": dd + ("row",), "blocks.0.wk": dd + ("row",),
            "blocks.1.wo": dd + ("row",), "blocks.1.w_down": dd + ("row",)}
    for name, axes in want.items():
        spec, got, lay, in_op = table[name]
        assert got == axes and not in_op, name


def test_megatron_refusals():
    """Megatron has no [q, q] grid to ring over; the gspmd op set still
    refuses, naming its ROADMAP item, and the ssm family on Megatron with
    the reference's reason."""
    with pytest.raises(ValueError, match="megatron1d has no"):
        ParallelContext(mode="megatron1d", cols=4, matmul_schedule="ring")
    run = RunConfig(param_dtype="float32")
    with pytest.raises(NotImplementedError, match="item A3"):
        build_model(port_reduced("yi-6b").model, ParallelContext(
            mode="gspmd"), run, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ssm arch runs in tesseract modes"):
        build_model(port_reduced("mamba2-1.3b").model, ParallelContext(
            mode="megatron1d"), run, device="cpu")


@pytest.mark.parametrize("name", ["dp1", "dp2"])
def test_megatron_checks_on_cpu_ranks(runs, name):
    result, _, _ = runs
    rc, out = result(name)
    assert rc == 0, out[-4000:]
    for check in (CHECKS if name == "dp1" else ("train_parity",)):
        assert f"PASS {check}" in out, out[-4000:]


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_megatron_engine_matches_reference(runs, case):
    """The spawn's ids per case: KV 2 and the preempting pool equal the
    reference's Megatron engine, KV 4 (which the reference's Megatron
    engine cannot run) its one-device engine; every case's logits within
    1e-4 of max of the port's one-rank run."""
    result, tmp, kv4_ids = runs
    rc, out = result("dp1")
    assert rc == 0, out[-4000:]
    got = json.loads((tmp / "out.json").read_text())[case]
    spec = {c["name"]: c for c in CASES}[case]
    if spec.get("params") == "kv2":
        rc, ref_out = result("ref")
        assert rc == 0, ref_out[-4000:]
        assert got["ids"] == json.loads((tmp / "ref.json").read_text())["ids"]
    elif spec.get("params") == "kv4":
        assert got["ids"] == kv4_ids
    if spec.get("preempt"):
        assert min(got["preemptions"]) > 0, got["preemptions"]
    assert got["logit_rel_err"] <= 1e-4


def test_megatron_train_launcher_matches_reference(runs):
    """The port's launcher on 4 ranks from the reference's init: its losses
    over 3 steps within 1e-5 of the reference's launcher's."""
    result, tmp, _ = runs
    for name in ("launcher", "ref"):
        rc, out = result(name)
        assert rc == 0, out[-4000:]
    got = json.loads((tmp / "train.json").read_text())["losses"]
    want = json.loads((tmp / "ref.json").read_text())["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
