"""The port's ssm family (mamba2) vs the JAX package on the serve path.

Inputs come from seeded numpy generators; model parameters come from the
reference's ``model.init`` and cross through numpy (repro_torch.convert).
The port runs with ``use_pallas=True``, which on the CPU takes the SSD
kernel's plain version.  Oracles, as for the dense slices: the plain
version is held to the reference's Pallas ``ssd_intra`` called directly in
interpret mode and to ``ref.ssd_intra_ref``; the model is held to the
reference's ``build_prefill_step`` / ``build_decode_step`` with
``use_pallas=False`` (its Pallas kernel inside ``shard_map`` fails under
the installed jax 0.9.0, ROADMAP Queue C).

Tolerances: float32 paths differ only in summation order, so outputs agree
within 1e-5 (kernel pieces) and cache leaves within 5e-5 of the leaf's
largest magnitude.  The bf16-compute case compiles the reference with
``xla_allow_excess_precision`` off, so that each jnp op rounds to its dtype
as the port's torch ops do (with it on, XLA keeps some bf16 products in
fp32 when their consumer is fp32): then the conv tails agree bit for bit
and the states within 1e-5 of their max, while casting only the matrices
to bf16 (the dense path's rule) moves them by ~0.5%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun, ShapeSpec
from repro.core.api import ParallelContext as RefCtx
from repro.core.mesh import logical_mesh
from repro.kernels import ref as kref
from repro.kernels.ssd import ssd_intra as ref_ssd_intra
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.models.ssm import segsum as ref_segsum
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro.runtime.steps import build_decode_step, build_prefill_step
from repro_torch.configs.base import RunConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.api import ParallelContext
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd as kssd
from repro_torch.models.registry import build_model, get_reduced
from repro_torch.models.ssm import MambaLM, ssd_chunked
from repro_torch.serve import EngineConfig, InferenceEngine

ARCH = "mamba2-1.3b"
B, T, STEPS = 2, 20, 3          # T = 20 with chunk 8 shrinks Q to 5
NO_EXCESS = {"xla_allow_excess_precision": False}


def _ssd_inputs(rng, Bsz, nc, Q, H, P, N, steep):
    """x, log_a (about -0.01 or -5: the decay underflows far from the
    diagonal), B, C as float32 numpy arrays."""
    x = rng.standard_normal((Bsz, nc, Q, H, P)).astype(np.float32)
    scale = 5.0 if steep else 0.01
    la = (-scale * rng.uniform(0.5, 1.5, (Bsz, nc, Q, H))).astype(np.float32)
    Bm = rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, nc, Q, N)).astype(np.float32)
    return x, la, Bm, Cm


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err:.3g} vs max {scale:.3g}"


@pytest.mark.parametrize("steep", [False, True], ids=["mild", "steep"])
@pytest.mark.parametrize("Q", [16, 10, 1])
def test_ssd_intra_plain_matches_pallas_and_ref(Q, steep):
    """(a) the plain version against the Pallas kernel in interpret mode and
    against ref.ssd_intra_ref; segsum against the reference's."""
    args = _ssd_inputs(np.random.default_rng(Q), 2, 3, Q, 4, 16, 16, steep)
    y, s = kssd.ssd_intra_plain(*map(torch.from_numpy, args))
    jargs = [jnp.asarray(a) for a in args]
    for name, (wy, ws) in (
            ("pallas", ref_ssd_intra(*jargs, interpret=True)),
            ("ref", kref.ssd_intra_ref(*jargs))):
        _close(y, wy, 1e-5, f"Y vs {name}")
        _close(s, ws, 1e-5, f"S_c vs {name}")
    la = args[1].transpose(0, 1, 3, 2)
    got = kssd.segsum(torch.from_numpy(la)).numpy()
    want = np.asarray(ref_segsum(jnp.asarray(la)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssd_chunked_matches_reference(use_pallas):
    """(b) the chunked scan at T = 40, chunk 16 (Q shrinks to 10, four
    chunks): y, the final state and the sequence's decay product (which
    chains a sequence shard to the next)."""
    rng = np.random.default_rng(11)
    Bsz, T_, H, P, N = 2, 40, 4, 16, 8
    x = rng.standard_normal((Bsz, T_, H, P)).astype(np.float32)
    la = (-0.3 * rng.uniform(0.5, 1.5, (Bsz, T_, H))).astype(np.float32)
    Bm = rng.standard_normal((Bsz, T_, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, T_, N)).astype(np.float32)
    y, h, a = ssd_chunked(*map(torch.from_numpy, (x, la, Bm, Cm)), 16,
                          use_pallas=use_pallas)
    wy, wh, wa = ref_ssd_chunked(*map(jnp.asarray, (x, la, Bm, Cm)), 16,
                                 use_pallas=use_pallas)
    _close(y, wy, 1e-5, "y")
    _close(h, wh, 1e-5, "h_last")
    _close(a, wa, 1e-5, "a_prod")


def _ref_serve(arch, compute_dtype, tokens, perturb=None):
    """Reference prefill + STEPS greedy decode steps (use_pallas=False,
    the oracle); returns (params as numpy, ids per step, caches per step)."""
    ctx = RefCtx(mode="tesseract")
    run = RefRun(param_dtype="float32", compute_dtype=compute_dtype,
                 use_pallas=False)
    mesh = logical_mesh(ctx)
    model = ref_build(arch.model, ctx, run)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    if perturb is not None:
        params = perturb(params)
    opts = NO_EXCESS if compute_dtype == "bfloat16" else None
    batch = {"tokens": jnp.asarray(tokens)}
    pre = build_prefill_step(model, mesh, ShapeSpec("p", T, B, "prefill"))
    ids, cache = pre.fn.lower(params, batch).compile(
        compiler_options=opts)(params, batch)
    dec = build_decode_step(model, mesh, ShapeSpec("d", T, B, "decode"))
    dec_fn = dec.fn.lower(params, cache, ids, jnp.int32(T)).compile(
        compiler_options=opts)
    out_ids, caches = [np.asarray(ids)], [jax.tree.map(np.asarray, cache)]
    for t in range(STEPS):
        ids, cache = dec_fn(params, cache, ids, jnp.int32(T + t))
        out_ids.append(np.asarray(ids))
        caches.append(jax.tree.map(np.asarray, cache))
    return params, out_ids, caches


def _port_serve(params, compute_dtype, tokens):
    run = RunConfig(param_dtype="float32", compute_dtype=compute_dtype,
                    use_pallas=True)
    model = build_model(get_reduced(ARCH).model, ParallelContext(), run,
                        device="cpu")
    params_from_jax(params, model)
    ids, cache = model.prefill(torch.from_numpy(tokens))
    out_ids, caches = [ids.numpy()], [cache]
    for _ in range(STEPS):
        ids, cache = model.decode(cache, ids)
        out_ids.append(ids.numpy())
        caches.append(cache)
    return model, out_ids, caches


def _perturb_vectors(params):
    """Vector leaves (norm scales, dt_bias, A_log, Dskip) moved off the
    values bf16 holds exactly, so casting them or not shows."""
    rng = np.random.default_rng(7)
    out = dict(params, blocks=dict(params["blocks"]))
    for name in ("ln", "ln_y", "dt_bias", "A_log", "Dskip"):
        a = out["blocks"][name]
        out["blocks"][name] = a + rng.uniform(-0.5, 0.5, a.shape).astype(
            np.float32)
    out["ln_f"] = params["ln_f"] + rng.uniform(
        -0.5, 0.5, params["ln_f"].shape).astype(np.float32)
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba_prefill_and_decode_match_reference(compute_dtype):
    """(c) fp32: the reduced mamba2 (two layers) prefill and three greedy
    decode steps, ids identical and every cache leaf within 5e-5 of its
    max.  (d) bf16 compute with fp32 params whose vectors bf16 cannot hold
    exactly: the reference casts every param leaf, vectors included."""
    arch = ref_reduced(ARCH)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, arch.model.vocab_size, (B, T)).astype(np.int32)
    bf16 = compute_dtype == "bfloat16"
    params, want_ids, want = _ref_serve(
        arch, compute_dtype, tokens, _perturb_vectors if bf16 else None)
    model, got_ids, got = _port_serve(params, compute_dtype, tokens)
    np.testing.assert_array_equal(params_to_numpy(model)["blocks"]["A_log"],
                                  params["blocks"]["A_log"])
    for step in range(STEPS + 1):
        np.testing.assert_array_equal(got_ids[step], want_ids[step],
                                      err_msg=f"ids, step {step}")
        assert set(got[step]) == set(want[step])
        for name, leaf in got[step].items():
            w = want[step][name]
            assert tuple(leaf.shape) == w.shape, name
            assert leaf.dtype == getattr(torch, str(w.dtype)), name
            tol = 0.0 if bf16 and name != "state" else (
                1e-5 if bf16 else 5e-5)
            _close(leaf.float().numpy(), w, tol, f"step {step} {name}")


def test_cache_abstract_matches_prefill():
    model = build_model(get_reduced(ARCH).model, ParallelContext(),
                        RunConfig(compute_dtype="float32"), device="cpu")
    tokens = torch.zeros((3, 9), dtype=torch.int64)
    ids, cache = model.prefill(tokens)
    assert ids.shape == (3, 1) and ids.dtype == torch.int32
    for name, (shape, dtype) in model.cache_abstract(3).items():
        assert cache[name].shape == shape and cache[name].dtype == dtype
    with pytest.raises(ValueError, match="K-1"):
        model.prefill(tokens[:, :2])


def test_engine_refuses_model_without_paged_decode():
    """The reference's guard (serve/engine.py): the paged engine cannot
    serve an ssm model."""
    model = build_model(get_reduced(ARCH).model, ParallelContext(),
                        RunConfig(), device="cpu")
    assert isinstance(model, MambaLM) and not hasattr(model, "decode_paged")
    with pytest.raises(NotImplementedError, match="paged decode"):
        InferenceEngine(model, EngineConfig(), device="cpu")


def test_ssd_wrapper_plain_on_cpu_and_checks():
    """On CPU tensors the wrapper returns the plain version and launches
    nothing; the checks refuse what the kernel does not take."""
    kops.reset_launches()
    t = lambda a: torch.from_numpy(a)
    args = [t(a) for a in _ssd_inputs(np.random.default_rng(0), 1, 2, 7, 2,
                                      16, 8, False)]
    for a, b in zip(kssd.ssd_intra(*args), kssd.ssd_intra_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.LAUNCHES["ssd_intra"] == 0
    kssd._check(*args)
    with pytest.raises(TypeError):
        kssd._check(*[a.double() for a in args])
    big = [t(a) for a in _ssd_inputs(np.random.default_rng(0), 1, 1, 257,
                                     1, 16, 4, False)]
    with pytest.raises(ValueError, match="chunk"):
        kssd._check(*big)
    odd = [t(a) for a in _ssd_inputs(np.random.default_rng(0), 1, 1, 4, 1,
                                     24, 4, False)]
    with pytest.raises(ValueError, match="head dim"):
        kssd._check(*odd)
