"""The port's flash-attention backward (the dQ and dK/dV plain versions,
and ``FlashAttention``'s autograd) vs the JAX package's Pallas passes.

Inputs come from a seeded numpy generator and go through both packages.
The reference kernels run in interpret mode on the CPU, as the JAX
package's own tests run them; the port's wrappers take their plain version
for CPU tensors.  Everything is float32, where only the summation order
differs, so the tolerance is 5e-5 (abs and rel; that of the reference's
own flash backward test, tests/test_kernels.py), and 1e-5 for the
autograd of the port's own plain forward.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_dkv_step, flash_dq_step,
                                           flash_fwd_step)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_dkv_plain,
                                                 flash_dq_plain,
                                                 flash_fwd_plain)

BWD_TOL = dict(rtol=5e-5, atol=5e-5)


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


def _qkv(rng, B, Hq, Hkv, Tq, Tk, D):
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _ref_bwd(q, k, v, dout, **kw):
    """The Pallas backward passes (interpret) with the reference's own lse
    and delta -> (lse, delta, dq, dk, dv) as numpy."""
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, dout))
    out, lse = flash_fwd_step(jq, jk, jv, bq=16, bk=16, interpret=True, **kw)
    delta = jnp.sum(jdo * out, axis=-1)
    dq = flash_dq_step(jq, jk, jv, jdo, lse, delta, bq=16, bk=16,
                       interpret=True, **kw)
    dk, dv = flash_dkv_step(jq, jk, jv, jdo, lse, delta, bq=16, bk=16,
                            interpret=True, **kw)
    return tuple(np.asarray(a) for a in (lse, delta, dq, dk, dv))


def _port_bwd(q, k, v, dout, lse, delta, **kw):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, dout, lse, delta)]
    dq = flash_dq_plain(*t, **kw)
    dk, dv = flash_dkv_plain(*t, **kw)
    return dq.numpy(), dk.numpy(), dv.numpy()


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (3, 1)])
@pytest.mark.parametrize("T", [16, 40])
@pytest.mark.parametrize("q_start", [0, None])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_bwd_plain_matches_reference(Hq, Hkv, T, q_start, window):
    """dq, dk, dv of the plain versions vs the Pallas dQ and dK/dV passes
    (interpret), given the reference's lse and delta, with tile skipping
    (q_start=0) and the full masked walk (None)."""
    rng = np.random.default_rng(Hq * 1000 + T + window)
    q, k, v = _qkv(rng, 1, Hq, Hkv, T, T, 16)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    q_pos = None if q_start is not None else np.arange(T, dtype=np.int32)
    lse, delta, *want = _ref_bwd(
        q, k, v, dout, causal=True, local_window=window, q_start=q_start,
        q_pos=None if q_pos is None else jnp.asarray(q_pos))
    got = _port_bwd(q, k, v, dout, lse, delta, causal=True,
                    local_window=window, q_start=q_start,
                    q_pos=None if q_pos is None else torch.from_numpy(q_pos))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BWD_TOL)


def test_flash_bwd_plain_fully_masked_rows():
    """Rows whose positions precede every key give exact-zero dq, and keys
    no row can see give exact-zero dk and dv, as in the Pallas passes."""
    rng = np.random.default_rng(8)
    T = 24
    q, k, v = _qkv(rng, 1, 4, 2, T, T, 16)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    q_pos = (np.arange(T) - 5).astype(np.int32)      # first 5 rows see nothing
    lse, delta, *want = _ref_bwd(q, k, v, dout, causal=True, q_start=None,
                                 q_pos=jnp.asarray(q_pos))
    dq, dk, dv = _port_bwd(q, k, v, dout, lse, delta, causal=True,
                           q_start=None, q_pos=torch.from_numpy(q_pos))
    assert np.all(dq[:, :, :5] == 0.0)
    assert np.all(dk[:, :, -5:] == 0.0) and np.all(dv[:, :, -5:] == 0.0)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(g, w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("q_start,window", [(0, 0), (None, 8)])
def test_flash_attention_function_matches_autograd_of_plain(q_start, window):
    """FlashAttention's backward (the dQ and dK/dV passes, plain on CPU
    tensors) vs autograd through flash_fwd_plain, the jnp path's oracle."""
    rng = np.random.default_rng(21)
    T = 40
    arrays = _qkv(rng, 2, 6, 2, T, T, 16)
    dout = torch.from_numpy(rng.standard_normal((2, 6, T, 16))
                            .astype(np.float32))
    q_pos = None if q_start is not None else torch.arange(T)
    grads = []
    for fn in ("kernel", "plain"):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        if fn == "kernel":
            out = FlashAttention.apply(q, k, v, True, window, q_pos, q_start,
                                       None)
        else:
            out, _ = flash_fwd_plain(q, k, v, local_window=window,
                                     q_pos=q_pos, q_start=q_start)
        out.backward(dout)
        grads.append([t.grad for t in (q, k, v)])
    for name, g, w in zip(("dq", "dk", "dv"), *grads):
        torch.testing.assert_close(g, w, msg=name, rtol=1e-5, atol=1e-5)
