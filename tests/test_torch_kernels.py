"""The port's forward kernel plain versions (flash forward, paged decode)
vs the JAX package's Pallas kernels (the backward passes:
``tests/test_torch_flash_bwd.py``).

Inputs come from a seeded numpy generator and go through both packages.
The reference kernels run in interpret mode on the CPU, as the JAX
package's own tests run them; the port's wrappers take their plain version
for CPU tensors.  Everything is float32, where only the summation order
differs, so the tolerance is 1e-5 (abs and rel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention, flash_fwd_step
from repro.kernels.paged_attention import paged_attention as ref_paged
from repro_torch.kernels.flash_attention import flash_fwd_plain
from repro_torch.kernels.paged_attention import paged_attention_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, B, Hq, Hkv, Tq, Tk, D):
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _torch_flash(q, k, v, **kw):
    out, lse = flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (3, 1)])
@pytest.mark.parametrize("T", [16, 40])
@pytest.mark.parametrize("q_start", [0, None])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_plain_matches_reference(Hq, Hkv, T, q_start, window):
    """out and lse of the plain version vs the Pallas forward (interpret),
    with block skipping (q_start=0) and the full masked walk (None)."""
    rng = np.random.default_rng(Hq * 100 + T + window)
    q, k, v = _qkv(rng, 1, Hq, Hkv, T, T, 16)
    q_pos = None if q_start is not None else np.arange(T, dtype=np.int32)
    want_out, want_lse = flash_fwd_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        local_window=window, q_pos=None if q_pos is None else jnp.asarray(q_pos),
        q_start=q_start, bq=16, bk=16, interpret=True)
    got_out, got_lse = _torch_flash(
        q, k, v, causal=True, local_window=window,
        q_pos=None if q_pos is None else torch.from_numpy(q_pos),
        q_start=q_start)
    np.testing.assert_allclose(got_out, np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), **TOL)


def test_flash_plain_fully_masked_rows():
    """Rows whose positions precede every key are fully masked: exact-zero
    output and lse at the -1e25 floor, as in the Pallas kernel."""
    rng = np.random.default_rng(7)
    T = 24
    q, k, v = _qkv(rng, 1, 4, 2, T, T, 16)
    q_pos = (np.arange(T) - 5).astype(np.int32)      # first 5 rows see nothing
    want_out, want_lse = flash_fwd_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_pos=jnp.asarray(q_pos), q_start=None, bq=8, bk=8, interpret=True)
    got_out, got_lse = _torch_flash(q, k, v, causal=True,
                                    q_pos=torch.from_numpy(q_pos),
                                    q_start=None)
    assert np.all(got_out[:, :, :5] == 0.0)
    np.testing.assert_array_equal(got_lse[:, :, :5], np.float32(-1e25))
    np.testing.assert_allclose(got_out, np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse), **TOL)
    # the public reference entry (tile lookup, padding) gives the same out
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_pos=jnp.asarray(q_pos), q_start=None,
                          interpret=True)
    np.testing.assert_allclose(got_out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_plain_matches_reference(window):
    """Random tables, mixed positions including pos=0 scratch slots, and a
    non-uniform kv_map, vs the Pallas paged kernel (interpret)."""
    rng = np.random.default_rng(11 + window)
    B, Hq, Hkv, D, bs, nb, P = 5, 6, 3, 16, 4, 5, 32
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    pk = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    table = table.astype(np.int32)
    pos = np.array([0, 3, 9, 19, 13], np.int32)
    table[0, :] = 0                                  # retired slot: scratch
    kv_map = np.array([0, 2, 2, 1, 0, 1], np.int32)  # non-uniform GQA map
    want = ref_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                     jnp.asarray(table), jnp.asarray(pos),
                     jnp.asarray(kv_map), local_window=window,
                     interpret=True)
    got = paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(kv_map), local_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
