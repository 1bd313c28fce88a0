"""The bf16 flash kernels' tile range and the dQ route's cut operands,
checked on the CPU (the forward's tile walk and cut P:
``tests/test_torch_flash_tiles.py``, whose letters these keep).

``csrc/flash_bwd.cu``'s bf16 dQ route walks the KV tiles that some row of
a q tile can see, read from the rows' own positions
(``kernels/flash_attention.py::flash_kv_tiles``, shared with the
forward), and computes dQ += lo.K + hi.K with dS cut into two bf16 parts.
Here:

(b) with q_pos = q_start + arange the range is the reference's
    ``_kv_bounds`` at 64-row tiles;
(d) an emulation of the dQ route's arithmetic (the walked tiles only,
    P = exp(S - lse) exactly 0 where masked, dS = P o (dP - delta) cut
    into hi + lo bf16 parts) stays within 1e-5 of max |dq| of the
    reference's ``flash_dq_step`` (interpret mode, on the reference
    forward's lse and delta) before rounding, and within
    ``chip_smoke.py``'s bf16 tolerance after.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (FlashCfg, _kv_bounds,
                                          flash_dq_step, flash_fwd_step)
from repro_torch.kernels.flash_attention import (FWD_TILE, NEG_INF, _scores,
                                                 flash_kv_tiles)

BF16_GRAD_TOL = 1e-2                 # chip_smoke.py's _bwd_tol(bfloat16),
                                     # times max |dq|
DQ_SPLIT_TOL = 1e-5                  # |unrounded dq - reference|, times
                                     # max |dq|


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


@pytest.mark.parametrize("q_start,Tq,window", [(0, 2048, 0), (0, 1000, 256),
                                               (37, 70, 0), (37, 1000, 100),
                                               (128, 300, 64), (0, 500, 0)])
def test_tile_range_is_kv_bounds(q_start, Tq, window):
    """(b) positions q_start + arange give the reference's _kv_bounds at
    bq = bk = 64 from the positions alone."""
    Tk = q_start + Tq
    nq, nk = -(-Tq // FWD_TILE), -(-Tk // FWD_TILE)
    cfg = FlashCfg(causal=True, window=window, scale=1.0, g=1, bq=FWD_TILE,
                   bk=FWD_TILE, nq=nq, nk=nk, q_start=q_start, tk_real=Tk,
                   interpret=True)
    want = [tuple(int(x) for x in _kv_bounds(cfg, i)) for i in range(nq)]
    q_pos = q_start + np.arange(Tq, dtype=np.int32)
    assert flash_kv_tiles(q_pos, Tk, FWD_TILE, FWD_TILE, window=window) == want


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).bfloat16().float()


def _split2(x):
    """x cut into hi = bf16(x) and lo = bf16(x - hi), as mma.cuh's
    split_bf16x2 does (round to nearest even)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _emulate_dq(q, k, v, dout, lse, delta, q_pos, *, causal, window, tile):
    """The bf16 dQ route's arithmetic in fp32 on the CPU: per q tile, the
    walked tiles of flash_kv_tiles only; P = exp(S - lse), exactly 0 where
    masked; dS = P o (dO.V^T - delta); dQ += lo.K + hi.K; dQ times the
    scale once at the end.  Returns dq before rounding."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s_all = _scores(q, k, causal=causal, local_window=window, q_pos=q_pos,
                    q_start=None, softmax_scale=None)    # [B, Hkv, g, Tq, Tk]
    dp_all = torch.einsum("bhgqd,bhkd->bhgqk",
                          dout.reshape(B, Hkv, g, Tq, D), v)
    lse5 = lse.reshape(B, Hkv, g, Tq, 1)
    delta5 = delta.reshape(B, Hkv, g, Tq, 1)
    kf = k[:, :, None]                                    # [B, Hkv, 1, Tk, D]
    dq = torch.zeros(B, Hkv, g, Tq, D)
    for i, (lo, hi) in enumerate(flash_kv_tiles(q_pos, Tk, tile, tile, causal,
                                                window)):
        r = slice(i * tile, (i + 1) * tile)
        acc = torch.zeros_like(dq[..., r, :])
        for j in range(lo, hi):
            c = slice(j * tile, (j + 1) * tile)
            s = s_all[..., r, c]
            p = torch.where(s == NEG_INF, torch.zeros_like(s),
                            torch.exp(s - lse5[..., r, :]))
            ds = p * (dp_all[..., r, c] - delta5[..., r, :])
            for part in reversed(_split2(ds)):
                acc = acc + part @ kf[..., c, :]
        dq[..., r, :] = acc
    return dq.reshape(B, Hq, Tq, D) / D ** 0.5


@pytest.mark.parametrize("q_start,window,kind", [(0, 0, None),
                                                 (0, 20, None),
                                                 (None, 12, "arange"),
                                                 (None, 0, "arange+5"),
                                                 (None, 0, "arange-20"),
                                                 (None, 16, "arange-20")])
def test_split_ds_emulation_matches_reference(q_start, window, kind):
    """(d) the dQ kernel's walk and cut dS, emulated, against the
    reference's fp32 dQ on bf16-valued inputs and the reference forward's
    lse and delta: within DQ_SPLIT_TOL of max |dq| before rounding and the
    chip's bf16 tolerance after; rows that see no key are exact zeros."""
    rng = np.random.default_rng(11 + window)
    Hq, Hkv, T, D, tile = 4, 2, 48, 16, 16
    q, k, v, dout = (_bf16(rng, 1, h, T, D) for h in (Hq, Hkv, Hkv, Hq))
    q_pos = None if kind is None else torch.from_numpy(
        np.arange(T, dtype=np.int32)
        + {"arange": 0, "arange+5": 5, "arange-20": -20}[kind])
    kw = dict(causal=True, local_window=window,
              q_pos=None if q_pos is None else jnp.asarray(q_pos.numpy()),
              q_start=q_start, bq=tile, bk=tile, interpret=True)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, dout))
    out, lse = flash_fwd_step(jq, jk, jv, **kw)
    delta = jnp.sum(jdo * out, axis=-1)
    want = np.asarray(flash_dq_step(jq, jk, jv, jdo, lse, delta, **kw))
    pos = q_pos if q_pos is not None else torch.arange(T, dtype=torch.int32)
    dq = _emulate_dq(q, k, v, dout, torch.tensor(np.asarray(lse)),
                     torch.tensor(np.asarray(delta)), pos, causal=True,
                     window=window, tile=tile)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(dq.numpy(), want, rtol=0,
                               atol=DQ_SPLIT_TOL * scale)
    np.testing.assert_allclose(dq.bfloat16().float().numpy(), want, rtol=0,
                               atol=BF16_GRAD_TOL * scale)
    dead = (pos < 0).numpy()
    assert dead.any() == (kind == "arange-20")
    assert np.all(dq.numpy()[:, :, dead] == 0.0)
