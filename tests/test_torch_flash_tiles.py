"""The bf16 flash kernels' tile walk and cut operands, checked on the CPU.

``csrc/flash_fwd.cu``'s bf16 route walks only the KV tiles that some row of
a q tile can see, read from the rows' own positions, and computes
P.V as lo.V + mid.V + hi.V with P cut exactly into three bf16 parts.
``csrc/flash_bwd.cu``'s bf16 dQ route walks the same tiles and computes
dQ += lo.K + hi.K with dS cut into two bf16 parts.  The plain mirror of
the tile range is ``kernels/flash_attention.py::flash_kv_tiles``.  Here:

(a) every KV tile outside that range is fully masked for every row of the
    q tile (``_scores`` gives NEG_INF there), so skipping it is exact;
(c) an emulation of the kernel's arithmetic (the online softmax over each
    q tile's walked tiles only, P cut into hi, mid and lo bf16 parts,
    bf16 inputs and output) stays within ``chip_smoke.py``'s bf16
    tolerance of the JAX reference's fp32 forward (interpret mode), and
    within 2e-5 of it before the output's rounding.

(b), the tile range against the reference's ``_kv_bounds``, and (d), the
dQ route's emulation, are in ``tests/test_torch_flash_dq_tiles.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_fwd_step
from repro_torch.kernels.flash_attention import (M_FLOOR, NEG_INF, _scores,
                                                 flash_kv_tiles)

BF16_OUT_TOL, LSE_TOL = 1e-2, 1e-3   # chip_smoke.py's _tols(bfloat16)
SPLIT_TOL = 2e-5                     # |unrounded output - reference|


def _positions(kind, Tq, rng):
    ar = np.arange(Tq)
    return {"arange+37": ar + 37,
            "arange-70": ar - 70,          # the first 70 rows see no key
            "random": rng.integers(-40, Tq + 40, Tq),
            "sorted": np.sort(rng.integers(-40, Tq + 40, Tq)),
            "reversed": ar[::-1].copy()}[kind].astype(np.int32)


@pytest.mark.parametrize("kind", ["arange+37", "arange-70", "random",
                                  "sorted", "reversed"])
@pytest.mark.parametrize("causal,window,tile", [(True, 0, 64), (True, 48, 16),
                                                (False, 40, 16)])
def test_skipped_tiles_are_fully_masked(kind, causal, window, tile):
    """(a) tiles outside [lo, hi) of every q tile are masked for all its
    rows, for positions past the keys, before every key, random and
    reversed."""
    rng = np.random.default_rng(len(kind) * 7 + window + tile)
    Tq, Tk = 300, 260
    q_pos = _positions(kind, Tq, rng)
    s = _scores(torch.zeros(1, 1, Tq, 4), torch.zeros(1, 1, Tk, 4),
                causal=causal, local_window=window,
                q_pos=torch.from_numpy(q_pos), q_start=None,
                softmax_scale=None)[0, 0, 0]
    tiles = flash_kv_tiles(q_pos, Tk, tile, tile, causal, window)
    assert len(tiles) == -(-Tq // tile)
    walked = 0
    for i, (lo, hi) in enumerate(tiles):
        rows = s[i * tile:(i + 1) * tile]
        for j in range(-(-Tk // tile)):
            if not lo <= j < hi:
                block = rows[:, j * tile:(j + 1) * tile]
                assert bool((block == NEG_INF).all()), (i, j, lo, hi)
        walked += hi - lo
    if kind != "random":   # random positions span every tile's columns
        assert walked < len(tiles) * -(-Tk // tile)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).bfloat16().float()


def _split3(p):
    """p cut into three bf16 parts of 8 significant bits by masks, as
    mma.cuh's split3_bf16x2 does: hi + mid + lo == p."""
    def top(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)
    hi = top(p)
    mid = top(p - hi)
    return hi, mid, p - hi - mid


def _emulate_fwd(q, k, v, q_pos, *, causal, window, tile):
    """The bf16 route's arithmetic in fp32 on the CPU: per q tile, the
    online softmax over the walked tiles of flash_kv_tiles only, with the
    reference's NEG_INF and max floor, and O += lo.V + mid.V + hi.V.
    Returns (out before rounding, lse)."""
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    s_all = _scores(q, k, causal=causal, local_window=window, q_pos=q_pos,
                    q_start=None, softmax_scale=None)    # [B, Hkv, g, Tq, Tk]
    vf = v[:, :, None]                                    # [B, Hkv, 1, Tk, D]
    out = torch.zeros(s_all.shape[:4] + (D,))
    lse = torch.zeros(s_all.shape[:4])
    for i, (lo, hi) in enumerate(flash_kv_tiles(q_pos, Tk, tile, tile, causal,
                                                window)):
        r = slice(i * tile, (i + 1) * tile)
        m = torch.full(s_all[..., r, 0].shape, NEG_INF)
        l, o = torch.zeros_like(m), torch.zeros_like(out[..., r, :])
        for j in range(lo, hi):
            c = slice(j * tile, (j + 1) * tile)
            s = s_all[..., r, c]
            m_new = torch.maximum(m, s.amax(-1))
            ms = m_new.clamp(min=M_FLOOR)
            p = torch.exp(s - ms[..., None])
            corr = torch.exp(m.clamp(min=M_FLOOR) - ms)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None]
            for part in reversed(_split3(p)):
                o = o + part @ vf[..., c, :]
            m = m_new
        ls = torch.where(l == 0, torch.ones_like(l), l)
        out[..., r, :] = o / ls[..., None]
        lse[..., r] = m.clamp(min=M_FLOOR) + torch.log(ls)
    return out.reshape(B, Hq, Tq, D), lse.reshape(B, Hq, Tq)


@pytest.mark.parametrize("q_start,window,kind", [(0, 0, None),
                                                 (None, 12, "arange"),
                                                 (None, 0, "arange+5"),
                                                 (None, 0, "arange-20")])
def test_split_p_emulation_matches_reference(q_start, window, kind):
    """(c) the kernel's walk and cut P, emulated, against the reference's
    fp32 forward on bf16-valued inputs: within the chip's bf16 tolerance
    once rounded to bf16, within SPLIT_TOL before; rows that see no key are
    exact zeros with lse at the floor."""
    rng = np.random.default_rng(5 + window)
    Hq, Hkv, T, D, tile = 4, 2, 48, 16, 16
    q, k, v = (_bf16(rng, 1, h, T, D) for h in (Hq, Hkv, Hkv))
    q_pos = None if kind is None else torch.from_numpy(
        np.arange(T, dtype=np.int32)
        + {"arange": 0, "arange+5": 5, "arange-20": -20}[kind])
    want_out, want_lse = flash_fwd_step(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        causal=True, local_window=window,
        q_pos=None if q_pos is None else jnp.asarray(q_pos.numpy()),
        q_start=q_start, bq=tile, bk=tile, interpret=True)
    want_out, want_lse = np.asarray(want_out), np.asarray(want_lse)
    pos = q_pos if q_pos is not None else torch.arange(T, dtype=torch.int32)
    out, lse = _emulate_fwd(q, k, v, pos, causal=True, window=window,
                            tile=tile)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=SPLIT_TOL)
    np.testing.assert_allclose(out.bfloat16().float().numpy(), want_out,
                               rtol=0, atol=BF16_OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_TOL)
    dead = (pos < 0).numpy()
    assert np.all(out.numpy()[:, :, dead] == 0.0)
    assert np.all(lse.numpy()[:, :, dead] == np.float32(M_FLOOR))
