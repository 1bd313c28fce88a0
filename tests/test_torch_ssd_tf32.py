"""The SSD kernel's three-pass TF32 products, emulated and checked on the CPU.

``csrc/ssd.cu`` runs its three contractions (the scores C.B over N,
Y_h = W_h x_h over j <= i, S_c = (decay x)^T B over j) as mma.sync TF32 on
the tensor cores.  Each fp32 operand v is split into hi = v rounded to TF32
(10 stored mantissa bits, to nearest with ties away from zero: the bits of
cvt.rna.tf32.f32) and lo = v - hi cut to TF32 (``csrc/mma.cuh``
split_tf32), and each product is hi.hi + hi.lo + lo.hi.  Here that
arithmetic is emulated in torch (the rounding by bit masking, the exact
TF32 products summed in float64, each product's result rounded to fp32 as
the kernel's fp32 accumulators hold it) and held to the reference's Pallas
``ssd_intra`` in interpret mode within ``chip_smoke.py``'s ``SSD_TOL`` of
max |.|, at the chunk lengths the model gives (256, 250, 143) with mild and
steep decay, with lo cut as the kernel cuts it and rounded as cvt.rna
would round it.  The same inputs through one TF32 pass (hi.hi only) miss
that tolerance: the reason the kernel takes three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_intra as ref_ssd_intra

SSD_TOL = 1e-4      # chip_smoke.py: |kernel - plain| <= SSD_TOL * max |plain|


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


def tf32_rna(x):
    """fp32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32):
    add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x):
    """fp32 -> TF32 by dropping the 13 low mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _product(a, b, eq, passes, lo_round=tf32_cut):
    """einsum ``eq`` of fp32 a and b as the kernel's TF32 passes form it."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = lo_round(a - a_hi), lo_round(b - b_hi)

    def mm(u, v):     # a TF32 x TF32 product is exact in float64
        return torch.einsum(eq, u.double(), v.double())

    if passes == 1:
        return mm(a_hi, b_hi).float()
    return (mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)).float()


def emulate(x, log_a, Bm, Cm, passes=3, lo_round=tf32_cut):
    """The kernel's arithmetic: fp32 cumulative sums, the scores as a TF32
    product, W = scores * exp(cs_i - cs_j) in fp32 with exact zeros above
    the diagonal, then Y and S_c as TF32 products of fp32 operands."""
    Q = x.shape[2]
    cs = torch.cumsum(log_a, 2)                                # [B,nc,Q,H]
    product = lambda a, b, eq: _product(a, b, eq, passes, lo_round)
    scores = product(Cm, Bm, "bcin,bcjn->bcij")
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :,
                                                          None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # [B,nc,i,j,H]
    W = torch.where(tri, scores[..., None]
                    * torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    Y = product(W, x, "bcijh,bcjhp->bcihp")
    xw = x * torch.exp(cs[:, :, -1:, :] - cs)[..., None]
    S_c = product(xw, Bm, "bcjhp,bcjn->bchpn")
    return Y, S_c


def _inputs(Q, steep, H=2, P=16, N=32):
    """x, log_a (about -0.01, or about -5 where the decay underflows far
    from the diagonal), B, C as float32 numpy arrays (B 1, nc 2)."""
    rng = np.random.default_rng(Q + 1000 * steep)
    x = rng.standard_normal((1, 2, Q, H, P)).astype(np.float32)
    scale = 5.0 if steep else 0.01
    la = (-scale * rng.uniform(0.5, 1.5, (1, 2, Q, H))).astype(np.float32)
    Bm = rng.standard_normal((1, 2, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((1, 2, Q, N)).astype(np.float32)
    return x, la, Bm, Cm


def _rel_errs(args, passes, lo_round=tf32_cut):
    """max |emulated - reference| / max |reference| of Y and S_c."""
    got = emulate(*map(torch.from_numpy, args), passes=passes,
                  lo_round=lo_round)
    want = ref_ssd_intra(*map(jnp.asarray, args), interpret=True)
    return [float(np.abs(g.numpy() - np.asarray(w)).max()
                  / np.abs(np.asarray(w)).max()) for g, w in zip(got, want)]


CASES = [(Q, steep) for Q in (256, 250, 143) for steep in (False, True)]
IDS = [f"Q{Q}-{'steep' if s else 'mild'}" for Q, s in CASES]


def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 stored mantissa bits; a tie rounds away from zero, either sign
    (3 + 2^-10 is a tie: the step in [2, 4) is 2^-9)."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0 + ulp, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one, one + ulp, one + ulp, -(one + ulp),
                         3.0 + 2 * ulp, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    r = tf32_rna(y)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - y).abs() / y.abs()).max()) <= 2.0 ** -11
    # the split: hi + lo carries v to ~2^-22 of |v|
    hi = tf32_rna(y)
    lo = tf32_cut(y - hi)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("lo_round", [tf32_cut, tf32_rna], ids=["cut", "rna"])
@pytest.mark.parametrize("Q,steep", CASES, ids=IDS)
def test_three_pass_tf32_matches_reference(Q, steep, lo_round):
    """hi.hi + hi.lo + lo.hi within SSD_TOL of the reference (interpret),
    lo cut to TF32 (the kernel) or rounded to it."""
    errs = _rel_errs(_inputs(Q, steep), passes=3, lo_round=lo_round)
    assert max(errs) <= SSD_TOL, errs


@pytest.mark.parametrize("Q,steep", CASES, ids=IDS)
def test_one_pass_tf32_misses_tolerance(Q, steep):
    """hi.hi alone exceeds SSD_TOL on the same inputs."""
    errs = _rel_errs(_inputs(Q, steep), passes=1)
    assert max(errs) > SSD_TOL, errs
