"""The split paged-decode kernel's arithmetic, checked on the CPU.

``csrc/paged_attention.cu`` splits each request's live positions into spans
of ``split_pages(nb, bs)`` pages (``SPLIT_POSITIONS`` rounded down to whole
pages, from the table's shape alone), one block per (split, kv head,
batch).  A block walks its span 64 positions at a time with an online
softmax for each q head that ``kv_map`` sends to its kv head, and writes a
partial (m, l, acc); a split wholly past ``pos`` or before the window's
first page writes (m = -1e30, l = 0).  A second kernel merges the splits in
order: acc = sum_s exp(max(m_s, -1e25) - M) acc_s over the splits with
l_s > 0, out = acc / l, zeros where l = 0.

``_split_combine`` mirrors that in fp32 torch, with the grid sized by the
port's own ``split_pages``, and is held to the reference's Pallas
``paged_attention`` in interpret mode (and to the port's plain version) on
tables where: splits lie wholly past ``pos``; a window's first page falls
inside a split and the window crosses a split boundary; a slot is retired;
a row has nothing to attend (exact zeros); ``kv_map`` is non-uniform, with
a kv head that serves no q head and one that serves more q heads than a
block takes in one pass (``GMAX``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as ref_paged
from repro_torch.kernels.paged_attention import (SPLIT_POSITIONS,
                                                 paged_attention_plain,
                                                 split_pages)

NEG_INF, M_FLOOR = -1e30, -1e25
CH = 64          # positions a split block stages per chunk (the kernel's CH)
GMAX = 8         # q heads a split block takes per pass (one warp each)
TOL = dict(rtol=1e-5, atol=1e-5)   # fp32: only the summation order differs


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


def _bounds(p, bs, nb, window):
    """[lo, hi) live pages (the reference's _page_bounds, hi clamped)."""
    hi = min(p // bs + 1, nb)
    lo = 0
    if window > 0:
        lo = min(max(p - window + 1, 0) // bs, hi - 1)
    return lo, hi


def _split_combine(q, pk, pv, table, pos, kv_map, window):
    """The split and combine kernels' arithmetic, in fp32 torch; returns
    (out, the (m, l) partials, the pages each split read)."""
    B, Hq, D = q.shape
    bs, Hkv = pk.shape[1], pk.shape[2]
    nb = table.shape[1]
    pps, n_splits = split_pages(nb, bs)
    scale = 1.0 / np.sqrt(D)
    m_part = torch.full((B, Hq, n_splits), NEG_INF)
    l_part = torch.zeros(B, Hq, n_splits)
    acc_part = torch.zeros(B, Hq, n_splits, D)
    read = {}
    for b in range(B):
        p_cur = int(pos[b])
        lo, hi = _bounds(p_cur, bs, nb, window)
        for s in range(n_splits):
            pg0, pg1 = max(s * pps, lo), min((s + 1) * pps, hi)
            if pg0 >= pg1:
                continue                               # empty partial
            read[b, s] = list(range(pg0, pg1))
            for hk in range(Hkv):
                heads = [h for h in range(Hq) if int(kv_map[h]) == hk]
                for h in heads:
                    m, l = torch.tensor(NEG_INF), torch.tensor(0.0)
                    acc = torch.zeros(D)
                    for c0 in range(pg0 * bs, pg1 * bs, CH):
                        pp = torch.arange(c0, min(c0 + CH, pg1 * bs))
                        rows = table[b, pp // bs].long() * bs + pp % bs
                        k = pk.reshape(-1, Hkv, D)[rows, hk]
                        v = pv.reshape(-1, Hkv, D)[rows, hk]
                        sc = (k @ q[b, h]) * scale
                        ok = pp <= p_cur
                        if window > 0:
                            ok &= pp > p_cur - window
                        sc = torch.where(ok, sc, torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, sc.max())
                        ms = torch.clamp(m_new, min=M_FLOOR)
                        corr = torch.exp(torch.clamp(m, min=M_FLOOR) - ms)
                        p = torch.exp(sc - ms)
                        l = l * corr + p.sum()
                        acc = acc * corr + p @ v
                        m = m_new
                    m_part[b, h, s], l_part[b, h, s] = m, l
                    acc_part[b, h, s] = acc
    M = torch.clamp(m_part.amax(-1), min=M_FLOOR)
    live = l_part > 0
    w = torch.where(live, torch.exp(torch.clamp(m_part, min=M_FLOOR)
                                    - M[..., None]), torch.zeros(()))
    l = (w * l_part).sum(-1)
    acc = (w[..., None] * acc_part).sum(-2)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out, (m_part, l_part), read


def _case(name):
    """(q, pool_k, pool_v, table, pos, kv_map, window) of one named case,
    from a seeded numpy generator; block sizes give several splits of the
    port's SPLIT_POSITIONS with small tables."""
    rng = np.random.default_rng(CASES.index(name) + 17)
    D, window = 16, 0
    Hq, Hkv = 6, 3
    kv_map = np.array([0, 2, 2, 1, 0, 1], np.int32)
    if name == "past_pos":            # short positions in a long table
        bs, nb = 64, 12
        pos = np.array([5, 70, 200, 0], np.int32)
    elif name == "window_in_split":   # the window's first page is mid-split
        bs, nb, window = 64, 12, 300
        pos = np.array([600, 767, 380, 299], np.int32)
    elif name == "window_crosses":    # pages of two splits, ragged split
        bs, nb, window = 96, 9, 150
        pos = np.array([200, 420, 575, 863], np.int32)
    elif name == "retired_and_empty":  # scratch slot, nothing to attend
        bs, nb = 128, 6
        pos = np.array([0, -1, 700, 0], np.int32)
    elif name == "uneven_map":        # kv 3 serves none, kv 0 serves 10
        bs, nb = 64, 12
        Hq, Hkv = 13, 4
        kv_map = np.array([0] * 10 + [1, 2, 1], np.int32)
        pos = np.array([300, 767, 31], np.int32)
    else:
        raise KeyError(name)
    B = len(pos)
    P = B * nb + 1
    table = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    table = table.astype(np.int32)
    if name == "retired_and_empty":
        table[0] = 0                                  # retired: all scratch
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    pk = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    return q, pk, pv, table, pos, kv_map, window


CASES = ["past_pos", "window_in_split", "window_crosses",
         "retired_and_empty", "uneven_map"]


@pytest.mark.parametrize("name", CASES)
def test_split_combine_matches_reference(name):
    """The mirror against the Pallas kernel (interpret) and the port's plain
    version."""
    q, pk, pv, table, pos, kv_map, window = _case(name)
    t = [torch.from_numpy(a) for a in (q, pk, pv, table, pos, kv_map)]
    got, _, _ = _split_combine(*t, window)
    want = ref_paged(*map(jnp.asarray, (q, pk, pv, table, pos, kv_map)),
                     local_window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = paged_attention_plain(*t, local_window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("name", CASES)
def test_split_partials_and_pages_read(name):
    """Which splits are live and which pages each reads: every live page of
    a request exactly once over its splits, none past pos or before the
    window; the other splits hold (m = -1e30, l = 0); a retired slot reads
    one page and a row with nothing to attend gives exact zeros."""
    q, pk, pv, table, pos, kv_map, window = _case(name)
    t = [torch.from_numpy(a) for a in (q, pk, pv, table, pos, kv_map)]
    out, (m, l), read = _split_combine(*t, window)
    bs, nb = pk.shape[1], table.shape[1]
    pps, n_splits = split_pages(nb, bs)
    for b, p in enumerate(pos):
        lo, hi = _bounds(int(p), bs, nb, window)
        pages = [pg for s in range(n_splits) for pg in read.get((b, s), [])]
        assert pages == list(range(lo, hi)), (b, pages, lo, hi)
        for s in range(n_splits):
            if (b, s) not in read:
                assert bool((m[b, :, s] == NEG_INF).all())
                assert bool((l[b, :, s] == 0).all())
        if p < 0:
            assert pages == [] and bool((out[b] == 0).all())
        if p == 0 and (table[b] == 0).all():
            assert pages == [0]


def test_split_grid_from_table_shape():
    """The grid is a function of (nb, bs): SPLIT_POSITIONS rounded down to
    whole pages, at least one page, enough splits to cover the table."""
    for bs in (1, 4, 8, 16, 64, 96, 256, 300):
        for nb in (1, 7, 256):
            pps, n = split_pages(nb, bs)
            assert pps == max(1, SPLIT_POSITIONS // bs)
            assert pps * bs <= max(SPLIT_POSITIONS, bs)
            assert (n - 1) * pps < nb <= n * pps


def test_uneven_map_needs_two_passes():
    """The uneven case sends more q heads to one kv head than a block takes
    in one pass, and leaves a kv head with none."""
    kv_map = _case("uneven_map")[5]
    counts = np.bincount(kv_map, minlength=4)
    assert counts.max() > GMAX and counts.min() == 0


def test_idle_kv_head_is_not_read():
    """A kv head that serves no q head (kv 3 of the uneven case) takes no
    part: filling its K/V with large values leaves the mirror's partials
    and output, and the reference's output, bit for bit as they were."""
    q, pk, pv, table, pos, kv_map, window = _case("uneven_map")
    idle = 3
    assert idle not in kv_map
    pk2, pv2 = pk.copy(), pv.copy()
    pk2[:, :, idle] = 1e4
    pv2[:, :, idle] = -1e4
    runs = []
    for k, v in ((pk, pv), (pk2, pv2)):
        t = [torch.from_numpy(a) for a in (q, k, v, table, pos, kv_map)]
        out, (m, l), _ = _split_combine(*t, window)
        ref = ref_paged(*map(jnp.asarray, (q, k, v, table, pos, kv_map)),
                        local_window=window, interpret=True)
        runs.append((out, m, l, np.asarray(ref)))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
