"""ZeRO-1's host-side reslicing and the elastic re-plan of the port
against the JAX package's, on the CPU: ``host_shard`` / ``host_unshard``
/ ``convert_leaf`` bit-equal to ``repro.optim.zero``'s over random
layouts (and the checkpoint converter making a ZeRO-1 leaf global), and
``replan`` equal to ``repro.runtime.elastic.replan`` over a grid of
layouts, survivor counts and batches (the same plan or the same error).
"""
import numpy as np
import pytest

from repro.core.api import ParallelContext as RefCtx
from repro.optim import zero as ref_zero
from repro.runtime import elastic as ref_elastic
from repro_torch.core.api import ParallelContext
from repro_torch.optim import zero
from repro_torch.runtime import elastic


def _random_layout(rng):
    """A leaf's ZeRO-1 layout on a random mesh: 1-3 dims, each sharded
    over 0-2 of the mesh axes."""
    sizes = {a: int(rng.choice([1, 2, 3])) for a in
             ("data", "depth", "row", "col")}
    free = ["depth", "row", "col"]
    rng.shuffle(free)
    spec, shape = [], []
    for _ in range(int(rng.integers(1, 4))):
        axes = tuple(free.pop() for _ in range(int(rng.integers(
            0, min(2, len(free)) + 1))))
        spec.append(axes)
        shape.append(int(np.prod([sizes[a] for a in axes]))
                     * int(rng.integers(1, 6)))
    return spec, tuple(shape), sizes


@pytest.mark.parametrize("seed", range(6))
def test_zero_host_reslice_equals_reference(seed):
    rng = np.random.default_rng(seed)
    spec, shape, sizes = _random_layout(rng)
    spec2, _, sizes2 = _random_layout(np.random.default_rng(seed + 100))
    lay = zero.layout_for(spec, shape, sizes)
    want_lay = ref_zero.LeafLayout.from_json(lay.to_json())
    assert zero.LeafLayout.from_json(want_lay.to_json()) == lay
    assert (lay.n_slices, lay.k) == (want_lay.n_slices, want_lay.k)
    full = rng.standard_normal(shape).astype(np.float32)
    z = zero.host_shard(full, lay)
    np.testing.assert_array_equal(z, ref_zero.host_shard(full, want_lay))
    np.testing.assert_array_equal(zero.host_unshard(z, lay), full)
    np.testing.assert_array_equal(zero.host_unshard(z, lay),
                                  ref_zero.host_unshard(z, want_lay))
    # to another mesh's layout of the same leaf (its own spec kept)
    sizes2 = dict(sizes2, **{a: sizes[a] for d in spec for a in d})
    other = zero.layout_for(spec, shape, sizes2)
    np.testing.assert_array_equal(
        zero.convert_leaf(z, lay, other),
        ref_zero.convert_leaf(z, want_lay,
                              ref_zero.LeafLayout.from_json(
                                  other.to_json())))
    conv = zero.make_ckpt_converter(None)
    meta = {"opt_layout": {"blocks/w": lay.to_json()}}
    np.testing.assert_array_equal(conv("opt/m/blocks/w", z, meta), full)
    assert conv("params/blocks/w", z, meta) is z


@pytest.mark.parametrize("layout,n", [((8, 1, 1, 1), 4), ((8, 1, 1, 1), 3),
                                      ((2, 2, 1, 1), 2), ((4, 1, 2, 2), 9),
                                      ((2, 2, 2, 2), 8), ((1, 2, 2, 2), 4)])
def test_replan_equals_reference(layout, n):
    data, depth, rows, cols = layout
    for batch in (7, 16, 24):
        got = want = None
        try:
            want = ref_elastic.replan(n, RefCtx(
                data=data, depth=depth, rows=rows, cols=cols),
                global_batch=batch)
        except (ValueError, RuntimeError) as e:
            want = type(e)
        try:
            got = elastic.replan(n, ParallelContext(
                data=data, depth=depth, rows=rows, cols=cols),
                global_batch=batch)
        except (ValueError, RuntimeError) as e:
            got = type(e)
        if isinstance(want, type):
            assert got is want, (layout, n, batch)
            continue
        assert (got.ctx.data, got.ctx.depth, got.ctx.rows, got.ctx.cols,
                got.n_used, got.n_idle, got.accum_steps) == \
            (want.ctx.data, want.ctx.depth, want.ctx.rows, want.ctx.cols,
             want.n_used, want.n_idle, want.accum_steps), (layout, n, batch)
