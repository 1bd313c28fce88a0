"""Training across ranks: the layout tables, checked without a spawn (the
rest of the letters: ``tests/test_torch_train_mesh.py``).

(a) ``optim/zero.py``'s layouts against ``repro.optim.zero.build_layouts``
    on the reference's own specs and abstract params: the same zaxes, k,
    local shape and padding;
(b) ``convert.unshard_params`` inverts ``convert.shard_params``.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.configs.base import RunConfig as RefRun
from repro.core.api import ParallelContext as RefCtx
from repro.core.ops import Plan as RefPlan
from repro.core.ops import make_ops as ref_make_ops
from repro.models.registry import build_model as ref_build
from repro.models.registry import get_reduced as ref_reduced
from repro.optim import zero as ref_zero
from repro_torch.convert import shard_params, unshard_params
from repro_torch.core.api import ParallelContext
from repro_torch.optim import zero

LAYOUTS = [(1, 1, 2, 2), (2, 2, 1, 1), (1, 2, 2, 2), (2, 1, 2, 2)]


def _ref_tree(arch, layout, kv=0):
    cfg = ref_reduced(arch).model
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    data, depth, rows, cols = layout
    ctx = RefCtx(mode="tesseract", data=data, depth=depth, rows=rows,
                 cols=cols)
    model = ref_build(cfg, ctx, RefRun(param_dtype="float32"))
    specs = model.specs(ref_make_ops(ctx, RefPlan.for_shape("train")))
    return cfg, model, specs


def _items(tree):
    top = [(k, v) for k, v in tree.items() if k != "blocks"]
    return top + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


@pytest.mark.parametrize("arch,layout", list(itertools.product(
    ["yi-6b", "smollm-360m"], LAYOUTS)))
def test_zero_layouts_match_reference(arch, layout):
    """The port's ``build_layouts`` on the reference's specs (as per-dim
    axis tuples) and shapes gives the reference's layouts leaf by leaf."""
    cfg, model, specs = _ref_tree(arch, layout)
    sizes = dict(zip(("data", "depth", "row", "col"), layout))
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = ref_zero.build_layouts(specs, abstract, sizes)
    port_specs = jax.tree.map(ref_zero.spec_dim_axes, specs,
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
    shapes = jax.tree.map(lambda a: tuple(a.shape), abstract)
    got = zero.build_layouts(port_specs, shapes, sizes)
    for (name, g), (_, w) in zip(_items(got), _items(want)):
        assert g.zaxes == w.zaxes, name
        assert g.local_shape == w.local_shape, name
        assert (g.zn, g.k) == (w.zn, w.k), name
        assert g.k * g.zn - int(np.prod(g.local_shape)) == \
            w.k * w.zn - int(np.prod(w.local_shape)), name


@pytest.mark.parametrize("arch,kv,layout", [
    ("yi-6b", 0, (1, 1, 2, 2)), ("yi-6b", 1, (1, 2, 2, 2)),
    ("smollm-360m", 0, (2, 1, 2, 2)), ("smollm-360m", 0, (2, 2, 1, 1))])
def test_unshard_params_inverts_shard_params(arch, kv, layout):
    """Every rank's blocks of the reference's one-device tree, put back
    together, give that tree (the layout's padding cut off)."""
    cfg, _, _ = _ref_tree(arch, (1, 1, 1, 1), kv)
    one = ref_build(cfg, RefCtx(mode="tesseract"),
                    RefRun(param_dtype="float32"))
    tree = jax.tree.map(np.asarray, one.init(jax.random.PRNGKey(0)))
    data, depth, rows, cols = layout
    ctx = ParallelContext(data=data, depth=depth, rows=rows, cols=cols)
    blocks = [shard_params(tree, cfg, ctx, dict(zip(
        ("data", "depth", "row", "col"), c)))
        for c in itertools.product(*(range(n) for n in layout))]
    got = unshard_params(blocks, cfg, ctx)
    for (name, g), (_, w) in zip(_items(got), _items(tree)):
        np.testing.assert_array_equal(g, w, err_msg=name)
