"""Parallel context: the single source of truth for how the model axis is factorized.

Tesseract (the paper) arranges the tensor-parallel group as a [q, q, d] grid
(`rows`, `cols`, `depth`).  The same abstraction covers the paper's baselines:

- ``tesseract``  : rows=cols=q, depth=d  (p = d*q^2)     [paper, 2.5-D]
- ``summa2d``    : depth=1               (Optimus, 2-D)
- ``megatron1d`` : rows=depth=1, cols=p  (Megatron-LM, 1-D)
- ``gspmd``      : same math as plain einsums + sharding constraints; XLA picks
                   the collective schedule (beyond-paper comparison mode).

The PyTorch port's own copy of ``repro.core.api``.  The port runs only the
single-device layout so far (``data = depth = rows = cols = seq = 1``):
``require_single_device`` refuses every other context.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

AXIS_DATA = "data"
AXIS_DEPTH = "depth"
AXIS_ROW = "row"
AXIS_COL = "col"


@dataclass(frozen=True)
class ParallelContext:
    """Hashable parallelism descriptor.

    The copy keeps the layout fields and the attention data path.  The
    reference's perf knobs (weight/activation gather caching, dgrad
    reduction, the SUMMA ``matmul_schedule`` and the seq-ring
    ``attn_schedule``) act only across ranks and come back with the
    multi-rank slice (ROADMAP Queue A, item A1)."""

    mode: str = "tesseract"  # tesseract | summa2d | megatron1d | gspmd
    data: int = 1
    depth: int = 1
    rows: int = 1
    cols: int = 1
    # Sequence-axis shards (ring/striped flash attention in the reference).
    seq: int = 1
    # Attention data path: "jnp" = the plain PyTorch versions, "pallas" =
    # the Hopper kernels, "auto" = the kernels on a CUDA device and the
    # plain versions on the CPU (kernels/ops.py::effective_attn_impl).
    attn_impl: str = "jnp"

    # axis names (fixed; kept here so ops never hard-code strings)
    axis_data: str = AXIS_DATA
    axis_depth: str = AXIS_DEPTH
    axis_row: str = AXIS_ROW
    axis_col: str = AXIS_COL

    def __post_init__(self):
        if self.mode in ("tesseract", "summa2d"):
            if self.rows != self.cols:
                raise ValueError(f"tesseract requires square q: {self.rows}x{self.cols}")
            if self.mode == "summa2d" and self.depth != 1:
                raise ValueError("summa2d is tesseract with depth=1")
        elif self.mode == "megatron1d":
            if self.rows != 1 or self.depth != 1:
                raise ValueError("megatron1d uses rows=depth=1, cols=p")
        elif self.mode != "gspmd":
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.attn_impl not in ("jnp", "pallas", "auto"):
            raise ValueError(
                f"attn_impl must be 'jnp', 'pallas' or 'auto', "
                f"got {self.attn_impl!r}")
        if self.seq < 1:
            raise ValueError(f"seq must be >= 1, got {self.seq}")

    @property
    def batch_shards(self) -> int:
        """How many ways the token dim is sharded in the canonical layout."""
        return self.data * self.depth * self.rows

    def replace(self, **kw) -> "ParallelContext":
        return dataclasses.replace(self, **kw)

    @property
    def token_axes(self) -> tuple:
        """Mesh axes that shard the token (batch*seq) dim of activations."""
        if self.mode == "megatron1d":
            return (self.axis_data,)
        return (self.axis_data, self.axis_depth, self.axis_row)


def require_single_device(ctx: ParallelContext) -> None:
    """Raise NotImplementedError unless ``ctx`` is the one-device layout.

    At one device every Tesseract collective is the identity, which is all
    the port implements so far; the multi-rank mesh over NCCL is ROADMAP
    Queue A, item A1."""
    if ctx.mode not in ("tesseract", "summa2d"):
        raise NotImplementedError(
            f"mode={ctx.mode!r} is not ported yet (ROADMAP Queue A, item A3: "
            f"MegatronOps and the other op sets)")
    sizes = dict(data=ctx.data, depth=ctx.depth, rows=ctx.rows,
                 cols=ctx.cols, seq=ctx.seq)
    if any(n != 1 for n in sizes.values()):
        raise NotImplementedError(
            f"repro_torch runs one device only, got {sizes} (ROADMAP Queue "
            f"A, item A1: multi-rank Tesseract serving over NCCL)")
