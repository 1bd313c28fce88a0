"""Parallel context: the single source of truth for how the model axis is factorized.

Tesseract (the paper) arranges the tensor-parallel group as a [q, q, d] grid
(`rows`, `cols`, `depth`).  The same abstraction covers the paper's baselines:

- ``tesseract``  : rows=cols=q, depth=d  (p = d*q^2)     [paper, 2.5-D]
- ``summa2d``    : depth=1               (Optimus, 2-D)
- ``megatron1d`` : rows=depth=1, cols=p  (Megatron-LM, 1-D)
- ``gspmd``      : same math as plain einsums + sharding constraints; XLA picks
                   the collective schedule (beyond-paper comparison mode).

The PyTorch port's own copy of ``repro.core.api``.  The port runs the
``tesseract`` and ``summa2d`` layouts over any ``data``, ``depth`` and
``rows == cols``, and ``megatron1d`` over any ``data`` and ``cols``
(``require_supported`` refuses the rest: a ``seq`` axis and ``gspmd``).
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

    The copy keeps the layout fields, the SUMMA ``matmul_schedule``, the
    attention data path, and the reference's gather-caching and dgrad knobs
    of the multi-rank matmul's backward (``core/summa.py``).  The seq-ring
    ``attn_schedule`` comes back with the ``seq`` axis (ROADMAP Queue A,
    item A3)."""

    mode: str = "tesseract"  # tesseract | summa2d | megatron1d | gspmd
    data: int = 1
    depth: int = 1
    rows: int = 1
    cols: int = 1
    # Sequence-axis shards (ring/striped flash attention in the reference).
    seq: int = 1
    # SUMMA execution schedule of the Tesseract matmuls (core/summa.py):
    #   "fused" — one all_gather per operand, then kernel #1 (tesseract_mm)
    #             on the gathered [T, E, F] x [T, F, G];
    #   "ring"  — Cannon-style skewed double ring over (row, col): q steps,
    #             each contracting the resident pair with kernel #2
    #             (tesseract_mm_stream) while the next pair is shifted;
    #   "auto"  — per-op: ring for large token blocks on q >= 4 grids,
    #             fused otherwise (summa.py::effective_schedule).
    matmul_schedule: str = "fused"
    # Attention data path: "jnp" = the plain PyTorch versions, "pallas" =
    # the Hopper kernels, "auto" = the kernels on a CUDA device and the
    # plain versions on the CPU (kernels/ops.py::effective_attn_impl).
    attn_impl: str = "jnp"
    # Backward of the fused SUMMA schedule: keep the forward's gathered W
    # (over row) and / or gathered A (over col) for the backward instead of
    # gathering them again (memory for bytes on the wire).
    cache_weight_gather: bool = True
    cache_act_gather: bool = False
    # The paper's per-op dW all-reduce over (data, depth) inside the
    # matmul's backward; False defers it to the step's one psum per leaf
    # (runtime/steps.py::sync_grads).
    reduce_dgrad_in_op: bool = True
    # bf16 wire format of the SUMMA backward's dW reductions (the
    # reduce-scatter over row, the ring's adds and the in-op psum), on
    # both schedules (core/summa.py).
    dgrad_rs_bf16: bool = False

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
        if self.matmul_schedule not in ("fused", "ring", "auto"):
            raise ValueError(
                f"matmul_schedule must be 'fused', 'ring' or 'auto', "
                f"got {self.matmul_schedule!r}")
        if self.matmul_schedule in ("ring", "auto") and self.mode == "megatron1d":
            raise ValueError(
                f"matmul_schedule={self.matmul_schedule!r} is a SUMMA "
                "schedule selector; megatron1d has no [q, q] grid to ring over")
        if self.attn_impl not in ("jnp", "pallas", "auto"):
            raise ValueError(
                f"attn_impl must be 'jnp', 'pallas' or 'auto', "
                f"got {self.attn_impl!r}")
        if self.seq < 1:
            raise ValueError(f"seq must be >= 1, got {self.seq}")

    # ---- derived sizes ----
    @property
    def q(self) -> int:
        return self.cols

    @property
    def tp(self) -> int:
        """Size of the tensor-parallel group (depth * rows * cols)."""
        return self.depth * self.rows * self.cols

    @property
    def size(self) -> int:
        """Ranks of the whole mesh (data * depth * rows * cols)."""
        return self.data * self.tp

    @property
    def batch_shards(self) -> int:
        """How many ways the token dim is sharded in the canonical layout."""
        return self.data * self.depth * self.rows

    def replace(self, **kw) -> "ParallelContext":
        return dataclasses.replace(self, **kw)

    @property
    def seq_shard_axes(self) -> tuple:
        """Axes that shard the sequence of the prefill plan (Megatron-SP
        shards it over col)."""
        if self.mode == "megatron1d":
            return (self.axis_col,)
        return (self.axis_depth, self.axis_row)

    @property
    def model_axes(self) -> tuple:
        return (self.axis_depth, self.axis_row, self.axis_col)

    @property
    def token_axes(self) -> tuple:
        """Mesh axes that shard the token (batch*seq) dim of activations."""
        if self.mode == "megatron1d":
            return (self.axis_data,)
        return (self.axis_data, self.axis_depth, self.axis_row)


def require_supported(ctx: ParallelContext) -> None:
    """Raise NotImplementedError for a layout the port does not run.

    It runs ``tesseract`` and ``summa2d`` at any ``data``, ``depth`` and
    ``rows == cols``, and ``megatron1d`` (rows = depth = 1, the fused
    schedule: ``ParallelContext`` checks both) at any ``data`` and
    ``cols``; the ``seq`` axis (ring/striped attention) and the ``gspmd``
    op set are ROADMAP Queue A, item A3."""
    if ctx.mode not in ("tesseract", "summa2d", "megatron1d"):
        raise NotImplementedError(
            f"mode={ctx.mode!r} is not ported yet (ROADMAP Queue A, item A3: "
            f"the gspmd op set)")
    if ctx.seq > 1:
        raise NotImplementedError(
            f"seq={ctx.seq} is not ported yet (ROADMAP Queue A, item A3: "
            f"ring/striped attention over a seq axis)")
