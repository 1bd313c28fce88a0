"""Config dataclasses: model architecture, run options, shape grid.

The PyTorch port's own copy of ``repro.configs.base`` (the port imports
nothing of the JAX package), so a config reads the same in both packages.
One file per ported architecture (the dense ones and mamba2 of the ssm
family) lives next to this module; each exports ``CONFIG: ArchConfig``
(full published config) and ``reduced() -> ArchConfig`` (a tiny
same-family config for CPU tests).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    mlp_act: str = "silu"        # silu (glu) | relu2 | gelu
    mlp_glu: bool = True
    use_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 5e5
    use_rope: bool = True
    norm_eps: float = 1e-5
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0  # deepseek-style always-on experts
    moe_d_ff: int = 0            # per-expert ffn width (routed)
    moe_every: int = 1           # apply MoE every k-th layer (1 = all)
    first_dense: int = 0         # leading dense layers (deepseek: 1)
    # --- MLA (deepseek) ---
    mla_kv_lora: int = 0
    mla_q_lora: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0    # one cross-attn block per k self-attn blocks
    vision_dim: int = 0
    vision_tokens: int = 0
    # --- hybrid (recurrentgemma) ---
    lru_width: int = 0
    local_window: int = 0
    block_pattern: tuple = ()    # e.g. ("rec", "rec", "attn")
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- audio (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0             # stub frontend frames (whisper-base: 1500)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D accounting)."""
        h, v, L = self.d_model, self.vocab_size, self.num_layers
        d = self.resolved_head_dim
        n = 2 * v * h  # embed + head
        att = h * self.num_heads * d + 2 * h * self.num_kv_heads * d \
            + self.num_heads * d * h
        if self.mla_kv_lora:
            qd = self.qk_nope_dim + self.qk_rope_dim
            att = (h * self.mla_q_lora + self.mla_q_lora * self.num_heads * qd
                   + h * (self.mla_kv_lora + self.qk_rope_dim)
                   + self.mla_kv_lora * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                   + self.num_heads * self.v_head_dim * h)
        mlp_mult = 3 if self.mlp_glu else 2
        if self.family == "ssm":
            di = self.ssm_expand * h
            heads = di // self.ssm_head_dim
            per = (h * (2 * di + 2 * self.ssm_state * 1 + heads) + di * h)
            n += L * per + L * 2 * h
            return n
        mlp = mlp_mult * h * self.d_ff
        if self.moe_num_experts:
            moe = self.moe_num_experts * mlp_mult * h * self.moe_d_ff \
                + self.moe_shared_experts * mlp_mult * h * self.moe_d_ff \
                + h * self.moe_num_experts
            n_moe_layers = max(0, (L - self.first_dense)) // max(self.moe_every, 1)
            n += n_moe_layers * (att + moe + 2 * h) \
                + (L - n_moe_layers) * (att + mlp + 2 * h)
        else:
            n += L * (att + mlp + 2 * h)
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            cross = (self.vision_dim * 2 * self.num_kv_heads * d
                     + h * self.num_heads * d + self.num_heads * d * h + 2 * h)
            n += n_cross * cross
        if self.enc_layers:
            n += self.enc_layers * (att + mlp + 2 * h)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.moe_num_experts:
            return self.param_count()
        full = self.param_count()
        mlp_mult = 3 if self.mlp_glu else 2
        h = self.d_model
        n_moe_layers = max(0, (self.num_layers - self.first_dense)) // max(self.moe_every, 1)
        all_experts = n_moe_layers * self.moe_num_experts * mlp_mult * h * self.moe_d_ff
        active_experts = n_moe_layers * self.moe_top_k * mlp_mult * h * self.moe_d_ff
        return full - all_experts + active_experts


_DTYPES = ("float32", "bfloat16", "float16")


@dataclass(frozen=True)
class RunConfig:
    """Run options of the serve and train slices, with the reference's
    defaults.  The reference's fields that the port does not run yet
    (pipeline and sequence shards, the attention schedules), the optimizer
    choice (AdamW only until LAMB is ported) and the attention chunk sizes
    of its jnp path come back with the slices that use them (ROADMAP
    Queue A); passing one is a TypeError rather than a setting that
    silently does nothing."""
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Per-block activation checkpointing of the train loss: "none" keeps
    # every activation, "full" recomputes each block in the backward
    # (torch.utils.checkpoint, the reference's jax.checkpoint).
    remat: str = "full"          # none | full  ("dots" is not ported)
    loss_chunk: int = 512        # tokens per cross-entropy chunk
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # Static loss scaling for low-precision compute: the loss is multiplied
    # by loss_scale before the backward and gradients are unscaled before
    # clipping and the optimizer.
    loss_scale: float = 1.0
    # Attention data path ("jnp" | "pallas" | "auto"), the config surface
    # that launchers copy onto ParallelContext.attn_impl.  In the port
    # (kernels/ops.py): "pallas" runs the Hopper kernels, "jnp" their plain
    # PyTorch versions, "auto" the kernels on a CUDA device and the plain
    # versions on the CPU.
    attn_impl: str = "jnp"
    # The ssm mixer's SSD intra-chunk pass: True runs kernels/ssd.py's
    # wrapper (the Hopper kernel for a CUDA tensor, its plain version for a
    # CPU tensor), False the plain version (the reference's einsum path).
    use_pallas: bool = False
    # Gradient-accumulation microbatches per optimizer step (train loop
    # default).
    accum_steps: int = 1
    # Deterministic fault injection plan (runtime/faults.py DSL, "" =
    # none), validated here; the train loop fires its train.* and ckpt.*
    # sites, and the serve engine refuses a serve.* site (ROADMAP Queue A,
    # item A3).  The whole fault sequence is a pure function of
    # (fault_seed, site, kind, step).
    fault_plan: str = ""
    fault_seed: int = 0
    # Non-finite update skips tolerated per step before the train loop
    # backs off loss_scale or raises (the reference's recovery ladder).
    nan_skip_limit: int = 2
    # ZeRO-1: the optimizer state of each leaf partitioned over the data and
    # depth axes it is replicated on (optim/zero.py); zero_stage=1 is the
    # same switch.
    zero1: bool = False
    zero_stage: int = 0
    # Wire format of the gradient reductions of the data and depth axes
    # (the step's gradient sync and ZeRO-1's reduce-scatter): "none"
    # (the gradients' dtype) or "bf16" (runtime/steps.py).
    grad_compression: str = "none"

    def __post_init__(self):
        if self.param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype must be one of {_DTYPES}, "
                             f"got {self.param_dtype!r}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {_DTYPES}, "
                             f"got {self.compute_dtype!r}")
        if self.remat == "dots":
            raise NotImplementedError(
                "remat='dots' (save matmul outputs) is not supported by "
                "repro_torch yet (ROADMAP Queue A, item A3)")
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', "
                             f"got {self.remat!r}")
        if not self.loss_scale > 0:
            raise ValueError(f"loss_scale must be > 0, got {self.loss_scale}")
        if self.loss_chunk < 1 or self.accum_steps < 1:
            raise ValueError(f"loss_chunk and accum_steps must be >= 1, got "
                             f"{self.loss_chunk}, {self.accum_steps}")
        if self.nan_skip_limit < 0:
            raise ValueError(f"nan_skip_limit must be >= 0, "
                             f"got {self.nan_skip_limit}")
        if self.attn_impl not in ("jnp", "pallas", "auto"):
            raise ValueError(f"attn_impl must be 'jnp', 'pallas' or 'auto', "
                             f"got {self.attn_impl!r}")
        if self.zero_stage not in (0, 1):
            raise ValueError(f"zero_stage must be 0 or 1, "
                             f"got {self.zero_stage}")
        if self.grad_compression not in ("none", "bf16"):
            raise ValueError(f"grad_compression must be 'none' or 'bf16', "
                             f"got {self.grad_compression!r}")
        if self.fault_plan:
            from ..runtime.faults import FaultPlan
            FaultPlan.parse(self.fault_plan)   # validate sites and kinds

    @property
    def zero_enabled(self) -> bool:
        return self.zero1 or self.zero_stage >= 1

    @property
    def master_weights(self) -> bool:
        """fp32 master copies are kept whenever params are low-precision."""
        return self.param_dtype != "float32"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic temporal mixing)
LONG_CONTEXT_OK = ("mamba2-1.3b", "recurrentgemma-9b")


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    notes: str = ""

    def shape_list(self):
        out = []
        for s in self.shapes:
            if s == "long_500k" and self.model.name not in LONG_CONTEXT_OK:
                continue
            out.append(SHAPES[s])
        return out

    def skipped_shapes(self):
        return [s for s in self.shapes
                if s == "long_500k" and self.model.name not in LONG_CONTEXT_OK]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
