"""mamba2-1.3b: 48L d_model=2048 (attn-free) vocab=50280, ssm_state=128 —
SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=256, ssm_conv=4),
    notes="attention-free; long_500k runs (constant state). Projections are "
          "tesseract-sharded; SSD temporal mixing is a chunked scan "
          "(see DESIGN.md §6).",
)


def reduced() -> ArchConfig:
    return ArchConfig(model=ModelConfig(
        name="mamba2-reduced", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=251, ssm_state=16, ssm_head_dim=16,
        ssm_expand=2, ssm_chunk=8, ssm_conv=4))
