"""llama3-405b: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256 —
GQA 128k vocab [arXiv:2407.21783; unverified]."""
from .base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="llama3-405b", family="dense",
        num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
        d_ff=53248, vocab_size=128256, mlp_act="silu", mlp_glu=True,
        rope_theta=5e5),
)


def reduced() -> ArchConfig:
    return ArchConfig(model=ModelConfig(
        name="llama3-405b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=251, mlp_act="silu", mlp_glu=True))
