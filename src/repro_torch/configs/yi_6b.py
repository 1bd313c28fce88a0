"""yi-6b: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="yi-6b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, mlp_act="silu", mlp_glu=True,
        rope_theta=5e6),
    notes="llama-style dense GQA; kv=4 heads are replicated across col when "
          "q does not divide 4 (q=2 shards them 2-way).",
)


def reduced() -> ArchConfig:
    return ArchConfig(model=ModelConfig(
        name="yi-6b-reduced", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=503, mlp_act="silu", mlp_glu=True))
