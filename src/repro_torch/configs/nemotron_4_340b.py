"""nemotron-4-340b: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
— GQA, squared-ReLU [arXiv:2402.16819; unverified]."""
from .base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="nemotron-4-340b", family="dense",
        num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
        d_ff=73728, vocab_size=256000, mlp_act="relu2", mlp_glu=False,
        norm="layernorm", rope_theta=1e4),
    notes="squared-ReLU non-GLU MLP, layernorm (nemotron-4 uses layernorm1p; "
          "our (1+scale) rms/layernorm parameterization matches that).",
)


def reduced() -> ArchConfig:
    return ArchConfig(model=ModelConfig(
        name="nemotron-4-reduced", family="dense",
        num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=251, mlp_act="relu2", mlp_glu=False,
        norm="layernorm"))
