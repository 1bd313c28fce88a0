"""smollm-360m: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152 —
llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf].

15 heads % q != 0 exercises head padding; kv=5 exercises replicated KV."""
from .base import ArchConfig, ModelConfig

CONFIG = ArchConfig(
    model=ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        d_ff=2560, vocab_size=49152, mlp_act="silu", mlp_glu=True,
        rope_theta=1e4),
    notes="15 q-heads padded to 16 under q=2 (padded heads are exactly "
          "zeroed); 5 KV heads replicated within col groups.",
)


def reduced() -> ArchConfig:
    return ArchConfig(model=ModelConfig(
        name="smollm-360m-reduced", family="dense",
        num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
        d_ff=96, vocab_size=257, head_dim=20, mlp_act="silu", mlp_glu=True))
