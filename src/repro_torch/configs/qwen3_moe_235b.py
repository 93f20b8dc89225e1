"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B; hf] — MoE 128e top-8."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    moe=MoESpec(n_experts=128, top_k=8),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
