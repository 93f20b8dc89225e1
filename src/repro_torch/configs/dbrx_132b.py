"""dbrx-132b [hf:databricks/dbrx-base; unverified] — MoE 16e top-4."""
from .base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoESpec(n_experts=16, top_k=4),
    source="hf:databricks/dbrx-base; unverified",
)
