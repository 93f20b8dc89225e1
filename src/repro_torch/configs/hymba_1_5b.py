"""hymba-1.5b [arXiv:2411.13676; hf] — parallel attn + mamba heads.

Sliding-window attention on all but 3 global layers (first/middle/last),
so long-context decode keeps an O(window) KV cache.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=2048,
    source="arXiv:2411.13676; hf",
)
