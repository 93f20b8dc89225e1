"""rwkv6-7b (Finch) [arXiv:2404.05892; hf] — attention-free, data-dependent decay."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads (head_dim = 64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    source="arXiv:2404.05892; hf",
)
