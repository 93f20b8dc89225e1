"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec, multimodal.

Backbone only: the audio frontend is a STUB; ``input_specs()`` provides
precomputed frame embeddings for the encoder (per assignment).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    source="arXiv:2308.11596; hf",
)
