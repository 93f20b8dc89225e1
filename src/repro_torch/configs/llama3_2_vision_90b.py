"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Cross-attn image layers every 5th layer; modality frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings (per assignment).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_every=5,
    n_image_tokens=1024,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
