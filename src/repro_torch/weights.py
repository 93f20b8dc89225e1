"""Load the JAX package's parameter tree into the port's.

``params_from_jax`` takes the reference ``TransformerLM``'s, ``RWKV6LM``'s or
``HymbaLM``'s params as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree, same names and layout, as tensors on ``device``.  With it both
packages compute on the same weights, which is how the tests hold one to the
other.
This module imports neither JAX nor the reference: it only reads arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig

def _tensor(a, device, dtype) -> torch.Tensor:
    # bf16 has no numpy dtype: go through f32, which holds every bf16 value exactly.
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device).to(dtype)


def params_from_jax(np_params: dict, cfg: ArchConfig, device="cuda", dtype=torch.float32) -> dict:
    """The port's param tree from the reference's (numpy leaves)."""
    if cfg.family not in ("dense", "ssm", "hybrid") or cfg.moe is not None or cfg.qkv_bias:
        raise NotImplementedError(f"only dense transformer, RWKV6 and Hymba params convert so far, not {cfg.name!r}")
    convert = lambda tree: {k: convert(v) if isinstance(v, dict) else _tensor(v, device, dtype)
                            for k, v in tree.items()}
    out = convert(np_params)
    if "unembed" not in out["emb"]:
        out["emb"]["embed_t"] = out["emb"]["embed"].t().contiguous()
    return out
