"""Load the JAX package's parameter tree into the port's.

``params_from_jax`` takes the reference ``TransformerLM``'s or ``RWKV6LM``'s
params as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's tree, same names and layout, as tensors on ``device``.  With it both
packages compute on the same weights, which is how the tests hold one to the
other.
This module imports neither JAX nor the reference: it only reads arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig

_ATTN = ("wq", "wk", "wv", "wo")
_FFN = ("w_gate", "w_up", "w_down")


def _tensor(a, device, dtype) -> torch.Tensor:
    # bf16 has no numpy dtype: go through f32, which holds every bf16 value exactly.
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device).to(dtype)


def params_from_jax(np_params: dict, cfg: ArchConfig, device="cuda", dtype=torch.float32) -> dict:
    """The port's param tree from the reference's (numpy leaves)."""
    if cfg.family not in ("dense", "ssm") or cfg.moe is not None:
        raise NotImplementedError(f"only dense transformer and RWKV6 params convert so far, not {cfg.family!r}")
    t = lambda a: _tensor(a, device, dtype)
    blocks = np_params["blocks"]
    emb = {"embed": t(np_params["emb"]["embed"])}
    if "unembed" in np_params["emb"]:
        emb["unembed"] = t(np_params["emb"]["unembed"])
    else:
        emb["embed_t"] = emb["embed"].t().contiguous()
    if cfg.family == "ssm":
        return {
            "emb": emb,
            "final_norm": t(np_params["final_norm"]),
            "blocks": {
                "rwkv": {k: t(a) for k, a in blocks["rwkv"].items()},
                "ln1": t(blocks["ln1"]),
                "ln2": t(blocks["ln2"]),
            },
        }
    return {
        "emb": emb,
        "final_norm": t(np_params["final_norm"]),
        "blocks": {
            "attn": {k: t(blocks["attn"][k]) for k in _ATTN},
            "ffn": {k: t(blocks["ffn"][k]) for k in _FFN},
            "ln1": t(blocks["ln1"]),
            "ln2": t(blocks["ln2"]),
        },
    }
