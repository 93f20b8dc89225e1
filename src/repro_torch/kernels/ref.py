"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch


def matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Oracle for kernels/matmul.py: f32-accumulated 2-D matmul, cast once."""
    out_dtype = out_dtype or lhs.dtype
    return (lhs.float() @ rhs.float()).to(out_dtype)
