"""Kernel entry points with runtime kernel selection (the paper's launcher).

Every matmul of the port's models routes through :func:`matmul`, every
multi-token RWKV6 WKV recurrence through :func:`wkv`, and every multi-token
Mamba selective scan through :func:`ssm_scan_fused` (:func:`ssm_scan` is the
same scan from dt * x and dt * a, the TPU kernel's inputs); :func:`attention` is the
tuned flash-attention op (no model calls it: their attention is plain torch
code, as in the reference).  Each asks the current
:class:`~repro_torch.core.runtime.KernelRuntime` for the deployed config of
the problem and runs it.  On a CUDA tensor that is always the hand-written
kernel (``matmul_cuda``, ``wkv_cuda``, ``ssm_cuda`` / ``ssm_cuda_fused``,
``attention_cuda``); a
failure raises, and nothing falls back to the plain version.  The plain
version runs only for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from ..core.runtime import current_runtime
from .attention import DEFAULT_ATTN_CONFIG, AttentionConfig, attention_cuda, attention_plain
from .matmul import DEFAULT_CONFIG, MatmulConfig, matmul_cuda, matmul_plain
from .ssm import DEFAULT_SSM_CONFIG, SsmConfig, ssm_cuda, ssm_cuda_fused, ssm_fused_plain, ssm_plain
from .wkv import DEFAULT_WKV_CONFIG, WkvConfig, wkv_cuda, wkv_plain

__all__ = ["FixedPolicy", "KernelPolicy", "attention", "matmul", "ssm_scan", "ssm_scan_fused", "wkv"]


class KernelPolicy(Protocol):
    """Maps a kernel problem to the deployed config that should run it.

    A policy that has no ``select_attention`` (``select_wkv``,
    ``select_ssm``) does not cover the attention (wkv, ssm_scan) family: the
    runtime then selects ``None`` and the op runs its default config.  A
    tuned ``core.dispatch.Deployment`` is such a policy.
    """

    def select_matmul(self, m: int, k: int, n: int, batch: int) -> MatmulConfig: ...

    def select_attention(self, sq: int, skv: int, d: int) -> AttentionConfig: ...

    def select_wkv(self, s: int, hd: int) -> WkvConfig: ...

    def select_ssm(self, s: int, d: int) -> SsmConfig: ...


@dataclasses.dataclass
class FixedPolicy:
    """Single-kernel-per-family baseline (what an untuned library ships)."""

    matmul_config: MatmulConfig = DEFAULT_CONFIG
    attention_config: AttentionConfig = DEFAULT_ATTN_CONFIG
    wkv_config: WkvConfig = DEFAULT_WKV_CONFIG
    ssm_config: SsmConfig = DEFAULT_SSM_CONFIG

    def select_matmul(self, m, k, n, batch):
        return self.matmul_config

    def select_attention(self, sq, skv, d):
        return self.attention_config

    def select_wkv(self, s, hd):
        return self.wkv_config

    def select_ssm(self, s, d):
        return self.ssm_config


def matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``lhs @ rhs`` with runtime kernel selection.

    ``lhs``: (..., k), ``rhs``: (k, n).  The problem is featurized as in the
    tuning dataset: the trailing lead dim is the GEMM M and everything before
    it the repeated batch, so a (B, S, D) activation is B GEMMs of (S, D).
    The kernel itself runs once on ``lhs.reshape(m * batch, k)``.
    """
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be 2-D, got {tuple(rhs.shape)}")
    *lead, k = lhs.shape
    n = rhs.shape[1]
    m = lead[-1] if lead else 1
    batch = 1
    for d in lead[:-1]:
        batch *= d
    config = current_runtime().select_matmul_config(m, k, n, batch)
    lhs2 = lhs.reshape(m * batch, k)
    if lhs2.device.type == "cpu":
        out = matmul_plain(lhs2, rhs, out_dtype)
    else:
        out = matmul_cuda(lhs2.contiguous(), rhs, config or DEFAULT_CONFIG, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Attention with runtime kernel selection.

    q: (..., sq, d), k/v: (..., skv, d) with the same leading dims (no GQA
    broadcast, as in the reference).  Under ``causal`` the diagonal is
    aligned to the end of KV; a row with no visible column (sq > skv) is
    zeros.  The problem is featurized as in the reference: (sq, skv, d).  On
    CPU tensors the plain version runs; on a CUDA tensor the kernel runs
    once over all the leading dims.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    config = current_runtime().select_attention_config(sq, skv, d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale)
    return attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), config or DEFAULT_ATTN_CONFIG,
                          causal=causal, scale=scale)


def wkv(r, k, v, logw, u, state=None):
    """Chunked RWKV6 WKV with runtime kernel selection.

    r/k/v/logw: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) or None.
    Returns (o (B, S, H, hd) f32, final state f32).  The problem is
    featurized as in the reference: (S, hd).  On CPU tensors the plain
    version runs (it ignores the chunk, as the reference's jnp path does).
    """
    _, s, _, hd = r.shape
    config = current_runtime().select_wkv_config(s, hd)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, logw, u, state)
    return wkv_cuda(r, k, v, logw, u, state, config or DEFAULT_WKV_CONFIG)


def ssm_scan(dtx, dta, b, c, state=None):
    """Mamba selective scan with runtime kernel selection.

    dtx: (B, S, d); dta: (B, S, d, N); b/c: (B, S, N); state: (B, d, N) or
    None.  Returns (y (B, S, d) f32, final state (B, d, N) f32).  The problem
    is featurized as in the reference: (S, d).  On CPU tensors the plain
    version runs.
    """
    _, s, d = dtx.shape
    config = current_runtime().select_ssm_config(s, d)
    if dtx.device.type == "cpu":
        return ssm_plain(dtx, dta, b, c, state)
    return ssm_cuda(dtx, dta, b, c, state, config or DEFAULT_SSM_CONFIG)


def ssm_scan_fused(x, dt, a, b, c, state=None):
    """:func:`ssm_scan` of dtx = dt * x and dta = dt[..., None] * a, formed in the kernel.

    x/dt: (B, S, d); a: (d, N); b/c: (B, S, N); state: (B, d, N) or None.
    Returns (y (B, S, d) f32, final state (B, d, N) f32).  Selected as
    :func:`ssm_scan` is (the ssm_scan family, features (S, d)).  On CPU
    tensors the plain version runs; on a CUDA tensor ``ssm_cuda_fused``, so
    the (B, S, d, N) dta is never formed.
    """
    _, s, d = x.shape
    config = current_runtime().select_ssm_config(s, d)
    if x.device.type == "cpu":
        return ssm_fused_plain(x, dt, a, b, c, state)
    return ssm_cuda_fused(x.contiguous(), dt.contiguous(), a.contiguous(), b.contiguous(), c.contiguous(), state,
                          config or DEFAULT_SSM_CONFIG)
