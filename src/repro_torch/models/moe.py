"""Mixture-of-Experts FFN, ported from ``repro/models/moe.py``.

Token-choice top-k routing into capacity buckets, step by step as the
reference:

  1. the router GEMM through ``ops.matmul`` (f32 logits), softmax, top-k with
     the gates renormalised, and the Switch load-balance aux loss;
  2. each assignment's position within its expert (a cumsum over expert
     one-hots, k-major per token), ``capacity = max(1, int(T k / E cf))``;
     assignments past capacity are dropped (their slot clamped, their
     contribution zero);
  3. a scatter-add of the tokens into an (E, C, d) buffer;
  4. the per-expert SwiGLU as three einsums over the experts;
  5. the gather back (``y`` cast to the activation dtype first) and the
     gate-weighted sum over k.

The expert products are ``torch.einsum`` (a library batched GEMM), as the
reference computes them with ``jnp.einsum`` outside any Pallas kernel; the
router goes through the tuned GEMM.  Nothing here reads a value on the host
(capacity is a Python int of the static shapes), so a CUDA graph can capture
it: the one-hots are a comparison, the scatter an ``index_add_``.
"""
from __future__ import annotations

import torch

from ..kernels import ops


def init_moe(cfg, normal, n_layers: int | None = None) -> dict:
    """Stacked MoE params at the reference's scales: the router (n, d, E) at
    (2 / (d + E))^0.5, the experts (n, E, d, ff) / (n, E, ff, d) at 0.02."""
    n = n_layers if n_layers is not None else cfg.n_layers
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal((n, d, e), (2.0 / (d + e)) ** 0.5),
        "w_gate": normal((n, e, d, ff), 0.02),
        "w_up": normal((n, e, d, ff), 0.02),
        "w_down": normal((n, e, ff, d), 0.02),
    }


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), f32 aux loss).  Params already sliced to one layer."""
    b, s, d = x.shape
    e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    router_logits = ops.matmul(xt, p["router"], out_dtype=torch.float32)
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    # jax.lax.top_k puts the lower index first among equal values; a stable
    # descending sort does too (torch.topk promises no order among ties).
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = ranked.values[:, :top_k], ranked.indices[:, :top_k]  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Load-balance aux loss (Switch): E * sum_e f_e * p_e.
    flat_e = expert_ids.reshape(-1)  # (T*k,) — k-major per token
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.ones(t * top_k, dtype=torch.float32, device=dev)) / (t * top_k)
    aux = e * torch.sum(me * ce)

    # Position of each assignment within its expert's capacity bucket.
    onehot = (flat_e[:, None] == torch.arange(e, device=dev)).to(torch.int64)  # (T*k, E)
    pos_in_e = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)  # (T*k,)
    capacity = max(1, int(t * top_k / e * cfg.moe.capacity_factor))
    keep = pos_in_e < capacity
    slot = torch.clamp(pos_in_e, max=capacity - 1)
    row = flat_e * capacity + slot  # the assignment's row of the (E * C, d) buffer

    # Dispatch: a dropped assignment adds exact zeros at its clamped slot, so the
    # sum is the same in any order.
    tok_idx = torch.arange(t * top_k, device=dev) // top_k  # each assignment's token
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, row, xt.index_select(0, tok_idx) * keep[:, None].to(x.dtype))
    buf = buf.view(e, capacity, d)

    # Expert SwiGLU.
    gate = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    up = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    # Combine: each assignment's expert output (y cast before the gather), weighted, summed over k.
    picked = y.to(x.dtype).reshape(e * capacity, d).index_select(0, row)
    out_flat = picked * (keep[:, None] * gate_vals.reshape(-1)[:, None]).to(x.dtype)
    out = out_flat.reshape(t, top_k, d).sum(dim=1)
    return out.reshape(b, s, d), aux
