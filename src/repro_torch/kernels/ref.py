"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Oracle for kernels/matmul.py: f32-accumulated 2-D matmul, cast once
    (f64-accumulated for f64 operands, which only the gradient's tests pass)."""
    out_dtype = out_dtype or lhs.dtype
    acc = torch.float64 if lhs.dtype == torch.float64 else torch.float32
    return (lhs.to(acc) @ rhs.to(acc)).to(out_dtype)


def wkv_ref(r, k, v, logw, u, state=None, chunk: int = 16):
    """Oracle for kernels/wkv.py: ``repro/models/rwkv.py::wkv_chunked`` in PyTorch.

    r/k/v/logw: (B, S, H, hd), f32 math; u: (H, hd); state: (B, H, hd, hd)
    (keys x values), zeros when None.  Returns (o (B, S, H, hd) f32, final
    state f32).  The sequence is padded to a multiple of ``chunk`` with zero
    k/v and zero decay, which alters neither the outputs nor the state.
    """
    b, s, h, hd = r.shape
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    pad = (-s) % chunk
    if pad:
        rf, kf, vf, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf, lw))
    n_chunks = (s + pad) // chunk
    # (n, B, H, L, hd)
    resh = lambda t: t.reshape(b, n_chunks, chunk, h, hd).permute(1, 0, 3, 2, 4)
    rc, kc, vc, lwc = resh(rf), resh(kf), resh(vf), resh(lw)
    S = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) if state is None else state.float()
    uu = u.float()[None, :, None, :]  # (1, H, 1, hd)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for rr, kk, vv, ww in zip(rc, kc, vc, lwc):  # (B, H, L, hd)
        cum = torch.cumsum(ww, dim=2)  # decreasing
        r_t = rr * torch.exp(cum - ww)  # r_t e^{cum_{t-1}}
        k_t = kk * torch.exp(-cum)  # k_tau e^{-cum_tau} (bounded by the clamp at chunk 16)
        scores = torch.einsum("bhlc,bhmc->bhlm", r_t, k_t).masked_fill(~tri, 0.0)
        diag = torch.einsum("bhlc,bhlc->bhl", rr, uu * kk)
        o = torch.einsum("bhlm,bhmv->bhlv", scores, vv) + diag[..., None] * vv
        o = o + torch.einsum("bhlc,bhcv->bhlv", r_t, S)  # incoming-state term
        # S' = e^{cum_L} (.)_k S + sum_tau (k_tau e^{cum_L - cum_tau}) v_tau^T
        decay_all = torch.exp(cum[:, :, -1, :])
        k_hat = kk * torch.exp(cum[:, :, -1:, :] - cum)
        S = decay_all[..., None] * S + torch.einsum("bhlc,bhlv->bhcv", k_hat, vv)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, n_chunks * chunk, h, hd)
    return o[:, :s], S


def ssm_scan_ref(dtx, dta, b, c, state=None):
    """Oracle for kernels/ssm.py: the selective scan as a sequential loop over S.

    dtx (B, S, d); dta (B, S, d, N); b/c (B, S, N); state (B, d, N), zeros
    when None.  f32 math:  h_t = exp(dta_t) * h_{t-1} + dtx_t b_t^T  and
    y_t = sum_N h_t c_t.  Returns (y (B, S, d) f32, final state (B, d, N) f32),
    as the reference's associative-scan ``ssm_scan_ref`` does.
    """
    bsz, s, d = dtx.shape
    n = b.shape[-1]
    abar = torch.exp(dta.float())
    bx = dtx.float()[..., None] * b.float()[:, :, None, :]  # (B, S, d, N)
    cf = c.float()
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=dtx.device) if state is None else state.float()
    ys = []
    for t in range(s):
        h = abar[:, t] * h + bx[:, t]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((bsz, 0, d), dtype=torch.float32, device=dtx.device)
    return y, h


def flash_attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Oracle for kernels/attention.py: ``repro/kernels/ref.py::flash_attention_ref`` in PyTorch.

    q: (..., sq, d), k/v: (..., skv, d) with the same leading dims.  q is
    scaled in f32 before the product, the causal diagonal is aligned to the
    end of KV (row i sees columns j <= i + skv - sq), the softmax is f32, and
    the output is cast once to q's dtype.  A row with no visible column
    (causal, sq > skv) is zeros here, where the reference's softmax over
    nothing gives NaN; every other row is the reference's.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = scale if scale is not None else 1.0 / d**0.5
    logits = (q.float() * scale) @ k.float().transpose(-1, -2)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        cols = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, float("-inf"))
    top = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(top), top, torch.zeros_like(top)))
    denom = p.sum(dim=-1, keepdim=True)
    out = (p @ v.float()) / torch.where(denom > 0, denom, torch.ones_like(denom))
    return out.to(q.dtype)
