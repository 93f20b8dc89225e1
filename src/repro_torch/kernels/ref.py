"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Oracle for kernels/matmul.py: f32-accumulated 2-D matmul, cast once
    (f64-accumulated for f64 operands, which only the gradient's tests pass).
    The operands are made row-major first, so a transposed view (``x.t()``, as
    the GEMM's backward passes them) gives the bits its row-major copy gives."""
    out_dtype = out_dtype or lhs.dtype
    acc = torch.float64 if lhs.dtype == torch.float64 else torch.float32
    return (lhs.to(acc).contiguous() @ rhs.to(acc).contiguous()).to(out_dtype)


def wkv_ref(r, k, v, logw, u, state=None, chunk: int = 16):
    """Oracle for kernels/wkv.py: ``repro/models/rwkv.py::wkv_chunked`` in PyTorch.

    r/k/v/logw: (B, S, H, hd), f32 math (f64 for f64 r, which only the
    gradient's tests pass); u: (H, hd); state: (B, H, hd, hd) (keys x values),
    zeros when None.  Returns (o (B, S, H, hd) f32, final state f32).  The
    sequence is padded to a multiple of ``chunk`` with zero k/v and zero
    decay, which alters neither the outputs nor the state.
    """
    b, s, h, hd = r.shape
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, lw = (t.to(acc) for t in (r, k, v, logw))
    pad = (-s) % chunk
    if pad:
        rf, kf, vf, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf, lw))
    n_chunks = (s + pad) // chunk
    # (n, B, H, L, hd)
    resh = lambda t: t.reshape(b, n_chunks, chunk, h, hd).permute(1, 0, 3, 2, 4)
    rc, kc, vc, lwc = resh(rf), resh(kf), resh(vf), resh(lw)
    S = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device) if state is None else state.to(acc)
    uu = u.to(acc)[None, :, None, :]  # (1, H, 1, hd)
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


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, H, n, chunk, hd), the tail padded with zeros."""
    b, s, h, hd = t.shape
    n = -(-s // chunk)
    t = F.pad(t, (0, 0, 0, 0, 0, n * chunk - s))
    return t.reshape(b, n, chunk, h, hd).permute(0, 3, 1, 2, 4)


def _unchunk(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, n, chunk, hd) -> (B, S, H, hd)."""
    b, h, n, chunk, hd = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, hd)[:, :s]


def wkv_states_ref(k, v, logw, state=None, chunk: int = 16):
    """Oracle for the WKV backward's states: the state at every chunk's start
    and the final state (what ``wkv_state_kernel`` writes).  Returns (hs
    (B, H, n, hd, hd), final (B, H, hd, hd)) in f32 (f64 for f64 k)."""
    acc = torch.float64 if k.dtype == torch.float64 else torch.float32
    kc, vc, wc = (_chunks(t.to(acc), chunk) for t in (k, v, logw))
    b, h, n, _, hd = kc.shape
    cum = torch.cumsum(wc, dim=3)
    k_hat = kc * torch.exp(cum[:, :, :, -1:] - cum)  # k_tau e^{cum_L - cum_tau}
    S = torch.zeros((b, h, hd, hd), dtype=acc, device=k.device) if state is None else state.to(acc)
    hs = []
    for c in range(n):
        hs.append(S)
        S = torch.exp(cum[:, :, c, -1])[..., None] * S + k_hat[:, :, c].transpose(-1, -2) @ vc[:, :, c]
    return torch.stack(hs, dim=2), S


def wkv_backward_ref(r, k, v, logw, u, state, do, ds_out, chunk: int, hs=None, s_final=None):
    """Oracle for kernels/wkv.py's backward: the WKV's VJP chunk by chunk at the
    forward's launch chunk.  ``csrc/wkv_bwd.cu`` computes the same function in
    another order: one reverse walk a head in blocks of up to 16 rows, the
    state's gradient carried from block to block (``tests/test_torch_wkv_grad.py
    ::_bwd_mirror`` is that order in numpy).

    Inputs as :func:`wkv_ref` takes them; ``do`` (B, S, H, hd) and
    ``ds_out`` (B, H, hd, hd) or None are the cotangents of the output and
    the final state; ``chunk`` is the forward's launch chunk; ``hs`` and
    ``s_final`` the forward's chunk start states and final state (recomputed
    by :func:`wkv_states_ref` when None).  Returns (dr, dk, dv, dlogw, du,
    dstate) in their inputs' dtypes (dstate None without a state).

    With cum the inclusive prefix sum of logw in a chunk, cp_t = cum_{t-1},
    S0 / S1 the chunk's start / end state and dS1 the gradient of S1:

      * a reverse pass over the chunks: dS0 = e^{cum_L} (.)_rows dS1 +
        (r e^{cp})^T do, the first chunk's dS0 being d(state);
      * per chunk, with A[t][tau] = sum_c r_tc k_tau,c e^{cp_tc - cum_tau,c}
        (tau < t), dA[t][tau] = do_t . v_tau, D_t = sum_c r u k, dD_t = do_t . v_t:
        dv = A^T do + D do + (k e^{cum_L - cum}) dS1,
        dr = (dA (.) decay) k + dD u k + e^{cp} (do S0^T),
        dk = (dA (.) decay)^T r + dD u r + e^{cum_L - cum} (v dS1^T),
        du = sum of dD r k over every position;
      * dlogw: cum and cp enter every term above but the u-bonus, so with
        g_cp = r (dr - dD u k) and g_cum = -k (dk - dD u r), plus
        sum_j S1 dS1 on the chunk's last row (e^{cum_L}'s share), dlogw_s is
        the sum over t >= s of g_cum_t + g_cp_{t+1}: a reverse cumulative sum.

    Every exponential is of a difference <= 0 (cum decreases).
    """
    b, s, h, hd = r.shape
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32
    if hs is None:
        hs, s_final = wkv_states_ref(k, v, logw, state, chunk)
    rc, kc, vc, wc, gc = (_chunks(t.to(acc), chunk) for t in (r, k, v, logw, do))
    n = rc.shape[2]
    S0 = hs.to(acc)
    uu = u.to(acc)[None, :, None, None, :]  # (1, H, 1, 1, hd)
    cum = torch.cumsum(wc, dim=3)
    cp = F.pad(cum[:, :, :, :-1], (0, 0, 1, 0))  # cum_{t-1}, 0 at t = 0
    cum_l = cum[:, :, :, -1:]
    # The reverse pass: dS1 of every chunk, then d(state).
    r_t = rc * torch.exp(cp)
    dS = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device) if ds_out is None else ds_out.to(acc)
    dS1 = [None] * n
    for c in reversed(range(n)):
        dS1[c] = dS
        dS = torch.exp(cum_l[:, :, c, 0])[..., None] * dS + r_t[:, :, c].transpose(-1, -2) @ gc[:, :, c]
    dS1 = torch.stack(dS1, dim=2)
    S1 = torch.cat([S0[:, :, 1:], s_final.to(acc)[:, :, None]], dim=2)
    # Every chunk at once.
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    decay = torch.exp((cp[..., :, None, :] - cum[..., None, :, :]).masked_fill(~tri[..., None], float("-inf")))
    A = torch.einsum("...tc,...uc,...tuc->...tu", rc, kc, decay)
    dA = (gc @ vc.transpose(-1, -2)).masked_fill(~tri, 0.0)
    D = (rc * uu * kc).sum(-1, keepdim=True)
    dD = (gc * vc).sum(-1, keepdim=True)
    k_out = kc * torch.exp(cum_l - cum)
    dv = A.transpose(-1, -2) @ gc + D * gc + k_out @ dS1
    dr_in = torch.einsum("...tu,...uc,...tuc->...tc", dA, kc, decay) + torch.exp(cp) * (gc @ S0.transpose(-1, -2))
    dk_in = torch.einsum("...tu,...tc,...tuc->...uc", dA, rc, decay) + torch.exp(cum_l - cum) * (
        vc @ dS1.transpose(-1, -2))
    dr = dr_in + dD * uu * kc
    dk = dk_in + dD * uu * rc
    du = (dD * rc * kc).sum(dim=(0, 2, 3))
    g = -kc * dk_in
    g[:, :, :, :-1] += (rc * dr_in)[:, :, :, 1:]
    g[:, :, :, -1] += (S1 * dS1).sum(-1)
    dlogw = torch.flip(torch.cumsum(torch.flip(g, dims=(3,)), dim=3), dims=(3,))
    grads = [_unchunk(t, s).to(x.dtype) for t, x in ((dr, r), (dk, k), (dv, v), (dlogw, logw))]
    return (*grads, du.to(u.dtype), None if state is None else dS.to(state.dtype))


def ssm_scan_ref(dtx, dta, b, c, state=None):
    """Oracle for kernels/ssm.py: the selective scan as a sequential loop over S.

    dtx (B, S, d); dta (B, S, d, N); b/c (B, S, N); state (B, d, N), zeros
    when None.  f32 math:  h_t = exp(dta_t) * h_{t-1} + dtx_t b_t^T  and
    y_t = sum_N h_t c_t (f64 for f64 dtx, which only the gradient's tests
    pass).  Returns (y (B, S, d) f32, final state (B, d, N) f32), as the
    reference's associative-scan ``ssm_scan_ref`` does.
    """
    bsz, s, d = dtx.shape
    n = b.shape[-1]
    acc = torch.float64 if dtx.dtype == torch.float64 else torch.float32
    abar = torch.exp(dta.to(acc))
    bx = dtx.to(acc)[..., None] * b.to(acc)[:, :, None, :]  # (B, S, d, N)
    cf = c.to(acc)
    h = torch.zeros((bsz, d, n), dtype=acc, device=dtx.device) if state is None else state.to(acc)
    ys = []
    for t in range(s):
        h = abar[:, t] * h + bx[:, t]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((bsz, 0, d), dtype=acc, device=dtx.device)
    return y, h


def ssm_scan_vjp_ref(dtx, dta, b, c, state, dy, ds_out, chunk: int):
    """Oracle for kernels/ssm.py's backward: the scan's VJP computed
    sequentially, in the compute dtype (f32, f64 for f64 dtx): a forward pass
    that keeps the state at every chunk's start, then the chunks in reverse,
    each chunk's states recomputed from its start and walked back step by step
    (``csrc/ssm.cu``'s ``ssm_bwd_kernel`` computes the same function in time
    groups with both recurrences folded over the groups' pairs):

      dh += dy_t c_t;  d(dta)_t = dh e^{dta_t} h_{t-1};  d(dtx)_t = sum_N dh b_t;
      db_t = sum_d dh dtx_t;  dc_t = sum_d dy_t h_t;  dh = e^{dta_t} dh,

    dh starting from ds_out, its last value d(state).  Returns (d(dtx), d(dta),
    db, dc, d(state)), each a full tensor."""
    acc = torch.float64 if dtx.dtype == torch.float64 else torch.float32
    dtx, dta, b, c, dy = (t.to(acc) for t in (dtx, dta, b, c, dy))
    bsz, s, d = dtx.shape
    n = b.shape[-1]
    h = torch.zeros((bsz, d, n), dtype=acc, device=dtx.device) if state is None else state.to(acc)
    starts = []
    for t in range(s):
        if t % chunk == 0:
            starts.append(h)
        h = torch.exp(dta[:, t]) * h + dtx[:, t, :, None] * b[:, t, None, :]
    g_dtx, g_dta, g_b, g_c = (torch.zeros_like(t) for t in (dtx, dta, b, c))
    dh = torch.zeros((bsz, d, n), dtype=acc, device=dtx.device) if ds_out is None else ds_out.to(acc)
    for k in reversed(range(len(starts))):
        t0, t1 = k * chunk, min(s, (k + 1) * chunk)
        hs = [starts[k]]
        for t in range(t0, t1):
            hs.append(torch.exp(dta[:, t]) * hs[-1] + dtx[:, t, :, None] * b[:, t, None, :])
        for t in reversed(range(t0, t1)):
            dh = dh + dy[:, t, :, None] * c[:, t, None, :]
            e = torch.exp(dta[:, t])
            g_dta[:, t] = dh * e * hs[t - t0]
            g_dtx[:, t] = (dh * b[:, t, None, :]).sum(-1)
            g_b[:, t] = (dh * dtx[:, t, :, None]).sum(1)
            g_c[:, t] = (dy[:, t, :, None] * hs[t - t0 + 1]).sum(1)
            dh = e * dh
    return g_dtx, g_dta, g_b, g_c, dh


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
