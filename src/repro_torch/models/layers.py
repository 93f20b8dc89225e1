"""Shared model building blocks, ported from ``repro/models/layers.py``.

Functional, params-in: each function takes a dict of tensors laid out as the
JAX package lays them out ((in, out) matrices), so ``ops.matmul(x, w)``
hands the GEMM kernel exactly what the reference's kernel got.  Every GEMM
routes through ``kernels.ops.matmul``.  Attention is plain PyTorch code
(einsum, softmax) with the reference's masking: the reference has no kernel
there either.
"""
from __future__ import annotations

import torch

from ..kernels import ops

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding on the two halves of the head dim (not interleaved pairs).

    x: (B, S, H, hd); positions: (B, S) absolute token positions.
    """
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions.float()[:, :, None, None] * freqs  # (B, S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked flash attention (grouped-query layout, no KV repeat)
# ---------------------------------------------------------------------------
def _attn_chunk(q, k, v, row0: int, col0: int, scale: float, window: int = 0):
    """One causal (q-chunk x kv-chunk) tile.  q: (B,KV,G,Lq,hd)  k/v: (B,KV,Lk,hd).
    ``window`` > 0 also masks columns at or before ``row - window``."""
    logits = torch.einsum("bkgqh,bkth->bkgqt", q.float(), k.float()) * scale
    rows = row0 + torch.arange(q.shape[-2], device=q.device)[:, None]
    cols = col0 + torch.arange(k.shape[-2], device=q.device)[None, :]
    masked = cols > rows
    if window:
        masked |= cols <= rows - window
    logits = logits.masked_fill(masked, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgqt,bkth->bkgqh", p, v.float())


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Causal grouped-query online-softmax attention (``flash_attention_jnp``).

    q: (B, S, H, hd) with H = KV * G;  k/v: (B, T, KV, hd).  The causal
    diagonal is aligned to the end of KV (query i sits at position T - S + i).
    ``window`` > 0 is sliding-window attention: a query at position r sees
    columns c with r - window < c <= r.  Memory is bounded by q_chunk x
    kv_chunk tiles.  The last chunk of each axis is simply shorter: the
    reference pads it and masks the pad columns at -1e30, which contributes
    exactly nothing to a row that has a real column, and every row has one
    (its own diagonal).
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / (hd**0.5)
    qg = q.reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)  # (B,KV,G,S,hd)
    kt = k.permute(0, 2, 1, 3)  # (B,KV,T,hd)
    vt = v.permute(0, 2, 1, 3)
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    diag_off = t - s
    blocks = []
    for q0 in range(0, s, qc):
        qblk = qg[:, :, :, q0 : q0 + qc]
        lq = qblk.shape[3]
        m = torch.full((b, kvh, g, lq), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, lq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, lq, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, t, kc):
            m_c, l_c, o_c = _attn_chunk(
                qblk, kt[:, :, k0 : k0 + kc], vt[:, :, k0 : k0 + kc],
                q0 + diag_off, k0, scale, window,
            )
            m_new = torch.maximum(m, m_c)
            corr = torch.exp(m - m_new)
            corr_c = torch.exp(m_c - m_new)
            l = l * corr + l_c * corr_c
            acc = acc * corr[..., None] + o_c * corr_c[..., None]
            m = m_new
        blocks.append((acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype))
    out = torch.cat(blocks, dim=3)  # (B,KV,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: torch.Tensor,
) -> torch.Tensor:
    """One-token attention over a (B, T, KV, hd) cache (``decode_attention_jnp``).

    ``valid_len`` (B,): number of valid cache slots per sequence.  Logits
    accumulate in f32; the probabilities are cast to the cache dtype before
    the value product, as in the reference.
    """
    b, _, h, hd = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / (hd**0.5)
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg.float(), k_cache.float()) * scale
    cols = torch.arange(t, device=q.device)[None, :]
    mask = cols < valid_len[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# attention layer (GQA), cache-aware
# ---------------------------------------------------------------------------
def attention_layer(
    p: dict,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    *,
    cache: tuple[torch.Tensor, torch.Tensor],
    cache_positions: torch.Tensor | None = None,
    cache_valid: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """GQA self-attention for one layer (params already sliced to this layer).

    ``cache = (k_cache, v_cache)``, each (B, T, KV, hd).  Modes:
      * prefill: s > 1 — x attends over itself, causally (within ``window``
        when > 0).  With s < T, k/v are written to positions [0, s); with
        s >= T the cache is a ring buffer (a sliding window's): it keeps the
        last T tokens, each at its ring slot p % T, so decode can continue;
      * decode: cache set, s == 1 — k/v are written at ``cache_positions``
        (B,) and the token attends over slots ``< cache_valid`` (default
        ``cache_positions + 1``).

    The cache is updated in place (the reference returns a new one); it is a
    view into the caller's cache, so no per-step copy is made.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = ops.matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = ops.matmul(x, p["wk"]).reshape(b, s, kvh, hd)
    v = ops.matmul(x, p["wv"]).reshape(b, s, kvh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    k_cache, v_cache = cache
    if s == 1:  # decode: write one token per row
        bidx = torch.arange(b, device=x.device)
        k_cache[bidx, cache_positions] = k[:, 0]
        v_cache[bidx, cache_positions] = v[:, 0]
        valid = cache_valid if cache_valid is not None else cache_positions + 1
        out = decode_attention(q, k_cache, v_cache, valid)
    else:  # prefill: write the whole prefix
        t_cache = k_cache.shape[1]
        for dst, src in ((k_cache, k), (v_cache, v)):
            if s >= t_cache:  # ring buffer: token p lands in slot p % t_cache
                dst.copy_(torch.roll(src[:, -t_cache:], (s - t_cache) % t_cache, dims=1))
            else:
                dst[:, :s] = src
        out = flash_attention(q, k, v, window=window)
    return ops.matmul(out.reshape(b, s, h * hd), p["wo"])


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = ops.matmul(x, p["w_gate"])
    up = ops.matmul(x, p["w_up"])
    act = torch.nn.functional.silu(gate.float()).to(x.dtype)
    return ops.matmul(act * up, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens]


def logits_from_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocab.

    Untied models carry ``unembed`` (d, V).  Tied models carry ``embed_t``,
    a contiguous copy of ``embed.T`` made once at load: the kernel takes
    row-major operands, and a per-call transpose copy would move the whole
    vocab matrix every step.
    """
    w = p["unembed"] if "unembed" in p else p["embed_t"]
    return ops.matmul(x, w, out_dtype=torch.float32)
