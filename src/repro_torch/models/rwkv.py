"""RWKV6 "Finch" time-mix and channel-mix, ported from ``repro/models/rwkv.py``.

Functional, params-in, with the reference's layout.  A multi-token time-mix
(prefill) runs the WKV recurrence through ``kernels.ops.wkv`` (the
hand-written kernel on the card); a one-token step with a state (decode) runs
:func:`wkv_decode_step`, plain PyTorch, as the reference runs jnp code there.
Every projection routes through ``kernels.ops.matmul``: 10 GEMMs a layer
(r, k, v, g, wd1, wd2, o; ck, cv, cr).

Numerics: per-channel log-decay is clamped to [-5, -1e-3], as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L

_LOGW_MIN, _LOGW_MAX = -5.0, -1e-3
_DECAY_RANK = 64


def init_rwkv(cfg, normal, full, n_layers: int | None = None) -> dict:
    """Time-mix and channel-mix params of ``n_layers`` layers, stacked.

    ``normal(shape, scale)`` draws scaled standard normals and ``full(shape,
    value)`` fills, both in the param dtype on the model's device.  Scales are
    the reference's: mu 0.5, w0 -1, u 0, ln_w 1, dense (2 / (in + out))^0.5.
    """
    n = n_layers if n_layers is not None else cfg.n_layers
    d, ff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.head_dim
    dense = lambda a, b: normal((n, a, b), (2.0 / (a + b)) ** 0.5)
    return {
        # time-mix
        "mu_r": full((n, d), 0.5),
        "mu_k": full((n, d), 0.5),
        "mu_v": full((n, d), 0.5),
        "mu_w": full((n, d), 0.5),
        "mu_g": full((n, d), 0.5),
        "w_r": dense(d, h * hd),
        "w_k": dense(d, h * hd),
        "w_v": dense(d, h * hd),
        "w_g": dense(d, h * hd),
        "w_o": dense(h * hd, d),
        "w0": full((n, d), -1.0),  # base log-log decay
        "wd1": dense(d, _DECAY_RANK),
        "wd2": dense(_DECAY_RANK, d),
        "u": full((n, h, hd), 0.0),  # per-head bonus
        "ln_w": full((n, h, hd), 1.0),  # per-head output norm
        # channel-mix
        "mu_cr": full((n, d), 0.5),
        "mu_ck": full((n, d), 0.5),
        "w_ck": dense(d, ff),
        "w_cv": dense(ff, d),
        "w_cr": dense(d, d),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} along the sequence (``prev`` fills t = 0, else zeros)."""
    first = x.new_zeros((x.shape[0], 1, x.shape[2])) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _time_mix_inputs(p, xn, x_prev, cfg):
    """Projections for the WKV op.  xn: (B, S, d) normalized input."""
    b, s, _ = xn.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xs = _shift(xn, x_prev)
    mix = lambda mu: xn * mu + xs * (1.0 - mu)
    r = L.split(ops.matmul(mix(p["mu_r"]), p["w_r"]), b, s, h, hd)
    k = L.split(ops.matmul(mix(p["mu_k"]), p["w_k"]), b, s, h, hd)
    v = L.split(ops.matmul(mix(p["mu_v"]), p["w_v"]), b, s, h, hd)
    g = ops.matmul(mix(p["mu_g"]), p["w_g"])
    # Data-dependent per-channel decay (Finch): logw = -exp(w0 + lora(xw)).
    xw = mix(p["mu_w"])
    lora = ops.matmul(torch.tanh(ops.matmul(xw, p["wd1"])), p["wd2"])
    logw = -torch.exp(p["w0"].float() + lora.float())
    logw = L.split(logw.clamp(_LOGW_MIN, _LOGW_MAX), b, s, h, hd)
    return r, k, v, g, logw


def _head_norm(o: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm of the WKV output, in f32.  o: (B, S, H, hd)."""
    of = o.float()
    scale = torch.rsqrt((of * of).mean(dim=-1, keepdim=True) + eps)
    return of * scale * w.float()


def wkv_decode_step(r, k, v, logw, u, state):
    """Single-token WKV.  r/k/v/logw: (B, 1, H, hd); state (B, H, hd, hd) f32."""
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))  # (B, H, hd)
    lw = logw.float()[:, 0]
    uu = u.float()[None]
    kv = torch.einsum("bhc,bhv->bhcv", kf, vf)
    o = torch.einsum("bhc,bhcv->bhv", rf, state + uu[..., None] * kv)
    new_state = torch.exp(lw)[..., None] * state + kv
    return o[:, None], new_state  # (B, 1, H, hd)


def time_mix_layer(p, xn, cfg, *, state=None, x_prev=None):
    """Full RWKV6 time-mix sublayer on normalized input xn.

    Returns (out (B, S, d), (wkv_state, last_x)).
    """
    b, s, _ = xn.shape
    r, k, v, g, logw = _time_mix_inputs(p, xn, x_prev, cfg)
    if s == 1 and state is not None:  # on each rank's shards of the batch or heads, if sharded
        bh, hs = (0, 2), (0, 1)
        o, new_state = L.on_shards(wkv_decode_step, (r, k, v, logw, p["u"], state),
                                   (bh, bh, bh, bh, (None, 0), hs), (bh, hs), heads=cfg.n_heads)
    else:
        o, new_state = ops.wkv(r, k, v, logw, p["u"], state)
    o = _head_norm(o, p["ln_w"])
    o = (o.reshape(b, s, -1) * F.silu(g.float())).to(xn.dtype)
    return ops.matmul(o, p["w_o"]), (new_state, xn[:, -1])


def channel_mix_layer(p, xn, cfg, *, x_prev=None):
    """RWKV channel-mix sublayer.  Returns (out, last_x)."""
    xs = _shift(xn, x_prev)
    xk = xn * p["mu_ck"] + xs * (1.0 - p["mu_ck"])
    xr = xn * p["mu_cr"] + xs * (1.0 - p["mu_cr"])
    k = ops.matmul(xk, p["w_ck"])
    k = torch.square(torch.relu(k.float())).to(xn.dtype)
    kv = ops.matmul(k, p["w_cv"])
    return torch.sigmoid(ops.matmul(xr, p["w_cr"]).float()).to(xn.dtype) * kv, xn[:, -1]
