"""Selective SSM (Mamba-style) head of Hymba, ported from ``repro/models/mamba.py``.

Functional, params-in, with the reference's layout.  A multi-token call
(prefill) runs the scan through ``kernels.ops.ssm_scan_fused`` (the
hand-written kernel on the card, which forms dt * x and dt * a itself); a one-token step with a state (decode) runs
:func:`mamba_decode_step`, plain PyTorch, as the reference runs jnp code there.
Every projection routes through ``kernels.ops.matmul``: 6 GEMMs a layer
(in, dt1, dt2, b, c, out).  The depthwise conv of full Mamba is omitted, as
in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

_DT_RANK = 48


def init_mamba(cfg, normal, full, n_layers: int | None = None) -> dict:
    """Mamba params of ``n_layers`` layers, stacked.

    ``normal(shape, scale)`` draws scaled standard normals and ``full(shape,
    value)`` fills, both in the param dtype on the model's device.  Scales are
    the reference's: dense (2 / (in + out))^0.5, ``a_log`` = 0.5 log(1..N)
    broadcast over channels, ``d_skip`` 1.
    """
    n = n_layers if n_layers is not None else cfg.n_layers
    d, ns = cfg.d_model, cfg.ssm_state
    dense = lambda a, b: normal((n, a, b), (2.0 / (a + b)) ** 0.5)
    ones = full((n, d, ns), 1.0)
    # The reference casts log(1..N) to the param dtype, then halves it (exact in any float type).
    log_n = torch.log(torch.arange(1, ns + 1, dtype=torch.float32, device=ones.device)).to(ones.dtype)
    return {
        "w_in": dense(d, 2 * d),
        "w_dt1": dense(d, _DT_RANK),
        "w_dt2": dense(_DT_RANK, d),
        "w_b": dense(d, ns),
        "w_c": dense(d, ns),
        "a_log": ones * log_n * 0.5,
        "d_skip": full((n, d), 1.0),
        "w_out": dense(d, d),
    }


def _ssm_inputs(p: dict, x: torch.Tensor):
    """Common projections.  x: (B, S, d) -> (xin, z, dt, b, c, a)."""
    d = x.shape[-1]
    xz = ops.matmul(x, p["w_in"])
    xin, z = xz[..., :d], xz[..., d:]
    dt = F.softplus(ops.matmul(ops.matmul(xin, p["w_dt1"]), p["w_dt2"]).float())
    b = ops.matmul(xin, p["w_b"]).float()  # (B, S, N)
    c = ops.matmul(xin, p["w_c"]).float()
    a = -torch.exp(p["a_log"].float())  # (d, N), negative
    return xin, z, dt, b, c, a


def mamba_layer(p: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill path: the fused selective scan.  x: (B, S, d) -> (out (B, S, d),
    final state (B, d, N) f32)."""
    xin, z, dt, b, c, a = _ssm_inputs(p, x)
    xf = xin.float()
    # The kernel forms dt * x and dt * a itself: no (B, S, d, N) tensor is built.
    y, h_last = ops.ssm_scan_fused(xf, dt, a, b, c)
    y = y + p["d_skip"].float() * xf
    y = y * F.silu(z.float())
    return ops.matmul(y.to(x.dtype), p["w_out"]), h_last


def mamba_decode_step(p: dict, x: torch.Tensor, state: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: x (B, 1, d), state (B, d, N) f32 -> (out (B, 1, d), new state)."""
    xin, z, dt, b, c, a = _ssm_inputs(p, x)
    xf = xin[:, 0].float()
    abar = torch.exp(dt[:, 0, :, None] * a)  # (B, d, N)
    bx = (dt[:, 0] * xf)[..., None] * b[:, 0, None, :]
    new_state = abar * state + bx
    y = (new_state * c[:, 0, None, :]).sum(-1) + p["d_skip"].float() * xf
    y = y * F.silu(z[:, 0].float())
    return ops.matmul(y.to(x.dtype), p["w_out"])[:, None], new_state
