"""The WKV and selective-scan backward kernels against their plain versions, on the card.

``csrc/wkv_bwd.cu`` (``wkv_backward_cuda``) and ``csrc/ssm.cu``'s
``ssm_bwd_kernel`` (``ssm_backward_cuda``, ``ssm_fused_backward_cuda``) at
every compiled config, against ``wkv_backward_plain`` / ``ssm_backward_plain``
/ ``ssm_fused_backward_plain`` on the same CUDA tensors (TF32 off), within
1e-4 of each gradient's largest value, and two calls bitwise equal; then the
ops under grad on the card, which must reach the backward kernels.  This file
imports no JAX: the CPU tests that hold the plain versions to the JAX package
are ``test_torch_wkv_grad.py`` and ``test_torch_ssm_grad.py``.  Every test here
needs the card (``cuda`` marker) and skips without one:

  python -m pytest -q tests/test_torch_backward_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssm as sm
from repro_torch.kernels import wkv as wk

TOL = 1e-4  # relative to each gradient's max: both sides f32, sums in other orders


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *shape: rng.standard_normal(shape, dtype=np.float32)


def _wkv_inputs(dev, b, s, h, hd, seed, dtype=torch.float32):
    f = _rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    r, k, v = (t(f(b, s, h, hd) * 0.5).to(dtype), t(f(b, s, h, hd) * 0.5).to(dtype), t(f(b, s, h, hd)).to(dtype))
    logw = t(-np.exp(f(b, s, h, hd) * 0.5).clip(1e-3, 5.0))
    return [r, k, v, logw, t(f(h, hd) * 0.3).to(dtype), t(f(b, h, hd, hd) * 0.1)], t(f(b, s, h, hd)), t(
        f(b, h, hd, hd))


def _ssm_inputs(dev, entry, s, n, seed, b=2, d=40):
    f = _rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x, dt = f(b, s, d), np.log1p(np.exp(f(b, s, d) - 1.0)).astype(np.float32)
    a = -np.exp(f(d, n) * 0.5).astype(np.float32)
    rest = [t(f(b, s, n)), t(f(b, s, n)), t(f(b, d, n) * 0.1)]
    seq = [t(x), t(dt), t(a)] if entry == "fused" else [t(dt * x), t(dt[..., None] * a)]
    return seq + rest, t(f(b, s, d)), t(f(b, d, n))


def _close(got, want, where):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, where
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (where, i)
        err = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        assert err <= (TOL if g.dtype == torch.float32 else 2 ** -7), (where, i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64])
def test_wkv_backward_kernel_matches_plain(card, hd):
    for s in (5, 37, 300):
        for dtype in (torch.float32, torch.bfloat16):
            args, do, ds = _wkv_inputs(card, 2, s, 3, hd, seed=s, dtype=dtype)
            for cfg in wk.config_space():
                chunk = wk.launch_chunk(cfg, s)
                for state, dso in ((args[5], ds), (None, None)):
                    want = wk.wkv_backward_plain(*args[:5], state, do, dso, chunk)
                    got = wk.wkv_backward_cuda(*args[:5], state, do, dso, cfg)
                    again = wk.wkv_backward_cuda(*args[:5], state, do, dso, cfg)
                    _close(got, want, (cfg, hd, s, dtype))
                    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again)), (cfg, hd, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16])
def test_ssm_backward_kernel_matches_plain(card, n):
    for s in (5, 37, 300):
        for entry, plain, kernel in (("fused", sm.ssm_fused_backward_plain, sm.ssm_fused_backward_cuda),
                                     ("dta", sm.ssm_backward_plain, sm.ssm_backward_cuda)):
            args, dy, ds = _ssm_inputs(card, entry, s, n, seed=s)
            for cfg in sm.config_space():
                for state, dso in ((args[-1], ds), (None, None)):
                    want = plain(*args[:-1], state, dy, dso, cfg.chunk)
                    got = kernel(*args[:-1], state, dy, dso, cfg)
                    again = kernel(*args[:-1], state, dy, dso, cfg)
                    _close(got, want, (entry, cfg, n, s))
                    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again)), (entry, cfg, n, s)


@pytest.mark.cuda
def test_ops_under_grad_launch_the_backward_kernels(card):
    args, do, _ = _wkv_inputs(card, 2, 40, 4, 64, seed=1)
    leaves = [a.requires_grad_(True) for a in args[:5]]
    wk.reset_launches()
    sm.reset_launches()
    o, _ = ops.wkv(*leaves)
    torch.autograd.grad(o, leaves, do)
    assert wk.total_launches() == 1 and sum(wk.BWD_LAUNCHES.values()) == 1
    fargs, dy, _ = _ssm_inputs(card, "fused", 40, 16, seed=2)
    fl = [a.requires_grad_(True) for a in fargs[:5]]
    y, _ = ops.ssm_scan_fused(*fl)
    torch.autograd.grad(y, fl, dy)
    assert sm.BWD_ENTRY_LAUNCHES == {"fused": 1, "dta": 0} and sm.ENTRY_LAUNCHES["fused"] == 1
