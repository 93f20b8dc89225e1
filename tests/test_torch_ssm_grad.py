"""The selective-scan ops' gradients against the JAX package's, on the CPU.

Seeded numpy inputs go through ``jax.vjp`` of the reference's
``repro.kernels.ref.ssm_scan_ref`` (for the fused entry, of a function that
forms dt * x and dt[..., None] * a first, as ``models/mamba.py`` does) and
through ``ops.ssm_scan`` / ``ops.ssm_scan_fused`` under grad, which on CPU
tensors run the ``repro_torch::ssm_scan`` / ``repro_torch::ssm_scan_fused``
ops: the plain forward, then ``ssm_backward_plain`` /
``ssm_fused_backward_plain``, the algorithm of ``csrc/ssm.cu``'s
``ssm_bwd_kernel`` (a forward walk keeping the state at every chunk's start,
then the chunks in reverse, each chunk's states recomputed from its start),
at the chunk of the config the runtime selects.  Both entries, N 8 and 16,
every compiled chunk, a ragged S over several chunks and an S below the
chunk, with and without an initial state and a final-state cotangent.

Tolerance: every input gradient within 1e-5 of JAX's, relative to the
leaf's largest (f32 on both sides, sums in other orders).  Also a
``gradcheck`` of each op in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssm_scan_ref
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import ops
from repro_torch.kernels import ssm as sm

GRAD_TOL = 1e-5  # relative to each leaf's max |gradient|, f32 against f32
B, D = 2, 12
RAGGED_S, SHORT_S = 37, 5  # ragged at every chunk; below every chunk
NAMES = {"dta": ("dtx", "dta", "b", "c", "state"), "fused": ("x", "dt", "a", "b", "c", "state")}


def _inputs(entry, s, n, seed, with_state):
    """Hymba's distributions: softplus dt, a = -exp(a_log), unit-normal x, b, c."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    x = f(B, s, D)
    dt = np.log1p(np.exp(f(B, s, D) - 1.0)).astype(np.float32)
    a = -np.exp(f(D, n) * 0.5).astype(np.float32)
    b, c = f(B, s, n), f(B, s, n)
    state = f(B, D, n) * 0.1 if with_state else None
    dy, ds = f(B, s, D), f(B, D, n)
    if entry == "fused":
        return [x, dt, a, b, c, state], dy, ds
    return [dt * x, dt[..., None] * a, b, c, state], dy, ds


def _runtime(chunk: int) -> KernelRuntime:
    rt = KernelRuntime(name=f"ssm_grad[{chunk}]")
    rt.install(ops.FixedPolicy(ssm_config=sm.SsmConfig(16, chunk)))
    return rt


def _port_grads(entry, args, dy, ds, chunk, with_ds):
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in args]
    fn = ops.ssm_scan_fused if entry == "fused" else ops.ssm_scan
    with _runtime(chunk).activate():
        y, s_out = fn(*leaves)
    outs, cots = [y], [torch.from_numpy(dy)]
    if with_ds:
        outs.append(s_out)
        cots.append(torch.from_numpy(ds))
    grads = torch.autograd.grad(outs, [t for t in leaves if t is not None], cots)
    return [g.numpy() for g in grads]


def _jax_grads(entry, args, dy, ds, with_ds):
    used = [jnp.asarray(a) for a in args if a is not None]
    has_state = args[-1] is not None

    def fn(*xs):
        state = xs[-1] if has_state else None
        if entry == "fused":
            x, dt, a, b, c = xs[:5]
            return ssm_scan_ref(dt * x, dt[..., None] * a, b, c, state)
        return ssm_scan_ref(*xs[:4], state)

    _, vjp = jax.vjp(fn, *used)
    ds_cot = jnp.asarray(ds) if with_ds else jnp.zeros(ds.shape, jnp.float32)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), ds_cot))]


CASES = {"ragged_state_ds": (RAGGED_S, True, True), "ragged": (RAGGED_S, False, False),
         "below_state": (SHORT_S, True, False), "below_ds": (SHORT_S, False, True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("chunk", sorted({c.chunk for c in sm.config_space()}))
@pytest.mark.parametrize("entry", ["fused", "dta"])
def test_op_gradient_matches_jax_vjp(entry, chunk, n, case):
    s, with_state, with_ds = CASES[case]
    assert s % chunk and (s > chunk) == (s == RAGGED_S)
    args, dy, ds = _inputs(entry, s, n, seed=chunk + n + s, with_state=with_state)
    got = _port_grads(entry, args, dy, ds, chunk, with_ds)
    want = _jax_grads(entry, args, dy, ds, with_ds)
    for name, g, w in zip([nm for nm, a in zip(NAMES[entry], args) if a is not None], got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, f"{name}: rel err {err:.3g} > {GRAD_TOL}"


@pytest.mark.parametrize("entry", ["fused", "dta"])
def test_op_gradcheck_f64(entry):
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, dtype=torch.float64) * scale
    s, d, n = 11, 3, 8
    x, dt = rnd(1, s, d), torch.nn.functional.softplus(rnd(1, s, d))
    a = -torch.exp(rnd(d, n, scale=0.5))
    b, c, state = rnd(1, s, n), rnd(1, s, n), rnd(1, d, n, scale=0.1)
    if entry == "fused":
        leaves, fn = [x, dt, a, b, c, state], ops.ssm_scan_fused
    else:
        leaves, fn = [dt * x, dt[..., None] * a, b, c, state], ops.ssm_scan
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with _runtime(8).activate():
        assert torch.autograd.gradcheck(lambda *q: fn(*q), leaves, eps=1e-6, atol=1e-7)


def test_fused_backward_is_the_dta_backward_of_the_formed_inputs():
    """The fused entry's gradient through dt * x and dt * a equals the dta entry's,
    carried through those two products by hand."""
    args, dy, ds = _inputs("fused", RAGGED_S, 16, seed=1, with_state=True)
    x, dt, a, b, c, state = (torch.from_numpy(t) for t in args)
    dyt, dst = torch.from_numpy(dy), torch.from_numpy(ds)
    dx, ddt, da, db, dc, dstate = sm.ssm_fused_backward_plain(x, dt, a, b, c, state, dyt, dst, 16)
    g_dtx, g_dta, db2, dc2, dstate2 = sm.ssm_backward_plain(dt * x, dt[..., None] * a, b, c, state, dyt, dst, 16)
    for got, want in ((dx, g_dtx * dt), (ddt, g_dtx * x + (g_dta * a).sum(-1)),
                      (da, (g_dta * dt[..., None]).sum((0, 1))), (db, db2), (dc, dc2), (dstate, dstate2)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_backward_is_the_same_at_every_chunk():
    """The chunk only sets where the backward keeps its start states: the
    gradients at every compiled chunk agree within f32 rounding."""
    args, dy, ds = _inputs("dta", RAGGED_S, 8, seed=2, with_state=True)
    t = [torch.from_numpy(a) for a in args]
    base = sm.ssm_backward_plain(*t, torch.from_numpy(dy), torch.from_numpy(ds), 8)
    for chunk in (16, 32):
        for got, want in zip(sm.ssm_backward_plain(*t, torch.from_numpy(dy), torch.from_numpy(ds), chunk), base):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_backward_counts_by_phase_and_keeps_the_selection():
    args, dy, _ = _inputs("fused", 20, 8, seed=4, with_state=False)
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in args]
    rt = _runtime(32)
    rt.set_selection_logging(True)
    ops.GRAD_SCANS.clear()
    chunks = []
    orig = ops.ssm_fused_backward_plain
    with rt.activate():
        y, _ = ops.ssm_scan_fused(*leaves)
        try:
            ops.ssm_fused_backward_plain = lambda *a: chunks.append(a[-1]) or orig(*a)
            torch.autograd.grad(y, [t for t in leaves if t is not None], torch.from_numpy(dy))
        finally:
            ops.ssm_fused_backward_plain = orig
    assert ops.grad_scans("ssm_scan_fused") == {"forward": 1, "backward": 1}
    assert rt.selection_log() == [("ssm_scan", (20, D), sm.SsmConfig(16, 32))]
    assert chunks == [32]

