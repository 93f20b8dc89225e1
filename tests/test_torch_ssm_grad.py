"""The selective-scan ops' gradients against the JAX package's, on the CPU.

Seeded numpy inputs go through ``jax.vjp`` of the reference's
``repro.kernels.ref.ssm_scan_ref`` (for the fused entry, of a function that
forms dt * x and dt[..., None] * a first, as ``models/mamba.py`` does) and
through ``ops.ssm_scan`` / ``ops.ssm_scan_fused`` under grad, which on CPU
tensors run the ``repro_torch::ssm_scan`` / ``repro_torch::ssm_scan_fused``
ops: the plain forward, then ``ssm_backward_plain`` /
``ssm_fused_backward_plain``, the sequential oracle (a forward walk keeping
the state at every chunk's start, then the chunks in reverse, each chunk's
states recomputed from its start and walked back step by step), at the chunk
of the config the runtime selects.  Both entries, N 8 and 16,
every compiled chunk, a ragged S over several chunks and an S below the
chunk, with and without an initial state and a final-state cotangent.

``_bwd_mirror`` is ``ssm_bwd_kernel``'s own order of work in numpy (the plain
versions stay the sequential oracle): the chunk starts by a time-grouped
forward walk, then each chunk in reverse in time groups of 8 steps with both
recurrences folded over the groups' pairs, and the sums over n, channels,
warps and time groups in the kernel's trees.  It runs at every compiled
(block_d, chunk), N 8 and 16, both entries and the four cases.

Tolerance: every input gradient within 1e-5 of JAX's, relative to the
leaf's largest (f32 on both sides, sums in other orders); the mirror in f64
within 1e-12 of the sequential ``ssm_scan_vjp_ref`` in f64 (the same
function, rounding order only).  Also a ``gradcheck`` of each op in f64.
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
from repro_torch.kernels.ref import ssm_scan_vjp_ref

GRAD_TOL = 1e-5  # relative to each leaf's max |gradient|, f32 against f32
F64_TOL = 1e-12  # the mirror in f64 against the sequential oracle in f64
LOG2E = 1.4426950408889634
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



# ---------------------------------------------------------------------------
# csrc/ssm.cu ssm_bwd_kernel's order of work
# ---------------------------------------------------------------------------
def _lane_sum(v):
    """A sum over the last axis (N) as the kernel forms it: each of the channel's 4
    lanes sums its K = N / 4 state indices in order, then the lanes pair as reduce4
    pairs them, (lane 0 + lane 2) + (lane 1 + lane 3)."""
    k = v.shape[-1] // sm.LANES
    parts = [v[..., q * k] for q in range(sm.LANES)]
    for q in range(sm.LANES):
        for i in range(1, k):
            parts[q] = parts[q] + v[..., q * k + i]
    return (parts[0] + parts[2]) + (parts[1] + parts[3])


def _block_sum(v, block_d):
    """A sum over the channel axis (-2, padded to whole blocks) per channel block, as
    the kernel forms db's and dc's partials: within a warp's 8 channels the butterfly
    ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)), then the block's warps in order.
    Returns (..., n_blocks, N)."""
    *lead, dp, n = v.shape
    v = v.reshape(*lead, dp // block_d, block_d // 8, 8, n)
    v = v[..., :4, :] + v[..., 4:, :]
    v = v[..., :2, :] + v[..., 2:, :]
    v = v[..., 0, :] + v[..., 1, :]  # (..., n_blocks, warps, N)
    out = v[..., 0, :]
    for wg in range(1, v.shape[-2]):
        out = out + v[..., wg, :]
    return out


def _bwd_mirror(entry, args, dy, ds, block_d, chunk, dtype=np.float32):
    """``ssm_bwd_kernel``'s arithmetic in numpy, in ``dtype`` (the kernel's is f32).

    Channels padded to whole blocks of ``block_d`` and steps to whole chunks with
    zeros (e = 1, no input: the gradient passes through), every batch row and block
    at once.  First the forward walk: each chunk but the last in time groups of
    ``ssm.GROUP_STEPS`` steps, each group from a zero state to its pair (decay
    product P_w, end state E_w), the chunk's start state folded through the pairs in
    group order to the next chunk's start.  Then the chunks in reverse, each in four
    passes: the groups' states recomputed from zero (keeping each step's state and
    e = 2^(dta log2 e)); each group's start state the fold of the earlier groups'
    pairs, a step's state hz + az hw; the adjoint walked back from zero in each group
    to its pair (P_w, E'_w), the gradient entering the chunk folded through the later
    groups' pairs in reverse group order (each group's entering gradient; the whole
    fold, the gradient leaving the chunk; with one group, the walk's own); each
    group walked back again from its entering gradient, forming the outputs.  Sums
    as the kernel's: over n ``_lane_sum``, db / dc per block ``_block_sum`` (the
    wrapper then sums the blocks), da per time group in the kernel's step order,
    then the groups in order, then the batch rows.  Returns the entry's gradients in
    the order of ``NAMES[entry]`` (d(state) None without a state)."""
    f = lambda v: None if v is None else np.asarray(v, dtype)
    if entry == "fused":
        x, dt, a, b, c, state = map(f, args)
        bsz, s, d = x.shape
    else:
        dtx_in, dta_in, b, c, state = map(f, args)
        bsz, s, d = dtx_in.shape
    dy = f(dy)
    n = b.shape[-1]
    group = sm.GROUP_STEPS
    w_groups = chunk // group
    n_chunks = -(-s // chunk)
    sp, dp = n_chunks * chunk, -(-d // block_d) * block_d
    pad_t = lambda v: np.pad(v, [(0, 0), (0, sp - s)] + [(0, 0)] * (v.ndim - 2))
    pad_d = lambda v, axis: np.pad(v, [(0, dp - d) if i == axis else (0, 0) for i in range(v.ndim)])
    if entry == "fused":
        xs, dts = pad_d(pad_t(x), 2), pad_d(pad_t(dt), 2)
        ap = pad_d(a, 0)
        dtx = dts * xs
        dta = dts[..., None] * ap
    else:
        dtx, dta = pad_d(pad_t(dtx_in), 2), pad_d(pad_t(dta_in), 2)
    bs, cs, dys = pad_t(b), pad_t(c), pad_d(pad_t(dy), 2)
    e = np.exp2(dta * dtype(LOG2E))
    u = dtx[..., None] * bs[:, :, None, :]
    zeros = np.zeros((bsz, dp, n), dtype)
    steps = lambda k, w: range(k * chunk + w * group, k * chunk + (w + 1) * group)

    def group_states(k):
        """Each group of chunk k from a zero state: every step's state and the pairs."""
        hz, pairs = {}, []
        for w in range(w_groups):
            hr, ar = zeros, np.ones_like(zeros)
            for t in steps(k, w):
                hr = e[:, t] * hr + u[:, t]
                ar = ar * e[:, t]
                hz[t] = hr
            pairs.append((ar, hr))
        return hz, pairs

    starts = [zeros if state is None else pad_d(state, 1)]
    for k in range(n_chunks - 1):
        h = starts[-1]
        for p_w, e_w in group_states(k)[1]:
            h = p_w * h + e_w
        starts.append(h)

    g_dtx, g_dta = np.zeros_like(dtx), np.zeros_like(dta)
    g_b, g_c = np.zeros((bsz, dp // block_d, sp, n), dtype), np.zeros((bsz, dp // block_d, sp, n), dtype)
    s2 = np.zeros_like(dtx)
    da = [zeros] * w_groups
    dh = zeros if ds is None else pad_d(f(ds), 1)
    for k in reversed(range(n_chunks)):
        hz, pairs = group_states(k)
        hw, h = [], starts[k]
        for p_w, e_w in pairs:
            hw.append(h)
            h = p_w * h + e_w
        hs = {}
        for w in range(w_groups):
            az = np.ones_like(zeros)
            for t in steps(k, w):
                az = az * e[:, t]
                hs[t] = hz[t] + az * hw[w]
        gin = [dh]
        if w_groups > 1:
            ends = []
            for w in range(w_groups):
                gz = zeros
                for t in reversed(steps(k, w)):
                    gz = (dys[:, t, :, None] * cs[:, t, None, :] + gz) * e[:, t]
                ends.append(gz)
            gin, carry = [None] * w_groups, dh
            for w in reversed(range(w_groups)):
                gin[w] = carry
                carry = pairs[w][0] * carry + ends[w]
        for w in range(w_groups):
            g = gin[w]
            for t in reversed(steps(k, w)):
                grad_h = dys[:, t, :, None] * cs[:, t, None, :] + g
                g = grad_h * e[:, t]
                prev = hs[t - 1] if t > steps(k, w)[0] else hw[w]
                g_dta[:, t] = g * prev
                g_dtx[:, t] = _lane_sum(grad_h * bs[:, t, None, :])
                g_b[:, :, t] = _block_sum(grad_h * dtx[:, t, :, None], block_d)
                g_c[:, :, t] = _block_sum(dys[:, t, :, None] * hs[t], block_d)
                if entry == "fused":
                    s2[:, t] = _lane_sum(g_dta[:, t] * ap)
                    da[w] = da[w] + g_dta[:, t] * dts[:, t, :, None]
        dh = carry if w_groups > 1 else g
    cut = lambda v: v[:, :s, :d]
    db, dc = g_b.sum(1)[:, :s], g_c.sum(1)[:, :s]
    d_state = None if state is None else dh[:, :d]
    if entry == "fused":
        da_sum = da[0]
        for w in range(1, w_groups):
            da_sum = da_sum + da[w]
        dx = cut(g_dtx * dts)
        ddt = cut(g_dtx * xs + s2)
        return [dx, ddt, da_sum.sum(0)[:d], db, dc, d_state]
    return [cut(g_dtx), cut(g_dta), db, dc, d_state]


def _sequential_f64(entry, args, dy, ds, chunk):
    """The plain backward (the sequential oracle ``ssm_scan_vjp_ref``) in f64."""
    t = lambda v: None if v is None else torch.from_numpy(np.asarray(v, np.float64))
    dyt, dst = t(dy), t(ds)
    if entry == "fused":
        x, dt, a, b, c, state = map(t, args)
        g = sm.ssm_fused_backward_plain(x, dt, a, b, c, state, dyt, dst, chunk)
    else:
        g = sm.ssm_backward_plain(*map(t, args), dyt, dst, chunk)
    return [None if v is None else v.numpy() for v in g]


_MIRROR_CFGS = [pytest.param(c, id=c.name()) for c in sm.config_space()]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("cfg", _MIRROR_CFGS)
@pytest.mark.parametrize("entry", ["fused", "dta"])
def test_kernel_order_matches_jax_vjp(entry, cfg, n, case):
    """The kernel's order of work in f32 against ``jax.vjp`` of ``ssm_scan_ref``."""
    s, with_state, with_ds = CASES[case]
    args, dy, ds = _inputs(entry, s, n, seed=cfg.block_d + cfg.chunk + n + s, with_state=with_state)
    got = _bwd_mirror(entry, args, dy, ds if with_ds else None, cfg.block_d, cfg.chunk)
    want = _jax_grads(entry, args, dy, ds, with_ds)
    names = [nm for nm, g in zip(NAMES[entry], got) if g is not None]
    for name, g, w in zip(names, [g for g in got if g is not None], want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, f"{name}: rel err {err:.3g} > {GRAD_TOL}"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("cfg", _MIRROR_CFGS)
@pytest.mark.parametrize("entry", ["fused", "dta"])
def test_kernel_order_f64_matches_sequential(entry, cfg, n, case):
    """The kernel's order of work in f64 against the sequential oracle in f64: the
    folds and trees compute the same function, only the rounding order differs."""
    s, with_state, with_ds = CASES[case]
    args, dy, ds = _inputs(entry, s, n, seed=cfg.block_d * cfg.chunk + n + s, with_state=with_state)
    ds = ds if with_ds else None
    got = _bwd_mirror(entry, args, dy, ds, cfg.block_d, cfg.chunk, np.float64)
    want = _sequential_f64(entry, args, dy, ds, cfg.chunk)
    for name, g, w in zip(NAMES[entry], got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape, name
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= F64_TOL, f"{name}: rel err {err:.3g} > {F64_TOL}"
