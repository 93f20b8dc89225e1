"""The WKV op's gradient against the JAX package's, on the CPU.

Seeded numpy inputs (``tests/test_wkv_kernel.py``'s distributions) go through
``jax.vjp`` of the reference's ``repro.models.rwkv.wkv_chunked`` and through
``ops.wkv`` under grad, which on CPU tensors runs the ``repro_torch::wkv`` op:
the plain forward, then ``wkv_backward_plain`` (the same function chunk by
chunk: a reverse pass over the chunk boundaries carrying the state's
gradient, then every chunk's gradients from the chunk start states), at the
launch chunk of the config the runtime selects.  Every compiled chunk, both
head dims, a ragged S, an S below the chunk, with and without an initial
state and a final-state cotangent.

``_bwd_mirror`` is ``csrc/wkv_bwd.cu``'s own order of work in numpy: the
reverse pass to the segments' ends, then per segment the reverse walk in
blocks of up to 16 rows carrying dS (a chunk longer than 16 first walked
forward to its blocks' start states), each block's prefix sums by runs, the
one-exponential pass over the pairs, and the sums over channels, row groups,
runs and segments in the kernel's trees.  It runs at every compiled chunk,
hd 16 and 64 and the four cases, and at segment lengths 1, 2 and all.

Tolerance: every input gradient within 1e-5 of JAX's, relative to the
leaf's largest (f32 on both sides, sums in other orders); the mirror in f64
within 1e-12 of a per-token sequential VJP in f64 (the same function,
rounding order only).  Also a ``gradcheck`` of the op in f64 (the plain
versions keep f64), and the plain backward's own pieces: the chunk start
states it recomputes against the reference on the prefix, and
``wkv_backward_plain`` given the forward's states against itself
recomputing them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv_chunked
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import ops
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.ref import wkv_states_ref

GRAD_TOL = 1e-5  # relative to each leaf's max |gradient|, f32 against f32
F64_TOL = 1e-12  # the mirror in f64 against the per-token sequential VJP in f64
LEAVES = ("r", "k", "v", "logw", "u", "state")


def _inputs(b, s, h, hd, seed, with_state):
    """The reference kernel test's distributions (test_wkv_kernel.py:_inputs), from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = f(b, s, h, hd) * 0.5, f(b, s, h, hd) * 0.5, f(b, s, h, hd)
    lw = -np.exp(f(b, s, h, hd) * 0.5).clip(1e-3, 5.0)
    u = f(h, hd) * 0.3
    state = f(b, h, hd, hd) * 0.1 if with_state else None
    do, ds = f(b, s, h, hd), f(b, h, hd, hd)
    return [r, k, v, lw, u, state], do, ds


def _runtime(chunk: int) -> KernelRuntime:
    rt = KernelRuntime(name=f"wkv_grad[{chunk}]")
    rt.install(ops.FixedPolicy(wkv_config=wk.WkvConfig(chunk)))
    return rt


def _port_grads(args, do, ds, chunk, with_ds):
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in args]
    with _runtime(chunk).activate():
        o, s_out = ops.wkv(*leaves)
    outs, cots = [o], [torch.from_numpy(do)]
    if with_ds:
        outs.append(s_out)
        cots.append(torch.from_numpy(ds))
    used = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(outs, used, cots)
    return [g.numpy() for g in grads]


def _jax_grads(args, do, ds, with_ds):
    used = [jnp.asarray(a) for a in args if a is not None]
    has_state = args[5] is not None

    def fn(*xs):
        return wkv_chunked(*xs[:5], xs[5] if has_state else None)

    _, vjp = jax.vjp(fn, *used)
    ds_cot = jnp.asarray(ds) if with_ds else jnp.zeros(ds.shape, jnp.float32)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), ds_cot))]


def _close(got, want, names, tol=GRAD_TOL):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        scale = np.abs(w).max()
        err = np.abs(g - w).max() / scale
        assert err <= tol, f"{name}: rel err {err:.3g} > {tol}"


# (S, with a state, with a final-state cotangent): S 259 is ragged at every chunk (3 chunks
# of 128, 33 of 8), S 5 below every chunk (one chunk of 8, the smallest compiled one that
# covers it).  One S for all chunks keeps the reference's compiled scan cached across cases.
RAGGED_S, SHORT_S = 259, 5
CASES = {"ragged_state_ds": (RAGGED_S, True, True), "ragged": (RAGGED_S, False, False),
         "below_state": (SHORT_S, True, False), "below_ds": (SHORT_S, False, True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
def test_op_gradient_matches_jax_vjp(chunk, hd, case):
    s, with_state, with_ds = CASES[case]
    h = 2 if hd == 64 else 3
    args, do, ds = _inputs(2 if hd == 16 else 1, s, h, hd, seed=chunk + hd + s, with_state=with_state)
    assert wk.launch_chunk(wk.WkvConfig(chunk), s) == (chunk if s == RAGGED_S else 8) and s % chunk
    got = _port_grads(args, do, ds, chunk, with_ds)
    want = _jax_grads(args, do, ds, with_ds)
    _close(got, want, [n for n, a in zip(LEAVES, args) if a is not None])


@pytest.mark.parametrize("with_state", [True, False])
def test_op_gradient_at_the_clamp(with_state):
    """Every logw at the model's clamp ends (-5 and -1e-3): the longest and the
    shortest memories, against JAX at chunk 16 and 64."""
    args, do, ds = _inputs(1, 40, 2, 16, seed=7, with_state=with_state)
    rng = np.random.default_rng(8)
    args[3] = np.where(rng.random(args[3].shape) < 0.5, -5.0, -1e-3).astype(np.float32)
    want = _jax_grads(args, do, ds, True)
    for chunk in (16, 64):
        _close(_port_grads(args, do, ds, chunk, True), want, [n for n, a in zip(LEAVES, args) if a is not None])


@pytest.mark.parametrize("chunk, s", [(8, 9), (16, 5)], ids=["ragged", "below"])
def test_op_gradcheck_f64(chunk, s):
    gen = torch.Generator().manual_seed(chunk)
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, dtype=torch.float64) * scale)
    b, h, hd = 1, 1, 16
    logw = -torch.exp(rnd(b, s, h, hd, scale=0.5)).clamp(1e-3, 5.0)
    leaves = [rnd(b, s, h, hd, scale=0.5), rnd(b, s, h, hd, scale=0.5), rnd(b, s, h, hd), logw,
              rnd(h, hd, scale=0.3), rnd(b, h, hd, hd, scale=0.1)]
    leaves = [t.requires_grad_(True) for t in leaves]
    with _runtime(chunk).activate():
        assert torch.autograd.gradcheck(lambda *a: ops.wkv(*a), leaves, eps=1e-6, atol=1e-7)


def test_states_plain_match_reference_on_the_prefix():
    """wkv_states_ref's state at every chunk's start is the reference's final
    state on the prefix before it."""
    args, _, _ = _inputs(1, 37, 2, 16, seed=3, with_state=True)
    hs, fin = wkv_states_ref(*(torch.from_numpy(a) for a in (args[1], args[2], args[3], args[5])), chunk=16)
    for c in range(hs.shape[2]):
        prefix = [jnp.asarray(a[:, : 16 * c]) if a.ndim == 4 else jnp.asarray(a) for a in args[:5]]
        want = wkv_chunked(*prefix, jnp.asarray(args[5]))[1] if c else jnp.asarray(args[5])
        np.testing.assert_allclose(hs[:, :, c].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fin.numpy(), np.asarray(wkv_chunked(*map(jnp.asarray, args))[1]), rtol=1e-5,
                               atol=1e-5)


def test_backward_plain_with_given_states_equals_recomputed():
    """Given the forward's chunk start states (what the card's forward keeps),
    the plain backward is bitwise the one that recomputes them."""
    args, do, ds = _inputs(2, 21, 2, 16, seed=5, with_state=True)
    t = [torch.from_numpy(a) for a in args]
    hs, fin = wkv_states_ref(t[1], t[2], t[3], t[5], chunk=8)
    a = wk.wkv_backward_plain(*t, torch.from_numpy(do), torch.from_numpy(ds), 8)
    b = wk.wkv_backward_plain(*t, torch.from_numpy(do), torch.from_numpy(ds), 8, hs, fin)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_backward_plain_keeps_input_dtypes():
    """bf16 r/k/v and u give bf16 gradients (as the kernel writes them); logw and the state f32."""
    args, do, _ = _inputs(1, 9, 2, 16, seed=9, with_state=True)
    t = [torch.from_numpy(a) for a in args]
    t[0], t[1], t[2], t[4] = (x.bfloat16() for x in (t[0], t[1], t[2], t[4]))
    grads = wk.wkv_backward_plain(*t, torch.from_numpy(do), None, 16)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32, torch.bfloat16, torch.float32]
    ref = wk.wkv_backward_plain(*(x.float() for x in t), torch.from_numpy(do), None, 16)
    for g, w in zip(grads, ref):
        assert ((g.float() - w).abs().max() / w.abs().max()).item() <= 2 ** -7


def test_backward_counts_by_phase_and_keeps_the_selection():
    """One forward and one backward call of the op, each counted by phase; the
    backward runs at the config the forward selected."""
    args, do, _ = _inputs(1, 20, 2, 16, seed=11, with_state=False)
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in args]
    rt = _runtime(32)
    rt.set_selection_logging(True)
    ops.GRAD_SCANS.clear()
    seen = []
    orig = wk.launch_chunk
    with rt.activate():
        o, _ = ops.wkv(*leaves)
        try:
            ops.launch_chunk = lambda cfg, s: seen.append(cfg) or orig(cfg, s)
            torch.autograd.grad(o, [t for t in leaves if t is not None], torch.from_numpy(do))
        finally:
            ops.launch_chunk = orig
    assert ops.grad_scans("wkv") == {"forward": 1, "backward": 1}
    assert rt.selection_log() == [("wkv", (20, 16), wk.WkvConfig(32))]
    assert seen and all(cfg == wk.WkvConfig(32) for cfg in seen)



# ---------------------------------------------------------------------------
# csrc/wkv_bwd.cu's order of work
# ---------------------------------------------------------------------------
THREADS = 256  # a walk CTA's


def _butterfly(x):
    """A sum over the last axis (a power of two) as a shuffle butterfly forms it: lanes i
    and i + half, the half halving."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _in_order(parts):
    """parts[0] + parts[1] + ..., left to right."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


def _runs(w, run, reverse=False):
    """The (reverse) prefix sum down axis 2 as the kernel forms it: each run of ``run`` rows
    by one thread in order, then the earlier (later) runs' totals in order."""
    m = w.shape[2]
    out, tots = np.empty_like(w), []
    for q in range(m // run):
        loc = np.zeros_like(w[:, :, 0])
        for a in (reversed(range(run)) if reverse else range(run)):
            loc = loc + w[:, :, q * run + a]
            out[:, :, q * run + a] = loc
        tots.append(loc)
    for q in range(m // run):
        others = tots[q + 1:][::-1] if reverse else tots[:q]
        if others:
            out[:, :, q * run:(q + 1) * run] += _in_order(others)[:, :, None]
    return out


def _sets(w, reverse=False):
    """The (reverse) prefix sum down axis 2 as the column map (hd 64) forms it by shuffles: in
    each set of 4 rows a two-step scan, (w0 + w1) + (w2 + w3) at the set's end (its start,
    reversed), then the earlier (later) sets' totals in order."""
    m = w.shape[2]
    out, tots = np.empty_like(w), []
    for s0 in range(0, m, 4):
        x = [w[:, :, s0 + i] for i in range(4)]
        if reverse:
            y = [x[0] + x[1], x[1] + x[2], x[2] + x[3], x[3]]
            y = [y[0] + y[2], y[1] + y[3], y[2], y[3]]
        else:
            y = [x[0], x[0] + x[1], x[1] + x[2], x[2] + x[3]]
            y = [y[0], y[1], y[0] + y[2], y[1] + y[3]]
        for i in range(4):
            out[:, :, s0 + i] = y[i]
        tots.append(y[0] if reverse else y[3])
    n = m // 4
    for k in range(n):
        others = tots[k + 1:][::-1] if reverse else tots[:k]
        if others:
            out[:, :, 4 * k:4 * k + 4] = _in_order(others)[:, :, None] + out[:, :, 4 * k:4 * k + 4]
    return out


def _outer_sum(a, b):
    """sum_t a[:, :, t, :, None] b[:, :, t, None, :], t in order: a (hd, hd) tile's FMA chain."""
    return _in_order([a[:, :, t, :, None] * b[:, :, t, None, :] for t in range(a.shape[2])])


def _row_dot(a, mat):
    """out[t][c] = sum_j a[t][j] mat[c][j], j in order (the rows map's float4 chains)."""
    return _in_order([a[:, :, :, j, None] * mat[:, :, None, :, j] for j in range(a.shape[3])])


def _tile_row_sum(prod):
    """sum_j of an (hd, hd) product per key row as the tile map forms it: each thread its
    hd / 16 columns in order, then the 16 column groups by a butterfly."""
    b, h, hd, _ = prod.shape
    p = prod.reshape(b, h, hd, 16, hd // 16)
    return _butterfly(_in_order([p[..., z] for z in range(hd // 16)]))


def _bwd_mirror(args, do, ds, chunk, seg_len=None, dtype=np.float32):
    """``wkv_bwd_walk_kernel``'s arithmetic in numpy, in ``dtype`` (the kernel's is f32).

    Positions padded to whole chunks with zeros, every (b, h) at once.  Segments of
    ``seg_len`` chunks (all of a head's by default): the reverse pass walks whole chunks
    from the last, writing dS at each segment's end.  Then each segment from its last
    block: dS1 the cotangent or the pass's, sum_j S1 dS1 by the tile map's sums; each
    chunk's blocks of m = min(chunk, 16) rows (only those holding a position), the
    start states of blocks after the first by a forward walk (cum by runs) from the
    forward's hs; each block in reverse: cum (runs at hd 16; at hd 64 the column map's
    scans over sets of 4 rows, ``_sets``), dA and D (a lane butterfly), the pairs
    tau < t each with one exponential feeding dr, dk's row-group partials and A (a
    butterfly over a channel group: 16 lanes at hd 16, a warp's 8 channels at hd 64,
    the groups in order), dk's partials summed over the row groups (in order; paired at
    hd 64), the three (m, hd) x (hd, hd) products as FMA chains, dlogw by the reverse
    scan, dS <- e^{cum_m} dS + (r e^{cp})^T do, and sum_j S0 dS for the block before.  du: a thread's rows in walk order, its row groups in order, then the
    partials over B and the segments.  Returns (dr, dk, dv, dlogw, du, dstate) as
    ``LEAVES`` orders them (dstate None without a state)."""
    f = lambda x: None if x is None else np.asarray(x, dtype)
    r, k, v, lw, u, state = map(f, args)
    do, ds = f(do), f(ds)
    bsz, s, h, hd = r.shape
    m = min(chunk, 16)
    n = -(-s // chunk)
    seg_len = n if seg_len is None else seg_len
    n_seg = -(-n // seg_len)
    nq = THREADS // hd
    run = m // nq if m >= nq else 1
    cols = hd == 64  # the column map: a warp is 8 channels x every row
    gw = 8 if cols else min(32, hd)
    scan = (lambda w, reverse=False: _sets(w, reverse)) if cols else (lambda w, reverse=False: _runs(w, run, reverse))
    pad = lambda x: np.pad(x, ((0, 0), (0, n * chunk - s), (0, 0), (0, 0))).transpose(0, 2, 1, 3)
    R, K, V, LW, G = map(pad, (r, k, v, lw, do))
    tt = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))
    hs, s_fin = (x.numpy().astype(dtype) for x in wkv_states_ref(tt(k), tt(v), tt(lw), tt(state), chunk=chunk))
    zeros = np.zeros((bsz, h, hd, hd), dtype)
    uu = u[None, :, None, :]

    dsw, dS = {}, zeros if ds is None else ds
    for ch in reversed(range(n) if n_seg > 1 else []):
        if (ch + 1) % seg_len == 0 and ch + 1 < n:
            dsw[(ch + 1) // seg_len - 1] = dS
        if ch < seg_len:
            break
        rr, ww, gg = (x[:, :, ch * chunk:(ch + 1) * chunk] for x in (R, LW, G))
        cum, rt = np.zeros_like(ww[:, :, 0]), np.empty_like(rr)
        for t in range(chunk):
            rt[:, :, t] = rr[:, :, t] * np.exp(cum)
            cum = cum + ww[:, :, t]
        dS = np.exp(cum)[..., None] * dS + _outer_sum(rt, gg)

    out = {name: np.zeros_like(R) for name in ("dr", "dk", "dv", "dlogw")}
    du_part, dstate = [], None
    for seg in range(n_seg):
        ch_lo, ch_hi = seg * seg_len, min((seg + 1) * seg_len, n)
        dS = dsw[seg] if seg + 1 < n_seg else (zeros if ds is None else ds)
        X = _tile_row_sum((s_fin if ch_hi == n else hs[:, :, ch_hi]) * dS)
        du_acc = [np.zeros((bsz, h, hd), dtype) for _ in range(nq)]
        for ch in reversed(range(ch_lo, ch_hi)):
            starts = [hs[:, :, ch]]
            for blk in range(-(-min(chunk, s - ch * chunk) // m) - 1):
                sl = slice(ch * chunk + blk * m, ch * chunk + (blk + 1) * m)
                cum = _runs(LW[:, :, sl], run)
                k_hat = K[:, :, sl] * np.exp(cum[:, :, -1:] - cum)
                starts.append(np.exp(cum[:, :, -1])[..., None] * starts[-1] + _outer_sum(k_hat, V[:, :, sl]))
            for blk in reversed(range(len(starts))):
                sl = slice(ch * chunk + blk * m, ch * chunk + (blk + 1) * m)
                rr, kk, vv, gg = (x[:, :, sl] for x in (R, K, V, G))
                S0 = starts[blk]
                cum = scan(LW[:, :, sl])
                cp = np.concatenate([np.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], axis=2)
                dec = np.exp(cum[:, :, -1:] - cum)
                dA = np.zeros((bsz, h, m, m), dtype)
                for t in range(m):
                    for tau in range(t + 1):
                        dA[:, :, t, tau] = _in_order([gg[:, :, t, j] * vv[:, :, tau, j] for j in range(hd)])
                lanes = np.zeros((bsz, h, m, 32), dtype)
                for c0 in range(0, hd, 32):
                    w = min(32, hd)
                    lanes[..., :w] = lanes[..., :w] + (rr[..., c0:c0 + w] * uu[..., c0:c0 + w]) * kk[..., c0:c0 + w]
                D = _butterfly(lanes)
                dra, A = np.zeros_like(rr), np.zeros((bsz, h, m, m), dtype)
                dkp = np.zeros((bsz, h, nq, m, hd), dtype)
                for tau in range(m - 1):
                    for t in range(tau + 1, m):
                        e = np.exp(cp[:, :, t] - cum[:, :, tau])
                        da = dA[:, :, t, tau][..., None]
                        x = kk[:, :, tau] * e
                        dra[:, :, t] = dra[:, :, t] + da * x
                        dkp[:, :, t % nq, tau] = dkp[:, :, t % nq, tau] + (da * rr[:, :, t]) * e
                        groups = _butterfly((rr[:, :, t] * x).reshape(bsz, h, hd // gw, gw))
                        A[:, :, t, tau] = _in_order([groups[..., g] for g in range(hd // gw)])
                if cols:  # the row groups' partials paired by shuffles: (q0 + q2) + (q1 + q3)
                    dka = (dkp[:, :, 0] + dkp[:, :, 2]) + (dkp[:, :, 1] + dkp[:, :, 3])
                else:
                    dka = _in_order([dkp[:, :, p] for p in range(nq)])
                dka[:, :, m - 1] = 0
                dd = np.einsum("bhtt->bht", dA)[..., None]
                dr_in = np.exp(cp) * _row_dot(gg, S0) + dra
                dk_in = dec * _row_dot(vv, dS) + dka
                k_hat = kk * dec
                dv = _row_dot(k_hat, dS.transpose(0, 1, 3, 2))
                for t in range(m):
                    x = dv[:, :, t]
                    for tp in range(t + 1, m):
                        x = x + A[:, :, tp, t][..., None] * gg[:, :, tp]
                    dv[:, :, t] = x + D[:, :, t][..., None] * gg[:, :, t]
                for t in range(m):
                    du_acc[t % nq] = du_acc[t % nq] + (dd[:, :, t] * rr[:, :, t]) * kk[:, :, t]
                g = -kk * dk_in
                g[:, :, :-1] += rr[:, :, 1:] * dr_in[:, :, 1:]
                g[:, :, -1] += X
                out["dr"][:, :, sl] = (dd * uu) * kk + dr_in
                out["dk"][:, :, sl] = (dd * uu) * rr + dk_in
                out["dv"][:, :, sl] = dv
                out["dlogw"][:, :, sl] = scan(g, reverse=True)
                dS = np.exp(cum[:, :, -1])[..., None] * dS + _outer_sum(rr * np.exp(cp), gg)
                X = _tile_row_sum(S0 * dS)
        if seg == 0:
            dstate = dS
        du_part.append(_in_order(du_acc))
    unpad = lambda x: x.transpose(0, 2, 1, 3)[:, :s]
    du = np.stack(du_part, axis=1).sum(axis=(0, 1))
    return [unpad(out["dr"]), unpad(out["dk"]), unpad(out["dv"]), unpad(out["dlogw"]), du,
            None if state is None else dstate]


def _sequential_f64(args, do, ds):
    """The VJP token by token in f64: S_{t+1} = e^{logw_t} (.) S_t + k_t^T v_t and
    o_t = r_t (S_t + diag(u) k_t^T v_t), walked back from the final state's cotangent."""
    r, k, v, lw, u, state = (None if a is None else np.asarray(a, np.float64) for a in args)
    do = np.asarray(do, np.float64)
    b, s, h, hd = r.shape
    w = np.exp(lw)
    S = np.zeros((b, h, hd, hd)) if state is None else state
    states = []
    for t in range(s):
        states.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
    dS = np.zeros((b, h, hd, hd)) if ds is None else np.asarray(ds, np.float64)
    dr, dk, dv, dlw = (np.zeros_like(r) for _ in range(4))
    du = np.zeros((h, hd))
    for t in reversed(range(s)):
        rt, kt, vt, gt, St = r[:, t], k[:, t], v[:, t], do[:, t], states[t]
        bonus = (gt * vt).sum(-1, keepdims=True)
        dr[:, t] = np.einsum("bhcj,bhj->bhc", St, gt) + u * kt * bonus
        dk[:, t] = u * rt * bonus + np.einsum("bhcj,bhj->bhc", dS, vt)
        dv[:, t] = gt * (rt * u * kt).sum(-1, keepdims=True) + np.einsum("bhc,bhcj->bhj", kt, dS)
        du += (rt * kt * bonus).sum(0)
        dlw[:, t] = w[:, t] * (dS * St).sum(-1)
        dS = w[:, t, :, :, None] * dS + rt[..., :, None] * gt[..., None, :]
    return [dr, dk, dv, dlw, du, None if state is None else dS]


def _rel_errs(got, want, names, tol, f32=True):
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.shape == w.shape and (not f32 or g.dtype == np.float32), name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, f"{name}: rel err {err:.3g} > {tol}"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
def test_kernel_order_matches_jax_vjp(chunk, hd, case):
    """The walk's order of work in f32 against ``jax.vjp`` of ``wkv_chunked``."""
    s, with_state, with_ds = CASES[case]
    h = 2 if hd == 64 else 3
    args, do, ds = _inputs(2 if hd == 16 else 1, s, h, hd, seed=chunk + hd + s, with_state=with_state)
    launch = wk.launch_chunk(wk.WkvConfig(chunk), s)
    got = _bwd_mirror(args, do, ds if with_ds else None, launch)
    want = _jax_grads(args, do, ds, with_ds)
    _rel_errs([g for g in got if g is not None], want, [n for n, a in zip(LEAVES, args) if a is not None], GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
def test_kernel_order_f64_matches_sequential(chunk, hd, case):
    """The walk's order of work in f64 against the per-token sequential VJP in f64: the
    blocks, runs and trees compute the same function, only the rounding order differs."""
    s, with_state, with_ds = CASES[case]
    h = 2 if hd == 64 else 3
    args, do, ds = _inputs(2 if hd == 16 else 1, s, h, hd, seed=chunk * hd + s, with_state=with_state)
    ds = ds if with_ds else None
    got = _bwd_mirror(args, do, ds, wk.launch_chunk(wk.WkvConfig(chunk), s), dtype=np.float64)
    _rel_errs(got, _sequential_f64(args, do, ds), LEAVES, F64_TOL, f32=False)


@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
def test_segment_lengths_agree(chunk):
    """Segments of 1, 2 and all chunks a head (the reverse pass writing dS at their ends)
    give the same gradients: in f32 within 1e-5 of each other, in f64 each within 1e-12
    of the sequential VJP."""
    s = 2 * chunk + 5 if chunk < 128 else 259  # 3 chunks, the last ragged
    args, do, ds = _inputs(1, s, 2, 16, seed=40 + chunk, with_state=True)
    n = -(-s // chunk)
    assert n == 3
    want64 = _sequential_f64(args, do, ds)
    base = _bwd_mirror(args, do, ds, chunk, n)
    for seg_len in (1, 2, n):
        _rel_errs(_bwd_mirror(args, do, ds, chunk, seg_len), base, LEAVES, GRAD_TOL)
        _rel_errs(_bwd_mirror(args, do, ds, chunk, seg_len, np.float64), want64, LEAVES, F64_TOL, f32=False)


def test_bwd_smem_fits_every_compiled_pair():
    """The backward's shared memory stays within one CTA's at every compiled (chunk, hd), so
    it never shrinks the forward's tuned config space, which stays the five chunks."""
    assert [c.chunk for c in wk.config_space()] == [8, 16, 32, 64, 128]
    for cfg in wk.config_space():
        assert cfg.is_valid()
        for hd in (16, 64):
            assert 0 < cfg.bwd_smem_bytes(hd) <= wk.SMEM_LIMIT
            # the walk's two CTAs an SM (csrc/wkv_bwd.cu WalkSmem's static_assert)
            assert cfg.bwd_smem_bytes(hd) <= 227 * 1024 // 2


@pytest.mark.parametrize("bh, n_chunks, want", [
    (512, 8, 8),     # rwkv6-7b's training shape (8 x 64 heads): one segment, one kernel
    (64, 128, 32),   # the long (1, 2048, 64, 64) call: 4 segments fill 264 slots
    (200, 40, 40),   # fewer heads than slots but not two copies: one segment
    (1, 3, 1),       # one head, 3 chunks: a segment a chunk
])
def test_bwd_segment_len(bh, n_chunks, want):
    """Chunks a segment at 132 SMs x 2 CTAs: cut only where B*H leaves slots empty."""
    assert wk.bwd_segment_len(bh, n_chunks, 132, 2) == want
