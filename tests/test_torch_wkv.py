"""The port's WKV path against the JAX package's, on the CPU.

``wkv_plain`` (the plain version of the Hopper kernel in ``csrc/wkv.cu``) is
held against the reference's ``wkv_chunked`` and against ``wkv_pallas`` in
interpret mode, on the same numpy inputs drawn as ``tests/test_wkv_kernel.py``
draws them.  The CUDA kernel runs only on the card (``cuda`` marker;
chip_smoke.py holds every compiled config against the plain version there).
Here a numpy mirror of the kernels' two passes (``_two_pass_mirror``: the
state at every chunk boundary into a workspace, then every chunk's output
from it alone; decay factors as exponentials of differences <= 0, a masked
tail instead of padding) is held against the reference at every chunk
length, each boundary state included, so the formulation the kernels
compute is checked before any card runs it.

Tolerance: rtol = atol = 1e-4 (f32 on both sides; the sums differ in order,
and 1e-4 is the reference's own kernel-test tolerance).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import WkvConfig as TpuWkvConfig
from repro.kernels.wkv import wkv_pallas
from repro.models.rwkv import wkv_chunked
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import ops
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.ref import wkv_ref

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(b, s, h, hd, seed=0, with_state=True, logw=None):
    """The reference test's distributions (test_wkv_kernel.py:_inputs), from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r = f(b, s, h, hd) * 0.5
    k = f(b, s, h, hd) * 0.5
    v = f(b, s, h, hd)
    lw = -np.exp(f(b, s, h, hd) * 0.5).clip(1e-3, 5.0)
    if logw is not None:
        lw = logw(rng, (b, s, h, hd)).astype(np.float32)
    u = f(h, hd) * 0.3
    state = f(b, h, hd, hd) * 0.1 if with_state else None
    return r, k, v, lw, u, state


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy() if isinstance(g, torch.Tensor) else g, np.asarray(w), **TOL)


def _pallas(r, k, v, logw, u, state, chunk):
    """wkv_pallas in interpret mode over every (batch, head), as ops.wkv vmaps it."""
    b, s, h, hd = r.shape
    o = np.zeros((b, s, h, hd), np.float32)
    s_out = np.zeros((b, h, hd, hd), np.float32)
    for bi in range(b):
        for hi in range(h):
            st = None if state is None else jnp.asarray(state[bi, hi])
            ob, sb = wkv_pallas(*(jnp.asarray(t[bi, :, hi]) for t in (r, k, v, logw)), jnp.asarray(u[hi]),
                                st, TpuWkvConfig(chunk), interpret=True)
            o[bi, :, hi], s_out[bi, hi] = np.asarray(ob), np.asarray(sb)
    return o, s_out


def _two_pass_mirror(r, k, v, logw, u, state, chunk):
    """csrc/wkv.cu's two kernels in numpy (f32).  Chunks of
    ``wk.launch_chunk`` rows, rows past the end zero r/k/v and logw 0, every
    decay an exponential of a difference <= 0 (below the diagonal 4 x 4
    blocks of scores, factored about the key block's last position as the
    output kernel factors it).

    Pass 1 (``wkv_state_kernel``) walks the chunks in order carrying only the
    state: it writes the state at each chunk's start into ``hs``, then
    applies S <- e^{cum_L} S + k^T v with k^_tau = k_tau e^{cum_L - cum_tau}.
    Pass 2 (``wkv_output_kernel``) computes every chunk's output at once from
    that chunk's r/k/v/logw and ``hs`` alone.  Returns (o, final state, hs).
    """
    b, s, h, hd = r.shape
    L = wk.launch_chunk(wk.WkvConfig(chunk), s)
    n = -(-s // L)
    # (B, H, n, L, hd), zero past the end
    tiles = [np.pad(t, ((0, 0), (0, n * L - s), (0, 0), (0, 0))).reshape(b, n, L, h, hd).transpose(0, 3, 1, 2, 4)
             for t in (r, k, v, logw)]
    rr, kk, vv, ww = (t.astype(np.float32) for t in tiles)
    hs = np.zeros((b, h, n, hd, hd), np.float32)
    S = np.zeros((b, h, hd, hd), np.float32) if state is None else state.astype(np.float32).copy()
    for c in range(n):
        hs[:, :, c] = S
        w = ww[:, :, c]
        after = np.cumsum(w[:, :, ::-1], axis=2)[:, :, ::-1] - w  # sum of logw past tau = cum_L - cum_tau
        khat = kk[:, :, c] * np.exp(after)
        S = np.exp(w.sum(axis=2))[..., None] * S + np.einsum("bhlc,bhlv->bhcv", khat, vv[:, :, c])
    cum = np.cumsum(ww, axis=3)
    cprev = np.concatenate([np.zeros_like(cum[:, :, :, :1]), cum[:, :, :, :-1]], axis=3)  # cum_{t-1}
    tri = np.tril(np.ones((L, L), bool), -1)
    # The decay of a score: e^{cum_{t-1} - cum_tau} inside a 4 x 4 block of (t, tau) on the
    # diagonal; below it, factored about R = cum at the key block's last position,
    # e^{cum_{t-1} - R} e^{R - cum_tau}. Every exponent is <= 0.
    ref = cum[..., np.arange(L) // 4 * 4 + 3, :]  # (tau, c)
    below = (np.arange(L)[:, None] // 4 > np.arange(L)[None, :] // 4)[..., None]
    diag_expo = np.where(tri[..., None], cprev[..., :, None, :] - cum[..., None, :, :], 0.0)  # (t, tau, c)
    t_expo = np.where(below, cprev[..., :, None, :] - ref[..., None, :, :], 0.0)
    tau_expo = np.where(below, (ref - cum)[..., None, :, :], 0.0)
    assert (t_expo <= 0).all() and (tau_expo <= 0).all() and (diag_expo <= 0).all()
    decay = np.where(below, np.exp(t_expo) * np.exp(tau_expo), np.exp(diag_expo))
    A = np.where(tri, np.einsum("bhntc,bhnjc,bhntjc->bhntj", rr, kk, decay), 0.0)
    A = A + np.einsum("bhntc,hc,bhntc->bhnt", rr, u.astype(np.float32), kk)[..., None] * np.eye(L)
    out = A @ vv + (rr * np.exp(cprev)) @ hs
    o = out.transpose(0, 2, 3, 1, 4).reshape(b, n * L, h, hd)[:, :s]
    return o.astype(np.float32), S, hs


@pytest.mark.parametrize("s", [7, 16, 50, 128])
@pytest.mark.parametrize("with_state", [True, False])
def test_plain_matches_wkv_chunked(s, with_state):
    args = _inputs(2, s, 2, 64, seed=s, with_state=with_state)
    got = wk.wkv_plain(*_torch(args))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (2, s, 2, 64)
    _close(got, wkv_chunked(*_jax(args)))


@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
def test_plain_matches_pallas_at_every_chunk(chunk):
    args = _inputs(1, 100, 2, 64, seed=3)
    want = _pallas(*args, chunk)
    # The reference kernel's midpoint factoring can overflow at large chunks
    # (ROADMAP queue 2 item 3); these inputs keep it finite at every chunk.
    assert all(np.isfinite(w).all() for w in want)
    _close(wk.wkv_plain(*_torch(args)), want)


_CLAMP = {
    "all -5": lambda rng, shape: np.full(shape, -5.0),
    "mix -5 / -1e-3": lambda rng, shape: np.where(rng.random(shape) < 0.5, -5.0, -1e-3),
}


@pytest.mark.parametrize("decay", sorted(_CLAMP))
def test_plain_finite_and_equal_at_the_clamp(decay):
    args = _inputs(2, 128, 2, 16, seed=9, logw=_CLAMP[decay])
    got = wk.wkv_plain(*_torch(args))
    assert all(torch.isfinite(t).all() for t in got)
    _close(got, wkv_chunked(*_jax(args)))


@pytest.mark.parametrize("chunk", [c.chunk for c in wk.config_space()])
@pytest.mark.parametrize("case", ["dist-S50", "dist-S100", "clamp-S128", "mix-S7"])
def test_kernel_arithmetic_matches_reference(chunk, case):
    """The kernel's formulation equals wkv_chunked at every chunk, finite
    even where the reference kernel's midpoint factoring overflows."""
    kind, s = case.split("-S")
    logw = {"dist": None, "clamp": _CLAMP["all -5"], "mix": _CLAMP["mix -5 / -1e-3"]}[kind]
    args = _inputs(1, int(s), 2, 16, seed=int(s) + chunk, logw=logw)
    got = _two_pass_mirror(*args, chunk)
    assert all(np.isfinite(g).all() for g in got)
    _close(got[:2], wkv_chunked(*_jax(args)))


_CHUNKS = [c.chunk for c in wk.config_space()]
_RAGGED = (1, 7, 50, 100, 300)


@functools.cache
def _chunked(s, with_state, decay="dist"):
    """Inputs at (1, s, 2, 16) and wkv_chunked's answer, shared by the chunk lengths."""
    args = _inputs(1, s, 2, 16, seed=s + 2 * with_state, with_state=with_state, logw=_CLAMP.get(decay))
    return args, tuple(np.asarray(w) for w in wkv_chunked(*_jax(args)))


@pytest.mark.parametrize("chunk", _CHUNKS)
@pytest.mark.parametrize("s", _RAGGED)
@pytest.mark.parametrize("with_state", [True, False])
def test_two_pass_matches_chunked_and_pallas(chunk, s, with_state):
    """The two passes equal wkv_chunked and wkv_pallas(interpret=True) at
    every compiled chunk length and ragged S, with and without a state."""
    args, want = _chunked(s, with_state)
    got = _two_pass_mirror(*args, chunk)[:2]
    _close(got, want)
    _close(got, _pallas(*args, chunk))


@pytest.mark.parametrize("chunk", _CHUNKS)
@pytest.mark.parametrize("decay", sorted(_CLAMP))
@pytest.mark.parametrize("with_state", [True, False])
def test_two_pass_finite_at_the_clamp(chunk, decay, with_state):
    """At logw = -5 and the -5 / -1e-3 mix, where wkv_pallas's midpoint
    factoring overflows at large chunks (ROADMAP queue 2 item 3), the two
    passes stay finite and equal wkv_chunked."""
    args, want = _chunked(100, with_state, decay)
    got = _two_pass_mirror(*args, chunk)
    assert all(np.isfinite(g).all() for g in got)
    _close(got[:2], want)


@pytest.mark.parametrize("chunk", _CHUNKS)
@pytest.mark.parametrize("with_state", [True, False])
def test_workspace_holds_each_chunk_start_state(chunk, with_state):
    """hs[:, :, c] is the state wkv_chunked ends with after the first c * L
    tokens (the given state at c = 0): what the output pass reads."""
    s = 50
    args = _inputs(1, s, 2, 16, seed=11, with_state=with_state)
    L = wk.launch_chunk(wk.WkvConfig(chunk), s)
    hs = _two_pass_mirror(*args, chunk)[2]
    assert hs.shape == (1, 2, -(-s // L), 16, 16) and hs.nbytes == wk.workspace_bytes(1, s, 2, 16, wk.WkvConfig(chunk))
    for c in range(hs.shape[2]):
        if c == 0:
            want = np.zeros_like(hs[:, :, 0]) if args[5] is None else args[5]
        else:
            want = np.asarray(wkv_chunked(*_jax([a[:, : c * L] for a in args[:4]] + list(args[4:])))[1])
        np.testing.assert_allclose(hs[:, :, c], want, **TOL)


def test_state_chaining_equals_full_run():
    """run(s1) then run(s2 | state) == run(s1 + s2): the serving invariant."""
    r, k, v, lw, u, _ = (None if a is None else torch.from_numpy(a)
                         for a in _inputs(1, 64, 2, 64, seed=5, with_state=False))
    o_full, s_full = wk.wkv_plain(r, k, v, lw, u)
    o1, s1 = wk.wkv_plain(r[:, :24], k[:, :24], v[:, :24], lw[:, :24], u)
    o2, s2 = wk.wkv_plain(r[:, 24:], k[:, 24:], v[:, 24:], lw[:, 24:], u, s1)
    _close((torch.cat([o1, o2], dim=1), s2), (o_full.numpy(), s_full.numpy()))


def test_ops_wkv_on_cpu_runs_plain_and_logs_selection():
    args = _torch(_inputs(2, 40, 2, 16, seed=7))
    rt = KernelRuntime()
    rt.install(ops.FixedPolicy(wkv_config=wk.WkvConfig(64)))
    rt.set_selection_logging(True)
    with rt.activate():
        got = ops.wkv(*args)
    want = wkv_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rt.selection_log() == [("wkv", (40, 16), wk.WkvConfig(64))]
    assert rt.shape_cache_stats()["per_family"]["wkv"] == {"hits": 0, "misses": 1, "size": 1}
    assert wk.total_launches() == 0


def test_selection_without_a_wkv_policy_is_none():
    class MatmulOnly:
        def select_matmul(self, m, k, n, batch):
            return None

    rt = KernelRuntime()
    assert rt.select_wkv_config(16, 64) is None
    rt.install(MatmulOnly())
    assert rt.select_wkv_config(16, 64) is None
    rt.install(ops.FixedPolicy())
    assert rt.select_wkv_config(16, 64) == wk.DEFAULT_WKV_CONFIG


def test_config_space_is_the_compiled_set():
    space = wk.config_space()
    assert [c.chunk for c in space] == [8, 16, 32, 64, 128]
    assert [c.name() for c in space] == ["wkv_c8", "wkv_c16", "wkv_c32", "wkv_c64", "wkv_c128"]
    assert wk.DEFAULT_WKV_CONFIG == wk.WkvConfig(16) and wk.DEFAULT_WKV_CONFIG in space
    assert set(wk.LAUNCHES) == {c.name() for c in space}
    assert all(c.smem_bytes(64) <= wk.SMEM_LIMIT for c in space)
    # The largest of the two kernels' CTAs: the output kernel's four (L, hd + 4) tiles, (L, L + 4)
    # scores, v and state columns of its value block and u, or the state pass's ring of four
    # (k, v, logw) stages of its key rows with their decays (f32 r/k/v; three at chunk 128).
    assert [wk.value_block(c.chunk, 64) for c in space] == [64, 64, 64, 64, 16]
    assert [c.smem_bytes(64) for c in space] == [27776, 39424, 66048, 131584, 219392]
    assert [c.smem_bytes(16) for c in space] == [6400, 12544, 24832, 49408, 117824]
    # hs: the f32 state at every chunk's start, 8.4 MB at rwkv6-7b's (1, 128, 64, 64), chunk 16.
    assert wk.workspace_bytes(1, 128, 64, 64) == 64 * 8 * 64 * 64 * 4 == 8_388_608
    assert wk.workspace_bytes(1, 2048, 64, 64, wk.WkvConfig(8)) == 268_435_456
    assert wk.workspace_bytes(2, 7, 3, 16, wk.WkvConfig(128)) == 2 * 3 * 1 * 16 * 16 * 4
    assert not wk.WkvConfig(256).is_valid()


def test_launch_chunk_follows_the_reference_chunk_rule():
    # The reference runs min(chunk, max(s, 8)); below the config's chunk that
    # is one chunk holding the whole sequence.
    for cfg in wk.config_space():
        for s in (1, 7, 8, 16, 50, 64, 127, 128, 300):
            ref_chunk = min(cfg.chunk, max(s, 8))
            got = wk.launch_chunk(cfg, s)
            if ref_chunk == cfg.chunk:
                assert got == cfg.chunk
            else:
                assert got >= ref_chunk >= s and -(-s // got) == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    args = _torch(_inputs(1, 8, 2, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        wk.wkv_cuda(*args)
    # A non-CPU tensor never takes the plain path: it reaches the kernel's wrapper.
    meta = [None if a is None else a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv(*meta)
    assert wk.total_launches() == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for hd in (16, 64):
        for s in (1, 7, 50, 300):
            for dtype in (torch.float32, torch.bfloat16):
                r, k, v, lw, u, st = (None if a is None else a.cuda() for a in _torch(_inputs(2, s, 3, hd, seed=s)))
                r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
                want = wk.wkv_plain(r, k, v, lw, u, st)
                for cfg in wk.config_space():
                    got = wk.wkv_cuda(r, k, v, lw, u, st, cfg)
                    for g, w in zip(got, want):
                        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-4, (cfg, hd, s, dtype)
