"""The WKV op's gradient against the JAX package's, on the CPU.

Seeded numpy inputs (``tests/test_wkv_kernel.py``'s distributions) go through
``jax.vjp`` of the reference's ``repro.models.rwkv.wkv_chunked`` and through
``ops.wkv`` under grad, which on CPU tensors runs the ``repro_torch::wkv`` op:
the plain forward, then ``wkv_backward_plain``, the algorithm of
``csrc/wkv_bwd.cu`` (a reverse pass over the chunk boundaries carrying the
state's gradient, then every chunk's gradients from the chunk start states),
at the launch chunk of the config the runtime selects.  So the backward
formula the card runs is the one held here, at every compiled chunk, both
head dims, a ragged S, an S below the chunk, with and without an initial
state and a final-state cotangent.

Tolerance: every input gradient within 1e-5 of JAX's, relative to the
leaf's largest (f32 on both sides, sums in other orders).  Also a
``gradcheck`` of the op in f64 (the plain versions keep f64), and the plain
backward's own pieces: the chunk start states it recomputes against the
reference on the prefix, and ``wkv_backward_plain`` given the forward's
states against itself recomputing them.
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

