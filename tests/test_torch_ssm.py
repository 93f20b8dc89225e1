"""The port's selective scan against the JAX package's, on the CPU.

``ssm_plain`` (the plain version of the Hopper kernel in ``csrc/ssm.cu``) is
held against the reference's ``ref.ssm_scan_ref`` (the associative scan) on
the same numpy inputs, drawn as ``tests/test_ssm_kernel.py`` draws them.  The
reference's Pallas kernel is not used: it does not run on the installed jax
(``pl.store`` is gone).  The CUDA kernel runs only on the card (``cuda``
marker; chip_smoke.py holds every compiled config against the plain version
there).  Here a numpy mirror of the kernel's chunking (``_kernel_mirror``:
blocks of ``block_d`` channels, chunks of ``chunk`` steps, the ragged tails
loaded as zeros instead of padded) is held against the reference at every
compiled config, so the formulation the kernel computes is checked before
any card runs it.

Tolerance: rtol 1e-4, atol 1e-5 (the reference kernel test's; f32 on both
sides, the sums taken in another order).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssm_scan_ref as jax_ssm_scan_ref
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ssm as sm
from repro_torch.kernels.ref import ssm_scan_ref

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(bsz, s, d, n, seed=0, with_state=True):
    """The reference test's distributions (test_ssm_kernel.py:_inputs), from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    dtx = f(bsz, s, d) * 0.5
    dta = -np.exp(f(bsz, s, d, n) * 0.3)
    b = f(bsz, s, n) * 0.5
    c = f(bsz, s, n) * 0.5
    state = f(bsz, d, n) * 0.1 if with_state else None
    return dtx, dta, b, c, state


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy() if isinstance(g, torch.Tensor) else g, np.asarray(w), **TOL)


def _kernel_mirror(dtx, dta, b, c, state, block_d, chunk):
    """csrc/ssm.cu's arithmetic in numpy (f32): per block of ``block_d``
    channels, chunks of ``chunk`` steps; steps past S and channels past d
    load as zeros (exp(0) = 1, zero input: h passes through), nothing is
    written for them, and y_t is the sum over the N lanes."""
    bsz, s, d = dtx.shape
    n = b.shape[-1]
    y = np.zeros((bsz, s, d), np.float32)
    s_out = np.zeros((bsz, d, n), np.float32)
    n_steps = -(-s // chunk) * chunk
    for bi in range(bsz):
        for ch0 in range(0, d, block_d):
            live = min(block_d, d - ch0)
            pad = lambda a, axes: np.pad(a, axes)
            a = pad(dta[bi, :, ch0:ch0 + live], ((0, n_steps - s), (0, block_d - live), (0, 0)))
            x = pad(dtx[bi, :, ch0:ch0 + live], ((0, n_steps - s), (0, block_d - live)))
            bb = pad(b[bi], ((0, n_steps - s), (0, 0)))
            cc = pad(c[bi], ((0, n_steps - s), (0, 0)))
            h = np.zeros((block_d, n), np.float32)
            if state is not None:
                h[:live] = state[bi, ch0:ch0 + live]
            for t0 in range(0, n_steps, chunk):
                for t in range(t0, t0 + chunk):
                    h = np.exp(a[t]) * h + x[t][:, None] * bb[t][None, :]
                    if t < s:
                        y[bi, t, ch0:ch0 + live] = (h * cc[t][None, :]).sum(-1)[:live]
            s_out[bi, ch0:ch0 + live] = h[:live]
    return y, s_out


_CASES = [(2, s, d, 16, st) for s, d in ((7, 32), (50, 100), (64, 128)) for st in (True, False)]
_CASES.append((1, 70, 96, 8, True))


@pytest.mark.parametrize("bsz,s,d,n,with_state", _CASES)
def test_plain_matches_reference(bsz, s, d, n, with_state):
    args = _inputs(bsz, s, d, n, seed=s + d, with_state=with_state)
    got = sm.ssm_plain(*_torch(args))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (bsz, s, d)
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == (bsz, d, n)
    _close(got, jax_ssm_scan_ref(*(None if a is None else jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("cfg", sm.config_space(), ids=lambda c: c.name())
def test_kernel_arithmetic_matches_reference(cfg):
    """Ragged S and d at every compiled (block_d, chunk)."""
    args = _inputs(2, 37, 50, 8, seed=cfg.block_d + cfg.chunk)
    got = _kernel_mirror(*args, cfg.block_d, cfg.chunk)
    _close(got, jax_ssm_scan_ref(*(jnp.asarray(a) for a in args)))


def test_state_chaining_equals_full_run():
    """run(s1) then run(s2 | state) == run(s1 + s2): the serving invariant."""
    dtx, dta, b, c, _ = _torch(_inputs(2, 64, 48, 16, seed=5, with_state=False))
    y_full, s_full = sm.ssm_plain(dtx, dta, b, c)
    y1, s1 = sm.ssm_plain(dtx[:, :24], dta[:, :24], b[:, :24], c[:, :24])
    y2, s2 = sm.ssm_plain(dtx[:, 24:], dta[:, 24:], b[:, 24:], c[:, 24:], s1)
    _close((torch.cat([y1, y2], dim=1), s2), (y_full.numpy(), s_full.numpy()))


def test_ops_ssm_scan_on_cpu_runs_plain_and_logs_selection():
    args = _torch(_inputs(2, 40, 48, 16, seed=7))
    rt = KernelRuntime()
    rt.install(ops.FixedPolicy(ssm_config=sm.SsmConfig(8, 16)))
    rt.set_selection_logging(True)
    with rt.activate():
        got = ops.ssm_scan(*args)
    want = ssm_scan_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rt.selection_log() == [("ssm_scan", (40, 48), sm.SsmConfig(8, 16))]
    assert rt.shape_cache_stats()["per_family"]["ssm_scan"] == {"hits": 0, "misses": 1, "size": 1}
    assert sm.total_launches() == 0


def test_selection_without_an_ssm_policy_is_none():
    class MatmulOnly:
        def select_matmul(self, m, k, n, batch):
            return None

    rt = KernelRuntime()
    assert rt.select_ssm_config(16, 64) is None
    rt.install(MatmulOnly())
    assert rt.select_ssm_config(16, 64) is None
    rt.install(ops.FixedPolicy())
    assert rt.select_ssm_config(16, 64) == sm.DEFAULT_SSM_CONFIG


def test_config_space_is_the_compiled_set():
    """The Python side lists exactly the instantiations csrc/ssm.cu compiles."""
    src = (_build.CSRC / "ssm.cu").read_text()
    grab = lambda name: tuple(int(v) for v in re.findall(r"X\((?:BD, )?(?:C, )?(\d+)\)",
                                                            re.search(rf"#define {name}\(.*", src).group(0)))
    block_ds, chunks, states = grab("REPRO_SSM_BLOCK_DS"), grab("REPRO_SSM_CHUNKS"), grab("REPRO_SSM_STATES")
    assert (block_ds, chunks, states) == ((8, 16, 32), (8, 16, 32), (8, 16))
    assert sm.config_space() == tuple(sm.SsmConfig(bd, c) for bd in block_ds for c in chunks)
    assert [c.name() for c in sm.config_space()][:2] == ["ssm_bd8_c8", "ssm_bd8_c16"]
    assert sm.DEFAULT_SSM_CONFIG == sm.SsmConfig(16, 32) and sm.DEFAULT_SSM_CONFIG in sm.config_space()
    assert set(sm.LAUNCHES) == {c.name() for c in sm.config_space()}
    assert not sm.SsmConfig(64, 32).is_valid() and not sm.SsmConfig(16, 64).is_valid()
    # At hymba-1.5b's batch-1 prefill (d = 1600) the default launches 100 CTAs on 132 SMs.
    assert -(-1600 // sm.DEFAULT_SSM_CONFIG.block_d) == 100


def _bad(kind):
    dtx, dta, b, c, st = _torch(_inputs(1, 8, 16, 16, seed=1))
    if kind == "state size 4":
        dta, b, c, st = dta[..., :4], b[..., :4], c[..., :4], st[..., :4]
    elif kind == "bf16":
        dta = dta.bfloat16()
    elif kind == "strided":
        dta = dta.transpose(2, 3)
    elif kind == "shape":
        b = b[:, :4]
    return dtx, dta, b, c, st


@pytest.mark.parametrize("kind,err", [("state size 4", ValueError), ("bf16", TypeError),
                                      ("strided", ValueError), ("shape", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, err):
    with pytest.raises(err):
        sm.ssm_cuda(*_bad(kind))
    assert sm.total_launches() == 0


def test_wrapper_needs_a_cuda_device():
    args = _torch(_inputs(1, 8, 16, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        sm.ssm_cuda(*args)
    with pytest.raises(ValueError, match="compiled ssm config"):
        sm.ssm_cuda(*args, config=sm.SsmConfig(16, 64))
    # A non-CPU tensor never takes the plain path: it reaches the kernel's wrapper.
    meta = [None if a is None else a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan(*meta)
    assert sm.total_launches() == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for n in (8, 16):
        for s, d in ((1, 100), (7, 32), (50, 100), (300, 64)):
            for with_state in (True, False):
                args = [None if a is None else a.cuda() for a in _torch(_inputs(2, s, d, n, seed=s, with_state=with_state))]
                want = sm.ssm_plain(*args)
                for cfg in sm.config_space():
                    got = sm.ssm_cuda(*args, config=cfg)
                    for g, w in zip(got, want):
                        assert torch.isfinite(g).all()
                        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-4, (cfg, n, s, d)
