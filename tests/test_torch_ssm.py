"""The port's selective scan against the JAX package's, on the CPU.

``ssm_plain`` and ``ssm_fused_plain`` (the plain versions of the Hopper
kernels in ``csrc/ssm.cu``) are held against the reference's
``ref.ssm_scan_ref`` (the associative scan) on the same numpy inputs, drawn as
``tests/test_ssm_kernel.py`` draws them.  The reference's Pallas kernel is not
used: it does not run on the installed jax (``pl.store`` is gone).  The CUDA
kernels run only on the card (``cuda`` marker; chip_smoke.py holds both
entries at every compiled config against the plain versions there).  Here a
numpy mirror of the kernels' design (``_kernel_mirror``: blocks of
``block_d`` channels; the sequence cut into segments of whole chunks; a state
pass running every segment but the last from a zero state to its end state
and decay product; the output pass folding the earlier segments' pairs in
segment order into its start state; dt * a and dt * x formed from x, dt and
a on the fused entry; exp as 2^(dta log2 e); ragged tails loaded as zeros) is
held against the reference at every compiled config and at 1, 2 and several
segments, each segment's start state against the reference on the prefix, so
the formulation the kernels compute is checked before any card runs it.

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


LOG2E = np.float32(1.4426950408889634)


def _fused_inputs(bsz, s, d, n, seed=0, with_state=True):
    """x, dt (softplus of a normal, as models/mamba.py makes it), a (-exp of 0.3
    normal: dt * a lies where the reference test's dta does), b, c and the state."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    x = f(bsz, s, d) * 0.5
    dt = np.log1p(np.exp(f(bsz, s, d))).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3)
    b = f(bsz, s, n) * 0.5
    c = f(bsz, s, n) * 0.5
    state = f(bsz, d, n) * 0.1 if with_state else None
    return x, dt, a, b, c, state


def _formed(x, dt, a):
    """dtx and dta as models/mamba.py forms them: one f32 multiply each."""
    return dt * x, dt[..., None] * a


def _kernel_mirror(x, d_in, a, b, c, state, block_d, chunk, segments, starts=None):
    """csrc/ssm.cu's arithmetic in numpy (f32).

    Fused entry when ``a`` is given (``x`` = x, ``d_in`` = dt: dtx = dt * x and
    dta = dt * a formed per step), else the dta entry (``x`` = dtx, ``d_in`` =
    dta).  Per block of ``block_d`` channels the sequence is cut into
    ``segments`` segments of whole chunks (``ssm.segment_len``), and each chunk
    into time groups of ``ssm.GROUP_STEPS`` steps.  A group runs its steps from
    a zero state, keeping after each step the state hz and the decay product az;
    the chunk's start state h is folded through the groups' (az, hz) at their
    last step in group order (h = P_v h + E_v), the fold up to group w being
    its start state hw, and a step's state is hz + az hw.  The state pass runs
    every segment but the last from zeros to its end state E and decay product
    P (the product of the groups' P in order); the output pass starts segment g
    from the given state folded through (P_0, E_0) .. (P_{g-1}, E_{g-1}) in that
    order, and the last segment writes the final state.  Steps past S and
    channels past d load as zeros (2^0 = 1, zero input: h passes through) and
    write nothing.  ``starts``, if a list, receives each segment's start state.
    """
    bsz, s, d = x.shape
    n = b.shape[-1]
    cfg = sm.SsmConfig(block_d, chunk)
    seg = sm.segment_len(s, cfg, segments)
    assert sm.reachable_segments(s, cfg, segments) == segments
    n_steps, group = segments * seg, sm.GROUP_STEPS
    pad_t = lambda arr: np.pad(arr, [(0, n_steps - s)] + [(0, 0)] * (arr.ndim - 1))
    y = np.zeros((bsz, s, d), np.float32)
    s_out = np.zeros((bsz, d, n), np.float32)
    seg_starts = np.zeros((segments, bsz, d, n), np.float32)
    for bi in range(bsz):
        for ch0 in range(0, d, block_d):
            live = min(block_d, d - ch0)
            pad_d = lambda arr: np.pad(arr, [(0, 0), (0, block_d - live)] + [(0, 0)] * (arr.ndim - 2))
            xs = pad_d(pad_t(x[bi, :, ch0:ch0 + live]))
            ds = pad_d(pad_t(d_in[bi, :, ch0:ch0 + live]))
            av = None if a is None else np.pad(a[ch0:ch0 + live], ((0, block_d - live), (0, 0)))
            bb, cc = pad_t(b[bi]), pad_t(c[bi])

            def run(t_begin, h, out):
                """One segment from ``h``; returns (end state, decay product)."""
                p_seg = np.ones((block_d, n), np.float32)
                for t0 in range(t_begin, t_begin + seg, chunk):
                    pairs, steps = [], []
                    for g0 in range(t0, t0 + chunk, group):  # phase 1, each group from zero
                        hr = np.zeros((block_d, n), np.float32)
                        ar = np.ones((block_d, n), np.float32)
                        for t in range(g0, g0 + group):
                            if av is None:
                                dtx, dta = xs[t], ds[t]
                            else:
                                dtx, dta = ds[t] * xs[t], ds[t][:, None] * av
                            e = np.exp2(dta * LOG2E)
                            hr = e * hr + dtx[:, None] * bb[t][None, :]
                            ar = ar * e
                            steps.append((t, hr, ar, len(pairs)))
                        pairs.append((ar, hr))
                    starts_w = []  # phase 2: the fold in group order
                    for p_v, e_v in pairs:
                        starts_w.append(h)
                        h = p_v * h + e_v
                        p_seg = p_seg * p_v
                    if out:
                        for t, hz, az, w in steps:
                            if t < s:
                                y[bi, t, ch0:ch0 + live] = ((hz + az * starts_w[w]) * cc[t][None, :]).sum(-1)[:live]
                return h, p_seg

            # state pass: every segment but the last, from zeros
            seg_pairs = [run(g * seg, np.zeros((block_d, n), np.float32), False)[::-1] for g in range(segments - 1)]
            # output pass: the fold over the earlier segments, then the segment
            for g in range(segments):
                h = np.zeros((block_d, n), np.float32)
                if state is not None:
                    h[:live] = state[bi, ch0:ch0 + live]
                for p_k, e_k in seg_pairs[:g]:
                    h = p_k * h + e_k
                seg_starts[g, bi, ch0:ch0 + live] = h[:live]
                h, _ = run(g * seg, h, True)
            s_out[bi, ch0:ch0 + live] = h[:live]
    if starts is not None:
        starts.extend(seg_starts)
    return y, s_out


def _jax_ref(dtx, dta, b, c, state):
    return jax_ssm_scan_ref(*(None if v is None else jnp.asarray(v) for v in (dtx, dta, b, c, state)))


_CASES = [(2, s, d, 16, st) for s, d in ((7, 32), (50, 100), (64, 128)) for st in (True, False)]
_CASES.append((1, 70, 96, 8, True))


@pytest.mark.parametrize("bsz,s,d,n,with_state", _CASES)
def test_plain_matches_reference(bsz, s, d, n, with_state):
    args = _inputs(bsz, s, d, n, seed=s + d, with_state=with_state)
    got = sm.ssm_plain(*_torch(args))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (bsz, s, d)
    assert got[1].dtype == torch.float32 and tuple(got[1].shape) == (bsz, d, n)
    _close(got, jax_ssm_scan_ref(*(None if a is None else jnp.asarray(a) for a in args)))


def _several(s, cfg):
    """The most segments of whole chunks S = 101 allows at ``cfg``, up to 5."""
    return sm.reachable_segments(s, cfg, 5)


_MIRROR_S, _MIRROR_D = 101, 50  # ragged against every chunk and block_d


@pytest.mark.parametrize("split", ["1", "2", "several"])
@pytest.mark.parametrize("cfg", sm.config_space(), ids=lambda c: c.name())
def test_kernel_mirror_matches_reference(cfg, split):
    """Ragged S and d at every compiled (block_d, chunk), at 1, 2 and several
    segments: the dta entry on the reference test's draws (N = 8), the fused
    entry on x, dt and a (N = 16)."""
    segments = {"1": 1, "2": 2, "several": _several(_MIRROR_S, cfg)}[split]
    seed = cfg.block_d + cfg.chunk + segments
    dtx, dta, b, c, st = _inputs(2, _MIRROR_S, _MIRROR_D, 8, seed=seed)
    _close(_kernel_mirror(dtx, dta, None, b, c, st, cfg.block_d, cfg.chunk, segments),
           _jax_ref(dtx, dta, b, c, st))
    x, dt, a, b, c, st = _fused_inputs(2, _MIRROR_S, _MIRROR_D, 16, seed=seed, with_state=segments != 2)
    _close(_kernel_mirror(x, dt, a, b, c, st, cfg.block_d, cfg.chunk, segments),
           _jax_ref(*_formed(x, dt, a), b, c, st))


@pytest.mark.parametrize("cfg", [sm.SsmConfig(8, 8), sm.DEFAULT_SSM_CONFIG, sm.SsmConfig(32, 16)],
                         ids=lambda c: c.name())
def test_segment_start_states_match_reference_on_the_prefix(cfg):
    """Each segment's folded start state is the reference's final state over the
    steps before it (from the given state)."""
    x, dt, a, b, c, st = _fused_inputs(1, 200, 40, 16, seed=cfg.chunk)
    segments = sm.reachable_segments(200, cfg, 5)
    assert segments > 2
    starts = []
    _kernel_mirror(x, dt, a, b, c, st, cfg.block_d, cfg.chunk, segments, starts)
    seg = sm.segment_len(200, cfg, segments)
    dtx, dta = _formed(x, dt, a)
    np.testing.assert_array_equal(starts[0], st)
    for g in range(1, segments):
        t = g * seg
        _, want = _jax_ref(dtx[:, :t], dta[:, :t], b[:, :t], c[:, :t], st)
        np.testing.assert_allclose(starts[g], np.asarray(want), **TOL)


_HARVEST_LONG = (2048, 4096, 32768, 524288)  # the ssm_scan family's long lengths (repro/core/recmodel.py)


@pytest.mark.parametrize("s", (32, 64, 128) + _HARVEST_LONG)
def test_segment_rule_at_hymba_shapes(s):
    """(1, S, 1600): the served buckets never cut; the long lengths cut only where
    the CTAs one SM holds leave the grid under a third of a wave."""
    d = 1600
    default = sm.DEFAULT_SSM_CONFIG
    for resident in (1, 2):  # the default's output pass on an H100 holds 1-2 CTAs an SM
        assert sm.ssm_segments(1, s, d, default, 132, resident) == 1  # 100 CTAs: a cut would not triple it
    c8 = sm.SsmConfig(16, 8)
    got = sm.ssm_segments(1, s, d, c8, 132, 10)
    if s < 12 * 8:
        assert got == 1
    else:  # fill the wave: 132 x 10 // 100 = 13 segments, as the chunks reach them
        assert got == sm.reachable_segments(s, c8, 13) and 3 <= got <= 13
        assert sm.segment_len(s, c8, got) >= 2 * 8 and (got - 1) * sm.segment_len(s, c8, got) < s


@pytest.mark.parametrize("s", (1, 7, 32, 96, 128, 300))
def test_segment_rule_small_grid(s):
    """(2, S, 100): a grid of 26 CTAs (block_d 8) cuts at chunk 8 from 12 chunks up,
    into segments of 2 chunks; chunk 32 never reaches 12 chunks here."""
    c8, c32 = sm.SsmConfig(8, 8), sm.SsmConfig(8, 32)
    n_chunks = -(-s // 8)
    want = sm.reachable_segments(s, c8, n_chunks // 2) if n_chunks >= 12 else 1
    assert sm.ssm_segments(2, s, 100, c8, 132, 24) == want
    assert sm.ssm_segments(2, s, 100, c32, 132, 24) == 1


def test_segment_rule_invariants():
    """Every count is 1 or at least SEG_MIN_CUT, one the whole-chunk segments reach
    exactly, none empty, each but the last at least SEG_MIN_CHUNKS chunks."""
    for cfg in sm.config_space():
        for b, d in ((1, 1600), (2, 100), (4, 64), (1, 32)):
            for s in (1, 8, 95, 96, 97, 200, 1000, 2048, 4099):
                for resident in (1, 4, 32):
                    g = sm.ssm_segments(b, s, d, cfg, 132, resident)
                    assert g == 1 or g >= sm.SEG_MIN_CUT
                    assert sm.reachable_segments(s, cfg, g) == g
                    seg = sm.segment_len(s, cfg, g)
                    assert (g - 1) * seg < s <= g * seg
                    assert g == 1 or seg >= sm.SEG_MIN_CHUNKS * cfg.chunk
                    assert g == 1 or b * -(-d // cfg.block_d) * g <= 132 * resident


def test_workspace_bound_holds_every_cut_call(monkeypatch):
    """No cut call needs more workspace than workspace_bound, the size a stream's
    first allocation takes and keeps (the CTAs an SM holds from a stub of the
    occupancy query, which needs the card)."""
    resident = {cfg: 1 + i % 3 for i, cfg in enumerate(sm.config_space())}
    monkeypatch.setattr(sm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(sm, "resident_ctas", lambda cfg, n, fused, index: resident[cfg] + fused)
    bound = sm.workspace_bound.__wrapped__(0)
    assert bound == max(2 * 132 * (resident[cfg] + fused) * cfg.block_d * n
                        for cfg in sm.config_space() for n in sm._STATES for fused in (0, 1))
    cut = 0
    for cfg in sm.config_space():
        for n in sm._STATES:
            for fused in (0, 1):
                for b, d in ((1, 1600), (2, 100), (4, 64), (1, 32), (1, 48)):
                    for s in (96, 200, 1000, 2048, 4099, 32768):
                        g = sm.ssm_segments(b, s, d, cfg, 132, resident[cfg] + fused)
                        cut += g > 1
                        assert sm.workspace_floats(b, d, n, g) <= bound
    assert cut > 0


def test_fused_plain_matches_reference():
    """ssm_fused_plain == the JAX path: dt[..., None] * a and dt * x into ssm_scan_ref."""
    for with_state in (True, False):
        args = _fused_inputs(2, 45, 36, 16, seed=3, with_state=with_state)
        x, dt, a, b, c, st = args
        got = sm.ssm_fused_plain(*_torch(args))
        jx, jdt, ja = (jnp.asarray(v) for v in (x, dt, a))
        want = jax_ssm_scan_ref(jdt * jx, jdt[..., None] * ja, jnp.asarray(b), jnp.asarray(c),
                                None if st is None else jnp.asarray(st))
        _close(got, want)
        # Bitwise the dta entry's plain version on the dtx and dta mamba_layer formed.
        dtx, dta = (torch.from_numpy(v) for v in _formed(x, dt, a))
        same = sm.ssm_plain(dtx, dta, *_torch((b, c, st)))
        assert all(torch.equal(g, w) for g, w in zip(got, same))


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


def test_wrapper_needs_a_cuda_device(monkeypatch):
    args = _torch(_inputs(1, 8, 16, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        sm.ssm_cuda(*args)
    with pytest.raises(ValueError, match="compiled ssm config"):
        sm.ssm_cuda(*args, config=sm.SsmConfig(16, 64))
    # A meta tensor (the dry run's) takes the scan op's fake impl: shapes only, no launch.
    meta = [None if a is None else a.to("meta") for a in args]
    y, s_out = ops.ssm_scan(*meta)
    assert y.is_meta and y.shape == args[0].shape
    # A tensor on a card never takes the plain path: it reaches the kernel's wrapper.
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan(*args)
    assert sm.total_launches() == 0


def _bad_fused(kind):
    x, dt, a, b, c, st = _torch(_fused_inputs(1, 8, 16, 16, seed=1))
    if kind == "state size 4":
        a, b, c, st = a[:, :4], b[..., :4], c[..., :4], st[..., :4]
    elif kind == "bf16":
        dt = dt.bfloat16()
    elif kind == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "dt shape":
        dt = dt[:, :4]
    elif kind == "a shape":
        a = a[:8]
    elif kind == "a rank":
        a = a[None]
    return x, dt, a, b, c, st


@pytest.mark.parametrize("kind,err", [("state size 4", ValueError), ("bf16", TypeError), ("strided", ValueError),
                                      ("dt shape", ValueError), ("a shape", ValueError), ("a rank", ValueError)])
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(kind, err):
    with pytest.raises(err):
        sm.ssm_cuda_fused(*_bad_fused(kind))
    assert sm.total_launches() == 0 and sm.ENTRY_LAUNCHES == {"fused": 0, "dta": 0}


def test_fused_wrapper_needs_a_cuda_device(monkeypatch):
    args = _torch(_fused_inputs(1, 8, 16, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        sm.ssm_cuda_fused(*args)
    with pytest.raises(ValueError, match="compiled ssm config"):
        sm.ssm_cuda_fused(*args, config=sm.SsmConfig(16, 64))
    meta = [None if a is None else a.to("meta") for a in args]
    y, s_out = ops.ssm_scan_fused(*meta)
    assert y.is_meta and y.shape == args[0].shape
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssm_scan_fused(*args)
    assert sm.total_launches() == 0


def test_ops_ssm_scan_fused_on_cpu_runs_plain_and_logs_selection():
    """Selected as ops.ssm_scan is (family ssm_scan, features (S, d)); on CPU the plain version."""
    args = _torch(_fused_inputs(2, 40, 48, 16, seed=7))
    rt = KernelRuntime()
    rt.install(ops.FixedPolicy(ssm_config=sm.SsmConfig(8, 16)))
    rt.set_selection_logging(True)
    with rt.activate():
        got = ops.ssm_scan_fused(*args)
    want = sm.ssm_fused_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rt.selection_log() == [("ssm_scan", (40, 48), sm.SsmConfig(8, 16))]
    assert sm.total_launches() == 0


def test_mamba_layer_builds_no_state_sized_tensor(monkeypatch):
    """mamba_layer hands x, dt and a to ops.ssm_scan_fused and forms no (B, S, d, N)
    tensor itself (the scan, stubbed here, is the kernel on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import registry
    from repro_torch.models import mamba as tmb

    cfg = registry.get("hymba-1.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in tmb.init_mamba(cfg, lambda shape, scale: torch.randn(shape, generator=gen) * scale,
                                            lambda shape, value: torch.full(shape, value), n_layers=1).items()}
    bsz, s, d, n = 2, 12, cfg.d_model, cfg.ssm_state
    seen, calls = [], []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    seen.append(tuple(t.shape))
            return out

    def stub(x, dt, a, b, c, state=None):
        calls.append((tuple(x.shape), tuple(dt.shape), tuple(a.shape), tuple(b.shape)))
        return torch.zeros((bsz, s, d)), torch.zeros((bsz, d, n))

    monkeypatch.setattr(ops, "ssm_scan_fused", stub)
    monkeypatch.setattr(ops, "ssm_scan", lambda *a, **k: pytest.fail("mamba_layer took the dta entry"))
    x = torch.randn((bsz, s, d), generator=gen)
    with Shapes():
        tmb.mamba_layer(p, x, cfg)
    assert calls == [((bsz, s, d), (bsz, s, d), (d, n), (bsz, s, n))]
    assert (bsz, s, d, n) not in seen and not any(len(shape) == 4 for shape in seen)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for n in (8, 16):
        for s, d in ((1, 100), (7, 32), (50, 100), (300, 64)):
            for with_state in (True, False):
                args = [None if a is None else a.cuda() for a in _torch(_inputs(2, s, d, n, seed=s, with_state=with_state))]
                want = sm.ssm_plain(*args)
                fargs = [None if a is None else a.cuda()
                         for a in _torch(_fused_inputs(2, s, d, n, seed=s, with_state=with_state))]
                fwant = sm.ssm_fused_plain(*fargs)
                for cfg in sm.config_space():
                    for got, ref in ((sm.ssm_cuda(*args, config=cfg), want),
                                     (sm.ssm_cuda_fused(*fargs, config=cfg), fwant)):
                        for g, w in zip(got, ref):
                            assert torch.isfinite(g).all()
                            assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-4, (cfg, n, s, d)
