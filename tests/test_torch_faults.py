"""The port's fault containment against the JAX package's (``core/faults.py``,
the runtime's breaker and incident ring, ``ops._guarded_call``).

Both packages get the same fault plans (parsed from the same text, the same
seed), the same call sequences and the same numpy inputs; fire logs,
``corrupt_text`` outputs, incident records, breaker states and epoch moves
must be equal.  The reference runs as its own tests run it on the CPU
(``use_pallas`` off: its guard answers a failure from the reference path),
and the port on CPU tensors answers from its plain version, so even the
incident outcomes match.  The port's one design difference, a CUDA call
redirected to the family's compiled default config instead of a plain
version (or raised as ``unrecoverable``), is held here with a stub CUDA
launcher: the plain version is never called for a CUDA-flagged call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.kernels import ops as jax_ops
from repro.kernels.matmul import MatmulConfig as JaxMatmulConfig
from repro.kernels.matmul import config_space as jax_matmul_space
from repro.kernels.ops import FixedPolicy as JaxFixedPolicy
from repro_torch.core import faults, runtime
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import _build, ops
from repro_torch.kernels import attention as at
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm as ss
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.matmul import MatmulConfig
from repro_torch.kernels.ops import FixedPolicy

PLANS = [
    "dispatch.matmul:nan:2,engine.prefill:compile_error:1:3",
    "engine.prefill:compile_error,engine.decode:compile_error:1:5,dispatch.matmul:compile_error",
    "dispatch.:oom:-1:2,canary.matmul:inf",
    "bundle.load:corrupt:2,dispatch.wkv:compile_error:1:1",
]
CALLS = [("dispatch.matmul", "mm_a"), ("engine.prefill", ""), ("dispatch.wkv", "wkv_c16"), ("engine.decode", ""),
         ("dispatch.matmul", "mm_b"), ("canary.matmul", "mm_a"), ("dispatch.ssm_scan", "ssm"),
         ("bundle.load", "p.json")]


def _events(plan):
    return [(e.seq, e.site, e.kind, e.key) for e in plan.events]


def _specs(plan):
    return [(s.site, s.kind, s.times, s.after, s.seen, s.fired) for s in plan.specs()]


@pytest.mark.parametrize("text", PLANS)
@pytest.mark.parametrize("seed", [0, 7])
def test_parsed_plans_fire_on_the_same_calls(text, seed):
    jp, tp = jax_faults.FaultPlan.parse(text, seed=seed), faults.FaultPlan.parse(text, seed=seed)
    for i in range(40):
        site, key = CALLS[i % len(CALLS)]
        j, t = jp.fire(site, key), tp.fire(site, key)
        assert (j is None) == (t is None)
        if j is not None:
            assert (j.kind, j.fired) == (t.kind, t.fired)
    assert _events(jp) == _events(tp) and _events(tp)
    assert _specs(jp) == _specs(tp)
    assert jp.active == tp.active


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_probabilistic_specs_draw_the_same(seed):
    plans = [jax_faults.FaultPlan(seed=seed), faults.FaultPlan(seed=seed)]
    for plan in plans:
        plan.inject("dispatch.matmul", "compile_error", times=None, p=0.3, match="bm128")
        plan.inject("dispatch.", "latency", times=4, after=2, p=0.6)
    keys = ["mm_bm128_bn128", "mm_bm64", "mm_bm128_bn64"]
    fired = [[plan.fire("dispatch.matmul", keys[i % 3]) is not None for i in range(60)] for plan in plans]
    assert fired[0] == fired[1] and any(fired[1]) and not all(fired[1])
    assert _events(plans[0]) == _events(plans[1])


@pytest.mark.parametrize("value", [0, 5, 64])
def test_corrupt_text_equal(value):
    text = '{"format": "bundle", "version": 6, "deployments": {"tpu_v5e": {"configs": [1, 2, 3]}}}' * 3
    outs = []
    for mod in (jax_faults, faults):
        plan = mod.FaultPlan(seed=3)
        plan.inject("bundle.load", "corrupt", times=2, value=value)
        outs.append([plan.corrupt_text("bundle.load", text, key="b.json") for _ in range(3)])
    assert outs[0] == outs[1]
    assert outs[1][0] != text and outs[1][1] != text and outs[1][2] == text


@pytest.mark.parametrize("kind", ["compile_error", "oom"])
def test_raising_kinds_raise_the_same_types(kind):
    names = []
    for mod in (jax_faults, faults):
        plan = mod.FaultPlan.parse(f"dispatch.matmul:{kind}")
        with pytest.raises(mod.FaultError) as err:
            plan.raise_if("dispatch.matmul", "mm_x")
        names.append((type(err.value).__name__, str(err.value)))
    assert names[0] == names[1]


def test_incident_records_have_the_same_shape():
    cfgs = (JaxMatmulConfig(128, 256, 512), MatmulConfig(128, 256, 512))
    for err, action in [(jax_faults.InjectedCompileError("boom"), "quarantined"), ("re-probe succeeded", "absolved")]:
        perr = faults.InjectedCompileError("boom") if not isinstance(err, str) else err
        want = jax_faults.incident("dispatch.matmul", "matmul", cfgs[0], err, action, device="tpu_v5e", seq=3)
        got = faults.incident("dispatch.matmul", "matmul", cfgs[1], perr, action, device="tpu_v5e", seq=3)
        assert got == want
    assert faults.incident("engine.decode", "engine", None, "x", "retry") == jax_faults.incident(
        "engine.decode", "engine", None, "x", "retry")


def test_incident_ring_caps_but_the_count_is_monotone():
    rt = KernelRuntime()
    for i in range(runtime.DEFAULT_INCIDENT_CAP + 10):
        rt.record_incident(faults.incident("s", "f", None, "e", "a"))
    assert rt.incident_count() == runtime.DEFAULT_INCIDENT_CAP + 10
    assert len(rt.incidents()) == runtime.DEFAULT_INCIDENT_CAP
    assert rt.incidents()[-1]["seq"] == rt.incident_count()


def test_guarded_exceptions():
    for kind in (faults.FaultError, faults.NonFiniteOutputError, _build.KernelBuildError,
                 _build.KernelLaunchError, torch.cuda.OutOfMemoryError):
        assert issubclass(kind, faults.GUARDED_EXCEPTIONS), kind
    for kind in (TypeError, ValueError, RuntimeError):
        assert not issubclass(kind, faults.GUARDED_EXCEPTIONS), kind
    if hasattr(torch, "AcceleratorError"):  # a sticky CUDA error poisons the context
        assert not issubclass(torch.AcceleratorError, faults.GUARDED_EXCEPTIONS)
    # The typed errors stay RuntimeErrors: existing catches still match.
    assert issubclass(_build.KernelBuildError, RuntimeError) and issubclass(_build.KernelLaunchError, RuntimeError)


def test_nvcc_missing_raises_a_build_error(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


# ---------------------------------------------------------------------------
# the guard and the breaker, against the reference, on the same call sequence
# ---------------------------------------------------------------------------
def _non_default():
    """A matmul config that is neither package's default, the same in both."""
    port_default = mm.DEFAULT_CONFIG
    jax_default = jax_ops.DEFAULT_CONFIG
    cfg = next(c for c in jax_matmul_space() if c != jax_default and (c.block_m, c.block_n, c.block_k, c.order) != (
        port_default.block_m, port_default.block_n, port_default.block_k, port_default.order))
    return cfg, MatmulConfig(cfg.block_m, cfg.block_n, cfg.block_k, cfg.order)


def _runtimes(text: str | None = None, seed: int = 0, plans=None):
    jcfg, tcfg = _non_default()
    jrt, trt = JaxRuntime(name="faults"), KernelRuntime(name="faults")
    jrt.install_for_device("tpu_v5e", JaxFixedPolicy(matmul_config=jcfg))
    trt.install_for_device("tpu_v5e", FixedPolicy(matmul_config=tcfg))
    jrt.activate_device("tpu_v5e")
    trt.activate_device("tpu_v5e")
    if text is not None:
        jrt.set_fault_plan(jax_faults.FaultPlan.parse(text, seed=seed))
        trt.set_fault_plan(faults.FaultPlan.parse(text, seed=seed))
    return jrt, trt, jcfg, tcfg


def _matmul_both(jrt, trt, a, b):
    with jrt.activate():
        want = np.asarray(jax_ops.matmul(jnp.asarray(a), jnp.asarray(b)))
    with trt.activate():
        got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return want, got


# Each package redirects a quarantined matmul selection to its own default
# config (the port's is a compiled Hopper tile): records name it "<default>".
_DEFAULTS = {jax_ops.DEFAULT_CONFIG.name(), mm.DEFAULT_CONFIG.name()}


def _neutral(text):
    for name in _DEFAULTS:
        text = text.replace(name, "<default>") if isinstance(text, str) else text
    return text


def _breaker(rt):
    return [{k: _neutral(e[k]) for k in ("family", "name", "device", "failures", "backoff", "countdown", "skipped",
                                         "probes", "state")} for e in rt.quarantined()]


def _incidents(rt):
    return [{k: _neutral(r[k]) for k in ("seq", "site", "family", "config", "device", "error", "action")}
            for r in rt.incidents()]


@pytest.mark.parametrize("text", ["dispatch.matmul:compile_error", "dispatch.matmul:oom",
                                  "dispatch.matmul:compile_error:1:2", "dispatch.matmul:compile_error:2"])
def test_breaker_cycle_equal(text):
    """quarantine -> redirected selections -> half-open re-probe -> absolve (or
    a failed probe doubling the backoff): equal incidents, breaker states, epoch
    moves and outputs at every call."""
    jrt, trt, jcfg, tcfg = _runtimes(text)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 8, 16)).astype(np.float32)
    b = rng.normal(size=(16, 8)).astype(np.float32)
    jrt.set_selection_logging(True)
    trt.set_selection_logging(True)
    for _ in range(2 * runtime.QUARANTINE_BACKOFF + 6):
        want, got = _matmul_both(jrt, trt, a, b)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert trt.policy_epoch() == jrt.policy_epoch()
        assert _breaker(trt) == _breaker(jrt)
        assert _incidents(trt) == _incidents(jrt)
    actions = [r["action"] for r in trt.incidents()]
    # The served config is absolved (with times=2 the second fault lands on the
    # redirected default, whose entry nothing re-probes, in both packages).
    assert "quarantined" in actions and "absolved" in actions
    assert tcfg.name() not in [e["name"] for e in trt.quarantined()]
    # The selections served the quarantined config, or redirected it, on the same calls.
    served = [[cfg.name() == jcfg.name() for _, _, cfg in rt.selection_log()] for rt in (jrt, trt)]
    assert served[0] == served[1] and not all(served[1])
    assert all(_neutral(cfg.name()) == "<default>" for _, _, cfg in trt.selection_log() if cfg.name() != tcfg.name())


def test_nan_injection_is_contained_not_served():
    jrt, trt, _, _ = _runtimes("dispatch.matmul:nan")
    a = np.ones((4, 16), np.float32)
    b = np.ones((16, 8), np.float32)
    want, got = _matmul_both(jrt, trt, a, b)
    assert np.isfinite(got).all() and np.array_equal(got, want)
    assert _incidents(trt) == _incidents(jrt) and trt.incidents()[0]["error"].startswith("NonFiniteOutputError")


def test_latency_spike_records_an_incident_without_quarantine():
    jrt, trt, _, _ = _runtimes()
    for rt, mod in ((jrt, jax_faults), (trt, faults)):
        plan = mod.FaultPlan(seed=0)
        plan.inject("dispatch.matmul", "latency", times=1, value=0.0)
        rt.set_fault_plan(plan)
    _matmul_both(jrt, trt, np.ones((4, 16), np.float32), np.ones((16, 8), np.float32))
    assert _incidents(trt) == _incidents(jrt) and trt.incidents()[0]["action"] == "latency_spike"
    assert not trt.quarantined()


def test_output_validation_catches_a_real_non_finite_output():
    jrt, trt, _, _ = _runtimes()
    a = np.ones((4, 16), np.float32)
    a[1, 3] = np.inf
    b = np.ones((16, 8), np.float32)
    b[3, :] = 0.0  # inf * 0 -> NaN in the product
    _matmul_both(jrt, trt, a, b)
    assert not trt.incidents() and not jrt.incidents()  # validation is opt-in
    jrt.set_output_validation(True)
    trt.set_output_validation(True)
    want, got = _matmul_both(jrt, trt, a, b)
    assert np.isnan(got).any() and np.array_equal(np.isnan(got), np.isnan(want))
    assert _incidents(trt) == _incidents(jrt) and trt.incidents()[0]["action"] == "quarantined"


def test_no_config_falls_back_labelled_as_the_reference():
    jrt, trt = JaxRuntime(), KernelRuntime()
    jrt.set_fault_plan(jax_faults.FaultPlan.parse("dispatch.matmul:compile_error"))
    trt.set_fault_plan(faults.FaultPlan.parse("dispatch.matmul:compile_error"))
    _matmul_both(jrt, trt, np.ones((4, 16), np.float32), np.ones((16, 8), np.float32))
    assert _incidents(trt) == _incidents(jrt) and trt.incidents()[0]["action"] == "fallback_ref"


@pytest.mark.parametrize("text", ["dispatch.wkv:compile_error", "dispatch.ssm_scan:oom"])
def test_sequence_families_contained_as_the_reference(text):
    """wkv and ssm_scan under a FixedPolicy config: a fault quarantines it and the
    plain version answers, as the reference answers from its oracle."""
    from repro.kernels.ssm import SsmConfig as JaxSsmConfig
    from repro.kernels.wkv import WkvConfig as JaxWkvConfig

    jrt, trt = JaxRuntime(), KernelRuntime()
    jrt.install(JaxFixedPolicy(wkv_config=JaxWkvConfig(64), ssm_config=JaxSsmConfig(8, 16)))
    trt.install(FixedPolicy(wkv_config=wk.WkvConfig(64), ssm_config=ss.SsmConfig(8, 16)))
    jrt.set_fault_plan(jax_faults.FaultPlan.parse(text))
    trt.set_fault_plan(faults.FaultPlan.parse(text))
    rng = np.random.default_rng(1)
    r, k, v = (rng.normal(size=(1, 12, 2, 4)).astype(np.float32) for _ in range(3))
    logw = -np.abs(rng.normal(size=(1, 12, 2, 4))).astype(np.float32)
    u = rng.normal(size=(2, 4)).astype(np.float32)
    dtx = rng.normal(size=(1, 12, 6)).astype(np.float32)
    dta = -np.abs(rng.normal(size=(1, 12, 6, 3))).astype(np.float32)
    bb, cc = (rng.normal(size=(1, 12, 3)).astype(np.float32) for _ in range(2))
    with jrt.activate():
        jo = jax_ops.wkv(*(jnp.asarray(x) for x in (r, k, v, logw, u)))[0]
        jy = jax_ops.ssm_scan(*(jnp.asarray(x) for x in (dtx, dta, bb, cc)))[0]
    with trt.activate():
        to = ops.wkv(*(torch.from_numpy(x) for x in (r, k, v, logw, u)))[0]
        ty = ops.ssm_scan(*(torch.from_numpy(x) for x in (dtx, dta, bb, cc)))[0]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    assert _incidents(trt) == _incidents(jrt) and len(trt.incidents()) == 1
    assert _breaker(trt) == _breaker(jrt)


@pytest.mark.parametrize("window, threshold, series", [
    (8, 2.0, [1.0] * 6 + [5.0, 1.0, 1.1, 9.0, 1.0]),
    (4, 1.5, [0.2, 0.3, 0.25, 0.9, 0.3, 0.31, 1.2, 0.28, 0.27]),
])
def test_straggler_detector_verdicts_equal(window, threshold, series):
    dets = [mod.StragglerDetector(window=window, threshold=threshold, warmup=3) for mod in (jax_faults, faults)]
    verdicts = [[d.observe(t) for t in series] for d in dets]
    assert verdicts[0] == verdicts[1] and any(verdicts[1])
    assert dets[0].flagged == dets[1].flagged and dets[0].median() == dets[1].median()


def test_preemption_guard_equal():
    import signal

    for mod in (jax_faults, faults):
        with mod.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            assert not guard.preempted
            signal.raise_signal(signal.SIGUSR1)
            assert guard.preempted
        guard2 = mod.PreemptionGuard()
        guard2.request()
        assert guard2.preempted


# ---------------------------------------------------------------------------
# CUDA-flagged calls: redirected to a compiled config, never the plain version
# ---------------------------------------------------------------------------
class _Card:
    """Stub CUDA launchers: every ``ops`` kernel call on a "CUDA" tensor goes to
    ``launch(family, config)``, computing the plain answer itself; the plain
    versions raise if called."""

    def __init__(self, monkeypatch, fail=(), sticky=()):
        self.calls: list[tuple[str, str]] = []
        self.fail = set(fail)  # config names whose launch raises KernelLaunchError
        self.sticky = set(sticky)  # config names whose launch reports an illegal address (700)
        monkeypatch.setattr(ops, "_on_card", lambda t: True)

        def refuse(*a, **k):
            raise AssertionError("a plain version was called for a CUDA-flagged call")

        for name in ("matmul_plain", "attention_plain", "wkv_plain", "ssm_plain", "ssm_fused_plain"):
            monkeypatch.setattr(ops, name, refuse)
        monkeypatch.setattr(ops, "matmul_cuda", lambda a, b, cfg, out_dtype=None: self._run(
            "matmul", cfg, lambda: mm.matmul_plain(a, b, out_dtype)))
        monkeypatch.setattr(ops, "attention_cuda", lambda q, k, v, cfg, causal=True, scale=None: self._run(
            "attention", cfg, lambda: at.attention_plain(q, k, v, causal=causal, scale=scale)))
        monkeypatch.setattr(ops, "wkv_cuda", lambda r, k, v, w, u, s, cfg: self._run(
            "wkv", cfg, lambda: wk.wkv_plain(r, k, v, w, u, s)))
        monkeypatch.setattr(ops, "ssm_cuda", lambda dtx, dta, b, c, s, cfg: self._run(
            "ssm_scan", cfg, lambda: ss.ssm_plain(dtx, dta, b, c, s)))
        monkeypatch.setattr(ops, "ssm_cuda_fused", lambda x, dt, a, b, c, s, cfg: self._run(
            "ssm_scan", cfg, lambda: ss.ssm_fused_plain(x, dt, a, b, c, s)))

    def _run(self, family, cfg, plain):
        self.calls.append((family, cfg.name()))
        if cfg.name() in self.fail:
            raise _build.KernelLaunchError(f"stub launch of {cfg.name()} failed")
        if cfg.name() in self.sticky:
            raise _build.launch_error(700, f"stub launch of {cfg.name()} failed: cudaError 700")
        return plain()


def _call(family):
    """(ops call, the family's served config, its default) on small CPU tensors."""
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)
    if family == "matmul":
        a, b = rn(3, 16), rn(16, 8)
        return lambda: ops.matmul(a, b), MatmulConfig(64, 128, 64, "nmk"), mm.DEFAULT_CONFIG
    if family == "attention":
        q, k, v = rn(2, 8, 64), rn(2, 8, 64), rn(2, 8, 64)
        return lambda: ops.attention(q, k, v), at.config_space()[-1], at.DEFAULT_ATTN_CONFIG
    if family == "wkv":
        r, k, v, u = rn(1, 8, 2, 4), rn(1, 8, 2, 4), rn(1, 8, 2, 4), rn(2, 4)
        logw = -rn(1, 8, 2, 4).abs()
        return lambda: ops.wkv(r, k, v, logw, u), wk.WkvConfig(64), wk.DEFAULT_WKV_CONFIG
    x, dt, b, c = rn(1, 8, 6), rn(1, 8, 6).abs(), rn(1, 8, 3), rn(1, 8, 3)
    a = -rn(6, 3).abs()
    if family == "ssm_scan_fused":
        return lambda: ops.ssm_scan_fused(x, dt, a, b, c), ss.SsmConfig(8, 16), ss.DEFAULT_SSM_CONFIG
    dta = dt[..., None] * a
    return lambda: ops.ssm_scan(dt * x, dta, b, c), ss.SsmConfig(8, 16), ss.DEFAULT_SSM_CONFIG


FAMILIES = ["matmul", "attention", "wkv", "ssm_scan", "ssm_scan_fused"]
_FAMILY_OF = {"ssm_scan_fused": "ssm_scan"}
_POLICY_FIELD = {"matmul": "matmul_config", "attention": "attention_config", "wkv": "wkv_config",
                 "ssm_scan": "ssm_config"}


def _card_runtime(family, served, text=None):
    rt = KernelRuntime()
    fam = _FAMILY_OF.get(family, family)
    rt.install(FixedPolicy(**{_POLICY_FIELD[fam]: served}))
    if text is not None:
        rt.set_fault_plan(faults.FaultPlan.parse(text.format(fam=fam)))
    return rt, fam


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["compile_error", "oom", "nan"])
def test_cuda_call_redirects_to_the_default_config(monkeypatch, family, kind):
    card = _Card(monkeypatch)
    call, served, default = _call(family)
    assert served != default
    rt, fam = _card_runtime(family, served, "dispatch.{fam}:" + kind)
    with rt.activate():
        out = call()
    # A raising fault fires before the launch; a NaN corrupts the served config's output.
    launched = [(fam, served.name())] if kind == "nan" else []
    assert card.calls == launched + [(fam, default.name())]
    assert all(bool(torch.isfinite(t).all()) for t in (out if isinstance(out, tuple) else (out,)))
    inc = rt.incidents()
    assert [(i["action"], i["config"]) for i in inc] == [("quarantined", served.name())]
    assert [(e["family"], e["name"]) for e in rt.quarantined()] == [(fam, served.name())]
    # The breaker redirects the next selections to the default config too.
    with rt.activate():
        call()
    assert card.calls[-1] == (fam, default.name())


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_launch_failure_redirects(monkeypatch, family):
    call, served, default = _call(family)
    card = _Card(monkeypatch, fail={served.name()})
    rt, fam = _card_runtime(family, served)
    with rt.activate():
        call()
    assert card.calls == [(fam, served.name()), (fam, default.name())]
    assert rt.incidents()[0]["error"].startswith("KernelLaunchError")


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_call_with_nothing_compiled_left_raises_unrecoverable(monkeypatch, family):
    call, served, default = _call(family)
    card = _Card(monkeypatch)
    rt, fam = _card_runtime(family, default, "dispatch.{fam}:compile_error")  # the default itself fails
    with rt.activate(), pytest.raises(faults.InjectedCompileError):
        call()
    assert [i["action"] for i in rt.incidents()] == ["unrecoverable"] and not rt.quarantined()
    assert card.calls == []
    # No policy: the call has no config; the default config ran and failed.
    card2 = _Card(monkeypatch, fail={default.name()})
    rt2 = KernelRuntime()
    with rt2.activate(), pytest.raises(_build.KernelLaunchError):
        call()
    assert [(i["action"], i["config"]) for i in rt2.incidents()] == [("unrecoverable", None)]
    assert card2.calls == [(fam, default.name())]


def test_cuda_redirect_that_fails_too_is_unrecoverable(monkeypatch):
    call, served, default = _call("matmul")
    card = _Card(monkeypatch, fail={served.name(), default.name()})
    rt, _ = _card_runtime("matmul", served)
    with rt.activate(), pytest.raises(_build.KernelLaunchError):
        call()
    assert [(i["action"], i["config"]) for i in rt.incidents()] == [
        ("quarantined", served.name()), ("unrecoverable", default.name())]
    assert card.calls == [("matmul", served.name()), ("matmul", default.name())]


def test_cuda_reprobe_absolves(monkeypatch):
    call, served, default = _call("matmul")
    card = _Card(monkeypatch)
    rt, _ = _card_runtime("matmul", served, "dispatch.matmul:compile_error")
    with rt.activate():
        for _ in range(runtime.QUARANTINE_BACKOFF + 1):
            call()
    assert [i["action"] for i in rt.incidents()] == ["quarantined", "absolved"] and not rt.quarantined()
    served_calls = [name for _, name in card.calls]
    assert served_calls == [default.name()] * runtime.QUARANTINE_BACKOFF + [served.name()]


@pytest.mark.parametrize("code", sorted(_build.LAUNCH_LOCAL_ERRORS))
def test_launch_local_error_codes_are_contained(code):
    err = _build.launch_error(code, f"cudaError {code}")
    assert type(err) is _build.KernelLaunchError and isinstance(err, faults.GUARDED_EXCEPTIONS)
    assert str(err) == f"cudaError {code}"


@pytest.mark.parametrize("code", [700, 710, 715, 716, 719, 999])
def test_sticky_error_codes_are_not_contained(code):
    """An illegal address, an assert, an illegal instruction, a misaligned address, a
    launch failure, an unknown error: reported by the next launch's
    ``cudaGetLastError``, they poison the context and name no config."""
    err = _build.launch_error(code, f"cudaError {code}")
    assert isinstance(err, torch.AcceleratorError) and not isinstance(err, faults.GUARDED_EXCEPTIONS)
    assert str(err).startswith(f"cudaError {code}")


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_sticky_error_is_neither_quarantined_nor_redirected(monkeypatch, family):
    call, served, default = _call(family)
    card = _Card(monkeypatch, sticky={served.name()})
    rt, fam = _card_runtime(family, served)
    with rt.activate(), pytest.raises(torch.AcceleratorError):
        call()
    assert card.calls == [(fam, served.name())]  # the default never ran in the poisoned context
    assert rt.incidents() == [] and not rt.quarantined()


@pytest.mark.cuda
def test_guard_on_card():
    """On the card: a dispatch fault redirects a bf16 GEMM to DEFAULT_CONFIG, bitwise
    equal to a direct launch of it; a NaN is never written during a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((4, 4096), device="cuda", generator=g, dtype=torch.bfloat16)
    b = torch.randn((4096, 1024), device="cuda", generator=g, dtype=torch.bfloat16)
    served = MatmulConfig(64, 128, 64, "nmk")
    rt = KernelRuntime()
    rt.install(FixedPolicy(matmul_config=served))
    rt.set_fault_plan(faults.FaultPlan.parse("dispatch.matmul:compile_error"))
    with rt.activate():
        got = ops.matmul(a, b)
    assert torch.equal(got, mm.matmul_cuda(a, b, mm.DEFAULT_CONFIG))
    spec = faults.FaultSpec("dispatch.matmul", "nan")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    out = torch.empty_like(got)
    with torch.cuda.graph(graph, stream=stream):
        assert faults.FaultPlan.corrupt_array(spec, out) is out
        ops._raise_non_finite("matmul", out)  # no sync under capture
