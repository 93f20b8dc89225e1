"""The port's serving engine under faults and retunes against the JAX engine.

Both engines serve one reduced model (granite-8b, rwkv6-7b and a 4-layer
Hymba, f32 on the CPU, the same weights) from one deployment: a reference
tune shared through the v6 bundle JSON both packages load, installed for
``tpu_v5e``.  Under one ``FaultPlan`` (the same text and seed) they must give
identical greedy streams, ``Request.retries``, incident lists (site, family,
config, outcome), health transitions, selection logs and ``EngineStatus``,
and drop no request; under a drifting request mix the same ``RetuneEvent``s
and retuned deployments; and the same auto-rollback and
``adopt_deployment`` results.  On the CPU both packages answer a guarded
failure from the plain or reference path, so even the outcome labels match.
The port's retune gets the reference's table through
``retune_dataset_builder`` (its default is the H100 model, which serves no
TPU deployment).  Every engine test runs with ``cuda_graphs=False`` and with
its default, which on the CPU runs the same pinned programs eagerly: a build
selects once, as a trace does, so the selection logs agree.
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import reduced_pair
from repro.core.bundle import DeploymentBundle as JaxBundle
from repro.core.dataset import build_model_dataset as jax_model_dataset
from repro.core.dataset import synthetic_problems as jax_synthetic
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.core.tuner import tune as jax_tune
from repro.kernels import ops as jax_ops
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.core import dataset
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm as ss
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.matmul import MatmulConfig
from repro_torch.serve.engine import ServingEngine

KW = dict(max_batch=2, cache_len=128)
MODES = [False, None]  # cuda_graphs: the eager engine, and the default (eager on the CPU)
ARCHS = [("granite-8b", None), ("rwkv6-7b", None), ("hymba-1.5b", 4)]
CHAOS = "engine.prefill:compile_error,engine.decode:compile_error:1:5,dispatch.matmul:compile_error"
EXTRA = {"granite-8b": "", "rwkv6-7b": ",dispatch.wkv:compile_error:1:1", "hymba-1.5b": ",dispatch.ssm_scan:oom"}
# A quarantined selection is redirected to each package's own family default:
# records name it "<default>".
_DEFAULTS = {c.name() for c in (jax_ops.DEFAULT_CONFIG, jax_ops.DEFAULT_WKV_CONFIG, jax_ops.DEFAULT_SSM_CONFIG,
                                mm.DEFAULT_CONFIG, wk.DEFAULT_WKV_CONFIG, ss.DEFAULT_SSM_CONFIG)}


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Two reference tunes (6 and 4 matmul kernels), each saved as a v6 bundle."""
    root = tmp_path_factory.mktemp("resilience")
    ds = jax_model_dataset(jax_synthetic(80), device_name="tpu_v5e")
    paths = []
    for n in (6, 4):
        path = root / f"bundle{n}.json"
        JaxBundle({"tpu_v5e": jax_tune(ds, n_kernels=n).deployment}).save(path)
        paths.append(path)
    return paths


def _port_table(problems, device):
    """The reference's TPU-model table at ``problems`` (what its engine retunes on)."""
    ds = jax_model_dataset(problems, device_name="tpu_v5e")
    return dataset.TuningDataset(device=ds.device, problems=list(ds.problems),
                                 configs=[MatmulConfig(**c.to_dict()) for c in ds.configs], perf=np.asarray(ds.perf))


def _engines(arch, n_layers, bundle, cuda_graphs, plan=None, seed=0, **kw):
    jm, jp, tm, tp = reduced_pair(arch, n_layers)
    jrt, trt = JaxRuntime(name="resilience"), KernelRuntime(name="resilience")
    if plan is not None:
        jrt.set_fault_plan(JaxFaultPlan.parse(plan, seed=seed))
        trt.set_fault_plan(FaultPlan.parse(plan, seed=seed))
    for rt in (jrt, trt):
        rt.set_selection_logging(True, cap=1 << 16)
    jeng = JaxEngine(jm, jp, runtime=jrt, bundle=bundle, device="tpu_v5e", **KW, **kw)
    teng = ServingEngine(tm, tp, runtime=trt, bundle=bundle, device="tpu_v5e", cuda_graphs=cuda_graphs,
                         retune_dataset_builder=_port_table, **KW, **kw)
    return jeng, teng


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def _serve(jeng, teng, prompts, new_tokens):
    jt = [jeng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    return jt, tt, jeng.drain(), teng.drain()


def _neutral(v):
    if isinstance(v, str):
        for name in _DEFAULTS:
            v = v.replace(name, "<default>")
    return v


def _incidents(rt):
    return [{k: _neutral(r[k]) for k in ("seq", "site", "family", "config", "device", "error", "action")}
            for r in rt.incidents()]


def _log(rt):
    return [(op, tuple(int(v) for v in p), _neutral(cfg.name() if cfg is not None else None))
            for op, p, cfg in rt.selection_log()]


def _status(s):
    return (s.completed, s.in_flight, s.queued, s.steps, s.exhausted, s.health)


def _same(jeng, teng, jt, tt, js, ts):
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert [t.request.retries for t in tt] == [t.request.retries for t in jt]
    assert _status(ts) == _status(js)
    assert ts.completed == len(tt) and not ts.exhausted  # zero drops
    assert all(t.done for t in tt)
    assert _incidents(teng.runtime) == _incidents(jeng.runtime)
    assert teng.health_events == jeng.health_events
    assert _log(teng.runtime) == _log(jeng.runtime)
    assert teng.runtime.policy_epoch() == jeng.runtime.policy_epoch()
    assert [dataclasses.astuple(e) for e in teng.retune_events] == [dataclasses.astuple(e)
                                                                     for e in jeng.retune_events]


@pytest.mark.parametrize("cuda_graphs", MODES)
@pytest.mark.parametrize("arch, n_layers", ARCHS)
def test_chaos_drain_equal(bundles, arch, n_layers, cuda_graphs):
    jeng, teng = _engines(arch, n_layers, bundles[0], cuda_graphs, CHAOS + EXTRA[arch])
    prompts = _prompts(teng.model.cfg.vocab, (5, 40, 17, 50), 31)
    jt, tt, js, ts = _serve(jeng, teng, prompts, 6)
    _same(jeng, teng, jt, tt, js, ts)
    actions = [r["action"] for r in teng.runtime.incidents()]
    assert actions.count("retry") == 2 and "quarantined" in actions
    assert sum(t.request.retries for t in tt) == 1  # the prefill retry; decode retries have no request
    assert teng.health_events[0][1] == "degraded" and ts.health == teng.health_events[-1][1]
    # One consultation per program build: the log holds one entry per call of each build.
    built = len(teng.program_log)
    # The prefill fault fires before its program is built; the decode retry drops a built
    # program and builds it again.
    assert built == len(jeng._prefill_cache) + len(jeng._decode_cache) + 1
    assert all(p.pins.sealed for c in (teng._prefill_cache, teng._decode_cache) for p in c.values())


@pytest.mark.parametrize("cuda_graphs", MODES)
def test_retries_keep_streams_of_the_clean_drain(bundles, cuda_graphs):
    """Under chaos the streams equal a clean drain's (the guard's redirect is
    the plain version on the CPU, the same numbers)."""
    clean_j, clean_t = _engines("granite-8b", None, bundles[0], cuda_graphs)
    chaos_j, chaos_t = _engines("granite-8b", None, bundles[0], cuda_graphs, CHAOS)
    prompts = _prompts(clean_t.model.cfg.vocab, (9, 33, 12), 32)
    _, clean, *_ = _serve(clean_j, clean_t, prompts, 5)
    _, chaos, *_ = _serve(chaos_j, chaos_t, prompts, 5)
    assert [t.request.output for t in chaos] == [t.request.output for t in clean]
    assert not clean_t.runtime.incidents() and clean_t.health_events == []


def _drifting(vocab):
    """A request mix whose prefill buckets the deployment's harvest lacks."""
    return _prompts(vocab, (4, 60, 7, 45, 11, 63), 33)


@pytest.mark.parametrize("cuda_graphs", MODES)
@pytest.mark.parametrize("arch, n_layers", ARCHS)
def test_drift_retune_equal(bundles, arch, n_layers, cuda_graphs):
    """Drift checks every 2 steps; matmul drifts past its event floor (the
    recurrence families' few events stay under it): the same RetuneEvents, the
    same retuned deployment, programs rebuilt, no request dropped."""
    floor = {"hymba-1.5b": 24}.get(arch, 8)  # Hymba's unscanned layers log 4 scans a prefill build
    jeng, teng = _engines(arch, n_layers, bundles[0], cuda_graphs, retune_interval=2, retune_min_events=floor)
    epoch0 = teng.runtime.policy_epoch()
    jt, tt, js, ts = _serve(jeng, teng, _drifting(teng.model.cfg.vocab), 5)
    _same(jeng, teng, jt, tt, js, ts)
    swaps = [e for e in teng.retune_events if e.swapped]
    assert swaps and swaps[0].families == ("matmul",) and teng.runtime.policy_epoch() > epoch0
    assert [c.name() for c in teng.deployment.configs] == [c.name() for c in jeng.deployment.configs]
    assert teng.deployment.meta["retune_log"] == jeng.deployment.meta["retune_log"]
    assert teng.retune_seconds and all(set(t) == {"measure_s", "fit_s", "canary_s"}
                                       for r in teng.retune_seconds for t in r["families"].values())
    # The swap dropped every program: each later one was built under the new policy.
    assert {r.epoch for r in teng.program_log[-len(teng.programs()):]} <= set(range(epoch0, 10 ** 6))
    assert teng._programs_policy[0] is teng.runtime.policy() is teng.deployment


@pytest.mark.parametrize("cuda_graphs", MODES)
def test_regressing_swap_rolls_back_equal(bundles, cuda_graphs):
    jeng, teng = _engines("granite-8b", None, bundles[0], cuda_graphs, rollback_threshold=2)
    prompts = _prompts(teng.model.cfg.vocab, (6, 21), 34)
    _serve(jeng, teng, prompts, 3)
    incumbent = teng.deployment
    jev, tev = jeng.maybe_retune(force=True), teng.maybe_retune(force=True)
    assert dataclasses.astuple(tev) == dataclasses.astuple(jev) and tev.swapped
    for rt, mod in ((jeng.runtime, JaxFaultPlan), (teng.runtime, FaultPlan)):
        rt.set_fault_plan(mod.parse("engine.decode:oom:2"))
    jt, tt, js, ts = _serve(jeng, teng, prompts, 6)
    _same(jeng, teng, jt, tt, js, ts)
    rb = [e for e in teng.retune_events if e.rolled_back]
    assert len(rb) == 1 and teng.deployment is incumbent and teng.runtime.policy() is incumbent
    assert teng.maybe_rollback() is None and jeng.maybe_rollback() is None  # one rollback per swap
    assert "degraded" in [s for _, s in teng.health_events] and ts.health == "healthy"
    assert [(d, p.meta.get("retune_count")) for d, p, _ in teng.runtime.swap_history()] == [
        (d, p.meta.get("retune_count")) for d, p, _ in jeng.runtime.swap_history()]


@pytest.mark.parametrize("cuda_graphs", MODES)
@pytest.mark.parametrize("plan, swapped", [(None, True), ("canary.matmul:compile_error", False)])
def test_offer_adopts_at_a_step_boundary_equal(bundles, cuda_graphs, plan, swapped):
    jeng, teng = _engines("rwkv6-7b", None, bundles[0], cuda_graphs, plan)
    prompts = _prompts(teng.model.cfg.vocab, (8, 30, 14), 35)
    jt = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=5) for p in prompts]
    for eng in (jeng, teng):
        eng.step()
        eng.step()
    jeng.offer_deployment(JaxBundle.load(bundles[1]).deployments["tpu_v5e"])
    offered = DeploymentBundle.load(bundles[1]).deployments["tpu_v5e"]
    teng.offer_deployment(offered)
    epoch0 = teng.runtime.policy_epoch()
    js, ts = jeng.drain(), teng.drain()
    _same(jeng, teng, jt, tt, js, ts)
    ev = teng.retune_events[0]
    assert ev.source == "control-plane" and ev.swapped is swapped and ev.step == 2
    assert (teng.deployment is offered) is swapped
    assert (teng.runtime.policy() is offered) is swapped
    if swapped:  # every live program was captured again under the adopted policy
        assert min(v["epoch"] for v in teng.programs().values()) > epoch0
    else:
        assert ev.rejected == ("matmul",) and ev.families == ()


@pytest.mark.parametrize("cuda_graphs", MODES)
def test_kernel_failure_in_a_replay_is_retried(bundles, cuda_graphs, monkeypatch):
    """A kernel launch failing in a program's replay (an eager run here, a capture
    on the card) is not in the fault plan: the guard quarantines the pinned config
    and the failure propagates to the engine, whose one retry builds the program
    again (its warm-up now redirected by the breaker); nothing is dropped."""
    from repro_torch.kernels import _build, ops

    _, clean = _engines("granite-8b", None, bundles[0], cuda_graphs)
    prompts = _prompts(clean.model.cfg.vocab, (9, 33), 36)
    want = [clean.submit(p, max_new_tokens=4) for p in prompts]
    clean.drain()

    _, teng = _engines("granite-8b", None, bundles[0], cuda_graphs)
    plain, calls = ops.matmul_plain, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 20:  # inside the first prefill program's first replay (its warm-up made 15)
            raise _build.KernelLaunchError("stub launch failure")
        return plain(*args)

    monkeypatch.setattr(ops, "matmul_plain", flaky)
    got = [teng.submit(p, max_new_tokens=4) for p in prompts]
    status = teng.drain()
    assert status.completed == 2 and [t.request.output for t in got] == [t.request.output for t in want]
    actions = [(r["site"], r["action"]) for r in teng.runtime.incidents()]
    assert actions[:2] == [("dispatch.matmul", "quarantined"), ("engine.prefill", "retry")]
    assert actions[2:] == [("dispatch.matmul", "absolved")]  # later builds re-probe the config
    assert got[0].request.retries == 1 and [r.kind for r in teng.program_log][:2] == ["prefill", "prefill"]


@pytest.mark.parametrize("cuda_graphs", MODES)
def test_sticky_error_in_a_replay_is_not_retried(bundles, cuda_graphs, monkeypatch):
    """A launch reporting a sticky CUDA error (an illegal address) poisons the
    context: the guard neither quarantines nor redirects, the engine does not
    retry, and the error reaches the caller."""
    import torch

    from repro_torch.kernels import _build, ops

    _, teng = _engines("granite-8b", None, bundles[0], cuda_graphs)
    plain, calls = ops.matmul_plain, []

    def poisoned(*args):
        calls.append(1)
        if len(calls) == 20:  # inside the first prefill program's first replay
            raise _build.launch_error(700, "stub launch: cudaError 700 (an illegal memory access)")
        return plain(*args)

    monkeypatch.setattr(ops, "matmul_plain", poisoned)
    got = [teng.submit(p, max_new_tokens=4) for p in _prompts(teng.model.cfg.vocab, (9, 33), 36)]
    with pytest.raises(torch.AcceleratorError):
        teng.drain()
    assert len(calls) == 20 and teng.runtime.incidents() == [] and not teng.runtime.quarantined()
    assert got[0].request.retries == 0 and [r.kind for r in teng.program_log] == ["prefill"]


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: ``capture_end`` raises as CUDA's
    does for a capture a failed launch invalidated."""

    def __init__(self, invalidated: bool):
        self.invalidated, self.log = invalidated, []

    def capture_begin(self):
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")
        if self.invalidated:
            raise RuntimeError("CUDA error: operation failed due to a previous error during capture")


@pytest.mark.parametrize("invalidated", [False, True])
def test_capture_failure_ends_the_capture_and_propagates_as_itself(invalidated):
    """A guarded failure inside a capture reaches the engine's retry as itself,
    not as the error that ending the invalidated capture raises."""
    from repro_torch.kernels import _build
    from repro_torch.serve import engine as engine_mod

    graph = _Graph(invalidated)

    def body():
        raise _build.KernelLaunchError("launch failed during the capture")

    with pytest.raises(_build.KernelLaunchError, match="during the capture"):
        engine_mod._capture(graph, body)
    assert graph.log == ["begin", "end"]
    ok = _Graph(False)
    assert engine_mod._capture(ok, lambda: {"next": 1}) == {"next": 1} and ok.log == ["begin", "end"]


def test_serve_cli_chaos_and_retune_flags(capsys):
    """The serve CLI's five new flags: a chaos plan contained (report after the
    run), drift checks every 2 steps; every request completes."""
    from repro_torch.launch import serve as serve_cli

    outs = serve_cli.main(["--arch", "granite-8b", "--device", "cpu", "--requests", "3", "--max-new-tokens", "4",
                           "--chaos", "dispatch.matmul:compile_error,engine.prefill:compile_error",
                           "--chaos-seed", "3", "--retune-interval", "2", "--drift-threshold", "0.2",
                           "--retune-min-events", "8"])
    text = capsys.readouterr().out
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    assert "chaos: 2 faults fired, 3 incidents contained" in text and "1 request retries" in text
    assert "engine health 'healthy'" in text and "-> retry:" in text and "-> quarantined:" in text
