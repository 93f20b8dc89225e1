"""SLO mode and objective-aware selection in the port against the JAX package.

* ``Objective`` / ``set_objective``: the same epoch moves, clears and no-ops
  as the reference's runtime.
* ``Deployment.select_for_objective`` on one shared table: a test family
  registered in both packages whose ``model_matrix`` reads one table; both
  deployments deploy the same columns and must pick the same one per problem
  (and fall back where the reference does), directly and through each
  runtime's selectors under an installed objective.
* ``OnlinePolicy.select_for_objective``: the best measured arm, on the same
  timings in both packages.
* The engine's SLO mode on an injected fake clock (each step costs 4 ms
  outside SLO mode and 1 ms inside it, read from the engine's own mode): the
  echo toy and reduced granite-8b (chunked prefill, so the chunk cap moves)
  give equal ``slo_events``, admission caps, chunk caps, objectives, streams
  and ``EngineStatus`` step by step; the port's programs are built again
  under each objective.
"""
import dataclasses
import importlib

import numpy as np
import pytest

from _torch_parity import reduced_pair
from _torch_toys import JaxToy, Toy, same_requests, status_equal
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.core.runtime import Objective as JaxObjective
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.core.dispatch import Deployment
from repro_torch.core.online import OnlinePolicy
from repro_torch.core.runtime import KernelRuntime, Objective
from repro_torch.kernels import matmul as mm
from repro_torch.kernels.ops import FixedPolicy
from repro_torch.serve.engine import ServingEngine

# The families module itself: the package exports the function of that name, as the reference does.
families = importlib.import_module("repro_torch.core.families")
jax_dataset, jax_families, jax_dispatch, jax_matmul, jax_online = (importlib.import_module(m) for m in (
    "repro.core.dataset", "repro.core.families", "repro.core.dispatch", "repro.kernels.matmul",
    "repro.core.online"))

FAMILY = "slo_shared"


@pytest.fixture(scope="module")
def shared():
    """A family in both packages whose model is one shared table over 20
    problems and 6 deployed columns; yields (problems, table, ref configs, port configs)."""
    problems = [tuple(p) for p in jax_dataset.synthetic_problems(20, seed=5)]
    table = np.random.default_rng(8).uniform(1.0, 100.0, (len(problems), 6))
    rows = {p: i for i, p in enumerate(problems)}
    ref_cfgs, port_cfgs = jax_matmul.config_space()[:6], mm.config_space()[:6]

    def lookup(cfg_space):
        def model(ps, cs, dev):
            return table[[rows[tuple(p)] for p in ps]][:, [cfg_space.index(c) for c in cs]]
        return model

    common = dict(name=FAMILY, feature_names=jax_dataset.FEATURE_NAMES, harvest=lambda a: problems,
                  default_n_kernels=4)
    jax_families.register_family(jax_families.KernelFamily(
        config_cls=jax_matmul.MatmulConfig, config_space=lambda: ref_cfgs, default_config=ref_cfgs[0],
        features=jax_dataset.problem_features, perf_matrix=lookup(ref_cfgs), model_matrix=lookup(ref_cfgs),
        policy_attr="select_matmul", problem_arity=4, reference="test", **common))
    families.register_family(families.KernelFamily(
        config_cls=mm.MatmulConfig, config_space=lambda: port_cfgs, default_config=port_cfgs[0],
        features=importlib.import_module("repro_torch.core.dataset").problem_features,
        perf_matrix=lookup(port_cfgs), model_matrix=lookup(port_cfgs), **common))
    yield problems, table, ref_cfgs, port_cfgs
    jax_families.unregister_family(FAMILY)
    families.unregister_family(FAMILY)


def _deployments(ref_cfgs, port_cfgs, cols):
    jdep = jax_dispatch.Deployment(device="host_cpu", configs=[], classifier=None)
    tdep = Deployment(device="host_cpu", configs=[], classifier=None)
    jdep.set_family_tuning(FAMILY, [ref_cfgs[i] for i in cols], None)
    tdep.set_family_tuning(FAMILY, [port_cfgs[i] for i in cols], None)
    return jdep, tdep


def test_objective_moves_the_epoch_as_reference():
    jrt, trt = JaxRuntime(), KernelRuntime()
    for obj in (Objective(latency_target_ms=5.0), Objective(latency_target_ms=5.0), Objective(), None,
                Objective(latency_target_ms=2.0, prefill_chunk_tokens=32), None):
        jobj = None if obj is None else JaxObjective(obj.latency_target_ms, obj.prefill_chunk_tokens)
        jrt.set_objective(jobj)
        trt.set_objective(obj)
        assert trt.policy_epoch() == jrt.policy_epoch()
        assert dataclasses.astuple(trt.objective()) == dataclasses.astuple(jrt.objective()) if obj else (
            trt.objective() is None and jrt.objective() is None)
    assert not Objective() and Objective(prefill_chunk_tokens=8)


def test_select_for_objective_on_a_shared_table(shared):
    problems, table, ref_cfgs, port_cfgs = shared
    cols = [0, 2, 3, 5]
    jdep, tdep = _deployments(ref_cfgs, port_cfgs, cols)
    target, plain = Objective(latency_target_ms=3.0), Objective(prefill_chunk_tokens=16)
    for p in problems:
        got = tdep.select_for_objective(FAMILY, p, target)
        want = jdep.select_for_objective(FAMILY, p, JaxObjective(latency_target_ms=3.0))
        assert port_cfgs.index(got) == ref_cfgs.index(want) == cols[int(np.argmax(table[problems.index(p), cols]))]
        # No target: the plain path (no tree -> the first deployed config), as the reference.
        assert tdep.select_for_objective(FAMILY, p, plain) == port_cfgs[cols[0]]
    one = _deployments(ref_cfgs, port_cfgs, [4])[1]
    assert one.select_for_objective(FAMILY, problems[0], target) == port_cfgs[4]
    # A family whose model fails falls back to the plain selection.
    assert tdep.select_for_objective("matmul", problems[0], target) == tdep.select("matmul", problems[0])


def test_runtime_routes_selection_through_the_objective(shared):
    problems, table, ref_cfgs, port_cfgs = shared
    cols = [1, 2, 4]
    jdep, tdep = _deployments(ref_cfgs, port_cfgs, cols)
    jrt, trt = JaxRuntime(), KernelRuntime()
    jrt.install(jdep)
    trt.install(tdep)
    jrt.set_objective(JaxObjective(latency_target_ms=4.0))
    trt.set_objective(Objective(latency_target_ms=4.0))
    for p in problems[:8]:
        got, want = trt.select_config(FAMILY, p), jrt.select_config(FAMILY, p)
        assert port_cfgs.index(got) == ref_cfgs.index(want) == cols[int(np.argmax(table[problems.index(p), cols]))]
    # Matmul under an objective asks the policy's select_for_objective.
    asked = []

    class Spy(FixedPolicy):
        def select_for_objective(self, family, problem, objective):
            asked.append((family, problem, objective.latency_target_ms))
            return mm.config_space()[1]

    rt = KernelRuntime()
    rt.install(Spy())
    assert rt.select_matmul_config(8, 64, 64, 1) == mm.DEFAULT_CONFIG
    rt.set_objective(Objective(latency_target_ms=1.5))
    assert rt.select_matmul_config(8, 64, 64, 1) == mm.config_space()[1]
    assert rt.select_wkv_config(32, 64) == mm.config_space()[1]
    assert asked == [("matmul", (8, 64, 64, 1), 1.5), ("wkv", (32, 64), 1.5)]


def test_online_policy_pauses_exploration_under_an_objective():
    problems = [(32, 256, 256, 1), (1, 512, 512, 4)]
    times = np.random.default_rng(2).uniform(1e-4, 1e-3, (len(problems), 4))
    ref_c, port_c = jax_matmul.config_space()[:4], mm.config_space()[:4]
    jpol = jax_online.OnlinePolicy(lambda p, c: times[problems.index(p), ref_c.index(c)], ref_c)
    tpol = OnlinePolicy(lambda p, c: times[problems.index(p), port_c.index(c)], port_c)
    for _ in range(2):  # two of four arms measured for the first problem
        assert port_c.index(tpol.select_matmul(*problems[0])) == ref_c.index(jpol.select_matmul(*problems[0]))
    obj, jobj = Objective(latency_target_ms=1.0), JaxObjective(latency_target_ms=1.0)
    for p in problems:  # measured bucket: its best measured arm; unseen bucket: candidates[0]
        got, want = tpol.select_for_objective("matmul", p, obj), jpol.select_for_objective("matmul", p, jobj)
        assert port_c.index(got) == ref_c.index(want)
    assert tpol.stats["slo_commit"] == jpol.stats["slo_commit"] == 1
    assert port_c.index(tpol.select_for_objective("matmul", problems[0], obj)) == int(np.argmin(times[0, :2]))
    assert tpol.stats["explore"] == 2  # no arm measured under the objective


class FakeClock:
    """Seconds that advance 4 ms a call outside SLO mode and 1 ms inside it
    (read from the engine's own mode): a step reads it twice, so it lasts one
    increment."""

    def __init__(self):
        self.t, self.engine = 0.0, None

    def __call__(self):
        self.t += (0.001 if self.engine._slo_mode else 0.004)
        return self.t


def _slo_pair(jmodel, jparams, tmodel, tparams, **kw):
    jc, tc = FakeClock(), FakeClock()
    jeng = JaxEngine(jmodel, jparams, runtime=JaxRuntime(), clock=jc, **kw)
    teng = ServingEngine(tmodel, tparams, runtime=KernelRuntime(), clock=tc, **kw)
    jc.engine, tc.engine = jeng, teng
    return jeng, teng


def _lockstep(jeng, teng, max_steps=200):
    caps = []
    for _ in range(max_steps):
        a, b = jeng.step(), teng.step()
        assert a == b
        assert teng.slo_events == jeng.slo_events
        assert (teng._slo_mode, teng._slo_cap, teng._slo_ok) == (jeng._slo_mode, jeng._slo_cap, jeng._slo_ok)
        assert teng._chunk_cap() == jeng._chunk_cap()
        tobj, jobj = teng.runtime.objective(), jeng.runtime.objective()
        assert (tobj is None) == (jobj is None)
        if tobj is not None:
            assert dataclasses.astuple(tobj) == dataclasses.astuple(jobj)
        assert list(teng._step_ms) == pytest.approx(list(jeng._step_ms))
        status_equal(teng.status(), jeng.status())
        caps.append((teng._slo_cap, teng._chunk_cap()))
        if not b:
            break
    return caps


def test_slo_mode_on_a_fake_clock_toy():
    kw = dict(max_batch=4, cache_len=64, block_size=8, prefill_buckets=(8, 16), prefill_chunk_tokens=16,
              slo_patience=2)
    jeng, teng = _slo_pair(JaxToy(), {}, Toy(), {}, **kw)
    reqs = []
    for i in range(6):
        target = 3.0 if i in (1, 4) else None
        reqs.append((jeng.submit(list(range(1 + i, 12 + i)), max_new_tokens=10, latency_target_ms=target).request,
                     teng.submit(list(range(1 + i, 12 + i)), max_new_tokens=10, latency_target_ms=target).request))
    caps = _lockstep(jeng, teng)
    kinds = [kind for _, kind, _ in teng.slo_events]
    assert kinds.count("enter") >= 2 and kinds.count("exit") >= 1  # entered, calmed, re-entered
    assert {c for c, _ in caps if c is not None} and {cc for _, cc in caps} == {8, 16}
    same_requests(reqs)
    assert all(tr.token_ms == pytest.approx(jr.token_ms) for jr, tr in reqs)
    status_equal(teng.drain(), jeng.drain())


def test_slo_mode_on_a_fake_clock_granite():
    """Reduced granite-8b, chunked prefill at 64 under SLO caps of 32: the
    same transitions, caps and streams; each transition drops the programs,
    and those built after it carry the objective's epoch."""
    jm, jp, tm, tp = reduced_pair("granite-8b")
    kw = dict(max_batch=2, cache_len=128, block_size=16, prefill_chunk_tokens=64, slo_patience=2)
    jeng, teng = _slo_pair(jm, jp, tm, tp, **kw)
    rng = np.random.default_rng(4)
    reqs = []
    for i, n in enumerate((70, 9, 40)):
        p = rng.integers(0, tm.cfg.vocab, n).astype(np.int32)
        target = 3.0 if i == 1 else None
        reqs.append((jeng.submit(p, max_new_tokens=8, latency_target_ms=target).request,
                     teng.submit(p, max_new_tokens=8, latency_target_ms=target).request))
    _lockstep(jeng, teng)
    assert [k for _, k, _ in teng.slo_events][:2] == ["enter", "exit"]
    same_requests(reqs)
    built = [(r.kind, r.size, r.epoch) for r in teng.program_log]
    assert ("chunk", 32) in {(k, s) for k, s, _ in built}  # the SLO chunk cap's program
    assert len({e for *_, e in built}) >= 2  # programs built under more than one epoch
    for prog in teng.programs().values():
        assert prog["epoch"] <= teng.runtime.policy_epoch()
