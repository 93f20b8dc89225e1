"""The port's ``OnlinePolicy`` against the JAX package's (``core/online.py``).

Both policies get the same candidates (the reference's matmul configs, as
the port's ``MatmulConfig`` with the same fields; on the CPU a config is a
selection only), the same analytic ``measure`` and the same call sequence:
their picks, commits, ``stats``, ``measurements`` and ``warmup_cost`` must be
equal.  A prior is one deployment tuned by the reference and loaded by both
packages from the same v6 bundle JSON.  The card's CUDA-event measurer is
held on the card only.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import online as jax_online
from repro.core.bundle import DeploymentBundle as JaxBundle
from repro.core.dataset import build_model_dataset as jax_model_dataset
from repro.core.dataset import synthetic_problems as jax_synthetic
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.core.tuner import tune as jax_tune
from repro.kernels.matmul import config_space as jax_matmul_space
from repro_torch.core import online
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import MatmulConfig


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    """(reference Deployment, port Deployment): one reference tune through the v6 bundle JSON."""
    dep = jax_tune(jax_model_dataset(jax_synthetic(80), device_name="tpu_v5e"), n_kernels=6).deployment
    path = tmp_path_factory.mktemp("online") / "bundle.json"
    JaxBundle({"tpu_v5e": dep}).save(path)
    return JaxBundle.load(path).deployments["tpu_v5e"], DeploymentBundle.load(path).deployments["tpu_v5e"]


def _candidates(n=6):
    jax_cands = jax_matmul_space()[:: max(1, len(jax_matmul_space()) // n)][:n]
    return jax_cands, [MatmulConfig(c.block_m, c.block_n, c.block_k, c.order) for c in jax_cands]


def _measure(problem, cfg):
    """An analytic stand-in for a timer: a deterministic function of shape and tile."""
    m, k, n, batch = problem
    tiles = -(-m // cfg.block_m) * -(-n // cfg.block_n) * -(-k // cfg.block_k)
    return 1e-6 * tiles * batch + 1e-9 * (cfg.block_m * cfg.block_n + 3 * cfg.block_k) + (
        2e-7 if cfg.order == "nmk" else 0.0)


def _problems(seed, n=60):
    rng = np.random.default_rng(seed)
    return [(int(rng.choice([1, 3, 32, 128])), int(rng.choice([1024, 4096])), int(rng.choice([512, 2048])), 1)
            for _ in range(n)]


def _measured(pol):
    return {b: [(c.name(), mean, trials) for c, mean, trials in rows] for b, rows in pol.measurements().items()}


@pytest.mark.parametrize("seed, trials", [(0, 1), (1, 2), (2, 1)])
def test_explore_then_commit_equal(seed, trials):
    jc, tc = _candidates()
    jpol = jax_online.OnlinePolicy(_measure, jc, trials_per_arm=trials)
    tpol = online.OnlinePolicy(_measure, tc, trials_per_arm=trials)
    picks = [(jpol.select_matmul(*p).name(), tpol.select_matmul(*p).name()) for p in _problems(seed, 150 * trials)]
    assert [a for a, _ in picks] == [b for _, b in picks]
    assert dict(jpol.stats) == dict(tpol.stats) and tpol.stats["explore"] > 0 and tpol.stats["commit"] > 0
    assert _measured(jpol) == _measured(tpol)
    assert {b: c.name() for b, c in jpol.committed().items()} == {b: c.name() for b, c in tpol.committed().items()}
    assert jpol.warmup_cost() == pytest.approx(tpol.warmup_cost(), rel=0, abs=0)


def test_prior_orders_the_arms_and_passes_other_families_through(priors):
    jdep, tdep = priors
    jc, tc = _candidates(10)
    jpol = jax_online.OnlinePolicy(_measure, jc, prior=jdep)
    tpol = online.OnlinePolicy(_measure, tc, prior=tdep)
    for p in _problems(3, 30):
        assert jpol.select_matmul(*p).name() == tpol.select_matmul(*p).name()
    assert _measured(jpol) == _measured(tpol)
    for q in [(1, 4096, 128), (512, 512, 64), (2048, 4096, 128)]:
        assert jpol.select_attention(*q).name() == tpol.select_attention(*q).name() == tdep.select_attention(*q).name()
    # set_prior drops the attention cache, keeps the arm measurements.
    before = _measured(tpol)
    tpol.set_prior(None)
    jpol.set_prior(None)
    assert _measured(tpol) == before and not tpol._attn_cache and tpol.prior is None


def test_not_memoized_by_the_runtime():
    """``cacheable = False``: the runtime consults the policy on every call, so
    exploration reaches a new arm each time; selection logs are equal."""
    jc, tc = _candidates()
    jrt, trt = JaxRuntime(), KernelRuntime()
    jpol, tpol = jax_online.OnlinePolicy(_measure, jc), online.OnlinePolicy(_measure, tc)
    jrt.install(jpol)
    trt.install(tpol)
    jrt.set_selection_logging(True)
    trt.set_selection_logging(True)
    for _ in range(len(tc) + 2):
        jrt.select_matmul_config(4, 1024, 2048, 1)
        trt.select_matmul_config(4, 1024, 2048, 1)
    assert [c.name() for *_, c in jrt.selection_log()] == [c.name() for *_, c in trt.selection_log()]
    assert len(set(c.name() for *_, c in trt.selection_log())) == len(tc)
    assert trt.shape_cache_stats()["hits"] == 0 and tpol.stats["explore"] == len(tc)
    snap = trt.telemetry(online=tpol)
    jsnap = jrt.telemetry(online=jpol)
    assert json.dumps(snap.to_json(), sort_keys=True) == json.dumps(jsnap.to_json(), sort_keys=True)


def test_wall_clock_measure_is_a_median():
    calls = []
    t = online.wall_clock_measure(lambda: calls.append(1), reps=5)
    assert len(calls) == 5 and t >= 0.0
    assert online.shape_bucket((1, 4096, 1024, 4)) == jax_online.shape_bucket((1, 4096, 1024, 4))


def test_cuda_event_measure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        online.cuda_event_measure()


@pytest.mark.cuda
def test_cuda_event_measure_on_card():
    """On the card: the measurer times matmul_cuda at each arm's config and
    refuses to run during a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import matmul as mm

    measure = online.cuda_event_measure()
    pol = online.OnlinePolicy(measure, mm.config_space()[:3])
    for _ in range(4):
        pol.select_matmul(1, 4096, 1024, 4)
    assert len(pol.committed()) == 1 and pol.warmup_cost() > 0
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="captured"):
        with torch.cuda.graph(graph, stream=stream):
            measure((1, 4096, 1024, 4), mm.DEFAULT_CONFIG)
