"""The port's continuous-tuning loop against the JAX package's (``core/retune.py``).

One deployment, tuned by the reference on its TPU model table, is shared
through the v6 bundle JSON that both packages load (the port's configs then
carry the reference's fields: on the CPU they are selections only).  Both
runtimes select the same drifted problem mix; from their selection logs the
telemetry snapshots, their JSON, the Jensen-Shannon divergences and the drift
reports must be equal.  ``incremental_retune`` gets the same benchmark
table in both packages through its ``dataset_builder=`` hook (the reference's
TPU-model table at the retune's problems; the port's default is its H100
model, which no TPU deployment may use) and must give the same deployed
configs, tree predictions over a grid, provenance and ``retune_log``.  A
test family registered in both packages over one shared table holds the
non-matmul path and the canary's selection check; the canary's verdicts on
injected faults and NaN-poisoned candidates are equal too.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core.bundle import DeploymentBundle as JaxBundle
from repro.core.dataset import build_model_dataset as jax_model_dataset
from repro.core.dataset import synthetic_problems as jax_synthetic
from repro.core.faults import FaultPlan as JaxFaultPlan
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.core.tuner import tune as jax_tune
from repro.kernels.attention import attention_config_space as jax_attention_space
from repro_torch.core import attnmodel, dataset, perfmodel, retune
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import attention as at
from repro_torch.kernels.matmul import MatmulConfig

# The submodules themselves: the package exports the functions of these names, as the reference does.
families = importlib.import_module("repro_torch.core.families")

jax_retune, jax_families, jax_attnmodel = (importlib.import_module(f"repro.core.{m}")
                                           for m in ("retune", "families", "attnmodel"))


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    """(reference, port): one reference tune loaded by both packages from one bundle JSON."""
    dep = jax_tune(jax_model_dataset(jax_synthetic(80), device_name="tpu_v5e"), n_kernels=6).deployment
    path = tmp_path_factory.mktemp("retune") / "bundle.json"
    JaxBundle({"tpu_v5e": dep}).save(path)
    return JaxBundle.load(path).deployments["tpu_v5e"], DeploymentBundle.load(path).deployments["tpu_v5e"]


def _drifted(seed=0, n=60):
    """A decode-heavy deep-k mix the tuning never saw (the reference's chaos tests' mix)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.choice([1, 2, 4])), int(rng.choice([8192, 16384])), int(rng.choice([1024, 2048])), 1)
            for _ in range(n)]


def _logged(deployments, problems):
    """Both runtimes with the deployment installed select ``problems``: (jax rt, port rt)."""
    jdep, tdep = deployments
    jrt, trt = JaxRuntime(), KernelRuntime()
    jrt.install(jdep)
    trt.install(tdep)
    for rt in (jrt, trt):
        rt.set_selection_logging(True)
        for p in problems:
            rt.select_matmul_config(*p)
    return jrt, trt


def _jax_table(problems, device):
    return jax_model_dataset(problems, device_name="tpu_v5e")


def _port_table(problems, device):
    """The reference's table at ``problems``, its columns as the port's configs."""
    ds = _jax_table(problems, device)
    return dataset.TuningDataset(device=ds.device, problems=list(ds.problems),
                                 configs=[MatmulConfig(**c.to_dict()) for c in ds.configs], perf=np.asarray(ds.perf))


def test_snapshot_json_equal(deployments):
    problems = _drifted() + list(jax_synthetic(30))
    jrt, trt = _logged(deployments, problems)
    js, ts = jrt.telemetry(), trt.telemetry()
    assert json.dumps(ts.to_json(), sort_keys=True) == json.dumps(js.to_json(), sort_keys=True)
    assert ts.n_events == len(problems) and ts.families() == js.families() == ["matmul"]
    back = retune.TelemetrySnapshot.from_json(json.loads(json.dumps(ts.to_json())))
    assert back.counts == ts.counts and back.family_problems == ts.family_problems and back.n_events == ts.n_events
    assert back.histogram() == js.histogram()


def test_merge_is_commutative_and_equal(deployments):
    a1, a2 = _logged(deployments, _drifted(1, 20))
    b1, b2 = _logged(deployments, _drifted(2, 30))
    for rt in (a1, a2, b1, b2):
        rt.record_incident({"site": "s", "family": "matmul", "config": None, "device": None, "error": "e",
                            "action": "retry"})
    ab = retune.TelemetrySnapshot.from_runtime(a2).merge(retune.TelemetrySnapshot.from_runtime(b2))
    ba = retune.TelemetrySnapshot.from_runtime(b2).merge(retune.TelemetrySnapshot.from_runtime(a2))
    want = jax_retune.TelemetrySnapshot.from_runtime(a1).merge(jax_retune.TelemetrySnapshot.from_runtime(b1))
    assert ab.to_json() == ba.to_json() == want.to_json()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_js_divergence_equal(seed):
    rng = np.random.default_rng(seed)
    keys = [tuple(int(v) for v in rng.integers(1, 15, 4)) for _ in range(12)]
    p = {k: float(v) for k, v in zip(keys[:8], rng.random(8))}
    q = {k: float(v) for k, v in zip(keys[4:], rng.random(8))}
    assert retune.js_divergence(p, q) == jax_retune.js_divergence(p, q)
    assert retune.js_divergence(p, p) == 0.0 and retune.js_divergence({}, {}) == 0.0


@pytest.mark.parametrize("threshold, min_events", [(0.15, 32), (0.5, 8), (0.15, 500)])
def test_drift_reports_equal(deployments, threshold, min_events):
    jrt, trt = _logged(deployments, _drifted() + list(jax_synthetic(20)))
    want = jax_retune.detect_drift_all(jrt.telemetry(), deployments[0], threshold=threshold, min_events=min_events)
    got = retune.detect_drift_all(trt.telemetry(), deployments[1], threshold=threshold, min_events=min_events)
    assert {f: dataclasses.astuple(r) for f, r in got.items()} == {f: dataclasses.astuple(r) for f, r in want.items()}
    # The provenance dict itself, and an artifact without provenance (scores 1.0).
    dist = deployments[1].meta["train_distribution"]
    assert dataclasses.astuple(retune.detect_drift(trt.telemetry(), dist)) == dataclasses.astuple(
        jax_retune.detect_drift(jrt.telemetry(), dist))
    assert retune.detect_drift(trt.telemetry(), None, min_events=1).score == 1.0


def _grid():
    return [(m, k, n, b) for m in (1, 4, 64, 512) for k in (256, 4096, 16384) for n in (512, 2048) for b in (1, 8)]


@pytest.mark.parametrize("blend, n_kernels", [(0.5, None), (0.8, 4)])
def test_incremental_retune_equal(deployments, blend, n_kernels):
    jrt, trt = _logged(deployments, _drifted() + list(jax_synthetic(20)))
    want = jax_retune.incremental_retune(deployments[0], jrt.telemetry(), blend=blend, n_kernels=n_kernels,
                                         dataset_builder=_jax_table)
    got = retune.incremental_retune(deployments[1], trt.telemetry(), blend=blend, n_kernels=n_kernels,
                                    dataset_builder=_port_table)
    assert [c.name() for c in got.deployment.configs] == [c.name() for c in want.deployment.configs]
    assert (got.n_harvested, got.n_problems, got.warm_started) == (want.n_harvested, want.n_problems,
                                                                   want.warm_started)
    assert dataclasses.astuple(got.report) == dataclasses.astuple(want.report)
    grid = _grid()
    assert [got.deployment.select_matmul(*p).name() for p in grid] == [
        want.deployment.select_matmul(*p).name() for p in grid]
    for key in ("train_distribution", "retune", "retune_log", "retune_count"):
        assert got.deployment.meta[key] == want.deployment.meta[key], key
    # The incumbent is untouched (clone).
    assert deployments[1].meta.get("retune_count") is None and got.deployment is not deployments[1]


def test_default_data_source_is_the_h100_model(deployments):
    jrt, trt = _logged(deployments, _drifted())
    with pytest.raises(ValueError, match="no H100 model"):
        retune.incremental_retune(deployments[1], trt.telemetry())
    h100 = deployments[1].clone()
    h100.device = perfmodel.H100_SXM5.name
    got = retune.incremental_retune(h100, trt.telemetry())
    ds = dataset.build_model_dataset(_drifted()[:4])
    assert ds.device == perfmodel.H100_SXM5.name and ds.source == "model"
    assert all(c in ds.configs for c in got.deployment.configs)


def test_clone_is_shallow_and_independent(deployments):
    dep = deployments[1]
    c = dep.clone()
    assert c is not dep and c.configs == dep.configs and c.classifier is dep.classifier
    c.meta["x"] = 1
    c.configs.append(c.configs[0])
    assert "x" not in dep.meta and len(dep.configs) == len(c.configs) - 1


# ---------------------------------------------------------------------------
# a family in both registries over one shared table: the non-matmul path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shared_family():
    problems = sorted(set(jax_attnmodel.harvest_attn_problems(None)) | set(attnmodel.harvest_attn_problems(None))
                      | {(s, s, 128) for s in (8192, 16384)} | {(1, s, 64) for s in (8192, 16384)})
    n = len(at.config_space())
    table = jax_attnmodel.build_attn_matrix(problems, jax_attention_space()[:n])
    lookup = {p: row for p, row in zip(problems, np.asarray(table))}
    perf = lambda ps, cs, dev: np.stack([lookup[tuple(p)] for p in ps])[:, : len(cs)]
    common = dict(name="attn_shared", feature_names=attnmodel.ATTN_FEATURE_NAMES, harvest=lambda a: problems,
                  perf_matrix=perf)
    jax_families.register_family(jax_families.KernelFamily(
        policy_attr="select_attn_shared", problem_arity=3, reference="test",
        config_cls=jax_attention_space()[0].__class__, config_space=lambda: jax_attention_space()[:n],
        default_config=jax_attention_space()[0], features=jax_attnmodel.attn_problem_features, **common))
    families.register_family(families.KernelFamily(
        config_cls=at.AttentionConfig, config_space=at.config_space, default_config=at.config_space()[0],
        features=attnmodel.attn_problem_features, model_matrix=perf, **common))
    yield problems
    jax_families.unregister_family("attn_shared")
    families.unregister_family("attn_shared")


def _family_snapshots(problems, seed):
    rng = np.random.default_rng(seed)
    picks = [problems[i] for i in rng.integers(0, len(problems), 50)]
    snaps = []
    for mod in (jax_retune, retune):
        snap = mod.TelemetrySnapshot()
        for p in picks:
            b = mod.shape_bucket(p)
            fam = snap.counts.setdefault("attn_shared", {})
            fam[b] = fam.get(b, 0) + 1
            snap.family_problems.setdefault("attn_shared", {})[b] = tuple(p)
            snap.n_events += 1
        snaps.append(snap)
    return snaps


def _index(cfgs, space):
    return [space.index(c) for c in cfgs]


@pytest.mark.parametrize("seed", [0, 3])
def test_family_retune_equal(deployments, shared_family, seed):
    js, ts = _family_snapshots(shared_family, seed)
    want = jax_retune.incremental_retune(deployments[0], js, family="attn_shared")
    got = retune.incremental_retune(deployments[1], ts, family="attn_shared")
    n = len(at.config_space())
    assert _index(got.deployment.family_tuning("attn_shared").configs, at.config_space()) == _index(
        want.deployment.family_tuning("attn_shared").configs, jax_attention_space()[:n])
    feats = attnmodel.attn_problem_features(shared_family)
    np.testing.assert_array_equal(got.deployment.family_tuning("attn_shared").tree.predict(feats),
                                  want.deployment.family_tuning("attn_shared").tree.predict(feats))
    for key in ("family_distributions", "retune", "retune_log", "retune_count"):
        assert got.deployment.meta[key] == want.deployment.meta[key], key
    # The matmul tuning is carried over untouched.
    assert got.deployment.configs == deployments[1].configs


def test_canary_selection_regression_rejected_equal(deployments, shared_family):
    js, ts = _family_snapshots(shared_family, 1)
    jgood = jax_retune.incremental_retune(deployments[0], js, family="attn_shared").deployment
    tgood = retune.incremental_retune(deployments[1], ts, family="attn_shared").deployment
    # A candidate that serves the worst config of the shared table everywhere.
    n = len(at.config_space())
    worst = int(np.argmin(np.asarray(families.get_family("attn_shared").perf_matrix(shared_family, range(n), None))
                          .mean(axis=0)))
    jbad, tbad = jgood.clone(), tgood.clone()
    jbad.set_family_tuning("attn_shared", [jax_attention_space()[worst]], None)
    tbad.set_family_tuning("attn_shared", [at.config_space()[worst]], None)
    for old, new, want_ok in ((tgood, tgood, True), (tgood, tbad, False)):
        jold, jnew = (jgood, jgood) if new is tgood else (jgood, jbad)
        got = retune.canary_deployment(old, new, ts, family="attn_shared")
        want = jax_retune.canary_deployment(jold, jnew, js, family="attn_shared")
        assert (got.ok, got.selection_ok, got.numeric_ok, got.reason) == (
            want.ok, want.selection_ok, want.numeric_ok, want.reason)
        assert got.ok is want_ok
        assert got.selection_score_new == pytest.approx(want.selection_score_new, rel=1e-12)


def _canary_both(deployments, text=None, **kw):
    jrt, trt = _logged(deployments, _drifted())
    if text is not None:
        jrt.set_fault_plan(JaxFaultPlan.parse(text))
        trt.set_fault_plan(FaultPlan.parse(text))
    want = jax_retune.canary_deployment(deployments[0], deployments[0], jrt.telemetry(), runtime=jrt, **kw)
    got = retune.canary_deployment(deployments[1], deployments[1], trt.telemetry(), runtime=trt, **kw)
    return want, got, trt


@pytest.mark.parametrize("text, ok", [(None, True), ("canary.matmul:compile_error", False),
                                      ("canary.matmul:nan", False), ("canary.matmul:inf", False),
                                      ("canary.matmul:oom", False), ("canary.attention:compile_error", True)])
def test_canary_verdicts_equal(deployments, text, ok):
    want, got, trt = _canary_both(deployments, text)
    assert (got.ok, got.numeric_ok, got.reason) == (want.ok, want.numeric_ok, want.reason)
    assert got.ok is ok
    # The port's H100 model does not score a TPU deployment: its selection check abstains.
    assert got.selection_ok and got.selection_score_new is None
    assert trt.fault_plan is not None or text is None  # the plan is reattached


def test_canary_without_traffic_passes():
    empty = retune.TelemetrySnapshot()
    rep = retune.canary_deployment(None, None, empty)
    assert rep.ok and rep.reason == "no holdout traffic"


@pytest.mark.parametrize("family", ["wkv", "ssm_scan"])
def test_recurrence_canary_probes_compare_the_oracle_with_itself(family):
    cfg = families.get_family(family).default_config
    for text, want in ((None, (True, "")), (f"canary.{family}:nan", (False, "canary probe produced non-finite output"))):
        rt = KernelRuntime()
        if text:
            rt.set_fault_plan(FaultPlan.parse(text))
        assert retune._numeric_agreement(family, cfg, rt) == want


@pytest.mark.cuda
def test_canary_probes_the_kernels_on_card():
    """On the card: the matmul probe launches matmul_cuda at the candidate's
    config (the 8 x 16 probe and a served decode GEMM) and attention_cuda
    (f32, head dim 64), each against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import attention as atk
    from repro_torch.kernels import matmul as mm

    mm.reset_launches()
    atk.reset_launches()
    ok, why = retune._numeric_agreement("matmul", mm.config_space()[0], KernelRuntime(), device="cuda",
                                        problem=(1, 4096, 1024, 4))
    assert ok, why
    assert mm.total_launches() == 2
    ok, why = retune._numeric_agreement("attention", atk.config_space()[0], KernelRuntime(), device="cuda")
    assert ok, why
    assert atk.total_launches() == 1
