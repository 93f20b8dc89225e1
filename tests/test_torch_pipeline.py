"""The port's staged tuning pipeline against the JAX package's, on shared tables.

The stages (prune on a model table, plan the measurements under a budget and
a donor, measure and fill from the model, warm-start the clustering, stamp
the lineage) are numpy in both packages; only the tables' sources differ
(the reference's TPU models, the port's measured H100 tables and H100
model).  So a test family is registered in each package, through its public
``register_family`` / ``unregister_family``, whose ``perf_matrix`` returns
rows of one shared "measured" table and whose ``model_matrix`` returns rows
of one shared model table: the reference's textured and untextured matmul
models at 10 of its configs, over its synthetic problems.  Each stage's
output is compared exactly.  The port's own H100 models are checked for what
the pipeline needs of them: finite, positive where a config launches, one
column per compiled config.
"""
import importlib

import numpy as np
import pytest

from repro.core.perfmodel import build_perf_matrix as jax_build_perf_matrix
from repro_torch.core import attnmodel, perfmodel, pipeline, recmodel
from repro_torch.core.dispatch import Deployment
from repro_torch.kernels import attention as at
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm, wkv

# The submodules themselves: the package exports the functions of these names, as the reference does.
families = importlib.import_module("repro_torch.core.families")

jax_dataset, jax_families, jax_pipeline, jax_matmul = (importlib.import_module(m) for m in (
    "repro.core.dataset", "repro.core.families", "repro.core.pipeline", "repro.kernels.matmul"))

FAMILY = "mm_staged"


@pytest.fixture(scope="module")
def shared():
    """Register the shared test family in both packages; yield (problems, perf, model)."""
    problems = jax_dataset.synthetic_problems(48, seed=3)
    space = jax_matmul.config_space()
    cols = np.linspace(0, len(space) - 1, len(mm.config_space())).astype(int)
    ref_cfgs = [space[i] for i in cols]
    perf = np.asarray(jax_build_perf_matrix(problems, ref_cfgs))
    model = np.asarray(jax_build_perf_matrix(problems, ref_cfgs, texture=False))
    rows = {tuple(p): i for i, p in enumerate(problems)}

    def tables(table, cfg_space):
        def lookup(ps, cs, dev):
            idx = [cfg_space.index(c) for c in cs]
            return table[[rows[tuple(p)] for p in ps]][:, idx]
        return lookup

    port_cfgs = list(mm.config_space())
    common = dict(name=FAMILY, feature_names=jax_dataset.FEATURE_NAMES, harvest=lambda a: problems,
                  default_n_kernels=4)
    jax_families.register_family(jax_families.KernelFamily(
        config_cls=jax_matmul.MatmulConfig, config_space=lambda: ref_cfgs, default_config=ref_cfgs[2],
        features=jax_dataset.problem_features, perf_matrix=tables(perf, ref_cfgs),
        model_matrix=tables(model, ref_cfgs), policy_attr="select_matmul", problem_arity=4,
        reference="test", **common))
    families.register_family(families.KernelFamily(
        config_cls=mm.MatmulConfig, config_space=lambda: port_cfgs, default_config=port_cfgs[2],
        features=importlib.import_module("repro_torch.core.dataset").problem_features,
        perf_matrix=tables(perf, port_cfgs), model_matrix=tables(model, port_cfgs), **common))
    yield problems, perf, model
    jax_families.unregister_family(FAMILY)
    families.unregister_family(FAMILY)
    assert not families.is_registered(FAMILY) and not jax_families.is_registered(FAMILY)


def _stages(pkg, prune_ratio, budget, donor):
    cand = pkg.generate_candidates(FAMILY)
    prior = pkg.as_transfer_prior(donor, FAMILY)
    prune = pkg.prune_candidates(cand, prune_ratio=prune_ratio,
                                 keep_configs=prior.configs if prior is not None else (),
                                 with_model=prior is not None or budget is not None)
    plan = pkg.plan_measurements(cand, prune, donor=prior, measure_budget=budget)
    return cand, prune, plan, pkg.run_measurements(cand, prune, plan)


def _donors(shared):
    """One donor per package: each package's full tune of the shared family."""
    return (pipeline.run_family_pipeline(FAMILY, n_kernels=4),
            jax_pipeline.run_family_pipeline(FAMILY, n_kernels=4))


@pytest.mark.parametrize("prune_ratio", [None, 0.3, 0.5, 0.8])
@pytest.mark.parametrize("budget", [None, 0.2, 0.35])
@pytest.mark.parametrize("with_donor", [False, True])
def test_stages_equal(shared, prune_ratio, budget, with_donor):
    donors = _donors(shared) if with_donor else (None, None)
    cand, prune, plan, meas = _stages(pipeline, prune_ratio, budget, donors[0])
    jcand, jprune, jplan, jmeas = _stages(jax_pipeline, prune_ratio, budget, donors[1])
    assert cand.problems == jcand.problems and len(cand.configs) == len(jcand.configs)
    assert prune.kept == jprune.kept and prune.ratio == jprune.ratio
    if jprune.predicted is None:
        assert prune.predicted is None
    else:
        np.testing.assert_array_equal(prune.predicted, jprune.predicted)
    np.testing.assert_array_equal(plan.mask, jplan.mask)
    assert (plan.agreed_rows, plan.capped_rows) == (jplan.agreed_rows, jplan.capped_rows)
    np.testing.assert_array_equal(meas.perf, jmeas.perf)
    assert (meas.n_measured, meas.full_cost, meas.measured_fraction, meas.model_error) == (
        jmeas.n_measured, jmeas.full_cost, jmeas.measured_fraction, jmeas.model_error)
    if budget is not None:
        assert meas.measured_fraction <= budget
    assert meas.seconds >= 0.0


@pytest.mark.parametrize("knobs", [
    {},
    {"prune_ratio": 0.5},
    {"measure_budget": 0.3},
    {"prune_ratio": 0.5, "measure_budget": "auto", "with_donor": True},
    {"prune_ratio": 0.4, "measure_budget": 0.35, "with_donor": True},
])
def test_run_family_pipeline_equal(shared, knobs):
    problems, _, _ = shared
    knobs = dict(knobs)
    donor, jdonor = _donors(shared) if knobs.pop("with_donor", False) else (None, None)
    got = pipeline.run_family_pipeline(FAMILY, n_kernels=4, transfer_from=donor, **knobs)
    want = jax_pipeline.run_family_pipeline(FAMILY, n_kernels=4, transfer_from=jdonor, **knobs)
    assert got.chosen == want.chosen
    feats = jax_dataset.problem_features(problems)
    np.testing.assert_array_equal(got.tree.predict(feats), want.tree.predict(feats))
    assert got.lineage == want.lineage  # the reference's lineage record, key for key
    assert abs(got.oracle_fraction - want.oracle_fraction) <= 1e-12
    assert abs(got.classifier_fraction - want.classifier_fraction) <= 1e-12
    res = got.to_family_result()
    assert res.lineage == got.lineage and res.measure_seconds == got.measure.seconds


def test_warm_start_centers_equal(shared):
    _, perf, _ = shared
    norm = importlib.import_module("repro_torch.core.normalize").normalize(perf, "standard")
    port_space = list(mm.config_space())
    deployed = [port_space[i] for i in (1, 4, 7)]
    got = pipeline.warm_start_centers(norm, port_space, perf, deployed)
    ref_space = jax_families.get_family(FAMILY).config_space()
    want = jax_pipeline.warm_start_centers(norm, ref_space, perf, [ref_space[i] for i in (1, 4, 7)])
    np.testing.assert_array_equal(got, want)
    assert pipeline.warm_start_centers(norm, port_space, perf, []) is None


@pytest.mark.parametrize("err", [None, 0.0, 0.01, 0.05, 0.1, 0.3, 2.0])
def test_auto_budget_equal(err):
    assert pipeline.auto_measure_budget(err) == jax_pipeline.auto_measure_budget(err)


def test_budget_resolution_reads_the_donors_lineage():
    dep = Deployment(device="gpu_x", configs=[mm.DEFAULT_CONFIG], classifier=None,
                     meta={"tuning_lineage": {"matmul": {"model_error": 0.1}, "wkv": {"model_error": None}}})
    for fam, want in (("matmul", 0.35000000000000003), ("wkv", 0.35), ("ssm_scan", 0.35)):
        got = pipeline.resolve_measure_budget("auto", dep, family=fam)
        assert got == pytest.approx(want) and got == jax_pipeline.auto_measure_budget(
            pipeline.donor_model_error(dep, fam))
    assert pipeline.resolve_measure_budget("auto", None) is None
    assert pipeline.resolve_measure_budget(0.2, dep) == 0.2
    assert pipeline.donor_model_error(dep, "matmul") == 0.1 and pipeline.donor_model_error(dep, "wkv") is None


def test_transfer_prior_shapes():
    cfgs = list(mm.config_space()[:3])
    dep = Deployment(device="gpu_nvidia_h100_80gb_hbm3", configs=cfgs, classifier=None)
    prior = pipeline.as_transfer_prior(dep, "matmul")
    assert prior.configs == cfgs and prior.source_device == "gpu_nvidia_h100_80gb_hbm3"
    assert pipeline.as_transfer_prior(dep, "wkv") is None  # untuned family: no prior
    assert pipeline.as_transfer_prior((cfgs, None), "matmul").configs == cfgs
    assert pipeline.as_transfer_prior(None, "matmul") is None
    assert pipeline.as_transfer_prior(prior, "matmul") is prior


def test_staged_matmul_dataset_equal(shared, monkeypatch):
    """The matmul entry of the staged pipeline over the shared tables: monkeypatch
    each package's matmul family to the shared family's sources."""
    problems, _, _ = shared
    for pkg_fams in (families, jax_families):
        shared_fam = pkg_fams.get_family(FAMILY)
        import dataclasses

        monkeypatch.setitem(pkg_fams._REGISTRY, "matmul", dataclasses.replace(shared_fam, name="matmul"))
    got, lin, donor = pipeline.staged_matmul_dataset(problems, "gpu_x", prune_ratio=0.5, measure_budget=0.3)
    want, jlin, jdonor = jax_pipeline.staged_matmul_dataset(problems, "gpu_x", prune_ratio=0.5,
                                                             measure_budget=0.3)
    np.testing.assert_array_equal(got.perf, want.perf)
    assert lin == jlin and donor is None and jdonor is None
    assert got.source == want.source == "pipeline" and len(got.configs) == len(want.configs)


# ---------------------------------------------------------------------------
# the port's H100 models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["matmul", "attention", "wkv", "ssm_scan"])
def test_h100_model_tables(name):
    fam = families.get_family(name)
    problems = fam.harvest(["granite-8b", "rwkv6-7b", "hymba-1.5b"])
    table = fam.model_matrix(problems, fam.config_space(), None)
    assert table.shape == (len(problems), len(fam.config_space()))
    assert np.isfinite(table).all() and (table > 0).all()  # every compiled config launches
    # The model is the card's roofline: no cell above the peak rate of its units.
    peak = perfmodel.H100_SXM5.peak_flops if name in ("matmul", "attention") else perfmodel.H100_SXM5.f32_flops
    if name != "attention":  # attention's useful FLOPs count masked columns of sq != skv (the table's convention)
        assert (table * 1e9 <= peak).all()
    np.testing.assert_array_equal(table, fam.model_matrix(problems, fam.config_space(), "gpu_other_card"))


def test_model_marks_configs_that_cannot_launch():
    big = mm.MatmulConfig(256, 256, 256)  # not compiled; its ring overflows shared memory
    assert perfmodel.predict_time((128, 4096, 4096, 1), big) == float("inf")
    assert perfmodel.predict_gflops((128, 4096, 4096, 1), big) == 0.0
    assert recmodel.predict_wkv_gflops((2048, 64), wkv.WkvConfig(256)) == 0.0
    assert attnmodel.predict_attn_gflops((128, 128, 128), at.AttentionConfig(256, 256)) == 0.0
    assert ssm.SsmConfig(64, 64).smem_bytes(16, True) > perfmodel.H100_SXM5.smem_per_cta
    assert recmodel.predict_ssm_gflops((2048, 1600), ssm.SsmConfig(64, 64)) == 0.0


def test_model_follows_the_kernels():
    # GEMM: a 16-row tile takes mma.sync, a 64-row tile wgmma; the decode GEMM splits k.
    assert mm.split_k(4, 1024, 4096, mm.MatmulConfig(16, 64, 128)) > 1
    t16 = perfmodel.predict_time((4096, 4096, 4096, 1), mm.MatmulConfig(16, 64, 128))
    t128 = perfmodel.predict_time((4096, 4096, 4096, 1), mm.MatmulConfig(128, 128, 32))
    assert t128 < t16  # wgmma at 128 rows beats mma.sync at 16 on a square GEMM
    # WKV: the state pass's chain grows with the chunk count, so time grows with S.
    assert recmodel.predict_wkv_time((4096, 64), wkv.WkvConfig(16)) < recmodel.predict_wkv_time(
        (32768, 64), wkv.WkvConfig(16))
    assert recmodel.wkv_heads(64) == 64 and recmodel.wkv_flops(128, 64, 64) == 8 * 128 * 64 * 64 * 64
    assert recmodel.ssm_flops(2048, 1600) == 6 * 2048 * 1600 * 16
