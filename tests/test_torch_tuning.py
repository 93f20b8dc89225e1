"""The port's tuning pipeline against the JAX package's, on one shared table.

The paper's loop (benchmark table -> normalize -> cluster-select -> decision
tree -> ``Deployment``) is numpy in both packages; only the table's source
differs (the reference's TPU analytic model, the port's measured H100 table,
``core/gpubench.py``, which needs the card).  So both packages get the SAME
table here: the reference's ``build_model_dataset(synthetic_problems(150))``,
exported to numpy with its columns cut to as many as the port compiles (10
GEMM configs).  Each column of the port's table stands for one of the port's
configs; the numbers are only data.  For the attention family a test family
is registered in each package, through its public ``register_family`` /
``unregister_family``, whose ``perf_matrix`` returns one shared table (the
reference's attention model at every problem either package harvests).

Everything else is compared exactly: equal arrays, equal indices, equal tree
predictions, fractions within 1e-12.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels.attention import attention_config_space as jax_attention_space
from repro_torch.configs import registry
from repro_torch.core import attnmodel, classify, cluster, codegen, dataset, families, gpubench, normalize, pca, recmodel
from repro_torch.core import pipeline, retune, tuner
from repro_torch.core.dispatch import Deployment
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import attention as at
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.launch import tune as tune_cli

# The reference's modules by path: ``repro.core`` re-exports functions under
# some module names (``normalize``).
(jax_attnmodel, jax_classify, jax_cluster, jax_codegen, jax_dataset, jax_families, jax_normalize, jax_pca,
 jax_pipeline, jax_retune) = (importlib.import_module(f"repro.core.{name}") for name in (
    "attnmodel", "classify", "cluster", "codegen", "dataset", "families", "normalize", "pca", "pipeline", "retune"))

PORTED = sorted(registry.ARCHS)


@pytest.fixture(scope="module")
def tables():
    """(reference dataset, port dataset) over one table: the synthetic GEMM
    problems x 10 columns of the reference's model table."""
    full = jax_dataset.build_model_dataset(jax_dataset.synthetic_problems(150))
    n = len(mm.config_space())
    cols = np.linspace(0, len(full.configs) - 1, n).astype(int)
    perf = np.asarray(full.perf)[:, cols].copy()
    ref = jax_dataset.TuningDataset(device="tpu_v5e", problems=list(full.problems),
                                    configs=[full.configs[i] for i in cols], perf=perf)
    port = dataset.TuningDataset(device="tpu_v5e", problems=list(full.problems),
                                 configs=list(mm.config_space()), perf=perf)
    return ref, port


def test_tables_and_features_are_the_references(tables):
    ref, port = tables
    assert port.perf.shape == (len(ref.problems), 10) and len(ref.problems) >= 100  # 150 draws, deduplicated
    np.testing.assert_array_equal(port.features, ref.features)
    assert dataset.FEATURE_NAMES == jax_dataset.FEATURE_NAMES


@pytest.mark.parametrize("method", jax_normalize.NORMALIZATIONS)
def test_normalize_equal(tables, method):
    ref, port = tables
    assert normalize.NORMALIZATIONS == jax_normalize.NORMALIZATIONS
    np.testing.assert_array_equal(normalize.normalize(port.perf, method), jax_normalize.normalize(ref.perf, method))


def test_pca_equal(tables):
    ref, port = tables
    x = normalize.normalize(port.perf, "standard")
    got, want = pca.PCA(4).fit(x), jax_pca.PCA(4).fit(x)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    np.testing.assert_array_equal(got.inverse_transform(got.transform(x)), want.inverse_transform(want.transform(x)))
    assert got.n_components_for_variance(0.9) == want.n_components_for_variance(0.9)


@pytest.mark.parametrize("method", jax_cluster.CLUSTER_METHODS)
@pytest.mark.parametrize("k", [3, 4])
def test_select_configs_equal(tables, method, k):
    ref, port = tables
    assert cluster.CLUSTER_METHODS == jax_cluster.CLUSTER_METHODS
    x = normalize.normalize(port.perf, "standard")
    got = cluster.select_configs(x, k, method, features=port.features, seed=0)
    assert got == jax_cluster.select_configs(x, k, method, features=ref.features, seed=0)


@pytest.mark.parametrize("name", list(jax_classify.CLASSIFIERS))
def test_classifiers_predict_equal(tables, name):
    ref, port = tables
    assert list(classify.CLASSIFIERS) == list(jax_classify.CLASSIFIERS)
    labels = port.perf[:, [0, 3, 6, 9]].argmax(axis=1)
    got = classify.make_classifier(name, seed=0).fit(port.features, labels)
    want = jax_classify.make_classifier(name, seed=0).fit(ref.features, labels)
    np.testing.assert_array_equal(got.predict(port.features), want.predict(ref.features))


def test_fit_weighted_equal(tables):
    ref, port = tables
    labels = port.perf[:, [1, 5, 8]].argmax(axis=1)
    w = np.linspace(0.5, 2.0, len(labels))
    got = classify.fit_weighted(classify.make_classifier("DecisionTreeB"), port.features, labels, w)
    want = jax_classify.fit_weighted(jax_classify.make_classifier("DecisionTreeB"), ref.features, labels, w)
    np.testing.assert_array_equal(got.predict(port.features), want.predict(ref.features))


@pytest.mark.parametrize("seed", [0, 3])
def test_split_equal(tables, seed):
    ref, port = tables
    for got, want in zip(port.split(0.25, seed=seed), ref.split(0.25, seed=seed)):
        assert got.problems == want.problems
        np.testing.assert_array_equal(got.perf, want.perf)
        assert got.configs == port.configs and got.family == "matmul"


@pytest.mark.parametrize("n_kernels,method", [(8, "pca_kmeans"), (4, "pca_kmeans"), (4, "kmeans"), (3, "tree")])
def test_tune_dataset_equal(tables, n_kernels, method):
    ref, port = tables
    got = pipeline.tune_dataset(port, n_kernels=n_kernels, method=method, families=[])
    want = jax_pipeline.tune_dataset(ref, n_kernels=n_kernels, method=method, families=[])
    assert got.chosen == want.chosen
    assert got.deployment.configs == [port.configs[i] for i in got.chosen]
    np.testing.assert_array_equal(got.deployment.classifier.predict(port.features),
                                  want.deployment.classifier.predict(ref.features))
    assert abs(got.oracle_fraction - want.oracle_fraction) <= 1e-12
    assert abs(got.classifier_fraction - want.classifier_fraction) <= 1e-12
    assert got.deployment.meta["train_distribution"] == want.deployment.meta["train_distribution"]
    assert got.deployment.meta["tuning_lineage"]["matmul"]["n_measured"] == port.perf.size


@pytest.mark.parametrize("n_kernels,method", [(4, "pca_kmeans"), (3, "kmeans")])
def test_tune_equal(tables, n_kernels, method):
    ref, port = tables
    got = tuner.tune(port, n_kernels=n_kernels, method=method, families=[])
    want = importlib.import_module("repro.core.tuner").tune(ref, n_kernels=n_kernels, method=method, families=[])
    assert got.chosen == want.chosen
    np.testing.assert_array_equal(got.deployment.classifier.predict(port.features),
                                  want.deployment.classifier.predict(ref.features))
    assert abs(got.oracle_fraction - want.oracle_fraction) <= 1e-12
    assert abs(got.classifier_fraction - want.classifier_fraction) <= 1e-12


def test_tree_blobs_equal(tables):
    ref, port = tables
    got = pipeline.tune_dataset(port, n_kernels=4, families=[]).deployment.classifier
    want = jax_pipeline.tune_dataset(ref, n_kernels=4, families=[]).deployment.classifier
    assert codegen.tree_to_flat_dict(got) == jax_codegen.tree_to_flat_dict(want)
    assert codegen.tree_to_dict(got) == jax_codegen.tree_to_dict(want)
    assert codegen.tree_to_python(got) == jax_codegen.tree_to_python(want)
    back = codegen.dict_to_tree(codegen.tree_to_flat_dict(got))
    np.testing.assert_array_equal(back.predict(port.features), got.predict(port.features))


def _attention_problems():
    return sorted(set(jax_attnmodel.harvest_attn_problems(None)) | set(attnmodel.harvest_attn_problems(None)))


@pytest.fixture(scope="module")
def attention_families():
    """A test family in each package over one shared attention table."""
    problems = _attention_problems()
    table = jax_attnmodel.build_attn_matrix(problems, jax_attention_space()[: len(at.config_space())])
    lookup = {p: row for p, row in zip(problems, np.asarray(table))}
    perf = lambda ps, cs, dev: np.stack([lookup[tuple(p)] for p in ps])[:, : len(cs)]
    common = dict(name="attn_shared", feature_names=attnmodel.ATTN_FEATURE_NAMES, harvest=lambda a: problems,
                  perf_matrix=perf)
    jax_families.register_family(jax_families.KernelFamily(
        policy_attr="select_attention", problem_arity=3, reference="test",
        config_cls=jax_attention_space()[0].__class__,
        config_space=lambda: jax_attention_space()[: len(at.config_space())],
        default_config=jax_attention_space()[0], features=jax_attnmodel.attn_problem_features, **common))
    families.register_family(families.KernelFamily(
        config_cls=at.AttentionConfig, config_space=at.config_space, default_config=at.DEFAULT_ATTN_CONFIG,
        features=attnmodel.attn_problem_features, **common))
    yield problems
    jax_families.unregister_family("attn_shared")
    families.unregister_family("attn_shared")
    assert not jax_families.is_registered("attn_shared") and not families.is_registered("attn_shared")


@pytest.mark.parametrize("n_kernels,method", [(4, "pca_kmeans"), (3, "kmeans"), (4, "topn")])
def test_attention_family_pipeline_equal(attention_families, n_kernels, method):
    problems = attention_families
    got = pipeline.run_family_pipeline("attn_shared", n_kernels=n_kernels, method=method)
    want = jax_pipeline.run_family_pipeline("attn_shared", n_kernels=n_kernels, method=method)
    assert got.chosen == want.chosen
    assert got.configs == [at.config_space()[i] for i in got.chosen]
    feats = attnmodel.attn_problem_features(problems)
    np.testing.assert_array_equal(got.tree.predict(feats), want.tree.predict(feats))
    assert abs(got.oracle_fraction - want.oracle_fraction) <= 1e-12
    assert abs(got.classifier_fraction - want.classifier_fraction) <= 1e-12
    assert got.lineage["n_measured"] == want.lineage["n_measured"] == len(problems) * 9


def test_tune_with_a_precomputed_family_equal(tables, attention_families):
    ref, port = tables
    got = pipeline.tune_dataset(port, n_kernels=4, families=["attn_shared"])
    want = jax_pipeline.tune_dataset(ref, n_kernels=4, families=["attn_shared"])
    assert got.family_results["attn_shared"].configs == [
        at.config_space()[jax_attention_space().index(c)] for c in want.family_results["attn_shared"].configs]
    assert got.deployment.meta["family_distributions"] == want.deployment.meta["family_distributions"]


@pytest.mark.parametrize("arch", PORTED)
def test_harvests_equal(arch):
    assert registry.SHAPES == {k: registry.ShapeSpec(*v.__dict__.values()) for k, v in jax_registry.SHAPES.items()}
    assert registry.shapes_for(arch) == jax_registry.shapes_for(arch)
    for shape in registry.shapes_for(arch):
        got = registry.gemm_problems(arch, shape)
        assert got == jax_registry.gemm_problems(arch, shape)
        np.testing.assert_array_equal(dataset.problem_features(got), jax_dataset.problem_features(got))
    assert dataset.harvest_problems([arch]) == jax_dataset.harvest_problems([arch])
    attn = attnmodel.harvest_attn_problems([arch])
    assert attn == jax_attnmodel.harvest_attn_problems([arch])
    if attn:
        np.testing.assert_array_equal(attnmodel.attn_problem_features(attn), jax_attnmodel.attn_problem_features(attn))


@pytest.mark.parametrize("arch", PORTED)
def test_recurrence_harvests_equal(arch):
    jax_recmodel = importlib.import_module("repro.core.recmodel")
    assert recmodel.harvest_wkv_problems([arch]) == jax_recmodel.harvest_wkv_problems([arch])
    assert recmodel.harvest_ssm_problems([arch]) == jax_recmodel.harvest_ssm_problems([arch])


def test_recurrence_harvests_of_the_served_archs():
    assert recmodel.harvest_wkv_problems(["rwkv6-7b"]) == [(1, 64), (2048, 64), (4096, 64), (32768, 64)]
    assert recmodel.harvest_ssm_problems(["hymba-1.5b"]) == [(2048, 1600), (4096, 1600), (32768, 1600)]
    assert recmodel.harvest_wkv_problems(["granite-8b"]) == [] == recmodel.harvest_ssm_problems(["granite-8b"])
    jax_recmodel = importlib.import_module("repro.core.recmodel")
    assert recmodel.harvest_wkv_problems(PORTED) == jax_recmodel.harvest_wkv_problems(PORTED)
    assert recmodel.harvest_ssm_problems(None) == jax_recmodel.harvest_ssm_problems(PORTED)
    probs = [(1, 64), (2048, 64), (32768, 1600)]
    np.testing.assert_array_equal(recmodel.wkv_problem_features(probs), jax_recmodel.wkv_problem_features(probs))
    np.testing.assert_array_equal(recmodel.ssm_problem_features(probs), jax_recmodel.ssm_problem_features(probs))


def test_harvest_of_the_tuned_archs():
    archs = ["granite-8b", "hymba-1.5b"]
    got = dataset.harvest_problems(archs)
    assert got == jax_dataset.harvest_problems(archs) and len(got) == 93
    assert dataset.harvest_problems(archs, max_problems=40) == jax_dataset.harvest_problems(archs, max_problems=40)
    assert dataset.harvest_problems(PORTED) == jax_dataset.harvest_problems(PORTED)
    attn = attnmodel.harvest_attn_problems(archs)
    assert attn == jax_attnmodel.harvest_attn_problems(archs) and len(attn) == 11
    assert (32768, 32768, 128) in attn and (1, 524288, 64) in attn


def test_train_distribution_equal(tables):
    _, port = tables
    for probs in (port.problems, _attention_problems()):
        assert retune.train_distribution(probs) == jax_retune.train_distribution(probs)
    w = np.arange(1, len(port.problems) + 1, dtype=float)
    assert retune.train_distribution(port.problems, w) == jax_retune.train_distribution(port.problems, w)


def test_dataset_save_load_round_trip(tables, tmp_path):
    _, port = tables
    port.save(tmp_path / "table.npz")
    back = dataset.TuningDataset.load(tmp_path / "table.npz")
    assert back.problems == port.problems and back.configs == port.configs and back.device == port.device
    np.testing.assert_array_equal(back.perf, port.perf)


@pytest.fixture(scope="module")
def deployment(tables, attention_families):
    """A port Deployment: matmul tuned on the shared table, attention on the shared family."""
    _, port = tables
    dep = pipeline.tune_dataset(port, n_kernels=4, families=[]).deployment
    fam = pipeline.run_family_pipeline("attn_shared", n_kernels=4)
    dep.set_family_tuning("attention", fam.configs, fam.tree)
    return dep


def test_deployment_save_load_round_trip(tables, deployment, tmp_path):
    _, port = tables
    deployment.save(tmp_path / "dep.json")
    back = Deployment.load(tmp_path / "dep.json")
    assert back.configs == deployment.configs and back.attention_configs == deployment.attention_configs
    assert back.to_blob() == deployment.to_blob() and back.to_blob()["version"] == 5
    for p in port.problems:
        assert back.select_matmul(*p) == deployment.select_matmul(*p)
    for p in _attention_problems():
        assert back.select_attention(*p) == deployment.select_attention(*p)
    # No tuning for wkv / ssm_scan: the family default, as the reference answers.
    from repro_torch.kernels import ssm, wkv

    assert back.select_wkv(128, 64) == wkv.DEFAULT_WKV_CONFIG
    assert back.select_ssm(128, 1600) == ssm.DEFAULT_SSM_CONFIG


def test_untuned_attention_takes_the_bucket_fallback():
    cfgs = [at.AttentionConfig(32, 32), at.AttentionConfig(64, 128), at.AttentionConfig(128, 128)]
    dep = Deployment(device="x", configs=[mm.DEFAULT_CONFIG], classifier=None, attention_configs=cfgs)
    from repro.core.dispatch import Deployment as JaxDeployment
    from repro.kernels.attention import AttentionConfig as JaxAttentionConfig

    ref = JaxDeployment(device="x", configs=[], classifier=None,
                        attention_configs=[JaxAttentionConfig(c.block_q, c.block_kv) for c in cfgs])
    for p in ((1, 64, 64), (1, 4096, 128), (4096, 4096, 128), (100, 100, 64)):
        got, want = dep.select_attention(*p), ref.select_attention(*p)
        assert (got.block_q, got.block_kv) == (want.block_q, want.block_kv)


def test_installed_deployment_picks_the_trees_configs(deployment):
    """The quickstart's path on CPU tensors: ops.matmul and ops.attention log
    the configs the Deployment's trees name."""
    rt = KernelRuntime()
    rt.install(Deployment.from_blob(deployment.to_blob()))
    rt.set_selection_logging(True)
    with rt.activate():
        ops.matmul(torch.ones(512, 784), torch.ones(784, 512))
        ops.matmul(torch.ones(1, 4096), torch.ones(4096, 512))
        q = torch.randn(1, 4, 128, 64)
        ops.attention(q, q, q)
        k = torch.randn(1, 4, 300, 128)
        ops.attention(torch.randn(1, 4, 1, 128), k, k)
    assert rt.selection_log() == [
        ("matmul", (512, 784, 512, 1), deployment.select_matmul(512, 784, 512, 1)),
        ("matmul", (1, 4096, 512, 1), deployment.select_matmul(1, 4096, 512, 1)),
        ("attention", (128, 128, 64), deployment.select_attention(128, 128, 64)),
        ("attention", (1, 300, 128), deployment.select_attention(1, 300, 128)),
    ]
    assert mm.total_launches() == 0 and at.total_launches() == 0


def test_families_registry():
    assert families.family_names()[:1] == ["matmul"]
    for name in ("matmul", "attention", "wkv", "ssm_scan"):
        assert families.is_registered(name)
    assert families.get_family("attention").device_sensitive  # the card's own table
    assert not jax_families.get_family("attention").device_sensitive  # one TPU model per fleet
    assert families.get_family("attention").feature_names == jax_families.get_family("attention").feature_names
    for name in ("wkv", "ssm_scan"):
        fam = families.get_family(name)
        assert fam.feature_names == jax_families.get_family(name).feature_names
        np.testing.assert_array_equal(fam.features([(128, 64), (1, 1600)]),
                                      jax_families.get_family(name).features([(128, 64), (1, 1600)]))
        # Harvested as the reference harvests; measured on the card only; device-sensitive.
        assert fam.harvest(None) == jax_families.get_family(name).harvest(None)
        assert fam.device_sensitive and fam.model_matrix is not None
        with pytest.raises(RuntimeError, match="CUDA device"):
            fam.perf_matrix([(128, 64)], fam.config_space(), None)
    with pytest.raises(KeyError):
        families.get_family("nope")


@pytest.mark.parametrize("family", ["wkv", "ssm_scan"])
def test_asking_for_an_unmeasured_family_raises(tables, family):
    """A family's table is measured on the card: with none, tuning it raises
    (nothing falls back to a model or to the CPU)."""
    _, port = tables
    with pytest.raises(RuntimeError, match="CUDA device"):
        pipeline.tune_dataset(port, n_kernels=4, families=[family])


def test_measuring_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        gpubench.measure_matmul([(8, 8, 8, 1)], mm.config_space())
    with pytest.raises(RuntimeError, match="CUDA device"):
        gpubench.measure_attention([(8, 8, 64)], at.config_space())
    from repro_torch.kernels import ssm, wkv

    with pytest.raises(RuntimeError, match="CUDA device"):
        gpubench.measure_wkv([(1, 64)], wkv.config_space())
    with pytest.raises(RuntimeError, match="CUDA device"):
        gpubench.measure_ssm([(2048, 1600)], ssm.config_space())
    with pytest.raises(ValueError, match="CUDA device"):
        gpubench.measure("wkv", [(1, 64)], wkv.config_space(), device="cpu")
    assert set(gpubench._MEASURE) == {"matmul", "attention", "wkv", "ssm_scan"}
    with pytest.raises(ValueError, match="CUDA device"):
        gpubench.measure_matmul([(8, 8, 8, 1)], mm.config_space(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tuner.tune_for_archs(["granite-8b"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        pipeline.run_family_pipeline("attention", ["granite-8b"])
    assert gpubench.attention_flops(4096, 4096, 128, 32) == 2 * 4096 * 4096 * 128 * 32
    assert gpubench.attention_flops(1, 4096, 128) == 4 * 4096 * 128


@pytest.mark.parametrize("problem,rows", [
    ((1, 4096, 4096, 128), 128),  # a decode step at batch 128: the 128-row GEMM ops.matmul launches
    ((1, 1600, 320, 1), 1),
    ((512, 4096, 14336, 1), 512),
    ((4096, 4096, 4096, 256), 16384),  # cut to the most whole instances under the cap
    ((4096, 64, 4096, 6400), 16384),
    ((32768, 4096, 14336, 32), 32768),  # taller than the cap: one instance
])
def test_matmul_table_rows(problem, rows):
    m, k, n, batch = problem
    assert gpubench.folded_rows(m, batch) == rows
    assert rows % m == 0 and rows <= max(m * batch, 1) and rows <= max(gpubench.FOLD_ROWS, m)


def test_tune_cli_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_cli.main(["--archs", "granite-8b", "--out", str(tmp_path / "d.json")])
    assert not (tmp_path / "d.json").exists()
