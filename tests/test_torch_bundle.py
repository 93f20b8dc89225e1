"""The port's DeploymentBundle, device registry and bundle install against the JAX package's.

Both packages read and write the same v1-v6 JSON: each loads the other's v6
bundle with no load errors and the same checksums, a bundle tuned in both
from one shared table serialises to the same JSON, and ``bundle_to_python``
emits the same launcher source.  The port loads the reference's committed
fixtures (``tests/data``) and, on a CPU runtime, makes every selection
``expected_selections.json`` records.  A fixture's TPU configs are not in
the port's compiled space, so installing one for a CUDA target raises; that
is checked with the card's name and type monkeypatched in, no GPU needed.
"""
import copy
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bundle as bundle_mod
from repro_torch.core import codegen, dataset, devices, pipeline
from repro_torch.core.bundle import BundleFormatError, BundleIntegrityError, DeploymentBundle, install_bundle
from repro_torch.core.dispatch import Deployment
from repro_torch.core.runtime import KernelRuntime, uncompiled_configs
from repro_torch.kernels import attention as at
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm, wkv

# The submodules themselves: the package exports the functions of these names, as the reference does.
families = importlib.import_module("repro_torch.core.families")

jax_bundle, jax_codegen, jax_dataset, jax_families, jax_pipeline, jax_attention = (
    importlib.import_module(m) for m in ("repro.core.bundle", "repro.core.codegen", "repro.core.dataset",
                                         "repro.core.families", "repro.core.pipeline", "repro.kernels.attention"))

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = ["dep_v1.json", "dep_v2.json", "bundle_v3.json", "bundle_v4.json", "bundle_v5.json"]
CARD = "gpu_nvidia_h100_80gb_hbm3"
FAMILY = "attn_bundle"


def _expected():
    return json.loads((DATA / "expected_selections.json").read_text())


# ---------------------------------------------------------------------------
# one shared table, tuned in both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shared_tuning():
    """(port bundle, reference bundle): each package tunes the same matmul table and the
    same attention-shaped test family, with config objects of equal values, into a
    two-device bundle (the card's name and host_cpu, two seeds)."""
    full = jax_dataset.build_model_dataset(jax_dataset.synthetic_problems(80, seed=5))
    cols = np.linspace(0, len(full.configs) - 1, 10).astype(int)
    ref_cfgs = [full.configs[i] for i in cols]
    port_cfgs = [mm.MatmulConfig(**c.to_dict()) for c in ref_cfgs]
    perf = np.asarray(full.perf)[:, cols].copy()
    attn_problems = [(sq, skv, d) for sq in (1, 128, 2048) for skv in (2048, 4096) for d in (64, 128)]
    ref_attn = list(jax_attention.attention_config_space()[:6])
    port_attn = [at.AttentionConfig(**c.to_dict()) for c in ref_attn]
    attn_perf = np.asarray(importlib.import_module("repro.core.attnmodel").build_attn_matrix(attn_problems, ref_attn))
    rows = {p: i for i, p in enumerate(attn_problems)}

    def lookup(space):
        return lambda ps, cs, dev: attn_perf[[rows[tuple(p)] for p in ps]][:, [space.index(c) for c in cs]]

    common = dict(name=FAMILY, feature_names=importlib.import_module("repro.core.attnmodel").ATTN_FEATURE_NAMES,
                  harvest=lambda a: attn_problems)
    jax_families.register_family(jax_families.KernelFamily(
        config_cls=type(ref_attn[0]), config_space=lambda: ref_attn, default_config=ref_attn[0],
        features=importlib.import_module("repro.core.attnmodel").attn_problem_features,
        perf_matrix=lookup(ref_attn), policy_attr="select_attention", problem_arity=3, reference="test", **common))
    families.register_family(families.KernelFamily(
        config_cls=at.AttentionConfig, config_space=lambda: port_attn, default_config=port_attn[0],
        features=importlib.import_module("repro_torch.core.attnmodel").attn_problem_features,
        perf_matrix=lookup(port_attn), **common))
    out = []
    for pkg_pipeline, pkg_dataset, cfgs, bundle_cls in (
            (pipeline, dataset, port_cfgs, DeploymentBundle),
            (jax_pipeline, jax_dataset, ref_cfgs, jax_bundle.DeploymentBundle)):
        deps = {}
        for device, seed in ((CARD, 0), ("host_cpu", 1)):
            ds = pkg_dataset.TuningDataset(device=device, problems=list(full.problems), configs=cfgs, perf=perf)
            res = pkg_pipeline.tune_dataset(ds, n_kernels=4, seed=seed, families=[FAMILY])
            fam = res.family_results[FAMILY]
            res.deployment.set_family_tuning("attention", fam.configs, fam.tree)  # equal values in both
            deps[device] = res.deployment
        out.append(bundle_cls(deployments=deps, meta={"archs": "synthetic"}))
    yield tuple(out)
    jax_families.unregister_family(FAMILY)
    families.unregister_family(FAMILY)


def test_bundles_tuned_in_both_packages_serialise_equal(shared_tuning, tmp_path):
    port, ref = shared_tuning
    assert json.dumps(port.to_blob(), sort_keys=True) == json.dumps(ref.to_blob(), sort_keys=True)
    port.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    blob = port.to_blob()
    assert blob["version"] == 6 and blob["format"] == "bundle" and set(blob["deployments"]) == {CARD, "host_cpu"}
    assert f"deployments.{CARD}.families.{FAMILY}" in blob["checksums"] and "provenance" in blob["checksums"]


def test_each_package_loads_the_others_v6_bundle(shared_tuning, tmp_path):
    port, ref = shared_tuning
    port.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    by_ref = jax_bundle.DeploymentBundle.load(tmp_path / "port.json")
    by_port = DeploymentBundle.load(tmp_path / "ref.json")
    assert by_ref.load_errors == [] and by_port.load_errors == []
    sums = json.loads((tmp_path / "port.json").read_text())["checksums"]
    assert by_ref.to_blob()["checksums"] == sums == by_port.to_blob()["checksums"]
    assert json.dumps(by_port.to_blob(), sort_keys=True) == json.dumps(by_ref.to_blob(), sort_keys=True)
    assert by_port.provenance() == port.provenance()


def test_bundle_to_python_is_the_references(shared_tuning):
    port, ref = shared_tuning
    got, want = codegen.bundle_to_python(port), jax_codegen.bundle_to_python(ref)
    assert got == want
    ns = {}
    exec(got, ns)
    feats = dataset.problem_features([(512, 784, 512, 16)])[0]
    assert ns["select_kernel"](CARD, *feats) == int(port.deployments[CARD].classifier.predict(feats[None])[0])


# ---------------------------------------------------------------------------
# the reference's committed fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixtures_load_and_select_as_recorded(fixture):
    exp = _expected()
    bundle = DeploymentBundle.load(DATA / fixture)
    ref = jax_bundle.DeploymentBundle.load(DATA / fixture)
    assert bundle.load_errors == [] and bundle.devices == ref.devices
    for device in bundle.devices:
        rt = KernelRuntime()
        dep = rt.install_bundle(bundle, device)  # a TPU name: a CPU target, selections only
        assert rt.active_device() == device and dep is bundle.deployments[device]
        got_m = [rt.select_matmul_config(*p).to_dict() for p in exp["matmul_probes"]]
        got_a = [rt.select_attention_config(*p).to_dict() for p in exp["attention_probes"]]
        if fixture == "bundle_v5.json":  # tuned after the recorded selections: the reference's own
            ref_dep = ref.deployments[device]
            want = {"matmul": [ref_dep.select_matmul(*p).to_dict() for p in exp["matmul_probes"]],
                    "attention": [ref_dep.select_attention(*p).to_dict() for p in exp["attention_probes"]]}
            for fam, probes in (("wkv", [(1, 64), (2048, 64), (32768, 64)]),
                                ("ssm_scan", [(2048, 1600), (32768, 1600)])):
                select = rt.select_wkv_config if fam == "wkv" else rt.select_ssm_config
                if ref_dep.family_tuning(fam).configs:
                    want_fam = [ref_dep.select(fam, p).to_dict() for p in probes]
                else:  # untuned in the fixture: each package answers its own default
                    want_fam = [families.get_family(fam).default_config.to_dict()] * len(probes)
                assert [select(*p).to_dict() for p in probes] == want_fam, (fam, device)
        else:
            want = exp["devices"][device]
        assert got_m == want["matmul"] and got_a == want["attention"], (fixture, device)
        if fixture in ("dep_v1.json", "dep_v2.json", "bundle_v3.json", "bundle_v4.json"):
            # pre-family artifacts serve the port's defaults for the new families
            assert rt.select_wkv_config(4096, 64) == wkv.DEFAULT_WKV_CONFIG
            assert rt.select_ssm_config(2048, 1600) == ssm.DEFAULT_SSM_CONFIG
    if fixture == "bundle_v5.json":
        for device in bundle.devices:
            got, want = bundle.deployments[device], ref.deployments[device]
            for fam in ("wkv", "ssm_scan"):
                assert [c.to_dict() for c in got.family_tuning(fam).configs] == [
                    c.to_dict() for c in want.family_tuning(fam).configs]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_truncated_fixture_raises_structured_error(tmp_path, fixture):
    text = (DATA / fixture).read_text()
    (tmp_path / "cut.json").write_text(text[: len(text) // 2])
    with pytest.raises(BundleFormatError) as got:
        DeploymentBundle.load(tmp_path / "cut.json")
    with pytest.raises(jax_bundle.BundleFormatError) as want:
        jax_bundle.DeploymentBundle.load(tmp_path / "cut.json")
    assert got.value.offset == want.value.offset and got.value.section == want.value.section
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("mangle", ["deployments", "version", "configs"])
def test_mangled_sections_name_the_section(mangle):
    blob = json.loads((DATA / "bundle_v5.json").read_text())
    if mangle == "deployments":
        blob["deployments"] = []
    elif mangle == "version":
        blob["version"] = "six"
    else:
        del blob["deployments"]["tpu_v4"]["configs"]
    with pytest.raises(BundleFormatError) as got:
        DeploymentBundle.from_blob(copy.deepcopy(blob))
    with pytest.raises(jax_bundle.BundleFormatError) as want:
        jax_bundle.DeploymentBundle.from_blob(copy.deepcopy(blob))
    assert got.value.section == want.value.section


def test_future_version_is_refused():
    blob = json.loads((DATA / "bundle_v5.json").read_text())
    blob["version"] = 7
    with pytest.raises(BundleFormatError, match="newer"):
        DeploymentBundle.from_blob(blob)


# ---------------------------------------------------------------------------
# v6 checksums: corruption is contained per section, as in the reference
# ---------------------------------------------------------------------------
def _corrupt(blob, where):
    blob = copy.deepcopy(blob)
    if where == "family":
        blob["deployments"][CARD]["families"][FAMILY]["configs"][0]["block_q"] += 1
    elif where == "device":
        blob["deployments"][CARD]["classifier_name"] = "tampered"
    elif where == "provenance":
        blob["provenance"][CARD]["train_distribution"]["n_problems"] += 1
    elif where == "all":
        for dev in blob["deployments"]:
            blob["deployments"][dev]["classifier_name"] = "tampered"
    elif where == "missing_family":
        del blob["deployments"][CARD]["families"][FAMILY]
    return blob


@pytest.mark.parametrize("where", ["family", "device", "provenance", "missing_family"])
def test_v6_corruption_is_contained_as_in_the_reference(shared_tuning, where):
    port, _ = shared_tuning
    bad = _corrupt(port.to_blob(), where)
    got = DeploymentBundle.from_blob(copy.deepcopy(bad))
    want = jax_bundle.DeploymentBundle.from_blob(copy.deepcopy(bad))
    assert got.load_errors == want.load_errors and got.load_errors
    assert got.devices == want.devices
    if where == "device":
        assert got.devices == ["host_cpu"]
        assert got.deployment_for(CARD)[1] == "host_cpu"  # a dropped device recovers through resolution
    if where in ("family", "missing_family"):
        assert FAMILY not in got.deployments[CARD].families and FAMILY in got.deployments["host_cpu"].families


def test_v6_every_device_corrupt_raises(shared_tuning):
    port, _ = shared_tuning
    with pytest.raises(BundleIntegrityError):
        DeploymentBundle.from_blob(_corrupt(port.to_blob(), "all"))


# ---------------------------------------------------------------------------
# install: the registry, the epoch, and the CUDA target's check
# ---------------------------------------------------------------------------
def _as_card(monkeypatch):
    monkeypatch.delenv(devices.DEVICE_ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")


def test_cuda_install_of_a_tpu_bundle_raises(monkeypatch):
    _as_card(monkeypatch)
    assert devices.detect_device() == CARD
    rt = KernelRuntime()
    epoch = rt.policy_epoch()
    with pytest.raises(ValueError, match="compiled space") as err:
        rt.install_bundle(DATA / "bundle_v5.json")
    assert "mm_bm512_bn512_bk2048" in str(err.value)  # the configs are named
    assert rt.device_policies() == {} and rt.policy_epoch() == epoch  # the registry is untouched
    with pytest.raises(ValueError, match="compiled space"):
        install_bundle(DATA / "bundle_v5.json", runtime=KernelRuntime())
    # Explicitly a CPU target: selections only, the install goes through.
    dep = KernelRuntime().install_bundle(DATA / "bundle_v5.json", target="cpu")
    assert dep.device in ("tpu_v4", "tpu_v5e")
    # A TPU name asks for a CPU target unless told otherwise.
    with pytest.raises(ValueError, match="compiled space"):
        KernelRuntime().install_bundle(DATA / "bundle_v5.json", "tpu_v4", target="cuda")


def test_cuda_activate_of_an_uncompiled_policy_raises():
    rt = KernelRuntime()
    rt.install_for_device(CARD, Deployment(device=CARD, configs=[mm.MatmulConfig(256, 256, 512)], classifier=None))
    rt.install_for_device("host_cpu", Deployment(device="host_cpu", configs=[mm.DEFAULT_CONFIG], classifier=None))
    with pytest.raises(ValueError, match="mm_bm256_bn256_bk512"):
        rt.activate_device(CARD)
    assert rt.active_device() is None
    assert rt.activate_device(CARD, target="cpu") == CARD
    assert rt.activate_device("host_cpu") == "host_cpu"


def test_compiled_deployments_install_on_the_card(shared_tuning, monkeypatch):
    _as_card(monkeypatch)
    space = Deployment(device=CARD, configs=list(mm.config_space()[:3]), classifier=None)
    space.set_family_tuning("wkv", [wkv.WkvConfig(32)], None)
    space.set_family_tuning("ssm_scan", [ssm.SsmConfig(8, 16)], None)
    assert uncompiled_configs(space) == {}
    b = DeploymentBundle({CARD: space, "host_cpu": Deployment(device="host_cpu", configs=[mm.MatmulConfig(1, 1, 1)],
                                                              classifier=None)})
    rt = b.runtime()
    assert rt.active_device() == CARD and rt.device_resolution() == (CARD, CARD)
    assert rt.select_wkv_config(128, 64) == wkv.WkvConfig(32) and rt.select_ssm_config(64, 1600) == ssm.SsmConfig(8, 16)
    # The reference's fixtures carry uncompiled configs in every family they tune.
    bad = uncompiled_configs(DeploymentBundle.load(DATA / "bundle_v5.json").deployments["tpu_v5e"])
    assert set(bad) >= {"matmul", "attention"}


def test_registry_semantics_and_epochs():
    a = Deployment(device="tpu_v4", configs=[mm.DEFAULT_CONFIG], classifier=None)
    b = Deployment(device="tpu_v5e", configs=[mm.config_space()[0]], classifier=None)
    rt = KernelRuntime()
    e0 = rt.policy_epoch()
    rt.install_for_device("TPU v4", a)  # canonicalized; registering alone activates nothing
    assert rt.device_policies() == {"tpu_v4": a} and rt.active_device() is None and rt.policy_epoch() == e0
    assert rt.activate_device("tpu_v5p") == "tpu_v4"  # the FALLBACKS chain
    assert rt.device_resolution() == ("tpu_v5p", "tpu_v4") and rt.policy() is a and rt.policy_epoch() == e0 + 1
    rt.install_for_device("tpu_v4", b)  # the live device: replaced in place, epoch moved
    assert rt.policy() is b and rt.policy_epoch() == e0 + 2
    rt.clear_device_policies()
    assert rt.policy() is None and rt.active_device() is None and rt.policy_epoch() == e0 + 3
    with pytest.raises(KeyError):
        rt.activate_device("tpu_v4")
    rt.install(a)  # a manual install is not registry-owned
    rt.clear_device_policies()
    assert rt.policy() is a


def test_install_bundle_moves_the_epoch_and_replaces_the_registry(shared_tuning):
    port, _ = shared_tuning
    rt = KernelRuntime()
    rt.install_for_device("tpu_v4", Deployment(device="tpu_v4", configs=[mm.DEFAULT_CONFIG], classifier=None))
    e0 = rt.policy_epoch()
    dep = rt.install_bundle(port, "host_cpu")
    assert dep is port.deployments["host_cpu"] and set(rt.device_policies()) == {CARD, "host_cpu"}
    assert rt.policy_epoch() > e0 and rt.active_device() == "host_cpu"
    with pytest.raises(KeyError):
        rt.install_bundle(port, "tpu_v4", strict=True)  # no TPU entry, and strict crosses no platform
    assert rt.active_device() == "host_cpu"


def test_serve_deployment_outside_the_compiled_space_raises_on_a_cuda_model():
    """``launch.serve``'s ``--deployment`` path checks the configs as a bundle's install does:
    the reference's TPU tiles fail at install on a CUDA model, not at a launch inside a capture;
    on a CPU model they are selections only."""
    import types

    from repro_torch.launch import serve as serve_cli
    from _torch_parity import reduced_pair

    dep = Deployment.load(DATA / "dep_v2.json")
    assert uncompiled_configs(dep)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))  # no GPU needed: the check raises first
    for given in (DATA / "dep_v2.json", dep):
        with pytest.raises(ValueError, match="compiled space"):
            serve_cli.build_engine(on_card, None, deployment=given)
    _, _, model, params = reduced_pair("granite-8b")
    eng = serve_cli.build_engine(model, params, deployment=DATA / "dep_v2.json", max_batch=2, cache_len=64)
    assert eng.runtime.select_matmul_config(512, 784, 512, 16) in dep.configs


def test_engine_consumes_a_bundle_and_rebuilds_programs(shared_tuning, monkeypatch):
    from repro_torch.launch import serve as serve_cli
    from _torch_parity import reduced_pair

    port, _ = shared_tuning
    monkeypatch.delenv(devices.DEVICE_ENV_VAR, raising=False)
    _, _, model, params = reduced_pair("rwkv6-7b")
    eng = serve_cli.build_engine(model, params, bundle=port, max_batch=2, cache_len=64)
    assert eng.device == "host_cpu" and eng.deployment is port.deployments["host_cpu"]  # detected: no card here
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    eng.drain()
    built = len(eng.program_log)
    eng.runtime.activate_device(CARD, target="cpu")  # another entry goes live: every program is built again
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    eng.drain()
    assert len(eng.program_log) > built and eng.program_log[-1].epoch == eng.runtime.policy_epoch()
    monkeypatch.setenv(devices.DEVICE_ENV_VAR, "NVIDIA A100-SXM4-80GB")
    eng2 = serve_cli.build_engine(model, params, bundle=port, max_batch=2, cache_len=64)
    assert eng2.device == CARD  # an untuned card resolves to the tuned one by platform
    assert bundle_mod.BUNDLE_VERSION == jax_bundle.BUNDLE_VERSION == 6
