"""Device resolution, fleet tuning, cpubench, the launchers' bundle paths and the facade.

``core/devices.py`` is the reference's copy: ``transfer_order``,
``transfer_donor``, ``resolve_device`` and ``REPRO_DEVICE`` detection are held
to the reference over a table of device names.  One difference is by design
and checked as such: a kind starting with ``NVIDIA`` is a GPU in the port.
Fleet tuning runs here for ``host_cpu`` (numpy, ``core/cpubench.py``); a
card entry needs the card and raises without one.
"""
import importlib
import itertools
import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import cpubench, devices, tuner
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.core.dispatch import Deployment
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ssm, wkv
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import tune as tune_cli

jax_devices, jax_cpubench = (importlib.import_module(m) for m in ("repro.core.devices", "repro.core.cpubench"))

CARD = "gpu_nvidia_h100_80gb_hbm3"
NAMES = ["tpu_v2", "tpu_v3", "tpu_v4", "TPU v4i", "tpu_v5e", "TPU v5 lite", "tpu_v5p", "tpu_v6e", "host_cpu", "cpu",
         CARD, "gpu_nvidia_a100_sxm4_80gb", "gpu_amd_mi300x", "tpu_v7x", "weird box"]
AVAILABLE = [
    [CARD, "host_cpu"],
    ["host_cpu"],
    ["tpu_v4", "tpu_v5e"],
    ["tpu_v5e", CARD],
    [CARD],
    ["gpu_nvidia_a100_sxm4_80gb", "tpu_v4", "host_cpu"],
]


@pytest.mark.parametrize("name", NAMES)
def test_canonical_names_and_fallback_chains_equal(name):
    assert devices.canonical_device_name(name) == jax_devices.canonical_device_name(name)
    assert devices.canonical_device_name(name, "gpu") == jax_devices.canonical_device_name(name, "gpu")
    assert devices.fallback_order(name) == jax_devices.fallback_order(name)
    assert devices.FALLBACKS == jax_devices.FALLBACKS and devices.DEVICE_ENV_VAR == jax_devices.DEVICE_ENV_VAR


@pytest.mark.parametrize("available", AVAILABLE)
def test_resolution_and_transfer_equal(available):
    for name in NAMES:
        for strict in (False, True):
            try:
                want = jax_devices.resolve_device(name, available, strict=strict)
            except KeyError:
                with pytest.raises(KeyError):
                    devices.resolve_device(name, available, strict=strict)
            else:
                assert devices.resolve_device(name, available, strict=strict) == want, (name, available)
        assert devices.transfer_donor(name, available) == jax_devices.transfer_donor(name, available)
    for fleet in itertools.permutations(available):
        assert devices.transfer_order(fleet) == jax_devices.transfer_order(fleet)
    assert devices.transfer_order(NAMES) == jax_devices.transfer_order(NAMES)


@pytest.mark.parametrize("env", ["tpu_v4", "TPU v5 lite", "host_cpu", CARD, "gpu_nvidia_a100_sxm4_80gb"])
def test_repro_device_override_equal(env):
    got = devices.detect_device({devices.DEVICE_ENV_VAR: env})
    assert got == jax_devices.detect_device({jax_devices.DEVICE_ENV_VAR: env})
    assert devices.resolve_device(got, [CARD, "host_cpu"]) == jax_devices.resolve_device(got, [CARD, "host_cpu"])


def test_detection_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert devices.detect_device({}) == "host_cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert devices.detect_device({}) == CARD
    assert devices.detect_device({devices.DEVICE_ENV_VAR: "tpu_v5e"}) == "tpu_v5e"  # the override wins


def test_nvidia_kinds_are_gpus_in_the_port():
    """The one difference from the reference: an NVIDIA kind without a platform is a GPU,
    so REPRO_DEVICE may name a card as torch reports it."""
    assert devices.canonical_device_name("NVIDIA H100 80GB HBM3") == CARD
    assert jax_devices.canonical_device_name("NVIDIA H100 80GB HBM3") == "nvidia_h100_80gb_hbm3"
    a100 = devices.detect_device({devices.DEVICE_ENV_VAR: "NVIDIA A100-SXM4-80GB"})
    assert a100 == "gpu_nvidia_a100_sxm4_80gb" and devices.fallback_order(a100) == []
    # no entry and no chain: the same-platform step picks the tuned card, even under strict
    assert devices.resolve_device(a100, [CARD, "host_cpu"], strict=True) == CARD
    assert devices.transfer_donor(a100, [CARD, "host_cpu"]) == CARD


# ---------------------------------------------------------------------------
# cpubench: the reference's numpy source over the port's config space
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (100, 130, 70), (1, 256, 128)])
@pytest.mark.parametrize("cfg", mm.config_space())
def test_blocked_gemm_equals_the_references(m, k, n, cfg):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = cpubench.blocked_gemm(a, b, cfg)
    want = jax_cpubench.blocked_gemm(a, b, importlib.import_module("repro.kernels.matmul").MatmulConfig(**cfg.to_dict()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)


def test_cpu_problems_and_dataset():
    for n, seed in ((8, 0), (24, 0), (5, 3)):
        assert cpubench.cpu_problems(n, seed) == jax_cpubench.cpu_problems(n, seed)
    ds = cpubench.build_cpu_dataset(cpubench.cpu_problems(3))
    assert ds.device == "host_cpu" and ds.source == "measured" and ds.configs == list(mm.config_space())
    assert ds.perf.shape == (3, len(mm.config_space())) and (ds.perf > 0).all()


# ---------------------------------------------------------------------------
# fleet tuning, the launchers and the facade
# ---------------------------------------------------------------------------
def test_host_cpu_fleet_answers_defaults(tmp_path):
    fleet = tuner.tune_fleet(device_names=("host_cpu",), cpu_problems=4, n_kernels=3)
    dep = fleet.bundle.deployments["host_cpu"]
    assert fleet.bundle.devices == ["host_cpu"] and len(dep.configs) == 3 and dep.families == {}
    assert dep.select_wkv(2048, 64) == wkv.DEFAULT_WKV_CONFIG and dep.select_ssm(2048, 1600) == ssm.DEFAULT_SSM_CONFIG
    assert fleet.bundle.meta["families"] == ["matmul", "attention", "ssm_scan", "wkv"]
    assert {"oracle_fraction", "classifier_fraction"} <= set(dep.meta)
    tuner.save_fleet(fleet, tmp_path / "b.json")
    back = DeploymentBundle.load(tmp_path / "b.json")
    assert back.load_errors == [] and back.to_blob() == fleet.bundle.to_blob()


def test_card_entries_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tuner.default_fleet() == ("host_cpu",)
    for names in ((CARD, "host_cpu"), ("tpu_v5e",)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tuner.tune_fleet(device_names=names, cpu_problems=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_cli.main(["--devices", f"{CARD},host_cpu", "--bundle", "unused.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_cli.main(["--bundle", "unused.json"])  # the default fleet holds the card


def test_tune_cli_flags():
    for bad in (["--bundle", "x"] + ["--prune-ratio", "1.5"], ["--devices", "host_cpu", "--out", "x"], [],
                ["--devices", "host_cpu", "--bundle", "x", "--transfer"]):
        with pytest.raises(SystemExit):
            tune_cli.main(bad)
    assert tune_cli._measure_budget("auto") == "auto" and tune_cli._measure_budget("0.3") == 0.3
    with pytest.raises(Exception):
        tune_cli._measure_budget("1.0")


def test_tune_and_serve_clis_on_a_host_cpu_bundle(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(devices.DEVICE_ENV_VAR, raising=False)
    path = tmp_path / "bundle.json"
    fleet = tune_cli.main(["--devices", "host_cpu", "--cpu-problems", "3", "--n-kernels", "3", "--bundle", str(path)])
    out = capsys.readouterr().out
    assert "verified: KernelRuntime" in out and list(fleet.results) == ["host_cpu"]
    blob = json.loads(path.read_text())
    assert blob["version"] == 6 and blob["format"] == "bundle" and set(blob["deployments"]) == {"host_cpu"}
    outs = serve_cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests", "2", "--max-new-tokens", "3",
                           "--max-batch", "2", "--cache-len", "64", "--bundle", str(path)])
    assert [len(o) for o in outs] == [3, 3]
    assert "serving with the 'host_cpu' deployment" in capsys.readouterr().out
    dep_path = tmp_path / "dep.json"
    fleet.bundle.deployments["host_cpu"].save(dep_path)
    outs2 = serve_cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests", "2", "--max-new-tokens", "3",
                            "--max-batch", "2", "--cache-len", "64", "--deployment", str(dep_path)])
    assert outs2 == outs  # the same deployment either way; on the CPU configs change no output
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "hymba-1.5b", "--bundle", str(path), "--deployment", str(dep_path)])
    single = tmp_path / "single.json"
    res = tune_cli.main(["--device", "host_cpu", "--cpu-problems", "3", "--n-kernels", "3", "--out", str(single)])
    assert res.deployment.device == "host_cpu" and res.deployment.families == {}


def test_tune_cli_bundle_and_out_tune_once(tmp_path, monkeypatch):
    """With --bundle and --out the fleet tunes each device once; --out is the fleet's entry."""
    def tuned_again(*a, **k):
        raise AssertionError("tuned a second time")

    monkeypatch.setattr(tune_cli, "tune", tuned_again)
    monkeypatch.setattr(tune_cli, "tune_for_archs", tuned_again)
    b, o = tmp_path / "b.json", tmp_path / "d.json"
    fleet = tune_cli.main(["--devices", "host_cpu", "--cpu-problems", "3", "--n-kernels", "3", "--bundle", str(b),
                           "--out", str(o)])
    assert list(fleet.results) == ["host_cpu"]
    assert Deployment.load(o).to_blob() == DeploymentBundle.load(b).deployments["host_cpu"].to_blob()
    with pytest.raises(SystemExit, match="did not tune"):
        tune_cli.main(["--devices", "host_cpu", "--cpu-problems", "3", "--n-kernels", "3", "--bundle", str(b),
                       "--out", str(o), "--device", "tpu_v4"])


def test_facade(tmp_path):
    jax_all = importlib.import_module("repro").__all__
    assert set(repro_torch.__all__) < set(jax_all)  # the reference's names whose modules the port has
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None
    bundle = repro_torch.tune(devices=("host_cpu",), cpu_problems=3, n_kernels=3)
    assert isinstance(bundle, repro_torch.DeploymentBundle) and bundle.devices == ["host_cpu"]
    bundle.save(tmp_path / "b.json")
    rt = repro_torch.load_bundle(tmp_path / "b.json").runtime(device="host_cpu")
    assert isinstance(rt, repro_torch.KernelRuntime) and rt.active_device() == "host_cpu"
    assert rt.select_matmul_config(512, 784, 512, 16) in bundle.deployments["host_cpu"].configs
    from repro_torch.serve.router import Router

    assert repro_torch.Router is Router  # the fleet router is ported
    assert repro_torch.Objective is repro_torch.serve.Objective
    # The control plane is ported under the reference's names.
    assert importlib.import_module("repro_torch.control").__all__ == importlib.import_module("repro.control").__all__
    from repro_torch import control

    for name in ("ControlPlane", "ControlPlaneClient", "PolicySubscriber", "ArtifactRegistry"):
        assert name in repro_torch.__all__ and getattr(repro_torch, name) is getattr(control, name)
