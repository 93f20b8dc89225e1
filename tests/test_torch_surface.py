"""The reference's remaining public surface on the port.

  * ``repro_torch.core`` exports the names of ``repro.core.__all__``, each the
    port's object of that name (``families`` and ``normalize`` are the
    functions, as in the reference);
  * ``families()`` lists the registered families in the reference's order,
    and ``build_family_dataset`` gives each of the four families' tables on
    the H100 model over the reference's harvest;
  * the module-level shims of ``kernels/ops.py``: each returns what its
    runtime method returns on the current runtime, the mutators warn
    ``DeprecationWarning`` (the readers do not, as the reference's), and
    ``set_pallas_enabled`` raises ``NotImplementedError``.
"""
import importlib
import warnings

import numpy as np
import pytest

import repro.core as jax_core
import repro.kernels.ops as jax_ops
import repro_torch.core as core
from repro_torch.core.runtime import KernelRuntime, current_runtime, default_runtime, reset_default_runtime
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.kernels.ops import FixedPolicy

families_mod = importlib.import_module("repro_torch.core.families")
jax_families = importlib.import_module("repro.core.families")


def test_core_exports_the_references_names():
    assert sorted(core.__all__) == sorted(jax_core.__all__)
    assert len(core.__all__) == len(set(core.__all__)) == 50
    for name in core.__all__:
        value = getattr(core, name)
        module = getattr(value, "__module__", None)
        assert module is None or module.startswith("repro_torch."), (name, module)
    assert core.families is families_mod.families and core.normalize.__name__ == "normalize"
    assert core.reset_default_runtime is reset_default_runtime


def test_families_in_the_references_order():
    got = core.families()
    assert [f.name for f in got] == [f.name for f in jax_families.families()] == core.family_names()
    assert all(isinstance(f, core.KernelFamily) for f in got)
    assert got[0].name == "matmul"


@pytest.mark.parametrize("family", ["matmul", "attention", "wkv", "ssm_scan"])
def test_build_family_dataset(family):
    """Each family's table on the H100 model: the reference's harvest, the port's config
    space, ``model_matrix``'s predictions, ``source="model"``; by name and by family, and
    over given problems."""
    fam = core.get_family(family)
    ds = core.build_family_dataset(family)
    ref = jax_core.build_family_dataset(family)
    assert ds.problems == ref.problems == fam.harvest(None)
    assert ds.configs == list(fam.config_space())
    assert (ds.source, ds.family, ds.device) == ("model", family, "gpu_nvidia_h100_80gb_hbm3")
    np.testing.assert_array_equal(ds.perf, fam.model_matrix(ds.problems, ds.configs, ds.device))
    assert np.isfinite(ds.perf).all() and (ds.perf > 0).all()
    some = ds.problems[:2]
    sub = core.build_family_dataset(fam, some)
    assert sub.problems == some
    np.testing.assert_array_equal(sub.perf, ds.perf[:2])


def test_the_matmul_family_dataset_is_the_model_dataset():
    """For the GEMM, ``build_family_dataset`` is ``build_model_dataset`` over the same problems."""
    problems = core.synthetic_problems(20)
    a = core.build_family_dataset("matmul", problems)
    b = core.build_model_dataset(problems)
    assert a.configs == b.configs and a.device == b.device
    np.testing.assert_array_equal(a.perf, b.perf)


@pytest.fixture
def rt():
    runtime = KernelRuntime(name="surface")
    with runtime.activate():
        yield runtime


# shim -> (arguments, the runtime method and its arguments, warns)
POLICY = FixedPolicy()
SHIMS = {
    "set_kernel_policy": ((POLICY,), ("install", (POLICY,)), True),
    "get_kernel_policy": ((), ("policy", ()), False),
    "set_kernel_policy_for_device": (("host_cpu", POLICY), ("install_for_device", ("host_cpu", POLICY)), True),
    "device_policies": ((), ("device_policies", ()), False),
    "activate_device": (("host_cpu",), ("activate_device", ("host_cpu",)), True),
    "active_device": ((), ("active_device", ()), False),
    "device_resolution": ((), ("device_resolution", ()), False),
    "clear_device_policies": ((), ("clear_device_policies", ()), True),
    "set_selection_logging": ((True,), ("set_selection_logging", (True,)), True),
    "selection_logging_enabled": ((), ("selection_logging_enabled", ()), False),
    "select_matmul_config": ((64, 128, 256, 1), ("select_matmul_config", (64, 128, 256, 1)), False),
    "select_kernel_config": (("matmul", (32, 64, 128, 1)), ("select_config", ("matmul", (32, 64, 128, 1))), False),
    "select_wkv_config": ((64, 64), ("select_wkv_config", (64, 64)), False),
    "select_ssm_config": ((64, 128), ("select_ssm_config", (64, 128)), False),
    "selection_log": ((), ("selection_log", ()), False),
    "clear_selection_log": ((), ("clear_selection_log", ()), True),
    "shape_cache_stats": ((), ("shape_cache_stats", ()), False),
    "clear_shape_cache": ((), ("clear_shape_cache", ()), True),
    "set_shape_cache_cap": ((64,), ("set_shape_cache_cap", (64,)), True),
    "policy_epoch": ((), ("policy_epoch", ()), False),
}


def test_the_shims_are_the_references():
    assert set(SHIMS) | {"set_pallas_enabled"} == {n for n in jax_ops.__all__ if n not in (
        "KernelPolicy", "FixedPolicy", "attention", "matmul", "ssm_scan", "wkv")}
    assert set(jax_ops.__all__) <= set(ops.__all__)


def _call(name, args, warns):
    if warns:
        with pytest.warns(DeprecationWarning, match=rf"repro_torch\.kernels\.ops\.{name}\(\)"):
            return getattr(ops, name)(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return getattr(ops, name)(*args)


@pytest.mark.parametrize("name", list(SHIMS))
def test_shim_is_its_runtime_method(rt, name):
    """The shim and the method, in the same order on two runtimes set up alike (the current one
    and a twin): same result, same state after."""
    args, (method, margs), warns = SHIMS[name]
    twin = KernelRuntime(name="twin")
    for runtime in (rt, twin):  # a policy for the selections and the device readers to see
        runtime.install_for_device("host_cpu", POLICY)
        runtime.activate_device("host_cpu")
        runtime.set_selection_logging(True)
    got = _call(name, args, warns)
    want = getattr(twin, method)(*margs)
    if name == "device_policies":
        assert got.keys() == want.keys()
    else:
        assert got == want, (got, want)
    assert current_runtime() is rt
    assert rt.policy_epoch() == twin.policy_epoch()
    assert rt.selection_logging_enabled() == twin.selection_logging_enabled()
    assert rt.active_device() == twin.active_device()
    assert len(rt.selection_log()) == len(twin.selection_log())


def test_shims_reach_the_default_runtime():
    """With no runtime active, a shim acts on the process default (the reference's legacy path);
    ``reset_default_runtime`` gives a fresh one."""
    fresh = reset_default_runtime()
    assert default_runtime() is fresh and current_runtime() is fresh
    with pytest.warns(DeprecationWarning):
        ops.set_kernel_policy(POLICY)
    assert fresh.policy() is POLICY and ops.get_kernel_policy() is POLICY
    assert ops.select_matmul_config(64, 128, 256) == DEFAULT_CONFIG
    again = reset_default_runtime()
    assert again is not fresh and again.policy() is None and ops.get_kernel_policy() is None


def test_set_pallas_enabled_has_no_counterpart():
    for enabled in (True, False):
        with pytest.raises(NotImplementedError, match="hand-written kernel"):
            ops.set_pallas_enabled(enabled)
