"""The port's KernelRuntime against the reference's: the same selections give
the same shape-cache counters, LRU evictions, log and epoch behaviour."""
import threading

import pytest

from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.kernels.matmul import DEFAULT_CONFIG as JAX_DEFAULT
from repro_torch.core.runtime import KernelRuntime, current_runtime, default_runtime
from repro_torch.kernels.matmul import DEFAULT_CONFIG, MatmulConfig
from repro_torch.kernels.ops import FixedPolicy


class _Counting:
    def __init__(self, config):
        self.config, self.calls = config, 0

    def select_matmul(self, m, k, n, batch):
        self.calls += 1
        return self.config


PROBLEMS = [(1, 64, 64, 4), (32, 64, 64, 1), (1, 64, 64, 4), (1, 64, 256, 4),
            (32, 64, 64, 1), (7, 9, 11, 1), (1, 64, 64, 4), (32, 64, 64, 1)]


@pytest.mark.parametrize("cap", [1024, 2])
def test_shape_cache_matches_reference(cap):
    rts = {"jax": (JaxRuntime(), _Counting(JAX_DEFAULT)), "torch": (KernelRuntime(), _Counting(DEFAULT_CONFIG))}
    stats = {}
    for name, (rt, pol) in rts.items():
        rt.install(pol)
        rt.set_shape_cache_cap(cap)
        rt.set_selection_logging(True, cap=5)
        for p in PROBLEMS:
            rt.select_matmul_config(*p)
        s = rt.shape_cache_stats()
        stats[name] = (s["hits"], s["misses"], s["size"], s["per_family"], pol.calls,
                       [entry[:2] for entry in rt.selection_log()], rt.policy_epoch())
    assert stats["torch"] == stats["jax"]


def test_install_swaps_policy_and_drops_cache():
    rt = KernelRuntime()
    assert rt.select_matmul_config(1, 2, 3, 1) is None  # no policy: the op runs its default
    rt.install(FixedPolicy())
    assert rt.select_matmul_config(1, 2, 3, 1) == DEFAULT_CONFIG
    epoch = rt.policy_epoch()
    other = FixedPolicy(matmul_config=MatmulConfig(16, 64, 128, "nmk"))
    rt.install(other)
    assert rt.policy_epoch() == epoch + 1 and rt.policy() is other
    assert rt.select_matmul_config(1, 2, 3, 1) == other.matmul_config
    assert rt.shape_cache_stats()["misses"] == 1


def test_activation_is_per_thread_and_nested():
    outer, inner = KernelRuntime(), KernelRuntime()
    seen = []
    with outer.activate():
        with inner.activate():
            assert current_runtime() is inner
            t = threading.Thread(target=lambda: seen.append(current_runtime()))
            t.start()
            t.join(timeout=10)
        assert current_runtime() is outer
    assert not t.is_alive() and seen == [default_runtime()]
    assert current_runtime() is default_runtime()
