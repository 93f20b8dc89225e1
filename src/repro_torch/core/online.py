"""Online (dynamic) kernel selection, the paper's §2.2 comparison point.

Ported from ``repro/core/online.py``.  cuDNN-launcher-style autotuning:
measure candidate kernels the first time a problem shape appears at run
time, then commit to the winner for the rest of the process lifetime.

  * :class:`OnlinePolicy` wraps any deployment (or the full config space) and
    implements the ``KernelPolicy`` protocol;
  * the first ``n_trials`` encounters of a shape bucket measure different
    candidates (explore), after which the best-measured config is committed;
  * the measurement hook makes it testable without hardware:
    :func:`cuda_event_measure` is the card's, timing ``matmul_cuda`` at the
    arm's config with CUDA events (``core/gpubench.py::time_ms``).

The hybrid mode, exploring only among the *deployed* subset the offline
pipeline chose, takes the classifier as the prior and corrects residual
mispredictions at the cost of a bounded warm-up.

A measurement launches and synchronizes, so it cannot run while a stream
captures a CUDA graph: :func:`cuda_event_measure` raises there.  An
``OnlinePolicy`` serves direct ``ops.*`` calls and the eager engine
(``cuda_graphs=False``).  Under a serving objective it pauses exploration
(``select_for_objective``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, defaultdict
from typing import Callable, Sequence

from ..kernels.matmul import MatmulConfig, config_space


def shape_bucket(problem: tuple[int, ...]) -> tuple[int, ...]:
    """log2 shape bucket: nearby shapes share measurements (paper's regimes).

    Shared vocabulary of the telemetry pipeline: ``core.retune`` keys its
    traffic histograms and drift detection on the same buckets.
    """
    return tuple(max(int(v), 1).bit_length() for v in problem)


_bucket = shape_bucket  # the reference's private name


@dataclasses.dataclass
class _Arm:
    config: MatmulConfig
    trials: int = 0
    total_time: float = 0.0

    @property
    def mean(self) -> float:
        return self.total_time / self.trials if self.trials else float("inf")


class OnlinePolicy:
    """Explore-then-commit online kernel selection (KernelPolicy protocol).

    ``measure(problem, config) -> seconds`` supplies timings: a real timer on
    the card (:func:`cuda_event_measure`), an analytic model in tests.
    ``candidates`` defaults to the full config space (pure dynamic tuning);
    pass a deployment's configs for the hybrid offline-prior + online-
    correction mode.
    """

    # Exploration is stateful (repeated calls for the same shape must reach
    # different arms), so the runtime's shape cache must not memoize us; the
    # per-bucket ``_committed`` dict is this policy's own fast path.
    cacheable = False

    def __init__(
        self,
        measure: Callable[[tuple, MatmulConfig], float],
        candidates: Sequence[MatmulConfig] | None = None,
        *,
        trials_per_arm: int = 1,
        prior: object | None = None,  # optional Deployment for the first guess
    ):
        self.measure = measure
        self.candidates = list(candidates if candidates is not None else config_space())
        self.trials_per_arm = trials_per_arm
        self.prior = prior
        self._arms: dict[tuple, list[_Arm]] = {}
        self._committed: dict[tuple, MatmulConfig] = {}
        self._attn_cache: OrderedDict[tuple, object] = OrderedDict()  # LRU, bounded
        self._attn_cache_cap = 1024
        self.stats = defaultdict(int)  # 'explore' / 'commit' counters

    # -- KernelPolicy ---------------------------------------------------------
    def select_matmul(self, m: int, k: int, n: int, batch: int) -> MatmulConfig:
        problem = (m, k, n, batch)
        b = _bucket(problem)
        if b in self._committed:
            self.stats["commit"] += 1
            return self._committed[b]
        arms = self._arms.get(b)
        if arms is None:
            # The prior's pick is measured first: if the exploration budget is
            # cut short, the offline prediction leads.
            cands = list(self.candidates)
            if self.prior is not None:
                first = self.prior.select_matmul(*problem)
                if first in cands:
                    cands.remove(first)
                    cands.insert(0, first)
            arms = [_Arm(c) for c in cands]
            self._arms[b] = arms
        for arm in arms:
            if arm.trials < self.trials_per_arm:
                self.stats["explore"] += 1
                arm.total_time += self.measure(problem, arm.config)
                arm.trials += 1
                if all(a.trials >= self.trials_per_arm for a in arms):
                    best = min(arms, key=lambda a: a.mean)
                    self._committed[b] = best.config
                return arm.config
        best = min(arms, key=lambda a: a.mean)
        self._committed[b] = best.config
        self.stats["commit"] += 1
        return best.config

    def select_attention(self, sq: int, skv: int, d: int):
        key = (sq, skv, d)
        got = self._attn_cache.get(key)
        if got is not None:
            self._attn_cache.move_to_end(key)
            return got
        if self.prior is not None:
            cfg = self.prior.select_attention(sq, skv, d)
        else:
            from ..kernels.attention import DEFAULT_ATTN_CONFIG

            cfg = DEFAULT_ATTN_CONFIG
        self._attn_cache[key] = cfg
        if len(self._attn_cache) > self._attn_cache_cap:
            self._attn_cache.popitem(last=False)
        return cfg

    def select_wkv(self, s: int, hd: int):
        """Prior passthrough (online exploration is matmul-only)."""
        return self._prior_family_select("wkv", "select_wkv", (s, hd))

    def select_ssm(self, s: int, d: int):
        return self._prior_family_select("ssm_scan", "select_ssm", (s, d))

    def _prior_family_select(self, family: str, attr: str, problem: tuple):
        meth = getattr(self.prior, attr, None) if self.prior is not None else None
        if meth is not None:
            return meth(*problem)
        from .families import get_family

        return get_family(family).default_config

    def select_for_objective(self, family: str, problem: tuple, objective):
        """SLO-aware selection: exploration pauses under a latency target.

        A constrained selection serves the best *measured* arm of the bucket
        (committed or mid-exploration leader); buckets with no evidence yet
        defer to the prior's objective-aware pick (or its plain selection).
        Measurements resume once the objective is lifted.
        """
        problem = tuple(problem)
        if family == "matmul":
            b = _bucket(problem)
            hit = self._committed.get(b)
            if hit is not None:
                self.stats["slo_commit"] += 1
                return hit
            measured = [a for a in self._arms.get(b, []) if a.trials > 0]
            if measured:
                self.stats["slo_commit"] += 1
                return min(measured, key=lambda a: a.mean).config
            if self.prior is not None:
                slo = getattr(self.prior, "select_for_objective", None)
                if slo is not None:
                    return slo(family, problem, objective)
                return self.prior.select_matmul(*problem)
            return self.candidates[0]
        if self.prior is not None:
            slo = getattr(self.prior, "select_for_objective", None)
            if slo is not None:
                return slo(family, problem, objective)
        if family == "attention":
            return self.select_attention(*problem)
        from .runtime import POLICY_ATTR

        return self._prior_family_select(family, POLICY_ATTR[family], problem)

    # -- continuous tuning ----------------------------------------------------
    def set_prior(self, prior: object | None) -> None:
        """Hot-swap the offline prior (a new :class:`Deployment` from retune).

        The attention cache holds the previous prior's answers, so it is
        dropped; matmul arm measurements are kept (real timings, still valid
        evidence): only unexplored buckets pick up the new prior's ordering.
        """
        self.prior = prior
        self._attn_cache.clear()

    def measurements(self) -> dict[tuple, list[tuple[MatmulConfig, float, int]]]:
        """Per-bucket measured arms: ``{bucket: [(config, mean_s, trials)]}``
        (folded into a telemetry snapshot by ``core.retune``)."""
        out: dict[tuple, list[tuple[MatmulConfig, float, int]]] = {}
        for b, arms in self._arms.items():
            rows = [(a.config, a.mean, a.trials) for a in arms if a.trials > 0]
            if rows:
                out[b] = rows
        return out

    # -- introspection ---------------------------------------------------------
    def warmup_cost(self) -> float:
        """Total seconds spent in exploration measurements so far."""
        return sum(a.total_time for arms in self._arms.values() for a in arms)

    def committed(self) -> dict[tuple, MatmulConfig]:
        return dict(self._committed)


def wall_clock_measure(run: Callable[[], None], reps: int = 3) -> float:
    """Median wall time of ``run``: a host-clock measurement hook."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def cuda_event_measure(device=None, *, n_runs: int = 5, seed: int = 0):
    """The card's ``measure(problem, config) -> seconds`` for :class:`OnlinePolicy`.

    Times ``matmul_cuda`` at ``config`` on the GEMM ``ops.matmul`` launches for
    ``(m, k, n, batch)``, ``(m * batch, k) @ (k, n)`` in bf16, with CUDA events
    (``gpubench.time_ms``: ``n_runs`` calls after a warm-up, each queued
    behind a device sleep; the median).  Inputs are made once per problem.
    Raises while the current stream captures a CUDA graph: a measurement
    launches and synchronizes.
    """
    import torch

    from ..kernels.matmul import matmul_cuda
    from .gpubench import CARD_LOCK, _cuda_device, time_ms

    dev = _cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs: dict[tuple, tuple] = {}

    def measure(problem: tuple, config: MatmulConfig) -> float:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("OnlinePolicy cannot measure while a CUDA graph is being captured: a measurement "
                               "launches and synchronizes; serve it through direct ops calls or an engine with "
                               "cuda_graphs=False")
        m, k, n, batch = problem
        with CARD_LOCK:  # never inside another thread's capture (gpubench's docstring)
            if problem not in inputs:
                inputs[problem] = (torch.randn((m * batch, k), device=dev, generator=gen, dtype=torch.bfloat16),
                                   torch.randn((k, n), device=dev, generator=gen, dtype=torch.bfloat16))
            a, b = inputs[problem]
            return time_ms(lambda _i: matmul_cuda(a, b, config), n_runs=n_runs) * 1e-3

    return measure
