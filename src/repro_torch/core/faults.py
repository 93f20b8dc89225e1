"""Fault containment: deterministic chaos injection and the failure-model types.

Ported from ``repro/core/faults.py`` (DESIGN.md §11 of the reference):

  * :class:`FaultPlan`: a seeded, runtime-scoped fault-injection registry.
    A plan is attached to one :class:`~repro_torch.core.runtime.KernelRuntime`
    (``rt.set_fault_plan(plan)``) and fires *deterministically* at named
    sites: kernel compile errors, simulated OOM, NaN/Inf output corruption,
    latency spikes, and corrupt bundle bytes.  Every firing is recorded in
    ``plan.events``.  A plan parsed from the same text with the same seed
    fires on the same calls as the reference's.
  * Structured fault types (:class:`FaultError` and friends) that the ops
    guard, the serving engine and the bundle loader agree on, and
    :data:`GUARDED_EXCEPTIONS`, what the guard may contain.
  * The incident record schema (:func:`incident`) shared by the guard and
    the engine's health state machine.
  * :class:`PreemptionGuard` and :class:`StragglerDetector`, and
    :func:`elastic_plan`, the resume plan after the fleet resizes.

Sites are dotted names; the registered injection points are::

    dispatch.<family>    ops-layer guarded kernel execution (per dispatch)
    canary.<family>      retune canary's numeric-agreement probe
    retune.candidate     incremental_retune output (degrade the candidate)
    bundle.load          bundle text corruption at install time
    engine.prefill       whole-program prefill run (engine-level retry)
    engine.decode        whole-program decode run (engine-level retry)

Determinism: a spec fires on its matching-call counter (``after`` skips, then
``times`` firings): no wall clock, no global RNG.  ``p < 1`` draws from the
plan's own seeded generator, so a given (seed, call sequence) always injects
the same faults.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from collections import deque

import numpy as np
import torch

from ..kernels._build import KernelBuildError, KernelLaunchError

__all__ = [
    "FAULT_KINDS",
    "ElasticPlan",
    "FaultError",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "GUARDED_EXCEPTIONS",
    "InjectedCompileError",
    "InjectedOOMError",
    "NonFiniteOutputError",
    "PreemptionGuard",
    "StragglerDetector",
    "elastic_plan",
    "incident",
]


# ---------------------------------------------------------------------------
# fault types (what the guard catches and what injection raises)
# ---------------------------------------------------------------------------
class FaultError(RuntimeError):
    """Base class for injected (and injection-shaped) kernel faults."""


class InjectedCompileError(FaultError):
    """Simulated compile failure for one kernel config."""


class InjectedOOMError(FaultError):
    """Simulated out-of-memory: the config's tiles do not fit this device."""


class NonFiniteOutputError(FaultError):
    """A guarded kernel call produced NaN/Inf on an output outside a program."""


GUARDED_EXCEPTIONS: tuple[type[BaseException], ...] = (
    FaultError,
    getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError),
    KernelBuildError,
    KernelLaunchError,
)
"""What the dispatch guard contains: injected faults, an allocator's out of
memory, and the kernels' typed build and launch errors.  Not every
``RuntimeError``: a ``TypeError`` / ``ValueError`` is a caller bug the other
config would reproduce, as in the reference.  Sticky CUDA errors (an illegal
address, which ``torch.AcceleratorError`` carries) stay out too: they poison
the CUDA context, so no retry in the same process can contain them."""

FAULT_KINDS = ("compile_error", "oom", "nan", "inf", "latency", "corrupt")


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FaultSpec:
    """One deterministic injection rule.

    ``site`` is the dotted injection point (exact match, or a prefix when it
    ends with ``.``); ``match`` optionally restricts firing to context keys
    (config names, device slugs) containing the substring.  The spec skips
    its first ``after`` matching calls, then fires ``times`` times (``None``
    = unlimited), each firing subject to probability ``p`` from the plan's
    seeded generator.  ``value`` parameterizes the kind (sleep seconds for
    ``latency``, corrupted-character count for ``corrupt``).
    """

    site: str
    kind: str
    times: int | None = 1
    after: int = 0
    p: float = 1.0
    match: str | None = None
    value: float = 0.0
    # mutable firing state (owned by the plan's lock)
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One firing of one spec (the plan's audit record)."""

    seq: int
    site: str
    kind: str
    key: str


class FaultPlan:
    """Seeded, deterministic fault-injection schedule for one runtime.

    Thread-safe: firing counters and the event log are lock-protected.  The
    plan is inert until attached to a runtime (``rt.set_fault_plan(plan)``).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._seq = 0
        self.events: list[FaultEvent] = []

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, specs={len(self._specs)}, "
                f"fired={len(self.events)})")

    # -- authoring -----------------------------------------------------------
    def inject(self, site: str, kind: str, *, times: int | None = 1, after: int = 0,
               p: float = 1.0, match: str | None = None, value: float = 0.0) -> FaultSpec:
        """Register one injection rule; returns the live spec (counters visible)."""
        spec = FaultSpec(site=site, kind=kind, times=times, after=after, p=p,
                         match=match, value=value)
        with self._lock:
            self._specs.append(spec)
        return spec

    @staticmethod
    def parse(text: str, *, seed: int = 0) -> "FaultPlan":
        """Build a plan from a compact CLI spec string.

        ``"site:kind[:times[:after]]"`` entries joined by ``,``, e.g.
        ``"dispatch.matmul:nan:2,engine.prefill:compile_error:1:3"``.
        """
        plan = FaultPlan(seed=seed)
        for entry in filter(None, (e.strip() for e in text.split(","))):
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault spec {entry!r} (want site:kind[:times[:after]])")
            site, kind = parts[0], parts[1]
            times = int(parts[2]) if len(parts) > 2 else 1
            after = int(parts[3]) if len(parts) > 3 else 0
            plan.inject(site, kind, times=None if times < 0 else times, after=after)
        return plan

    def specs(self) -> list[FaultSpec]:
        with self._lock:
            return list(self._specs)

    @property
    def active(self) -> bool:
        """True while any spec can still fire (cheap armed check)."""
        with self._lock:
            return any(s.times is None or s.fired < s.times for s in self._specs)

    # -- firing --------------------------------------------------------------
    def _matches(self, spec: FaultSpec, site: str, key: str) -> bool:
        if spec.site.endswith("."):
            if not site.startswith(spec.site) and site != spec.site[:-1]:
                return False
        elif spec.site != site:
            return False
        return spec.match is None or spec.match in key

    def fire(self, site: str, key: str = "") -> FaultSpec | None:
        """The first eligible spec for (site, key), advancing its counters.

        Returns ``None`` when nothing fires.  At most one spec fires per
        call: injection points are single-fault sites.
        """
        with self._lock:
            for spec in self._specs:
                if not self._matches(spec, site, key):
                    continue
                spec.seen += 1
                if spec.seen <= spec.after:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                self._seq += 1
                self.events.append(FaultEvent(self._seq, site, spec.kind, key))
                return spec
        return None

    # -- kind-specific helpers (what injection *does*) -----------------------
    def raise_if(self, site: str, key: str = "") -> FaultSpec | None:
        """Fire at ``site``; raising kinds raise, ``latency`` sleeps.

        Returns the non-raising spec (``nan``/``inf``/``corrupt``) so the
        caller can apply it to its own payload, or ``None``.
        """
        spec = self.fire(site, key)
        if spec is None:
            return None
        if spec.kind == "compile_error":
            raise InjectedCompileError(f"injected compile failure at {site} [{key}]")
        if spec.kind == "oom":
            raise InjectedOOMError(f"injected OOM at {site} [{key}]")
        if spec.kind == "latency":
            time.sleep(max(float(spec.value), 0.0))
        return spec

    @staticmethod
    def corrupt_array(spec: FaultSpec, out):
        """Poison one tensor (or a tuple's first) per the spec's kind.

        A tensor passes through untouched while the current stream captures
        a CUDA graph (the counterpart of the reference passing a tracer
        through): a NaN written there would be baked into every replay, which
        no guard can inspect, so injecting there would break the containment
        contract instead of testing it.
        """
        if isinstance(out, tuple):
            return (FaultPlan.corrupt_array(spec, out[0]),) + tuple(out[1:])
        if not isinstance(out, torch.Tensor) or not out.is_floating_point():
            return out
        if out.is_cuda and torch.cuda.is_current_stream_capturing():
            return out
        return torch.full_like(out, float("inf") if spec.kind == "inf" else float("nan"))

    def corrupt_text(self, site: str, text: str, key: str = "") -> str:
        """Deterministically mangle ``text`` when a ``corrupt`` spec fires.

        Flips ``value`` characters (default 16) at seeded positions: the
        "bit rot / truncated upload" shape a bundle checksum must catch.
        """
        spec = self.fire(site, key)
        if spec is None or spec.kind != "corrupt":
            return text
        n = int(spec.value) or 16
        chars = list(text)
        positions = self._rng.integers(1, max(len(chars) - 1, 2), size=n)
        for pos in positions:
            chars[int(pos)] = "#"
        return "".join(chars)


# ---------------------------------------------------------------------------
# incident records (guard -> telemetry -> engine health)
# ---------------------------------------------------------------------------
def incident(site: str, family: str, config, error: BaseException | str,
             action: str, *, device: str | None = None, seq: int = 0) -> dict:
    """The structured incident record the guard emits and telemetry carries.

    ``action`` names what containment did: ``fallback_ref`` (a CPU call with
    no config served the plain version), ``quarantined`` (the config entered
    the circuit breaker; on a CUDA tensor the call ran the family's default
    config, on the CPU the plain version), ``unrecoverable`` (a CUDA call
    with no compiled config left: the guard raised), ``absolved`` (a
    re-probe succeeded), ``latency_spike``, ``retry`` (engine-level request
    retry), ``rollback`` (policy rolled back), ``candidate_failed`` /
    ``candidate_rejected`` (a retune candidate never installed).
    """
    name = config.name() if hasattr(config, "name") and callable(config.name) else (
        None if config is None else str(config))
    return {
        "seq": int(seq),
        "site": site,
        "family": family,
        "config": name,
        "device": device,
        "error": f"{type(error).__name__}: {error}" if isinstance(error, BaseException) else str(error),
        "action": action,
    }


# ---------------------------------------------------------------------------
# training-side fault tolerance
# ---------------------------------------------------------------------------
class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful 'save and exit' request (poll per step)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = threading.Event()
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def _handler(self, signum, frame):
        self._requested.set()

    def request(self) -> None:  # for tests / in-process triggers
        self._requested.set()

    @property
    def preempted(self) -> bool:
        return self._requested.is_set()


class StragglerDetector:
    """Rolling step-time stats; flags steps slower than threshold x median.

    The trainer times whole steps (``start``/``stop``); :meth:`observe`
    takes a time directly.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0, warmup: int = 5):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self.times: deque[float] = deque(maxlen=window)
        self.flagged: list[tuple[int, float, float]] = []  # (step, t, median)
        self._step = 0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record the step; returns True if it was a straggler step."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        med = self.median()
        straggler = len(self.times) >= self.warmup and med > 0 and dt > self.threshold * med
        if straggler:
            self.flagged.append((self._step, dt, med))
        self.times.append(dt)
        return straggler

    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    ok: bool
    reason: str
    data: object | None = None  # DataConfig on ok=True


def elastic_plan(data, new_host_index: int, new_host_count: int) -> ElasticPlan:
    """Resume plan after the fleet grows or shrinks.

    The checkpoint needs no conversion (it holds whole arrays); the only
    constraint is global-batch divisibility across the new host count.
    """
    from ..data.pipeline import reshard

    if new_host_count <= 0:
        return ElasticPlan(False, "host count must be positive")
    if data.global_batch % new_host_count != 0:
        return ElasticPlan(
            False,
            f"global_batch={data.global_batch} not divisible by {new_host_count} hosts",
        )
    if not (0 <= new_host_index < new_host_count):
        return ElasticPlan(False, f"host index {new_host_index} out of range")
    return ElasticPlan(True, "ok", reshard(data, new_host_index, new_host_count))
