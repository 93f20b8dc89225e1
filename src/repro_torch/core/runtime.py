"""`KernelRuntime`: the explicit owner of kernel-selection state.

Port of the selection half of ``repro/core/runtime.py``: the installed
policy, the per-thread LRU shape cache with its counters, the selection log,
and the per-thread activation stack (``with rt.activate(): ...``) that
``kernels.ops`` consults through :func:`current_runtime`.

Selection timing differs from the reference by design.  JAX selects once per
trace of a jitted program; eager PyTorch selects on every call, so the shape
cache lookup is the dispatch hot path here.

The per-device policy registry is the reference's: ``install_for_device``
registers a policy per canonical device name, ``activate_device`` makes the
one resolved for a device live (``devices.resolve_device``), and
``install_bundle`` installs a whole :class:`~repro_torch.core.bundle.DeploymentBundle`.
Each moves the policy epoch, so a serving engine captures its CUDA graphs
again.  On a CUDA target (a ``gpu_*`` device, or ``target="cuda"``)
``install_bundle`` and ``activate_device`` raise, naming the configs, when
the resolved deployment holds a config outside the port's compiled space
(a TPU bundle's tiles, say): the fault shows at install, not at the first
launch inside a capture.  On the CPU any deployment installs: there its
configs are selections only.

Failure containment is the reference's (its DESIGN.md §11): an attached
:class:`~repro_torch.core.faults.FaultPlan`, output validation, the incident
ring, the per-(device, family, config) circuit breaker with its capped
exponential re-probe backoff, the bounded swap history and
``rollback_device``.  The breaker and the swaps move the epoch as the
reference's do.

Telemetry: ``telemetry(online=)`` folds the selection log into a
:class:`~repro_torch.core.retune.TelemetrySnapshot`.

SLO-aware selection, as in the reference: a serving engine in SLO mode
installs an :class:`Objective` (``set_objective``, which moves the epoch, so
the engine's CUDA graphs are captured again); while one with a latency
target is live, every selector routes through the policy's
``select_for_objective(family, problem, objective)`` where the policy has
one.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict, deque

DEFAULT_LOG_CAP = 4096
DEFAULT_SHAPE_CACHE_CAP = 1024
DEFAULT_INCIDENT_CAP = 256
DEFAULT_SWAP_HISTORY = 4
# Circuit breaker re-probe cadence, counted in selections of the quarantined
# config: first re-probe after QUARANTINE_BACKOFF skipped selections, doubling
# per failed probe up to the cap.
QUARANTINE_BACKOFF = 4
QUARANTINE_MAX_BACKOFF = 256

# The policy method each family's selection calls (the reference's registry
# ``policy_attr``); a policy may instead expose a generic ``select(family, problem)``.
POLICY_ATTR = {"matmul": "select_matmul", "attention": "select_attention", "wkv": "select_wkv",
               "ssm_scan": "select_ssm"}

_MISS = object()


@dataclasses.dataclass(frozen=True)
class Objective:
    """A serving objective consulted at kernel-selection time.

    ``latency_target_ms`` is a per-token SLO: while an objective with a
    target is installed (:meth:`KernelRuntime.set_objective`), selection
    routes through the policy's ``select_for_objective(family, problem,
    objective)``.  Policies without it are unaffected.
    ``prefill_chunk_tokens`` is the work-granularity hint an SLO-mode engine
    sets beside the target: the largest prompt chunk one prefill program
    covers.
    """

    latency_target_ms: float | None = None
    prefill_chunk_tokens: int | None = None

    def __bool__(self) -> bool:
        return self.latency_target_ms is not None or self.prefill_chunk_tokens is not None


class _RuntimeLocal(threading.local):
    """One thread's dispatch fast path within one runtime."""

    def __init__(self):
        self.epoch: int = -1  # never matches: first dispatch syncs
        self.policy = None
        self.shape_cache: OrderedDict[tuple, object] = OrderedDict()
        self.shape_cache_cap: int = DEFAULT_SHAPE_CACHE_CAP
        self.cache_hits: int = 0
        self.cache_misses: int = 0
        self.family_stats: dict[str, list] = {}  # op -> [hits, misses]
        self.pins: "SelectionPins | None" = None  # the program being built or run on this thread


def _config_name(config) -> str:
    return config.name() if hasattr(config, "name") and callable(config.name) else str(config)


class SelectionPins:
    """The selections of one program build, in call order.

    A serving engine runs a program's body more than once per build (a
    warm-up, then a capture; or, eager, on every call), where the reference
    traces it once.  So the first run *records*: every ``ops.*`` call
    selects through the runtime (the policy, the shape cache, the breaker,
    the selection log, the fault plan's dispatch sites) and its pin holds
    the config it served.  Once :meth:`seal` ed, every later run *replays*:
    each call takes its pinned config and consults nothing, so one build
    consults the runtime once, as one trace does.
    """

    def __init__(self):
        self.entries: list[list] = []  # [family, problem, config served]
        self.sealed = False
        self._next = 0

    def record(self, family: str, problem: tuple, config) -> list:
        pin = [family, problem, config]
        self.entries.append(pin)
        return pin

    def seal(self) -> None:
        self.sealed = True

    def take(self, family: str, problem: tuple):
        """The next pinned config; raises if the body's calls changed since the build."""
        i = self._next
        if i >= len(self.entries) or self.entries[i][:2] != [family, problem]:
            got = self.entries[i][:2] if i < len(self.entries) else "nothing"
            raise RuntimeError(f"a program's kernel call {i} is ({family}, {problem}) on replay but {got} "
                               f"at its build")
        self._next = i + 1
        return self.entries[i][2]


class _Pinning:
    """``with rt.pinning(pins):`` — this thread's ops calls record into, or
    replay from, ``pins`` (see :class:`SelectionPins`)."""

    __slots__ = ("runtime", "pins", "_saved")

    def __init__(self, runtime, pins: SelectionPins):
        self.runtime, self.pins = runtime, pins

    def __enter__(self) -> SelectionPins:
        loc = self.runtime._local
        self._saved, loc.pins = loc.pins, self.pins
        self.pins._next = 0
        return self.pins

    def __exit__(self, *exc) -> None:
        self.runtime._local.pins = self._saved


_runtime_ids = itertools.count(1)


class KernelRuntime:
    """Explicit owner of kernel-selection state (policy, caches, selection log).

    Installing a policy bumps the runtime's epoch under its lock; dispatching
    threads re-sync lazily on their next selection and drop their shape
    cache, so a config cached under an old policy is never served as if the
    new one had chosen it.
    """

    def __init__(self, name: str | None = None):
        self.name = name or f"runtime-{next(_runtime_ids)}"
        self._lock = threading.RLock()
        self._epoch: int = 0
        self._policy = None
        self._log_enabled: bool = False
        self._selection_log: deque[tuple] = deque(maxlen=DEFAULT_LOG_CAP)
        self._shape_cache_cap: int = DEFAULT_SHAPE_CACHE_CAP
        self._local = _RuntimeLocal()
        self._device_policies: dict[str, object] = {}
        self._active_device: str | None = None
        self._requested_device: str | None = None
        # -- failure containment --
        self.fault_plan = None  # core.faults.FaultPlan, or None
        self._validate_outputs: bool = False
        self._quarantine: dict[tuple[str, str], dict] = {}
        self._incidents: deque[dict] = deque(maxlen=DEFAULT_INCIDENT_CAP)
        self._incident_count: int = 0
        self._swap_history: deque[tuple[str, object, int]] = deque(maxlen=DEFAULT_SWAP_HISTORY)
        # -- SLO-aware selection (serving tier) --
        self._objective: Objective | None = None

    def __repr__(self) -> str:
        if self._active_device is not None:
            return (f"KernelRuntime({self.name!r}, active_device={self._active_device!r}, "
                    f"devices={sorted(self._device_policies)}, epoch={self._epoch})")
        return f"KernelRuntime({self.name!r}, policy={self._policy!r}, epoch={self._epoch})"

    # -- scoping --------------------------------------------------------------
    def activate(self) -> "_Activation":
        """Context manager making this the innermost active runtime of the thread."""
        return _Activation(self)

    # -- policy ---------------------------------------------------------------
    def install(self, policy) -> None:
        """Install ``policy`` (``None`` uninstalls: ops then run their default).

        Clears the active-device marker: a manually installed policy is not
        tied to the device registry.
        """
        with self._lock:
            self._policy = policy
            self._active_device = None
            self._requested_device = None
            self._epoch += 1
        self.clear_shape_cache()

    def policy(self):
        """The live policy, syncing this thread's view of a swap."""
        return self._sync()

    def policy_epoch(self) -> int:
        """Monotonic counter bumped by every policy mutation, the breaker's included."""
        return self._epoch

    # -- serving objective ----------------------------------------------------
    def set_objective(self, objective: Objective | None) -> None:
        """Install (or with ``None`` / an empty one, clear) the serving
        objective.  Moves the epoch like a policy swap: every thread drops its
        shape cache on its next selection, and a serving engine captures its
        programs again."""
        if objective is not None and not objective:
            objective = None
        with self._lock:
            if objective == self._objective:
                return
            self._objective = objective
            self._epoch += 1
        self.clear_shape_cache()

    def objective(self) -> Objective | None:
        """The live serving objective (``None`` when unconstrained)."""
        return self._objective

    # -- per-device registry ----------------------------------------------------
    def install_for_device(self, device: str, policy) -> None:
        """Register (or with ``None``, drop) the policy tuned for one device.

        Registration alone activates nothing; :meth:`activate_device` picks
        which registered policy serves.  If ``device`` is the active one, the
        live policy is replaced in place (epoch moved): the hot-swap
        primitive of the retune loop.  Replacing a registered policy keeps
        the previous one in the bounded swap history (:meth:`rollback_device`).
        """
        from .devices import canonical_device_name

        name = canonical_device_name(device)
        with self._lock:
            if policy is None:
                self._device_policies.pop(name, None)
                if name == self._active_device:
                    self._policy = None
                    self._active_device = None
                    self._requested_device = None
                    self._epoch += 1
            else:
                prev = self._device_policies.get(name)
                if prev is not None and prev is not policy:
                    self._swap_history.append((name, prev, self._epoch))
                self._device_policies[name] = policy
                if name == self._active_device:
                    self._policy = policy
                    self._epoch += 1

    def device_policies(self) -> dict[str, object]:
        """Snapshot of the registered per-device policies (name -> policy)."""
        with self._lock:
            return dict(self._device_policies)

    def active_device(self) -> str | None:
        """Canonical name of the device whose registered policy is live."""
        return self._active_device

    def device_resolution(self) -> tuple[str | None, str | None]:
        """(requested, resolved) device names from the last activation."""
        with self._lock:
            return (self._requested_device, self._active_device)

    def activate_device(self, device: str | None = None, *, strict: bool = False,
                        target: str | None = None) -> str:
        """Make the registered policy for ``device`` the live one.

        ``device=None`` detects the host (``REPRO_DEVICE`` override first).
        An unregistered device resolves to the nearest registered sibling
        (``devices.resolve_device``); ``strict=True`` raises instead of
        crossing platform families.  ``target`` is the torch device type the
        kernels will launch on (default: ``cuda`` for a ``gpu_*`` device,
        else ``cpu``); on ``cuda`` a policy holding configs outside the
        compiled space raises.  Returns the resolved canonical name.
        """
        from .devices import canonical_device_name, detect_device, resolve_device

        requested = canonical_device_name(device) if device is not None else detect_device()
        with self._lock:
            resolved = resolve_device(requested, list(self._device_policies), strict=strict)
            if resolved is None:
                raise KeyError(
                    f"no kernel policy registered for device {requested!r} "
                    f"(registered: {sorted(self._device_policies)})"
                )
            policy = self._device_policies[resolved]
            check_compiled(policy, _target(requested, target), resolved)
            self._policy = policy
            self._active_device = resolved
            self._requested_device = requested
            self._epoch += 1
        self.clear_shape_cache()
        return resolved

    def clear_device_policies(self) -> None:
        """Drop every registered per-device policy, deactivating the live one.

        A policy activated from the registry is uninstalled with it; a policy
        installed with :meth:`install` is not registry-owned and survives.
        """
        with self._lock:
            self._device_policies.clear()
            if self._active_device is not None:
                self._policy = None
            self._active_device = None
            self._requested_device = None
            self._epoch += 1
        self.clear_shape_cache()

    def install_bundle(self, bundle, device: str | None = None, *, strict: bool = False,
                       target: str | None = None):
        """Install a :class:`~repro_torch.core.bundle.DeploymentBundle` (or path).

        The bundle's policies become this runtime's registry (replacing any
        previous registrations) and the one resolved for ``device`` (default:
        the detected host) activates.  Raises before touching the registry
        when nothing resolves under ``strict``, or when ``target`` (as in
        :meth:`activate_device`) is ``cuda`` and the resolved deployment holds
        a config outside the compiled space.  Returns the activated
        ``Deployment``.
        """
        from .bundle import DeploymentBundle
        from .devices import canonical_device_name, detect_device

        if not isinstance(bundle, DeploymentBundle):
            bundle = DeploymentBundle.load(bundle)
        requested = canonical_device_name(device) if device else detect_device()
        dep, resolved = bundle.deployment_for(requested, strict=strict)
        check_compiled(dep, _target(requested, target), resolved)
        self.clear_device_policies()
        for name, d in bundle.deployments.items():
            self.install_for_device(name, d)
        resolved = self.activate_device(requested, strict=strict, target=target)
        return bundle.deployments[resolved]

    def apply_policy_update(self, deployment, device: str | None = None) -> str | None:
        """Adopt a control-plane-pushed deployment without a serving engine.

        The engine-less counterpart of ``ServingEngine.adopt_deployment``: a
        :class:`repro_torch.control.PolicySubscriber` attached directly to a
        runtime lands pushed artifacts here.  ``device=None`` targets the
        active device; the update goes through :meth:`install_for_device`, so
        when the target is live this is the lock+epoch hot-swap a retune uses
        (an engine on this runtime then captures its programs again), or
        installs directly when there is no target device.  On a CUDA target
        (a ``gpu_*`` device) a deployment holding configs the port has not
        compiled raises before anything is installed, as
        :meth:`install_bundle` does.  Returns the canonical device name the
        update landed on (``None`` for a direct install).
        """
        from .devices import canonical_device_name

        target = canonical_device_name(device) if device is not None else self.active_device()
        if target is None:
            self.install(deployment)
            return None
        check_compiled(deployment, _target(target, None), target)
        self.install_for_device(target, deployment)
        if self.active_device() is None:
            self.activate_device(target)
        return target

    # -- failure containment ----------------------------------------------------
    def set_fault_plan(self, plan) -> None:
        """Attach (or with ``None``, detach) a chaos-injection plan.

        An attached plan arms the ops guard's injection sites and its
        non-finite output validation.
        """
        self.fault_plan = plan

    def set_output_validation(self, enabled: bool) -> None:
        """Opt dispatch into checking kernel outputs for NaN/Inf.

        Only direct ``ops.*`` calls are checked: inside a program build (the
        counterpart of a jit trace) and during a capture there is nothing to
        inspect without a host sync.  Always on while a fault plan is attached.
        """
        self._validate_outputs = bool(enabled)

    def output_validation_enabled(self) -> bool:
        return self._validate_outputs or self.fault_plan is not None

    def record_incident(self, rec: dict) -> dict:
        """Append one structured incident (``core.faults.incident``), stamped
        with the monotonic incident sequence number; the ring keeps the
        newest :data:`DEFAULT_INCIDENT_CAP`, :meth:`incident_count` counts all."""
        with self._lock:
            self._incident_count += 1
            rec = dict(rec, seq=self._incident_count)
            self._incidents.append(rec)
        return rec

    def incidents(self) -> list[dict]:
        """Newest-last snapshot of recorded dispatch/serving incidents."""
        with self._lock:
            return list(self._incidents)

    def incident_count(self) -> int:
        """Monotonic count of incidents ever recorded on this runtime."""
        return self._incident_count

    def quarantine_config(self, family: str, config, error=None) -> dict:
        """Open (or re-open) the circuit breaker for ``(device, family, config)``.

        While open, selections that would serve ``config`` are redirected to
        the family default; every :data:`QUARANTINE_BACKOFF` (doubling per
        failed re-probe, capped at :data:`QUARANTINE_MAX_BACKOFF`) redirected
        selections the breaker goes half-open and serves the quarantined
        config once so the guard can re-probe it.  Moves the epoch: a shape
        cached before the quarantine is never served after it.
        """
        name = _config_name(config)
        with self._lock:
            entry = self._quarantine.get((family, name))
            if entry is None:
                entry = {"family": family, "config": config, "name": name, "device": self._active_device,
                         "failures": 0, "backoff": QUARANTINE_BACKOFF, "countdown": QUARANTINE_BACKOFF,
                         "skipped": 0, "probes": 0, "state": "open", "error": None}
                self._quarantine[(family, name)] = entry
            else:
                entry["backoff"] = min(entry["backoff"] * 2, QUARANTINE_MAX_BACKOFF)
                entry["countdown"] = entry["backoff"]
                entry["state"] = "open"
            entry["failures"] += 1
            if error is not None:
                entry["error"] = (f"{type(error).__name__}: {error}" if isinstance(error, BaseException)
                                  else str(error))
            self._epoch += 1
        self.clear_shape_cache()
        return dict(entry)

    def absolve(self, family: str, config) -> bool:
        """Close the breaker after a successful re-probe (config healthy again)."""
        name = _config_name(config)
        with self._lock:
            entry = self._quarantine.pop((family, name), None)
            if entry is not None:
                self._epoch += 1
        if entry is not None:
            self.clear_shape_cache()
        return entry is not None

    def quarantined(self) -> list[dict]:
        """Snapshot of open/half-open breaker entries (shallow copies)."""
        with self._lock:
            return [dict(e) for e in self._quarantine.values()]

    def _apply_quarantine(self, family: str, cfg):
        """Selection-time breaker: redirect a quarantined config, or probe it.

        Called only when the quarantine table is non-empty.  It counts per
        selection, after the shape cache, so a cache hit advances the
        re-probe countdown too.
        """
        if cfg is None:
            return cfg
        with self._lock:
            entry = self._quarantine.get((family, _config_name(cfg)))
            if entry is None:
                return cfg
            if entry["device"] not in (None, self._active_device):
                return cfg
            entry["countdown"] -= 1
            if entry["countdown"] <= 0:
                # Half-open: serve the quarantined config once as a probe.  The
                # countdown resets at once, so a selection whose kernel never
                # runs cannot wedge the breaker half-open.
                entry["countdown"] = entry["backoff"]
                entry["probes"] += 1
                entry["state"] = "half_open"
                return cfg
            entry["skipped"] += 1
            entry["state"] = "open"
        fallback = quarantine_redirect(family)
        return fallback if fallback is not None else cfg

    def probing(self, family: str, config) -> bool:
        """True when ``config`` is a half-open breaker's live probe."""
        with self._lock:
            entry = self._quarantine.get((family, _config_name(config)))
            return entry is not None and entry["state"] == "half_open"

    def swap_history(self) -> list[tuple[str, object, int]]:
        """Bounded (device, previous_policy, epoch) history of hot-swaps."""
        with self._lock:
            return list(self._swap_history)

    def rollback_device(self, device: str | None = None):
        """Reinstall the most recent pre-swap policy for ``device`` (default:
        the active one), moving the epoch when the device is live.  Returns
        the restored policy, or ``None`` with no history."""
        from .devices import canonical_device_name

        name = canonical_device_name(device) if device else self._active_device
        if name is None:
            return None
        with self._lock:
            prev = None
            for i in range(len(self._swap_history) - 1, -1, -1):
                if self._swap_history[i][0] == name:
                    prev = self._swap_history[i][1]
                    del self._swap_history[i]
                    break
            if prev is None:
                return None
            self._device_policies[name] = prev
            if name == self._active_device:
                self._policy = prev
                self._epoch += 1
        return prev

    # -- program builds ----------------------------------------------------------
    def pinning(self, pins: SelectionPins) -> _Pinning:
        """Context manager: this thread's ``ops.*`` calls record into ``pins``
        (until it is sealed) or replay from it (see :class:`SelectionPins`)."""
        return _Pinning(self, pins)

    def pins(self) -> SelectionPins | None:
        """The pins this thread's ``ops.*`` calls record into or replay from."""
        return self._local.pins

    def scan_layers(self, n: int):
        """Layer indices ``0 .. n-1``, iterated as the reference's ``lax.scan``
        over a layer stack traces its body once: the kernel calls of layer 0
        select (recording into the enclosing build's pins, if any), and every
        later layer replays layer 0's configs without consulting the runtime.
        The models whose reference scans its layers (the transformer and
        RWKV6) loop with this."""
        loc = self._local
        outer = loc.pins
        if outer is None:
            body = SelectionPins()
            with self.pinning(body):
                yield 0
        else:
            start = outer._next if outer.sealed else len(outer.entries)
            yield 0
            body = SelectionPins()
            body.entries = outer.entries[start:outer._next if outer.sealed else len(outer.entries)]
        body.seal()
        for i in range(1, n):
            with self.pinning(body):
                yield i

    # -- serving ---------------------------------------------------------------
    def serve(self, model, params, **kwargs):
        """Build a :class:`~repro_torch.serve.engine.ServingEngine` owned by this
        runtime (every selection its programs make dispatches here)."""
        from ..serve.engine import ServingEngine

        return ServingEngine(model, params, runtime=self, **kwargs)

    # -- selection log --------------------------------------------------------
    def set_selection_logging(self, enabled: bool, *, cap: int | None = None) -> None:
        """Opt in/out of recording dispatch decisions; ``cap`` bounds the buffer."""
        with self._lock:
            self._log_enabled = enabled
            if cap is not None:
                self._selection_log = deque(self._selection_log, maxlen=max(int(cap), 1))

    def selection_logging_enabled(self) -> bool:
        return self._log_enabled

    def selection_log(self) -> list[tuple]:
        """Dispatch decisions (op, problem, chosen config), newest last."""
        return list(self._selection_log)

    def clear_selection_log(self) -> None:
        self._selection_log.clear()

    def telemetry(self, online=None):
        """This runtime's selection log and incidents as a
        :class:`~repro_torch.core.retune.TelemetrySnapshot` (what
        ``ServingEngine.maybe_retune`` reads each drift-check window)."""
        from .retune import TelemetrySnapshot

        return TelemetrySnapshot.from_runtime(self, online=online)

    # -- shape cache ----------------------------------------------------------
    def clear_shape_cache(self) -> None:
        """Drop this thread's shape cache (other threads re-sync on epoch bump)."""
        loc = self._local
        loc.shape_cache.clear()
        loc.cache_hits = 0
        loc.cache_misses = 0
        loc.family_stats = {}

    def set_shape_cache_cap(self, cap: int) -> None:
        """Bound the dispatch cache; oldest (LRU) shape keys are evicted."""
        cap = max(int(cap), 1)
        self._shape_cache_cap = cap
        loc = self._local
        loc.shape_cache_cap = cap
        while len(loc.shape_cache) > cap:
            loc.shape_cache.popitem(last=False)

    def shape_cache_stats(self) -> dict:
        """Hit/miss counters for this thread's dispatch cache (reset on swap)."""
        loc = self._local
        sizes: dict[str, int] = {}
        for key in loc.shape_cache:
            sizes[key[0]] = sizes.get(key[0], 0) + 1
        per_family = {
            op: {"hits": hm[0], "misses": hm[1], "size": sizes.get(op, 0)}
            for op, hm in sorted(loc.family_stats.items())
        }
        for op, size in sorted(sizes.items()):
            per_family.setdefault(op, {"hits": 0, "misses": 0, "size": size})
        return {
            "hits": loc.cache_hits,
            "misses": loc.cache_misses,
            "size": len(loc.shape_cache),
            "cap": loc.shape_cache_cap,
            "per_family": per_family,
        }

    # -- selection ------------------------------------------------------------
    def _sync(self):
        """The live policy, after syncing this thread's view of a swap."""
        loc = self._local
        if loc.epoch != self._epoch:
            with self._lock:
                loc.policy = self._policy
                loc.epoch = self._epoch
                loc.shape_cache_cap = self._shape_cache_cap
            loc.shape_cache.clear()
            loc.cache_hits = 0
            loc.cache_misses = 0
            loc.family_stats = {}
        return loc.policy

    def _select(self, op: str, problem: tuple, policy, select_fn):
        """Policy consultation with LRU shape memoization.

        Policies whose selections are not a pure function of the shape opt
        out with ``cacheable = False``.
        """
        loc = self._local
        cacheable = bool(getattr(policy, "cacheable", True))
        key = (op, *problem)
        if cacheable:
            cfg = loc.shape_cache.get(key, _MISS)
            if cfg is not _MISS:
                loc.cache_hits += 1
                loc.family_stats.setdefault(op, [0, 0])[0] += 1
                loc.shape_cache.move_to_end(key)
                if self._quarantine:
                    cfg = self._apply_quarantine(op, cfg)
                if self._log_enabled:
                    self._selection_log.append((op, problem, cfg))
                return cfg
        cfg = select_fn()
        if cacheable:
            loc.cache_misses += 1
            loc.family_stats.setdefault(op, [0, 0])[1] += 1
            loc.shape_cache[key] = cfg
            if len(loc.shape_cache) > loc.shape_cache_cap:
                loc.shape_cache.popitem(last=False)
        if self._quarantine:
            cfg = self._apply_quarantine(op, cfg)
        if self._log_enabled:
            self._selection_log.append((op, problem, cfg))
        return cfg

    def _objective_hook(self, pol, family: str):
        """The SLO-aware selection callable, or None when unconstrained or the
        policy has no ``select_for_objective``."""
        obj = self._objective
        if obj is None:
            return None
        slo = getattr(pol, "select_for_objective", None)
        if slo is None:
            return None
        return lambda problem: slo(family, problem, obj)

    def select_matmul_config(self, m: int, k: int, n: int, batch: int = 1):
        """The matmul selection ``ops.matmul`` runs on every call; ``None``
        with no policy installed."""
        pol = self._sync()
        if pol is None:
            return None
        problem = (m, k, n, batch)
        hook = self._objective_hook(pol, "matmul")
        if hook is not None:
            return self._select("matmul", problem, pol, lambda: hook(problem))
        return self._select("matmul", problem, pol, lambda: pol.select_matmul(m, k, n, batch))

    def select_config(self, family: str, problem: tuple):
        """Generic selection for any family, under the family-qualified shape
        key and recorded in the selection log as ``(family, problem, config)``;
        ``None`` with no policy installed or when the policy does not cover
        the family (the op then runs its default config).  Under a serving
        objective it routes through the policy's ``select_for_objective``."""
        pol = self._sync()
        if pol is None:
            return None
        problem = tuple(problem)
        slo = self._objective_hook(pol, family)
        meth = getattr(pol, POLICY_ATTR.get(family, ""), None)
        if slo is not None:
            hook = lambda: slo(problem)
        elif meth is not None:
            hook = lambda: meth(*problem)
        else:
            generic = getattr(pol, "select", None)
            if generic is None:
                return None
            hook = lambda: generic(family, problem)
        return self._select(family, problem, pol, hook)

    def select_attention_config(self, sq: int, skv: int, d: int):
        """The flash-attention selection ``ops.attention`` runs, under the
        family key ``"attention"``."""
        return self.select_config("attention", (sq, skv, d))

    def select_wkv_config(self, s: int, hd: int):
        """The WKV selection ``ops.wkv`` runs, under the family key ``"wkv"``."""
        return self.select_config("wkv", (s, hd))

    def select_ssm_config(self, s: int, d: int):
        """The selective-scan selection ``ops.ssm_scan`` runs, under the
        family key ``"ssm_scan"``."""
        return self.select_config("ssm_scan", (s, d))


def quarantine_redirect(family: str):
    """The config a quarantined selection is redirected to: the family's
    default, which the port always compiles."""
    from .families import get_family

    return get_family(family).default_config


def _target(requested: str, target: str | None) -> str:
    """The torch device type selections launch on: ``target``, else ``cuda``
    for a GPU device name and ``cpu`` for anything else."""
    if target is not None:
        return target
    return "cuda" if requested.startswith("gpu_") else "cpu"


def uncompiled_configs(policy) -> dict[str, list]:
    """Configs of a ``Deployment`` (anything with ``family_names`` /
    ``family_tuning``) outside its family's compiled space, by family."""
    from .families import get_family, is_registered

    if not hasattr(policy, "family_names"):
        return {}
    out: dict[str, list] = {}
    for fam in policy.family_names():
        if not is_registered(fam):
            continue
        space = set(get_family(fam).config_space())
        bad = [c for c in policy.family_tuning(fam).configs if c not in space]
        if bad:
            out[fam] = bad
    return out


def check_compiled(policy, target: str, device: str) -> None:
    """On a ``cuda`` target, raise naming every config of ``policy`` the port
    has not compiled (it would fail at its first launch, maybe inside a
    capture); elsewhere nothing launches a config, so nothing is checked."""
    if target != "cuda":
        return
    bad = uncompiled_configs(policy)
    if bad:
        names = "; ".join(f"{fam}: {', '.join(c.name() for c in cfgs)}" for fam, cfgs in bad.items())
        raise ValueError(f"the {device!r} deployment cannot serve on a CUDA device: configs outside "
                         f"the compiled space ({names})")


class _Activation:
    """``with rt.activate():`` — push/pop on the thread's activation stack."""

    __slots__ = ("runtime",)

    def __init__(self, runtime: KernelRuntime):
        self.runtime = runtime

    def __enter__(self) -> KernelRuntime:
        _active.stack.append(self.runtime)
        return self.runtime

    def __exit__(self, *exc) -> None:
        popped = _active.stack.pop()
        if popped is not self.runtime:
            raise RuntimeError("unbalanced KernelRuntime activation")


class _ActiveStack(threading.local):
    def __init__(self):
        self.stack: list[KernelRuntime] = []


_active = _ActiveStack()
_default_lock = threading.Lock()
_default_runtime: KernelRuntime | None = None


def default_runtime() -> KernelRuntime:
    """The process-wide runtime, created lazily on first use."""
    global _default_runtime
    rt = _default_runtime
    if rt is None:
        with _default_lock:
            rt = _default_runtime
            if rt is None:
                rt = _default_runtime = KernelRuntime(name="default")
    return rt


def reset_default_runtime() -> KernelRuntime:
    """Replace the default runtime with a fresh one (test isolation).

    Threads still dispatching against the old default keep their reference's
    state; new calls that reach the default see the fresh runtime.
    """
    global _default_runtime
    with _default_lock:
        _default_runtime = KernelRuntime(name="default")
        return _default_runtime


def current_runtime() -> KernelRuntime:
    """The innermost runtime activated on this thread, else the default."""
    stack = _active.stack
    return stack[-1] if stack else default_runtime()
