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

Quarantine, fault plans, objectives and telemetry join as the port grows
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict, deque

DEFAULT_LOG_CAP = 4096
DEFAULT_SHAPE_CACHE_CAP = 1024

_MISS = object()


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
        """Monotonic counter bumped by every policy mutation."""
        return self._epoch

    # -- per-device registry ----------------------------------------------------
    def install_for_device(self, device: str, policy) -> None:
        """Register (or with ``None``, drop) the policy tuned for one device.

        Registration alone activates nothing; :meth:`activate_device` picks
        which registered policy serves.  If ``device`` is the active one, the
        live policy is replaced in place (epoch moved).
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

    def selection_log(self) -> list[tuple]:
        """Dispatch decisions (op, problem, chosen config), newest last."""
        return list(self._selection_log)

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
        if self._log_enabled:
            self._selection_log.append((op, problem, cfg))
        return cfg

    def select_matmul_config(self, m: int, k: int, n: int, batch: int = 1):
        """The matmul selection ``ops.matmul`` runs on every call; ``None``
        with no policy installed."""
        pol = self._sync()
        if pol is None:
            return None
        return self._select(
            "matmul", (m, k, n, batch), pol, lambda: pol.select_matmul(m, k, n, batch)
        )

    def select_attention_config(self, sq: int, skv: int, d: int):
        """The flash-attention selection ``ops.attention`` runs on every call,
        under the family key ``"attention"``; ``None`` with no policy
        installed or when the policy does not cover the family."""
        pol = self._sync()
        select = getattr(pol, "select_attention", None)
        if select is None:
            return None
        return self._select("attention", (sq, skv, d), pol, lambda: select(sq, skv, d))

    def select_wkv_config(self, s: int, hd: int):
        """The WKV selection ``ops.wkv`` runs on every call, under the family
        key ``"wkv"``; ``None`` with no policy installed or when the policy
        does not cover the family."""
        pol = self._sync()
        select = getattr(pol, "select_wkv", None)
        if select is None:
            return None
        return self._select("wkv", (s, hd), pol, lambda: select(s, hd))

    def select_ssm_config(self, s: int, d: int):
        """The selective-scan selection ``ops.ssm_scan`` runs on every call,
        under the family key ``"ssm_scan"``; ``None`` with no policy installed
        or when the policy does not cover the family."""
        pol = self._sync()
        select = getattr(pol, "select_ssm", None)
        if select is None:
            return None
        return self._select("ssm_scan", (s, d), pol, lambda: select(s, d))


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


def current_runtime() -> KernelRuntime:
    """The innermost runtime activated on this thread, else the default."""
    stack = _active.stack
    return stack[-1] if stack else default_runtime()
