"""Multi-engine router: one ServingEngine per device behind one front door.

Ported from ``repro/serve/router.py``.  A :class:`Router` fronts a fleet of
:class:`~repro_torch.serve.engine.ServingEngine` instances — typically one per
tuned device of a single :class:`~repro_torch.core.bundle.DeploymentBundle`,
each on its own isolated :class:`~repro_torch.core.runtime.KernelRuntime`
(``bundle.router(model, params)`` builds exactly that), or several engines on
one card, each on its own runtime.  Per-engine isolation is what makes per-engine SLO
objectives safe: an engine entering SLO mode constrains only its own
runtime's kernel selection.

Dispatch policy (deterministic):

* engines reporting ``health == "degraded"`` (the incident/quarantine
  state machine) are skipped while any healthy engine exists;
* **prefix affinity**: when the prompt is known, engines are probed with
  :meth:`~repro_torch.serve.engine.ServingEngine.prefix_overlap` (read-only — the
  hit-rate counters are untouched) and the ones already holding the longest
  cached prefix win, provided they hold at least one full block.  Sending a
  shared-system-prompt request to the engine that cached the prompt turns
  its prefill into a block-table alias instead of recomputation;
* among equally-affine engines, least-loaded wins — load is normalized
  queue+lane occupancy plus KV-pool block utilization;
* a request carrying ``latency_target_ms`` additionally avoids engines
  currently under SLO pressure (their width is capped — adding latency-
  sensitive traffic there defeats the point);
* remaining ties break on device name, so routing is reproducible.

The router re-exposes the engine's submit/stream surface: ``submit`` returns
a :class:`~repro_torch.serve.engine.Ticket` whose streaming iterator steps the
whole fleet; ``step`` round-robins one scheduling round across engines with
work; ``drain`` runs everything down and aggregates the per-engine
:class:`~repro_torch.serve.engine.EngineStatus`.
"""
from __future__ import annotations

import itertools

from .engine import EngineStatus, Request, ServingEngine, Ticket

__all__ = ["Router"]


class Router:
    def __init__(self, engines, *, name: str | None = None):
        """``engines``: mapping of key (device name) -> ServingEngine, or an
        iterable of engines (keyed by their ``device`` / position)."""
        if isinstance(engines, dict):
            self.engines: dict[str, ServingEngine] = dict(engines)
        else:
            self.engines = {}
            for i, eng in enumerate(engines):
                key = getattr(eng, "device", None) or f"engine{i}"
                if key in self.engines:
                    key = f"{key}#{i}"
                self.engines[key] = eng
        if not self.engines:
            raise ValueError("Router needs at least one engine")
        self.name = name or "router"
        self._uid = itertools.count()

    # -- dispatch -------------------------------------------------------------
    def _load(self, eng: ServingEngine) -> float:
        occupancy = (len(eng.scheduler) + sum(s is not None for s in eng.slots)) / max(
            eng.max_batch, 1
        )
        stats = eng.pool.stats()
        return occupancy + stats["used_blocks"] / max(stats["n_blocks"], 1)

    def dispatch(
        self, *, latency_target_ms: float | None = None, prompt=None
    ) -> str:
        """The engine key the next submit would pick (pure, no side effects)."""
        keys = sorted(self.engines)
        healthy = [k for k in keys if self.engines[k].health == "healthy"]
        eligible = healthy or keys
        if latency_target_ms is not None:
            calm = [k for k in eligible if not self.engines[k]._slo_mode]
            eligible = calm or eligible
        if prompt is not None and len(prompt) > 1:
            # Prefix affinity: prefer engines already holding the longest
            # cached prefix of this prompt (at least one full block).
            overlap = {k: self.engines[k].prefix_overlap(prompt) for k in eligible}
            best = max(overlap.values(), default=0)
            if best > 0:
                eligible = [k for k in eligible if overlap[k] == best]
        return min(eligible, key=lambda k: (self._load(self.engines[k]), k))

    # -- serving surface ------------------------------------------------------
    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int = 16,
        eos_id: int | None = None,
        priority: int = 0,
        latency_target_ms: float | None = None,
        uid: int | None = None,
    ) -> Ticket:
        """Route one prompt to the best engine; returns a fleet-wide Ticket
        (its streaming iterator steps the whole router, so progress does not
        depend on which engine holds the request)."""
        key = self.dispatch(latency_target_ms=latency_target_ms, prompt=prompt)
        ticket = self.engines[key].submit(
            prompt,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            priority=priority,
            latency_target_ms=latency_target_ms,
            uid=uid if uid is not None else next(self._uid),
        )
        ticket.request.routed_to = key
        return Ticket(ticket.request, self)

    def submit_request(self, req: Request) -> Ticket:
        key = self.dispatch(
            latency_target_ms=req.latency_target_ms, prompt=req.prompt
        )
        self.engines[key].submit_request(req)
        req.routed_to = key
        return Ticket(req, self)

    def pending(self) -> bool:
        return any(e.pending() for e in self.engines.values())

    def step(self) -> bool:
        """One scheduling round on every engine with work; False = no progress."""
        progressed = False
        for key in sorted(self.engines):
            eng = self.engines[key]
            if eng.pending():
                progressed = bool(eng.step()) or progressed
        return progressed

    def drain(self, *, max_steps: int = 10_000) -> EngineStatus:
        """Serve everything submitted fleet-wide; aggregate EngineStatus.

        Engines are stepped round-robin (not drained one after another), so
        a slow engine cannot starve the others' budget and the fleet finishes
        together.  ``steps`` in the aggregate is the per-engine maximum (the
        wall-clock analogue), not the sum.
        """
        rounds = 0
        while self.pending() and rounds < max_steps:
            if not self.step():
                break
            rounds += 1
        statuses = [
            eng.drain(max_steps=eng.steps)  # budget spent: just close the epoch
            for eng in (self.engines[k] for k in sorted(self.engines))
        ]
        return self._aggregate(statuses)

    def status(self) -> EngineStatus:
        """Live fleet-wide aggregate snapshot."""
        return self._aggregate(
            [self.engines[k].status() for k in sorted(self.engines)]
        )

    def _aggregate(self, statuses: list[EngineStatus]) -> EngineStatus:
        n = max(len(statuses), 1)
        return EngineStatus(
            completed=sum(s.completed for s in statuses),
            in_flight=sum(s.in_flight for s in statuses),
            queued=sum(s.queued for s in statuses),
            steps=max((s.steps for s in statuses), default=0),
            exhausted=any(s.exhausted for s in statuses),
            health="degraded" if any(s.health == "degraded" for s in statuses)
            else "healthy",
            preempted=sum(s.preempted for s in statuses),
            # Pool health: ratios average across the fleet, counters sum.
            pool_utilization=sum(s.pool_utilization for s in statuses) / n,
            pool_fragmentation=sum(s.pool_fragmentation for s in statuses) / n,
            shared_blocks=sum(s.shared_blocks for s in statuses),
            prefix_hits=sum(s.prefix_hits for s in statuses),
            prefix_lookups=sum(s.prefix_lookups for s in statuses),
        )

    def healths(self) -> dict[str, str]:
        return {k: self.engines[k].health for k in sorted(self.engines)}
