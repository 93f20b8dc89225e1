"""Serving tier: paged KV pool with prefix sharing, SLO-aware continuous batching, fleet router.

Single-engine serving is ``rt.serve(model, params)`` on a
:class:`~repro_torch.core.runtime.KernelRuntime`; :class:`Router` fronts
several engines (``bundle.router(model, params)``: one per device of a
:class:`~repro_torch.core.bundle.DeploymentBundle`) with health-, SLO- and
prefix-aware, least-loaded dispatch.
"""
from ..core.runtime import Objective
from .engine import EngineStatus, Request, RetuneEvent, ServingEngine, Ticket
from .kvpool import KVPool
from .router import Router
from .scheduler import Scheduler, SchedulerConfig

__all__ = [
    "EngineStatus",
    "KVPool",
    "Objective",
    "Request",
    "RetuneEvent",
    "Router",
    "Scheduler",
    "SchedulerConfig",
    "ServingEngine",
    "Ticket",
]
