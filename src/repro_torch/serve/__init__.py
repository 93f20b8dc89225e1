"""Serving tier: dense KV pool, priority scheduler, continuous-batching engine."""
from .engine import EngineStatus, Request, ServingEngine, Ticket
from .kvpool import KVPool
from .scheduler import Scheduler, SchedulerConfig

__all__ = [
    "EngineStatus",
    "KVPool",
    "Request",
    "Scheduler",
    "SchedulerConfig",
    "ServingEngine",
    "Ticket",
]
