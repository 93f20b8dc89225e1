"""Admission/eviction scheduling for continuous batching.

The scheduler owns the wait queue and the ranking rules; the engine owns
lanes, the block pool, and the decode loop.  Policy:

* **Priority first.**  Requests carry an integer ``priority`` (higher runs
  sooner).  Waiting requests *age*: every ``aging_steps`` engine steps spent
  in the queue adds +1 to the effective priority, so a starved low-priority
  request eventually outranks fresh high-priority traffic (and eventually
  earns the right to preempt for admission).
* **Deadline second.**  Among equal effective priority, a smaller
  ``latency_target_ms`` (the request's SLO) sorts earlier; untargeted
  requests sort last.  Submission order breaks remaining ties, so scheduling
  is deterministic.
* **Head-of-line bypass.**  ``pop_next`` returns the best-ranked request
  *that fits* (per the engine's block-availability predicate), letting short
  prompts slip past a big one waiting for cache blocks.
* **Preemption.**  ``pick_victim`` chooses the active request to evict when
  the pool runs dry: lowest priority first, SLO-targeted requests protected
  over untargeted ones, then the one holding the most emitted tokens (the
  over-budget decode), newest submission last.  Preempted requests come back
  through ``submit`` with state ``"preempted"`` and keep their output; the
  engine re-admits them by re-prefilling prompt + generated tokens.  The
  engine passes requests whose lanes hold shared (refcount > 1) prefix
  blocks via ``protect=`` so siblings keep their cheap aliases; eviction of
  a protected holder is only a fallback when no other victim exists (and is
  still safe — release just decrements the refcount).
* **Prefill budget.**  With ``prefill_token_budget`` set, the engine calls
  ``begin_step()`` each step and ``charge_prefill(n)`` per admitted prompt
  chunk; ``prefill_budget_left`` caps how much prefill work one step may
  interleave with decode, so a 4k-token prompt is spread over many steps
  instead of stalling every decode lane while it traces.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

__all__ = ["Scheduler", "SchedulerConfig"]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    # Queue steps per +1 effective priority for waiting requests.
    aging_steps: int = 16
    # A waiter must outrank a victim by this much to preempt it for admission.
    preempt_priority_gap: int = 1
    # Max prefill tokens admitted per engine step (None = unbounded, the
    # monolithic-prefill behaviour).  Counted in padded chunk widths.
    prefill_token_budget: int | None = None


class Scheduler:
    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        self._wait: list = []
        self._seq = itertools.count()
        self._prefill_spent = 0

    # -- per-step prefill budget -------------------------------------------
    def begin_step(self) -> None:
        """Reset the step's prefill-token spend (call once per engine step)."""
        self._prefill_spent = 0

    def charge_prefill(self, n_tokens: int) -> None:
        self._prefill_spent += n_tokens

    def prefill_budget_left(self) -> int | float:
        budget = self.config.prefill_token_budget
        if budget is None:
            return math.inf
        return max(0, budget - self._prefill_spent)

    def __len__(self) -> int:
        return len(self._wait)

    def waiting(self) -> list:
        return list(self._wait)

    def clear(self) -> list:
        """Drop (and return) everything still waiting — drain exhaustion."""
        out, self._wait = self._wait, []
        return out

    def submit(self, req, *, step: int) -> None:
        if getattr(req, "_seq", None) is None:
            req._seq = next(self._seq)
        req._enqueued_step = step
        self._wait.append(req)

    def effective_priority(self, req, step: int) -> int:
        aging = self.config.aging_steps
        waited = max(0, step - getattr(req, "_enqueued_step", step))
        return req.priority + (waited // aging if aging else 0)

    def _rank_key(self, req, step: int):
        target = req.latency_target_ms
        return (
            -self.effective_priority(req, step),
            target if target is not None else math.inf,
            req._seq,
        )

    def peek_best(self, step: int):
        if not self._wait:
            return None
        return min(self._wait, key=lambda r: self._rank_key(r, step))

    def pop_next(self, step: int, *, fits=lambda req: True):
        """Best-ranked waiting request that ``fits``; head-of-line bypass."""
        for req in sorted(self._wait, key=lambda r: self._rank_key(r, step)):
            if fits(req):
                self._wait.remove(req)
                return req
        return None

    def remove(self, req) -> None:
        self._wait.remove(req)

    def pick_victim(self, running, step: int, *, protect=()):
        """Active request to evict under block pressure (None if no choice).

        Raw priority (no aging — active requests aren't waiting), untargeted
        before SLO-targeted, most-emitted-tokens first, newest submission
        breaking ties.
        """
        cands = [r for r in running if r is not None and r not in protect]
        if not cands:
            return None
        return min(
            cands,
            key=lambda r: (
                r.priority,
                0 if r.latency_target_ms is None else 1,
                -len(r.output),
                -r._seq,
            ),
        )
