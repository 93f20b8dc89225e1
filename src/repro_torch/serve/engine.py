"""Continuous-batching serving engine, ported from ``repro/serve/engine.py``.

The engine owns ``max_batch`` decode **lanes** backed by a dense
:class:`~repro_torch.serve.kvpool.KVPool` (k/v blocks for a transformer, one
recurrent-state row per lane for RWKV6, both for Hymba, whose SSM state and
sliding-window rings shorter than ``cache_len`` are lane rows), a priority
:class:`~repro_torch.serve.scheduler.Scheduler`, and the reference's legacy
(monolithic-prefill) admission path:

    ticket = engine.submit(prompt, max_new_tokens=32)
    for tok in ticket.tokens():   # streams; drives engine.step() as needed
        ...
    status = engine.drain()       # run everything submitted to completion

One ``engine.step()`` is one scheduling round: admit waiting requests into
free lanes (prompt left-padded to its prefill bucket with token 0, the pad
tokens attended as real tokens, or run through RWKV6's or Mamba's recurrence, as in the
reference; first token from the last position's logits), then one
batched decode advances every active lane at the smallest power-of-two width
bucket that fits, padded with idle lanes (whose recurrent-state rows advance
too, as in the reference).  Kernel selection runs against the
engine's :class:`~repro_torch.core.runtime.KernelRuntime`; eager PyTorch
selects on every GEMM call, so the runtime's shape cache is consulted on
every forward (the reference selects once per jit trace).

Streaming admission, SLO mode, retuning, deployment offers and rollback wait
for later parts of the port.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..core.runtime import current_runtime
from .kvpool import KVPool
from .scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    priority: int = 0  # higher admits sooner (scheduler ages waiters up)
    latency_target_ms: float | None = None  # ranks the wait queue (scheduler)
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: str = "queued"  # queued | active | done | starved
    truncated_tokens: int = 0  # prompt tokens dropped by sliding-window admit


@dataclasses.dataclass(frozen=True)
class EngineStatus:
    """What a drain/status snapshot finished (and what it didn't).

    ``completed + in_flight + queued`` partitions the serving epoch;
    ``exhausted`` means the step budget ran out with work left.  The
    reference's health, preemption and prefix-sharing fields join with the
    fault guard and the paged pool.
    """

    completed: int
    in_flight: int
    queued: int
    steps: int
    exhausted: bool
    pool_utilization: float = 0.0  # used / total blocks
    pool_fragmentation: float = 0.0  # 1 - used token slots / allocated slots


@dataclasses.dataclass
class Ticket:
    """Streaming handle for one submitted request."""

    request: Request
    source: object  # anything with .step() -> bool

    @property
    def done(self) -> bool:
        return self.request.done

    def tokens(self):
        sent = 0
        while True:
            out = self.request.output
            while sent < len(out):
                yield out[sent]
                sent += 1
            if self.request.done or self.request.state == "starved":
                return
            if not self.source.step():
                return


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _extend_ladder(buckets: tuple[int, ...], cache_len: int) -> tuple[int, ...]:
    """Extend the prefill bucket ladder geometrically, capped below cache_len.

    ``cache_len`` itself is excluded so an admitted prompt always leaves
    decode room.
    """
    out = [int(b) for b in buckets]
    last = out[-1]
    while last * 2 < cache_len:
        last *= 2
        out.append(last)
    return tuple(out)


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int = 4,
        cache_len: int = 256,
        prefill_buckets: tuple[int, ...] = (32, 64, 128),
        runtime=None,
        block_size: int | None = None,
        n_blocks: int | None = None,
        scheduler: SchedulerConfig | None = None,
        on_prefill=None,
        on_decode=None,
    ):
        # Every prefill and decode dispatches against ONE runtime (the caller's
        # current one when not given), activated around each forward.
        self.runtime = runtime if runtime is not None else current_runtime()
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prefill_buckets = prefill_buckets
        self._ladder = _extend_ladder(tuple(prefill_buckets), cache_len)
        self.pool = KVPool(model, lanes=max_batch, cache_len=cache_len,
                           block_size=block_size, n_blocks=n_blocks)
        self.scheduler = Scheduler(scheduler)
        self.positions = np.zeros(max_batch, dtype=np.int64)  # next position to write
        self.slots: list[Request | None] = [None] * max_batch
        self.steps = 0
        self._uid = itertools.count()
        self._epoch_requests: list[Request] = []
        # Decode width buckets: powers of two up to max_batch.
        buckets, w = [], 1
        while w < max_batch:
            buckets.append(w)
            w *= 2
        buckets.append(max_batch)
        self._width_buckets = tuple(buckets)
        self.on_prefill = on_prefill
        self.on_decode = on_decode

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def cache(self) -> dict:
        """Dense read view of all lanes, for inspection."""
        return self.pool.gather(range(self.max_batch))

    # -- lane admission -------------------------------------------------------
    def _free_lane(self) -> int | None:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _seq_tokens(self, req: Request) -> np.ndarray:
        prompt = np.asarray(req.prompt, dtype=np.int32)
        if req.output:
            return np.concatenate([prompt, np.asarray(req.output, dtype=np.int32)])
        return prompt

    def _fits(self, req: Request) -> bool:
        return self.pool.can_fit(_bucket(len(self._seq_tokens(req)), self._ladder))

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill ``req`` into ``slot`` and emit its first token."""
        tail = self._seq_tokens(req)
        plen = _bucket(len(tail), self._ladder)
        if len(tail) > plen:
            # A prompt longer than the largest bucket keeps its last plen tokens.
            req.truncated_tokens = len(tail) - plen
            tail = tail[-plen:]
        prompt = np.zeros(plen, dtype=np.int64)
        if len(tail):
            prompt[-len(tail):] = tail  # left-pad with id 0 (causal end-aligned)
        batch = {"tokens": torch.from_numpy(prompt[None, :]).to(self.device)}
        with self.runtime.activate():
            logits, cache1 = self.model.prefill(self.params, batch, self.cache_len)
        self.pool.release(slot)
        if not self.pool.ensure(slot, plen):
            raise RuntimeError(f"admitted request {req.uid} with no blocks for plen={plen}")
        self.pool.admit(slot, cache1)
        self.pool.note_tokens(slot, min(len(tail), plen))
        if self.on_prefill is not None:
            self.on_prefill(plen)
        req.output.append(int(torch.argmax(logits[0, -1])))
        req.state = "active"
        self.slots[slot] = req
        self.positions[slot] = plen

    def _grow_active(self) -> None:
        """Every active lane must own the block its next token writes into.
        In the dense layout a lane's one block covers ``cache_len`` tokens,
        so this never needs to preempt."""
        for lane, req in enumerate(self.slots):
            if req is None:
                continue
            need = int(self.positions[lane]) + 1
            if not self.pool.ensure(lane, need):
                raise RuntimeError(f"lane {lane} has no block for position {need - 1}")
            self.pool.note_tokens(lane, need)

    # -- decode ---------------------------------------------------------------
    def _width(self, n_active: int) -> int:
        return _bucket(n_active, self._width_buckets)

    def _decode_active(self) -> list[Request]:
        """One batched decode over the active lanes, padded with idle lanes
        to the smallest width bucket that fits; returns the requests that
        received a token."""
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        width = self._width(len(active))
        idle = [i for i, r in enumerate(self.slots) if r is None]
        sel = active + idle[: width - len(active)]
        tokens = np.zeros((width, 1), dtype=np.int64)
        for row, lane in enumerate(active):
            tokens[row, 0] = self.slots[lane].output[-1]
        dev = self.device
        with self.runtime.activate():
            logits, new_cache = self.model.decode_step(
                self.params,
                self.pool.gather(sel),
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(self.positions[sel]).to(dev),
            )
        self.pool.scatter(sel, new_cache)
        if self.on_decode is not None:
            self.on_decode(width)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        got = []
        for row, lane in enumerate(active):
            r = self.slots[lane]
            self.positions[lane] += 1
            tok = int(nxt[row])
            r.output.append(tok)
            got.append(r)
            if (
                len(r.output) >= r.max_new_tokens
                or (r.eos_id is not None and tok == r.eos_id)
                or self.positions[lane] >= self.cache_len - 1
            ):
                r.done = True
                r.state = "done"
                self.slots[lane] = None
                self.pool.retire(lane)  # blocks stay readable until reclaimed
        self.steps += 1
        return got

    # -- public ---------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16, eos_id: int | None = None,
               priority: int = 0, uid: int | None = None) -> Ticket:
        """Enqueue one prompt; returns a streaming :class:`Ticket`."""
        req = Request(
            uid=uid if uid is not None else next(self._uid),
            prompt=np.asarray(prompt, dtype=np.int32),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            priority=priority,
        )
        return self.submit_request(req)

    def submit_request(self, req: Request) -> Ticket:
        """Enqueue a pre-built :class:`Request`."""
        self.scheduler.submit(req, step=self.steps)
        self._epoch_requests.append(req)
        return Ticket(req, self)

    def pending(self) -> bool:
        """Work remains: requests waiting or lanes mid-decode."""
        return bool(len(self.scheduler) or any(s is not None for s in self.slots))

    def step(self) -> bool:
        """One scheduling round (admit -> grow -> decode).

        Returns False when no progress was possible (nothing admitted and no
        active lane decoded).
        """
        self.scheduler.begin_step()
        emitted: list[Request] = []
        while len(self.scheduler):
            lane = self._free_lane()
            if lane is None:
                break
            req = self.scheduler.pop_next(self.steps, fits=self._fits)
            if req is None:
                break
            self._admit(req, lane)
            emitted.append(req)
        self._grow_active()
        emitted.extend(self._decode_active())
        return bool(emitted)

    def status(self) -> EngineStatus:
        """Live snapshot over this serving epoch (since the last drain)."""
        waiting = self.scheduler.waiting()
        in_flight = sum(s is not None for s in self.slots)
        return EngineStatus(
            completed=sum(r.done for r in self._epoch_requests),
            in_flight=in_flight,
            queued=len(waiting),
            steps=self.steps,
            exhausted=bool(waiting or in_flight),
            **self._pool_health(),
        )

    def _pool_health(self) -> dict:
        ps = self.pool.stats()
        return {"pool_utilization": ps["utilization"], "pool_fragmentation": ps["fragmentation"]}

    def drain(self, *, max_steps: int = 10_000) -> EngineStatus:
        """Serve everything submitted until done or the step budget runs out.

        Waiting requests left when the budget is exhausted are marked
        ``state="starved"`` and dropped from the queue (``done=False``).
        Closes the serving epoch: the next drain reports only requests
        submitted after this one (in-flight survivors carry over).
        """
        while self.pending() and self.steps < max_steps:
            if not self.step():
                break
        exhausted = self.pending()
        starved = self.scheduler.clear()
        for r in starved:
            r.state = "starved"
        reqs = self._epoch_requests
        status = EngineStatus(
            completed=sum(r.done for r in reqs),
            in_flight=sum(s is not None for s in self.slots),
            queued=len(starved),
            steps=self.steps,
            exhausted=exhausted,
            **self._pool_health(),
        )
        self._epoch_requests = [r for r in reqs if r.state == "active"]
        return status
