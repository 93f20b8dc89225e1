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
too, as in the reference).

Compiled programs, as in the reference: one program per prefill bucket
(``_prefill_fn``, ``_prefill_cache``) and one per decode width bucket
(``_decode_fn``, ``_decode_cache``).  A program owns static buffers (the
prompt tokens; the decode tokens, positions and the pool's block and lane
row ids, and a fixed decode view of the cache) that the host fills through
host staging buffers (pinned on the card) before each call.  On a CUDA model
each program is a CUDA graph, captured once and replayed on every later
call, on a stream of the engine's own (ordered after the caller's stream and
before its next work): a decode replay gathers the selected lanes into the view, runs
``model.decode_step``, scatters the view back into the pool (re-zeroing
scratch block 0) and takes the argmax; a prefill replay runs
``model.prefill`` and the argmax, and ``pool.admit`` copies its cache out.
Kernel selection runs against the engine's
:class:`~repro_torch.core.runtime.KernelRuntime` when a program is captured,
as the reference selects when it traces; each program records the runtime's
policy epoch, and a moved epoch (an ``install``) drops every program, so the
next call captures under the new policy.  A failed capture or replay raises.
On a CPU model (or with ``cuda_graphs=False``) the same programs run their
body eagerly, selecting on every call.

Streaming admission, SLO mode, retuning, deployment offers and rollback wait
for later parts of the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import time

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


@contextlib.contextmanager
def _no_gc():
    """Hold off Python's cyclic collector: a collection during a capture could free
    a dead engine's graphs, and destroying a graph while a stream captures is an
    operation CUDA forbids there (it invalidates the capture)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass(frozen=True)
class ProgramRecord:
    """One program an engine built: what, under which policy epoch, how."""

    kind: str  # "prefill" | "decode"
    size: int  # prefill bucket or decode width
    epoch: int
    captured: bool  # a CUDA graph (else the body runs eagerly on every call)
    seconds: float  # warm-up and capture


class _Program:
    """One prefill bucket's or decode width's step: static input buffers, the
    body that reads them, and its CUDA graph where it was captured.

    ``outputs`` holds the body's outputs: the graph's own tensors once
    captured (each replay rewrites them in place), else the latest eager
    run's."""

    def __init__(self, kind: str, size: int, epoch: int, inputs: dict[str, torch.Tensor], body):
        self.kind, self.size, self.epoch = kind, size, epoch
        self.inputs = inputs
        pin = next(iter(inputs.values())).device.type == "cuda"
        self._host = {name: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for name, t in inputs.items()}
        self.body = body
        self.graph: torch.cuda.CUDAGraph | None = None
        self.stream: torch.cuda.Stream | None = None  # the graph's capture and replay stream
        self.view: dict | None = None  # a decode program's fixed cache view
        self.outputs: dict = {}
        self.runs = 0

    def stage(self, **values) -> None:
        """Copy host values into the static inputs, through the staging buffers."""
        for name, value in values.items():
            host = self._host[name]
            host.numpy()[...] = value
            self.inputs[name].copy_(host, non_blocking=True)

    def replay(self) -> None:
        """Replay the graph on its capture stream, ordered after the caller's
        stream (the staged inputs) and before the caller's next work (the
        outputs): the kernels' workspaces the graph captured are that
        stream's, so only work on that stream ever touches them."""
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        caller.wait_stream(self.stream)

    def run(self, runtime) -> dict:
        if self.graph is not None:
            self.replay()
        else:
            with runtime.activate():
                self.outputs = self.body()
        self.runs += 1
        return self.outputs


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int = 4,
        cache_len: int = 256,
        prefill_buckets: tuple[int, ...] = (32, 64, 128),
        bundle=None,
        device: str | None = None,
        runtime=None,
        block_size: int | None = None,
        n_blocks: int | None = None,
        scheduler: SchedulerConfig | None = None,
        on_prefill=None,
        on_decode=None,
        cuda_graphs: bool | None = None,
    ):
        """``cuda_graphs``: None captures every program as a CUDA graph on a
        CUDA model and runs the bodies eagerly on a CPU one; True on a CPU
        model raises.  False on a CUDA model runs the bodies eagerly: the
        eager engine, kept only to compare against the graphs (the
        counterpart of the reference under ``jax.disable_jit()``).

        ``bundle`` (a ``DeploymentBundle`` or a path): installed into the
        runtime before the first program is built, resolved for ``device``
        (a device name; default: the detected host), as the reference does;
        ``engine.device`` is then the resolved device name.  On a CUDA model
        a bundle whose resolved deployment holds configs the port has not
        compiled raises here."""
        # Every prefill and decode dispatches against ONE runtime (the caller's
        # current one when not given), activated around each forward.
        self.runtime = runtime if runtime is not None else current_runtime()
        self.deployment = None
        self.device = device
        if bundle is not None:
            self.deployment = self.runtime.install_bundle(bundle, device, target=model.device.type)
            self.device = self.runtime.active_device()
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
        on_card = model.device.type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a model on a CUDA device, not {model.device}")
        self.cuda_graphs = on_card if cuda_graphs is None else bool(cuda_graphs)
        # Compiled programs, keyed as the reference keys its jit caches; never
        # shared between engines.  Both are dropped when the runtime's policy
        # epoch moves.
        self._prefill_cache: dict[int, _Program] = {}
        self._decode_cache: dict[int, _Program] = {}
        self._programs_epoch = self.runtime.policy_epoch()
        self.program_log: list[ProgramRecord] = []  # every program built, dropped ones included
        # The stream this engine warms up, captures and replays on.  The kernels key
        # their workspaces by stream and a graph keeps the ones it captured, so no
        # work on another stream touches them (engines that torch's stream pool puts
        # on one stream run in turn).
        self._stream: torch.cuda.Stream | None = None

    @property
    def cache(self) -> dict:
        """Dense read view of all lanes, for inspection."""
        return self.pool.gather(range(self.max_batch))

    # -- compiled programs ------------------------------------------------------
    def _sync_programs(self) -> None:
        """Drop every program captured under an older policy epoch (the
        counterpart of the reference dropping its programs on adoption)."""
        epoch = self.runtime.policy_epoch()
        if epoch != self._programs_epoch:
            self._prefill_cache.clear()
            self._rejit_decode()
            self._programs_epoch = epoch

    def _rejit_decode(self) -> None:
        self._decode_cache.clear()

    def _prefill_fn(self, plen: int) -> _Program:
        self._sync_programs()
        if plen not in self._prefill_cache:
            tokens = torch.zeros((1, plen), dtype=torch.int64, device=self.model.device)

            def body():
                logits, cache1 = self.model.prefill(self.params, {"tokens": tokens}, self.cache_len)
                return {"cache": cache1, "logits": logits, "next": torch.argmax(logits[0, -1])}

            # No side effect: pool.admit copies the cache out after the call.
            self._prefill_cache[plen] = self._build("prefill", plen, {"tokens": tokens}, body, body)
        return self._prefill_cache[plen]

    def _decode_fn(self, width: int) -> _Program:
        self._sync_programs()
        if width not in self._decode_cache:
            dev = self.model.device
            inputs = {"tokens": torch.zeros((width, 1), dtype=torch.int64, device=dev)}
            for name in ("positions", "blocks", "lanes"):
                inputs[name] = torch.zeros(width, dtype=torch.int64, device=dev)
            view = self.pool.decode_view(width)  # raises on a replicated leaf, which scatter rebinds

            def forward():
                self.pool.gather_rows(inputs["blocks"], inputs["lanes"], out=view)
                return self.model.decode_step(self.params, view, inputs["tokens"], inputs["positions"])

            def body():
                logits, new_cache = forward()
                self.pool.scatter_rows(inputs["blocks"], inputs["lanes"], new_cache)
                return {"logits": logits, "next": torch.argmax(logits[:, -1], dim=-1)}

            def warm():
                # The whole body but the scatter, its one side effect: the model
                # advances only the gathered copy.
                logits, _ = forward()
                torch.argmax(logits[:, -1], dim=-1)

            prog = self._build("decode", width, inputs, body, warm)
            prog.view = view
            self._decode_cache[width] = prog
        return self._decode_cache[width]

    def _build(self, kind: str, size: int, inputs: dict, body, warm) -> _Program:
        """A program over ``inputs`` running ``body``: warmed up once (``warm``,
        without side effects), then captured where the engine takes CUDA graphs."""
        t0 = time.perf_counter()
        prog = _Program(kind, size, self._programs_epoch, inputs, body)
        if not self.cuda_graphs:
            with self.runtime.activate():
                warm()
        else:
            dev = self.model.device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            stream = prog.stream = self._stream
            # Torch's recipe: the warm-up runs on the capture stream, which allocates
            # the kernels' workspaces for that stream outside the capture.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), self.runtime.activate():
                warm()
            torch.cuda.current_stream(dev).wait_stream(stream)
            prog.graph = torch.cuda.CUDAGraph()
            with _no_gc(), torch.cuda.graph(prog.graph, stream=stream), self.runtime.activate():
                prog.outputs = body()
        self.program_log.append(ProgramRecord(kind, size, prog.epoch, prog.graph is not None,
                                              time.perf_counter() - t0))
        return prog

    def programs(self) -> dict:
        """Live programs by (kind, size): policy epoch, captured, calls so far."""
        return {(p.kind, p.size): {"epoch": p.epoch, "captured": p.graph is not None, "runs": p.runs}
                for cache in (self._prefill_cache, self._decode_cache) for p in cache.values()}

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
        prog = self._prefill_fn(plen)
        prog.stage(tokens=prompt[None, :])
        out = prog.run(self.runtime)
        self.pool.release(slot)
        if not self.pool.ensure(slot, plen):
            raise RuntimeError(f"admitted request {req.uid} with no blocks for plen={plen}")
        self.pool.admit(slot, out["cache"])  # before any other call of this program
        self.pool.note_tokens(slot, min(len(tail), plen))
        if self.on_prefill is not None:
            self.on_prefill(plen)
        req.output.append(int(out["next"].cpu()))
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
        prog = self._decode_fn(width)
        blocks, lanes = self.pool.row_ids(sel)
        prog.stage(tokens=tokens, positions=self.positions[sel], blocks=blocks, lanes=lanes)
        out = prog.run(self.runtime)
        if self.on_decode is not None:
            self.on_decode(width)
        nxt = out["next"].cpu().numpy()  # the step's one host sync
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
