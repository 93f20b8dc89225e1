"""Continuous-batching serving engine over a paged KV cache, ported from ``repro/serve/engine.py``.

The engine owns ``max_batch`` decode **lanes** backed by a block-allocated
:class:`~repro_torch.serve.kvpool.KVPool` (k/v blocks for a transformer, one
recurrent-state row per lane for RWKV6, both for Hymba, whose SSM state and
sliding-window rings shorter than ``cache_len`` are lane rows), a priority
:class:`~repro_torch.serve.scheduler.Scheduler` with starvation aging and
preemption, and one program per prefill bucket, chunk width and decode width:

    ticket = engine.submit(prompt, max_new_tokens=32, priority=1, latency_target_ms=8.0)
    for tok in ticket.tokens():   # streams; drives engine.step() as needed
        ...
    status = engine.drain()       # run everything submitted to completion

One ``engine.step()`` is one scheduling round, in the reference's order:
adopt an offered deployment, update SLO mode, admit waiting requests into
free lanes (preempting a weaker resident when the pool is dry and a waiter
outranks it), run the budgeted prefill chunks of lanes still prefilling,
grow every active lane's block table to cover its next token (preempting the
scheduler's victim when the pool runs dry), then one batched decode advances
every active lane at the smallest power-of-two width bucket that fits,
padded with idle lanes (whose recurrent-state rows advance too, as in the
reference) and with lanes still prefilling.

**Admission regimes**, as in the reference.  The *legacy* regime prefills a
prompt left-padded to its bucket with token 0 in one program, the first token
from the last position's logits.  When the pool is paged and the model
supports ``prefill_chunk`` (the transformer with a plain k/v cache; an int8
cache, RWKV6 and Hymba stay legacy), admission *streams*: the sequence is
left-aligned, any cached prefix is aliased from the pool's prefix index
(``prefix_sharing``), and the rest is prefilled in chunks of at most
``prefill_chunk_tokens`` (the scheduler's per-step token budget) that
interleave with decode rounds; the final chunk's last real row gives the
first token.

**SLO mode**: when a latency-targeted request's recent per-token time (on
``clock``, the wall clock by default) or the engine's recent step time
overruns its target, the engine installs an
:class:`~repro_torch.core.runtime.Objective` on its runtime (selection then
routes through the policy's ``select_for_objective``), caps admission below
the current width bucket and the chunk width one ladder rung, and drops its
programs so they are captured again under the objective; it leaves the mode
after ``slo_patience`` calm steps or when no targeted work remains.

Compiled programs, as in the reference: one program per prefill bucket
(``_prefill_fn``, ``_prefill_cache``), chunk width (``_chunk_fn``,
``_chunk_cache``) and decode width (``_decode_fn``, ``_decode_cache``).  A
program owns static buffers (the prompt or chunk tokens; a chunk's ``start``,
``last_row`` and its lane's block table; the decode tokens, positions and the
``(W, blocks_per_lane)`` block table and lane ids, and a fixed dense view of
the cache) that the host fills through host staging buffers (pinned on the
card) before each call.  On a CUDA model each program is a CUDA graph,
captured once and replayed on every later call, on a stream of the engine's
own (ordered after the caller's stream and before its next work): a decode
or chunk replay gathers its lanes' blocks into the view, runs
``model.decode_step`` or ``model.prefill_chunk``, scatters the view back
into the pool (re-zeroing scratch block 0) and takes the argmax; a prefill
replay runs ``model.prefill`` and the argmax, and ``pool.admit`` copies its
cache out.  Nothing in a chunk program reads ``start`` or ``last_row`` on the
host, so one capture serves every chunk offset.
Kernel selection runs against the engine's
:class:`~repro_torch.core.runtime.KernelRuntime` once per program build, as
the reference selects once per trace: the build's first run (the warm-up)
selects and pins each call's config (``SelectionPins``), and the capture and
every later eager run replay the pins.  A change of the live policy (an
``install``, a retune's hot swap, a rollback) or of the serving objective
drops every program, so the next call captures under the new policy; the
breaker's quarantines do not, as the reference's compiled programs keep
their kernels.  On a CPU model (or with ``cuda_graphs=False``) the same
programs run their body eagerly on every call, with the pinned configs.

Fault containment and continuous tuning, as in the reference (its DESIGN.md
§8 and §11): every program runs through :meth:`ServingEngine._run_program`,
which gives an injected fault at ``engine.prefill`` / ``engine.decode``, or a
contained failure escaping a program (a kernel failing at a capture or an
eager replay, or a dispatch fault with nothing compiled left), one retry
after dropping that program, so the retry builds it again (a warm-up and a
capture) under the breaker's redirects; a second failure propagates.  A
health state machine (``healthy`` / ``degraded``) follows the incidents; an
auto-rollback watchdog reinstalls the previous deployment after
``rollback_threshold`` incidents since a swap; ``maybe_retune`` runs
telemetry -> drift -> incremental retune -> canary -> hot swap every
``retune_interval`` steps; ``offer_deployment`` stages an external
deployment that ``adopt_deployment`` canaries and swaps in at the next step
boundary.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core.faults import GUARDED_EXCEPTIONS, incident
from ..core.gpubench import CARD_LOCK
from ..core.retune import DEFAULT_DRIFT_THRESHOLD, DEFAULT_MIN_EVENTS
from ..core.runtime import Objective, SelectionPins, current_runtime
from .kvpool import KVPool
from .scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    priority: int = 0  # higher admits sooner (scheduler ages waiters up)
    latency_target_ms: float | None = None  # per-token SLO -> kernel selection
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: str = "queued"  # queued | prefilling | active | preempted | done | starved
    truncated_tokens: int = 0  # prompt tokens dropped by sliding-window admit
    retries: int = 0  # kernel-fault retries this request survived
    preemptions: int = 0  # times evicted back to the wait queue
    token_ms: list[float] = dataclasses.field(default_factory=list)  # per-token latency
    routed_to: str | None = None  # engine key a Router dispatched this to


@dataclasses.dataclass(frozen=True)
class RetuneEvent:
    """One firing of the continuous tuning loop (the reference's, field for field).

    ``swapped`` distinguishes a drift check that triggered a retune and a
    policy hot swap from one that only looked; ``epoch`` is the runtime's
    policy epoch after the swap.  ``families`` names the families whose
    tunings were refreshed (empty when nothing triggered); ``drift_score`` /
    ``unseen_fraction`` report the worst family observed.  ``rejected``
    names families whose candidate failed the canary and was never
    installed; ``rolled_back`` marks an auto-rollback; ``source`` says who
    produced the swapped-in deployment (``"drift"``, or the label an
    :meth:`ServingEngine.adopt_deployment` caller gave).
    """

    step: int
    drift_score: float
    unseen_fraction: float
    swapped: bool
    triggered: bool  # False + high score means the min-events floor blocked it
    n_events: int
    n_configs: int
    epoch: int
    families: tuple[str, ...] = ()
    rejected: tuple[str, ...] = ()
    rolled_back: bool = False
    source: str = "drift"


@dataclasses.dataclass(frozen=True)
class EngineStatus:
    """What a drain/status snapshot finished (and what it didn't).

    ``exhausted`` means the step budget ran out with work left.  A request
    evicted back to the wait queue counts once: in live snapshots it moves
    from ``in_flight`` to ``preempted`` and back on re-admission, so
    ``completed + in_flight + queued + preempted`` partitions the epoch; a
    drain report instead uses ``preempted`` for how many requests were
    evicted at least once while it served.  ``health`` is ``"degraded"``
    while dispatch incidents are arriving or configs sit in quarantine,
    ``"healthy"`` once a check window is clean.
    """

    completed: int
    in_flight: int
    queued: int
    steps: int
    exhausted: bool
    health: str = "healthy"
    preempted: int = 0
    # -- pool health (the paged / prefix-reuse path) --------------------------
    pool_utilization: float = 0.0  # used / total blocks
    pool_fragmentation: float = 0.0  # 1 - used token slots / allocated slots
    shared_blocks: int = 0  # blocks aliased by more than one lane
    prefix_hits: int = 0  # admissions that reused a cached prefix
    prefix_lookups: int = 0  # admissions that probed the prefix index

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_lookups if self.prefix_lookups else 0.0


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

    def result(self) -> list[int]:
        """Block (stepping the source) until done; return the full output."""
        for _ in self.tokens():
            pass
        return list(self.request.output)


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


def _batch_extra(v) -> torch.Tensor:
    """One extra prefill input shaped for the batch-1 prefill, as the reference
    shapes it: a scalar gains a batch axis, a leading batch-1 axis passes
    through, anything else is per-sequence data and gains one."""
    v = torch.as_tensor(v)
    if v.ndim == 0 or v.shape[0] != 1:
        return v[None]
    return v


def _recent_ms(req: Request, k: int = 3) -> float | None:
    if not req.token_ms:
        return None
    xs = req.token_ms[-k:]
    return sum(xs) / len(xs)


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


def _capture(graph, body):
    """``body()`` captured into ``graph`` on the current stream.

    A failure inside the body (a kernel refusing to allocate during the
    capture, a launch error that invalidates it) ends the capture and
    propagates as itself: ``torch.cuda.graph``'s exit would replace it with
    the error that ending an invalidated capture raises, which the engine's
    retry does not contain, and would leave the capture stream current."""
    graph.capture_begin()
    try:
        out = body()
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass  # the capture was invalidated: the body's failure is the one to report
        raise
    graph.capture_end()
    return out


@dataclasses.dataclass(frozen=True)
class ProgramRecord:
    """One program an engine built: what, under which policy epoch, how."""

    kind: str  # "prefill" | "chunk" | "decode"
    size: int  # prefill bucket, chunk width or decode width
    epoch: int  # the runtime's policy epoch at the build
    captured: bool  # a CUDA graph (else the body runs eagerly on every call)
    seconds: float  # warm-up and capture


class _Program:
    """One prefill bucket's, chunk width's or decode width's step: static input
    buffers, the body that reads them, and its CUDA graph where it was
    captured.

    ``outputs`` holds the body's outputs: the graph's own tensors once
    captured (each replay rewrites them in place), else the latest eager
    run's.  ``pins`` holds the configs the build's warm-up selected, which
    the capture and every eager run launch."""

    def __init__(self, kind: str, size: int, epoch: int, inputs: dict[str, torch.Tensor], body):
        self.kind, self.size, self.epoch = kind, size, epoch
        self.inputs = inputs
        self.pins = SelectionPins()
        pin = next(iter(inputs.values())).device.type == "cuda"
        self._host = {name: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for name, t in inputs.items()}
        self.body = body
        self.graph: torch.cuda.CUDAGraph | None = None
        self.stream: torch.cuda.Stream | None = None  # the graph's capture and replay stream
        self.view: dict | None = None  # a decode or chunk program's fixed cache view
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
            with runtime.activate(), runtime.pinning(self.pins):
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
        extra_inputs: dict | None = None,
        bundle=None,
        device: str | None = None,
        runtime=None,
        block_size: int | None = None,
        n_blocks: int | None = None,
        scheduler: SchedulerConfig | None = None,
        prefill_chunk_tokens: int | None = None,
        prefix_sharing: bool = True,
        slo_aware: bool = True,
        slo_patience: int = 4,
        clock=None,
        on_prefill=None,
        on_decode=None,
        cuda_graphs: bool | None = None,
        retune_interval: int | None = None,
        drift_threshold: float = DEFAULT_DRIFT_THRESHOLD,
        retune_min_events: int = DEFAULT_MIN_EVENTS,
        canary: bool = True,
        rollback_threshold: int = 3,
        swap_history: int = 4,
        retune_dataset_builder=None,
    ):
        """``cuda_graphs``: None captures every program as a CUDA graph on a
        CUDA model and runs the bodies eagerly on a CPU one; True on a CPU
        model raises.  False on a CUDA model runs the bodies eagerly: the
        eager engine, kept only to compare against the graphs (the
        counterpart of the reference under ``jax.disable_jit()``).

        ``extra_inputs``: more prefill inputs beside the tokens (a VLM's
        ``image_embs``), engine-wide constants as in the reference: each is
        given a batch-1 axis where it has none (:func:`_batch_extra`) and moved
        to the model's device once, so every prefill program reads the same
        tensor at its capture and at every replay.  Extras keep the legacy
        admission (no streaming, no prefix sharing), as in the reference.

        ``bundle`` (a ``DeploymentBundle`` or a path): installed into the
        runtime before the first program is built, resolved for ``device``
        (a device name; default: the detected host), as the reference does;
        ``engine.device`` is then the resolved device name.  On a CUDA model
        a bundle whose resolved deployment holds configs the port has not
        compiled raises here.

        The paged tier, as in the reference: ``block_size`` / ``n_blocks``
        page the pool (``block_size=None``: one dense block per lane);
        ``prefill_chunk_tokens`` caps a prefill chunk (and is the default
        per-step prefill budget); ``prefix_sharing`` aliases cached prompt
        prefixes; ``slo_aware`` / ``slo_patience`` drive SLO mode on
        ``clock`` (a zero-argument function returning seconds; default
        ``time.perf_counter``).

        Continuous tuning and containment, as in the reference:
        ``retune_interval`` (steps between drift checks; ``None``: never by
        itself), ``drift_threshold`` and ``retune_min_events`` (the drift
        check's), ``canary`` (gate candidates), ``rollback_threshold``
        (incidents after a swap that roll it back), ``swap_history``
        (previous deployments kept for rollback).  ``retune_dataset_builder``
        (``(problems, device) -> TuningDataset``) is the matmul table a
        retune fits: default the H100 model; on the card a ``gpubench``
        measurement."""
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
        self.extra_inputs = {k: _batch_extra(v).to(model.device) for k, v in (extra_inputs or {}).items()}
        self.pool = KVPool(model, lanes=max_batch, cache_len=cache_len,
                           block_size=block_size, n_blocks=n_blocks)
        # Streaming admission (chunked prefill + prefix sharing) needs a
        # chunk-capable model, no extra prefill inputs, and either a chunk
        # budget or a paged pool with sharing; everything else keeps the
        # legacy admission.
        chunk_capable = (hasattr(model, "prefill_chunk") and model.supports_chunked_prefill()
                         and not self.extra_inputs)
        paged = self.pool.block_size < self.cache_len
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self._sharing = bool(prefix_sharing) and paged and chunk_capable
        self._streaming = chunk_capable and (prefill_chunk_tokens is not None or self._sharing)
        if (self._streaming and prefill_chunk_tokens is not None
                and (scheduler is None or scheduler.prefill_token_budget is None)):
            # The chunk cap doubles as the default per-step prefill budget.
            scheduler = dataclasses.replace(scheduler or SchedulerConfig(),
                                            prefill_token_budget=int(prefill_chunk_tokens))
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
        # shared between engines.  Both are dropped when the runtime's live
        # policy changes.
        self._prefill_cache: dict[int, _Program] = {}
        self._decode_cache: dict[int, _Program] = {}
        self._chunk_cache: dict[int, _Program] = {}
        self._programs_policy = self._live_policy()
        self.program_log: list[ProgramRecord] = []  # every program built, dropped ones included
        # The stream this engine warms up, captures and replays on.  The kernels key
        # their workspaces by stream and a graph keeps the ones it captured, so no
        # work on another stream touches them (engines that torch's stream pool puts
        # on one stream run in turn).
        self._stream: torch.cuda.Stream | None = None

        # -- SLO-aware selection -------------------------------------------------
        self.slo_aware = slo_aware
        self.slo_patience = max(int(slo_patience), 1)
        self._prefix_reused_tokens = 0  # prefill tokens skipped through aliasing
        self.slo_events: list[tuple[int, str, float | None]] = []
        self._slo_mode = False
        self._slo_cap: int | None = None
        self._slo_ok = 0
        self._step_ms: deque = deque(maxlen=8)  # recent per-step times
        self._clock = clock if clock is not None else time.perf_counter

        # -- continuous tuning loop --------------------------------------------
        self.retune_interval = retune_interval
        self.drift_threshold = drift_threshold
        self.retune_min_events = retune_min_events
        self.retune_dataset_builder = retune_dataset_builder
        self.retune_events: list[RetuneEvent] = []
        self.retune_seconds: list[dict] = []  # per retune cycle: measure / fit / canary seconds
        self._last_retune_check = 0
        # -- failure containment -----------------------------------------------
        self.canary = canary
        self.rollback_threshold = max(int(rollback_threshold), 1)
        self.health = "healthy"
        self.health_events: list[tuple[int, str]] = []  # (step, new state)
        self._incidents_seen = self.runtime.incident_count()
        # Previous deployments, newest last: maybe_retune pushes the incumbent
        # before installing a candidate, the rollback watchdog pops it.
        self._swap_history: deque = deque(maxlen=max(int(swap_history), 1))
        self._incidents_at_swap: int | None = None
        # An externally offered deployment, staged from any thread and adopted
        # at the next step boundary, so a swap never lands mid-step.
        self._offer_lock = threading.Lock()
        self._offered: tuple[object, str] | None = None
        if retune_interval is not None:
            # Telemetry source: the runtime's selection log.
            self.runtime.set_selection_logging(True)

    @property
    def cache(self) -> dict:
        """Dense read view of all lanes, for inspection."""
        return self.pool.gather(range(self.max_batch))

    # -- compiled programs ------------------------------------------------------
    def _live_policy(self) -> tuple:
        """What the programs were built against: the runtime's live policy,
        the device it serves and the serving objective.  The breaker is not
        part of it: a quarantine redirects new selections and leaves programs
        already built alone, as the reference's compiled programs keep theirs."""
        return self.runtime.policy(), self.runtime.active_device(), self.runtime.objective()

    def _sync_programs(self) -> None:
        """Drop every program built under another live policy or objective (the
        counterpart of the reference dropping its programs on adoption)."""
        policy, device, objective = self._live_policy()
        built = self._programs_policy
        if policy is not built[0] or device != built[1] or objective != built[2]:
            self._drop_programs()

    def _drop_programs(self) -> None:
        self._prefill_cache.clear()
        self._rejit_decode()
        self._programs_policy = self._live_policy()

    def _rejit_decode(self) -> None:
        self._decode_cache.clear()
        self._chunk_cache.clear()

    def _prefill_fn(self, plen: int) -> _Program:
        self._sync_programs()
        if plen not in self._prefill_cache:
            tokens = torch.zeros((1, plen), dtype=torch.int64, device=self.model.device)

            def body():
                logits, cache1 = self.model.prefill(self.params, {"tokens": tokens, **self.extra_inputs}, self.cache_len)
                return {"cache": cache1, "logits": logits, "next": torch.argmax(logits[0, -1])}

            # No side effect: pool.admit copies the cache out after the call.
            self._prefill_cache[plen] = self._build("prefill", plen, {"tokens": tokens}, body, body)
        return self._prefill_cache[plen]

    def _decode_fn(self, width: int) -> _Program:
        self._sync_programs()
        if width not in self._decode_cache:
            dev = self.model.device
            inputs = {"tokens": torch.zeros((width, 1), dtype=torch.int64, device=dev)}
            for name in ("positions", "lanes"):
                inputs[name] = torch.zeros(width, dtype=torch.int64, device=dev)
            inputs["blocks"] = torch.zeros((width, self.pool.blocks_per_lane), dtype=torch.int64, device=dev)
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

    def _chunk_fn(self, width: int) -> _Program:
        """The chunk-append prefill program of one chunk width: one lane's
        blocks gathered into a fixed one-row view, ``model.prefill_chunk`` at
        the staged ``start`` and ``last_row``, the view scattered back."""
        self._sync_programs()
        if width not in self._chunk_cache:
            dev = self.model.device
            inputs = {"tokens": torch.zeros((1, width), dtype=torch.int64, device=dev),
                      "start": torch.zeros((), dtype=torch.int64, device=dev),
                      "last_row": torch.zeros((), dtype=torch.int64, device=dev),
                      "blocks": torch.zeros((1, self.pool.blocks_per_lane), dtype=torch.int64, device=dev),
                      "lanes": torch.zeros(1, dtype=torch.int64, device=dev)}
            view = self.pool.decode_view(1)

            def forward():
                self.pool.gather_rows(inputs["blocks"], inputs["lanes"], out=view)
                return self.model.prefill_chunk(self.params, view, inputs["tokens"], inputs["start"],
                                                inputs["last_row"])

            def body():
                logits, cache = forward()
                self.pool.scatter_rows(inputs["blocks"], inputs["lanes"], cache)
                return {"logits": logits, "next": torch.argmax(logits[0, -1])}

            def warm():
                logits, _ = forward()  # the view only: the pool stays as it was
                torch.argmax(logits[0, -1])

            prog = self._build("chunk", width, inputs, body, warm)
            prog.view = view
            self._chunk_cache[width] = prog
        return self._chunk_cache[width]

    def _build(self, kind: str, size: int, inputs: dict, body, warm) -> _Program:
        """A program over ``inputs`` running ``body``: warmed up once (``warm``,
        without side effects), which selects and pins every call's config,
        then captured where the engine takes CUDA graphs.  A failure during
        the capture ends it and reaches :meth:`_run_program` as itself
        (:func:`_capture`)."""
        t0 = time.perf_counter()
        prog = _Program(kind, size, self.runtime.policy_epoch(), inputs, body)
        rt = self.runtime
        if not self.cuda_graphs:
            with rt.activate(), rt.pinning(prog.pins):
                warm()
        else:
            dev = self.model.device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            stream = prog.stream = self._stream
            # Torch's recipe: the warm-up runs on the capture stream, which allocates
            # the kernels' workspaces for that stream outside the capture.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream), rt.activate(), rt.pinning(prog.pins):
                warm()
            torch.cuda.current_stream(dev).wait_stream(stream)
            prog.pins.seal()
            prog.graph = torch.cuda.CUDAGraph()
            # The card is held against measurements on other threads (a control plane's
            # tune job), whose allocations and synchronisations would fail a capture in
            # the default (global) mode: gpubench's CARD_LOCK.
            with CARD_LOCK:
                # What torch.cuda.graph does on entry; its exit is _capture's.
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                with _no_gc(), torch.cuda.stream(stream), rt.activate(), rt.pinning(prog.pins):
                    prog.outputs = _capture(prog.graph, body)
        prog.pins.seal()
        self.program_log.append(ProgramRecord(kind, size, prog.epoch, prog.graph is not None,
                                              time.perf_counter() - t0))
        return prog

    def programs(self) -> dict:
        """Live programs by (kind, size): policy epoch, captured, calls so far."""
        return {(p.kind, p.size): {"epoch": p.epoch, "captured": p.graph is not None, "runs": p.runs}
                for cache in (self._prefill_cache, self._chunk_cache, self._decode_cache) for p in cache.values()}

    # -- lane admission -------------------------------------------------------
    def _free_lane(self) -> int | None:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _seq_tokens(self, req: Request) -> np.ndarray:
        """Tokens a (re-)admission must prefill: the prompt plus anything already
        generated (a preempted request resumes by prefilling both)."""
        prompt = np.asarray(req.prompt, dtype=np.int32)
        if req.output:
            return np.concatenate([prompt, np.asarray(req.output, dtype=np.int32)])
        return prompt

    def _fits(self, req: Request) -> bool:
        if self._streaming:
            return self.pool.can_fit(min(len(self._seq_tokens(req)), self._ladder[-1]))
        return self.pool.can_fit(_bucket(len(self._seq_tokens(req)), self._ladder))

    def _admit(self, req: Request, slot: int) -> bool:
        """Admit ``req`` into ``slot``; True if a first token was emitted
        (legacy monolithic prefill), False if the lane entered the
        ``"prefilling"`` state (streaming: chunks run in :meth:`_advance_prefills`)."""
        if self._streaming:
            self._admit_streaming(req, slot)
            return False
        tail = self._seq_tokens(req)
        plen = _bucket(len(tail), self._ladder)
        if len(tail) > plen:
            # A prompt longer than the largest bucket keeps its last plen tokens.
            req.truncated_tokens = len(tail) - plen
            tail = tail[-plen:]
        prompt = np.zeros(plen, dtype=np.int64)
        if len(tail):
            prompt[-len(tail):] = tail  # left-pad with id 0 (causal end-aligned)

        def run():
            prog = self._prefill_fn(plen)
            prog.stage(tokens=prompt[None, :])
            return prog.run(self.runtime)

        out = self._run_program("engine.prefill", run, retrace=lambda: self._prefill_cache.pop(plen, None),
                                request=req)
        # Back the lane with blocks (its previous tenant is reclaimed) and copy
        # the batch-1 prefill cache into them.
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
        return True

    # -- streaming admission (chunked prefill + prefix sharing) ---------------
    def _chunk_cap(self) -> int:
        """Largest chunk width one prefill program may cover right now: the
        biggest ladder value at or under ``prefill_chunk_tokens`` (the whole
        ladder if unset), one rung lower in SLO mode."""
        limit = self.prefill_chunk_tokens
        cap = self._ladder[0]
        for b in self._ladder:
            if limit is None or b <= limit:
                cap = max(cap, b)
        if self._slo_mode:
            below = [b for b in self._ladder if b < cap]
            cap = max(below) if below else self._ladder[0]
        return cap

    def _admit_streaming(self, req: Request, slot: int) -> None:
        """Left-aligned admission: alias any cached prefix, allocate the rest,
        and queue the sequence for budgeted chunked prefill.  No program runs
        here; the final chunk emits the first token."""
        seq = self._seq_tokens(req)
        keep = self._ladder[-1]
        if len(seq) > keep:
            # As in the legacy regime: keep the most recent tokens.
            req.truncated_tokens = len(seq) - keep
            seq = seq[-keep:]
        body = seq[:-1]
        shared_tokens = 0
        if self._sharing:
            # Match-then-release in one call: the lane's outgoing tenant may
            # own the matched blocks.
            shared_tokens = self.pool.admit_prefix(slot, body)
            self._prefix_reused_tokens += shared_tokens
        else:
            self.pool.release(slot)
        # Lane leaves must start from zeros: nothing below rewrites them whole.
        self.pool.reset_lane_state(slot)
        if not self.pool.ensure(slot, len(seq)):
            raise RuntimeError(f"admitted request {req.uid} with no blocks for {len(seq)} tokens")
        self.pool.note_tokens(slot, len(seq))
        # Chunks cover the whole sequence: the final chunk's last real row
        # predicts the first output token.  Sharing matches and registers the
        # body only, so the decode-frontier block stays private.
        req._chunk_tokens = np.asarray(seq, dtype=np.int64)
        req._chunk_pos = shared_tokens
        req._first_token = None
        req.state = "prefilling"
        self.slots[slot] = req
        self.positions[slot] = len(seq) - 1  # overwritten by the final chunk

    def _run_chunk(self, lane: int, req: Request, width: int) -> None:
        """One chunk-append program over ``[chunk_pos, chunk_pos + width)``."""
        toks = req._chunk_tokens
        s0 = req._chunk_pos
        chunk = np.zeros(width, dtype=np.int64)
        real = toks[s0:s0 + width]
        chunk[:len(real)] = real
        blocks, lanes = self.pool.row_ids([lane])

        def run():
            prog = self._chunk_fn(width)
            prog.stage(tokens=chunk[None, :], start=s0, last_row=len(real) - 1, blocks=blocks, lanes=lanes)
            return prog.run(self.runtime)

        out = self._run_program("engine.prefill", run, retrace=lambda: self._chunk_cache.pop(width, None),
                                request=req)
        if self.on_prefill is not None:
            self.on_prefill(width)
        req._chunk_pos = min(s0 + width, len(toks))
        if req._chunk_pos >= len(toks):
            # Final chunk: its last real row predicts the first output token
            # (read now: the program's outputs are rewritten by its next call).
            req._first_token = int(out["next"].cpu())
        if self._sharing:
            # Index the blocks this chunk completed right away, so siblings
            # admitted meanwhile can alias them (the body only: COW rule).
            self.pool.register_prefix(lane, toks[:min(req._chunk_pos, len(toks) - 1)])

    def _activate_lane(self, lane: int, req: Request) -> None:
        """Sequence fully cached: emit the first token from the final chunk
        and join the batched decode."""
        seq = req._chunk_tokens
        if self._sharing:
            self.pool.register_prefix(lane, seq[:-1])
        req.output.append(req._first_token)
        req._first_token = None
        req.state = "active"
        self.positions[lane] = len(seq)
        self.pool.note_tokens(lane, len(seq))

    def _advance_prefills(self) -> tuple[list[Request], list[Request]]:
        """Run chunk programs for ``"prefilling"`` lanes within this step's
        prefill-token budget; activate lanes whose sequence is cached.
        Returns ``(progressed, activated)``.  At least one chunk runs per step
        when a lane is prefilling (the budget is a soft cap, never a stall)."""
        progressed: list[Request] = []
        activated: list[Request] = []
        for lane, req in enumerate(self.slots):
            if req is None or req.state != "prefilling":
                continue
            did = False
            while req._chunk_pos < len(req._chunk_tokens):
                remaining = len(req._chunk_tokens) - req._chunk_pos
                width = min(self._chunk_cap(), _bucket(remaining, self._ladder))
                left = self.scheduler.prefill_budget_left()
                if width > left and self.scheduler._prefill_spent > 0:
                    break  # budget spent; resume next step
                self._run_chunk(lane, req, width)
                self.scheduler.charge_prefill(width)
                did = True
            if did:
                progressed.append(req)
            if req._chunk_pos >= len(req._chunk_tokens):
                self._activate_lane(lane, req)
                activated.append(req)
        return progressed, activated

    # -- preemption -----------------------------------------------------------
    def _preempt(self, lane: int) -> Request:
        """Evict the lane's resident back to the wait queue, reclaiming its
        blocks; it keeps its output and re-admits through prompt+output prefill."""
        req = self.slots[lane]
        self.slots[lane] = None
        self.pool.release(lane)
        req.state = "preempted"
        req.preemptions += 1
        self.scheduler.submit(req, step=self.steps)
        return req

    def _pick_victim(self, running: list) -> Request | None:
        """The scheduler's victim, preferring lanes that hold no shared
        blocks: shared-prefix holders are ``protect``ed and become candidates
        only when no other victim exists."""
        protect = [r for lane, r in enumerate(self.slots) if r is not None and self.pool.lane_holds_shared(lane)]
        victim = self.scheduler.pick_victim(running, self.steps, protect=protect)
        if victim is None and protect:
            victim = self.scheduler.pick_victim(running, self.steps)
        return victim

    def _preempt_for_admission(self) -> Request | None:
        """A waiter that outranks the weakest resident by the configured gap
        may take its blocks."""
        best = self.scheduler.peek_best(self.steps)
        if best is None:
            return None
        running = [r for r in self.slots if r is not None]
        victim = self._pick_victim(running)
        if victim is None:
            return None
        gap = self.scheduler.config.preempt_priority_gap
        if self.scheduler.effective_priority(best, self.steps) < victim.priority + gap:
            return None
        self._preempt(self.slots.index(victim))
        if self._fits(best):
            self.scheduler.remove(best)
            return best
        return None

    def _grow_active(self) -> None:
        """Every active lane must own the block its next token writes into;
        under pool pressure the scheduler's victim (lowest priority, most
        emitted tokens) is preempted until the allocation fits."""
        for lane, req in enumerate(self.slots):
            if req is None or req.state == "prefilling":
                continue  # prefilling lanes allocated fully at admission
            need = int(self.positions[lane]) + 1
            while not self.pool.ensure(lane, need):
                running = [r for r in self.slots if r is not None]
                victim = self._pick_victim(running)
                if victim is None:
                    break
                vlane = self.slots.index(victim)
                self._preempt(vlane)
                if vlane == lane:
                    break  # preempted ourselves; the lane is empty now
            else:
                self.pool.note_tokens(lane, need)

    # -- decode ---------------------------------------------------------------
    def _width(self, n_active: int) -> int:
        return _bucket(n_active, self._width_buckets)

    def _decode_active(self) -> list[Request]:
        """One batched decode over the active lanes, padded to the smallest
        width bucket that fits with idle lanes (their tables are empty or
        retired, so their writes land in scratch or past their frontier), then
        with lanes still prefilling (their pad write lands at the last prompt
        position, which their final chunk overwrites); returns the requests
        that received a token."""
        active = [i for i, r in enumerate(self.slots) if r is not None and r.state == "active"]
        if not active:
            return []
        width = self._width(len(active))
        idle = [i for i, r in enumerate(self.slots) if r is None]
        idle += [i for i, r in enumerate(self.slots) if r is not None and r.state == "prefilling"]
        sel = active + idle[: width - len(active)]
        tokens = np.zeros((width, 1), dtype=np.int64)
        for row, lane in enumerate(active):
            tokens[row, 0] = self.slots[lane].output[-1]
        blocks, lanes = self.pool.row_ids(sel)

        def run():
            prog = self._decode_fn(width)
            prog.stage(tokens=tokens, positions=self.positions[sel], blocks=blocks, lanes=lanes)
            return prog.run(self.runtime)

        out = self._run_program("engine.decode", run, retrace=lambda: self._decode_cache.pop(width, None))
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

    # -- SLO pressure (objective-aware selection) -----------------------------
    def _admit_blocked(self) -> bool:
        if not self._slo_mode or self._slo_cap is None:
            return False
        return sum(s is not None for s in self.slots) >= self._slo_cap

    def _enter_slo(self, target: float) -> None:
        self._slo_mode = True
        self._slo_ok = 0
        # Cap admission below the current width bucket, so the batch shrinks
        # as residents finish instead of refilling.
        cur = self._width(sum(s is not None for s in self.slots))
        cap = 1
        for b in self._width_buckets:
            if b < cur:
                cap = b
        self._slo_cap = cap
        self.slo_events.append((self.steps, "enter", target))
        # SLO mode also shrinks the chunk cap one ladder rung (_chunk_cap reads
        # _slo_mode, set above); the Objective publishes it.
        self.runtime.set_objective(Objective(
            latency_target_ms=float(target),
            prefill_chunk_tokens=self._chunk_cap() if self._streaming else None,
        ))
        # The next call of each program captures it again under the objective.
        self._drop_programs()

    def _exit_slo(self) -> None:
        self._slo_mode = False
        self._slo_cap = None
        self._slo_ok = 0
        self.slo_events.append((self.steps, "exit", None))
        self.runtime.set_objective(None)
        self._drop_programs()

    def _update_slo(self) -> None:
        """Hysteresis around the latency objective.

        Enter SLO mode when the engine's recent per-step time (or a targeted
        resident's recent per-token latency) overruns the target of any
        latency-targeted request, resident or queued.  Exit when no targeted
        work remains, or after ``slo_patience`` consecutive calm (< 0.7x
        target) steps.
        """
        if not self.slo_aware:
            return
        resident = [r for r in self.slots if r is not None and r.latency_target_ms is not None]
        queued = [r for r in self.scheduler.waiting() if r.latency_target_ms is not None]
        if not self._slo_mode:
            recent = list(self._step_ms)[-3:]
            step_ms = sum(recent) / len(recent) if recent else None
            at_risk = [r for r in resident if _recent_ms(r) is not None and _recent_ms(r) > r.latency_target_ms]
            if step_ms is not None:
                at_risk += [r for r in resident + queued if r.latency_target_ms < step_ms]
            if at_risk:
                self._enter_slo(min(r.latency_target_ms for r in at_risk))
            return
        if not resident and not queued:
            self._exit_slo()
            return
        # A targeted request still waiting holds the mode: dropping the cap
        # now would widen the batch right before it lands.
        calm = bool(resident) and all(
            _recent_ms(r) is None or _recent_ms(r) < 0.7 * r.latency_target_ms for r in resident
        )
        if calm:
            self._slo_ok += 1
            if self._slo_ok >= self.slo_patience:
                self._exit_slo()
        else:
            self._slo_ok = 0

    # -- failure containment ---------------------------------------------------
    def _run_program(self, site: str, fn, *, retrace, request: Request | None = None):
        """Run one program with one retry on a contained failure.

        The engine's safety net above the ops guard: an injected fault at
        ``site`` (fired before the program runs, so no input is half
        consumed) or a contained failure escaping the program (its build or
        capture, or an eager run) is recorded as a ``retry`` incident and
        gets one retry after ``retrace()`` drops the program: the retry
        builds it again, a warm-up that selects under the breaker's
        redirects, then a capture.  A second failure propagates: no request
        is dropped silently, and nothing retries forever.
        """
        rt = self.runtime
        plan = rt.fault_plan
        try:
            if plan is not None:
                plan.raise_if(site)
            return fn()
        except GUARDED_EXCEPTIONS as e:
            rt.record_incident(incident(site, "engine", None, e, "retry", device=rt.active_device()))
            if request is not None:
                request.retries += 1
            retrace()
            return fn()

    def _update_health(self) -> str:
        """Advance the healthy/degraded state machine; record transitions.

        Degraded while new incidents arrived since the last check or any
        config sits in quarantine; healthy once a check window passes clean
        with an empty quarantine table.
        """
        rt = self.runtime
        count = rt.incident_count()
        fresh = count > self._incidents_seen
        self._incidents_seen = count
        state = "degraded" if (fresh or rt.quarantined()) else "healthy"
        if state != self.health:
            self.health = state
            self.health_events.append((self.steps, state))
        return state

    def _install(self, deployment) -> None:
        """Hot-swap ``deployment`` in (the registry's live device, else a
        direct install); the programs are dropped and built again."""
        rt = self.runtime
        if self.device is not None and rt.active_device() == self.device:
            rt.install_for_device(self.device, deployment)
        else:
            rt.install(deployment)
        self.deployment = deployment
        rt.clear_selection_log()  # a fresh telemetry window for the new policy
        self._drop_programs()

    def maybe_rollback(self) -> RetuneEvent | None:
        """Auto-rollback watchdog for an installed-but-regressing policy.

        If ``rollback_threshold`` incidents accumulate after a hot swap, the
        most recent pre-swap deployment is reinstalled (one rollback per
        swap).  The programs are dropped and captured again, as on a swap;
        in-flight requests keep their lanes.
        """
        rt = self.runtime
        if self._incidents_at_swap is None or not self._swap_history:
            return None
        if rt.incident_count() - self._incidents_at_swap < self.rollback_threshold:
            return None
        prev = self._swap_history.pop()
        self._incidents_at_swap = None  # one rollback per swap
        self._install(prev)
        rt.record_incident(incident("engine.retune", "engine", None,
                                    f"{self.rollback_threshold}+ incidents since hot-swap", "rollback",
                                    device=rt.active_device()))
        ev = RetuneEvent(self.steps, 0.0, 0.0, True, True, 0,
                         len(prev.configs) if hasattr(prev, "configs") else 0, rt.policy_epoch(), rolled_back=True)
        self.retune_events.append(ev)
        return ev

    # -- continuous tuning -----------------------------------------------------
    def maybe_retune(self, *, force: bool = False, online=None) -> RetuneEvent | None:
        """Telemetry -> drift check -> incremental retune -> canary -> hot swap.

        Called between steps when ``retune_interval`` is set, or directly.
        Returns the :class:`RetuneEvent` when a drift check ran
        (``swapped=False`` if nothing was installed), ``None`` with no
        deployment or no telemetry.  ``online`` optionally names a hybrid
        ``OnlinePolicy``: its measurements ride into the snapshot, and after
        a swap it adopts the retuned deployment as its prior.  Each family's
        candidate must pass the canary (on the engine's device) before it is
        installed.  The swap drops the programs, so the next call of each
        captures under the new policy; lanes and requests are untouched.
        Seconds spent measuring (``retune_dataset_builder``), fitting and in
        the canary are appended to ``retune_seconds``.
        """
        from ..core.dispatch import Deployment
        from ..core.faults import FaultError
        from ..core.retune import _model_dataset_builder, canary_deployment, detect_drift_all, incremental_retune

        rt = self.runtime
        dep = self.deployment
        if dep is None:
            pol = rt.policy()
            dep = pol if isinstance(pol, Deployment) else None
        if dep is None:
            return None
        snap = rt.telemetry(online=online)
        if snap.n_events == 0:
            return None
        reports = detect_drift_all(snap, dep, threshold=self.drift_threshold, min_events=self.retune_min_events)
        worst = max(reports.values(), key=lambda r: r.score)
        to_retune = [f for f, r in reports.items() if r.triggered]
        if force and not to_retune:
            to_retune = list(reports)
        if not to_retune:
            ev = RetuneEvent(self.steps, worst.score, worst.unseen_fraction, False,
                             any(r.triggered for r in reports.values()), worst.n_events, len(dep.configs),
                             rt.policy_epoch())
            self.retune_events.append(ev)
            return ev
        measure_s = [0.0]
        source = self.retune_dataset_builder or _model_dataset_builder

        def builder(problems, device):
            t0 = time.perf_counter()
            try:
                return source(problems, device)
            finally:
                measure_s[0] += time.perf_counter() - t0

        new_dep = dep
        adopted: list[str] = []
        rejected: list[str] = []
        timing = {"step": self.steps, "families": {}}
        for fam in to_retune:
            t0, measured = time.perf_counter(), measure_s[0]
            try:
                if rt.fault_plan is not None:
                    rt.fault_plan.raise_if("retune.candidate", fam)
                cand = incremental_retune(new_dep, snap, family=fam, report=reports[fam],
                                          threshold=self.drift_threshold, min_events=self.retune_min_events,
                                          dataset_builder=builder).deployment
            except (FaultError, ValueError) as e:
                rejected.append(fam)
                rt.record_incident(incident("retune.candidate", fam, None, e, "candidate_failed",
                                            device=rt.active_device()))
                continue
            t1 = time.perf_counter()
            fam_measure = measure_s[0] - measured
            times = {"measure_s": fam_measure, "fit_s": t1 - t0 - fam_measure, "canary_s": 0.0}
            timing["families"][fam] = times
            if self.canary:
                verdict = canary_deployment(new_dep, cand, snap, family=fam, runtime=rt,
                                            device=self.model.device.type)
                times["canary_s"] = time.perf_counter() - t1
                if not verdict.ok:
                    rejected.append(fam)
                    rt.record_incident(incident(f"canary.{fam}", fam, None, verdict.reason, "candidate_rejected",
                                                device=rt.active_device()))
                    continue
            new_dep = cand
            adopted.append(fam)
        self.retune_seconds.append(timing)
        if not adopted:
            ev = RetuneEvent(self.steps, worst.score, worst.unseen_fraction, False,
                             any(r.triggered for r in reports.values()), worst.n_events, len(dep.configs),
                             rt.policy_epoch(), rejected=tuple(rejected))
            self.retune_events.append(ev)
            return ev
        # The incumbent joins the swap history and the rollback watchdog
        # re-arms: incidents from here on count against this swap.
        self._swap_history.append(dep)
        self._incidents_at_swap = rt.incident_count()
        self._install(new_dep)
        if online is not None and hasattr(online, "set_prior"):
            online.set_prior(new_dep)
        worst_retuned = max((reports[f] for f in adopted), key=lambda r: r.score)
        ev = RetuneEvent(self.steps, worst_retuned.score, worst_retuned.unseen_fraction, True,
                         any(r.triggered for r in reports.values()), worst_retuned.n_events, len(new_dep.configs),
                         rt.policy_epoch(), tuple(adopted), rejected=tuple(rejected))
        self.retune_events.append(ev)
        return ev

    # -- adopting an external deployment -----------------------------------------
    def offer_deployment(self, candidate, *, source: str = "control-plane") -> None:
        """Stage an externally produced deployment for adoption.

        Thread-safe; the engine adopts it at the top of its next
        :meth:`step`, so the swap lands on a step boundary.  A newer offer
        replaces an unclaimed older one.
        """
        with self._offer_lock:
            self._offered = (candidate, source)

    def _take_offer(self):
        with self._offer_lock:
            offer, self._offered = self._offered, None
        return offer

    def adopt_deployment(self, candidate, *, source: str = "external") -> RetuneEvent:
        """Canary-gate and hot-swap an externally produced deployment.

        Every family with live traffic in the current telemetry window is
        canaried (on the engine's device); one failing family rejects the
        whole artifact.  On adoption the incumbent joins the swap history and
        the rollback watchdog re-arms; the programs are captured again.
        """
        from ..core.retune import canary_deployment

        rt = self.runtime
        incumbent = self.deployment
        snap = rt.telemetry()
        gated: list[str] = []
        rejected: list[str] = []
        if self.canary and incumbent is not None:
            for fam in snap.families():
                verdict = canary_deployment(incumbent, candidate, snap, family=fam, runtime=rt,
                                            device=self.model.device.type)
                gated.append(fam)
                if not verdict.ok:
                    rejected.append(fam)
                    rt.record_incident(incident(f"canary.{fam}", fam, None, verdict.reason, "candidate_rejected",
                                                device=rt.active_device()))
        if rejected:
            ev = RetuneEvent(self.steps, 0.0, 0.0, False, False, snap.n_events, len(incumbent.configs),
                             rt.policy_epoch(), rejected=tuple(rejected), source=source)
            self.retune_events.append(ev)
            return ev
        if incumbent is not None:
            self._swap_history.append(incumbent)
            self._incidents_at_swap = rt.incident_count()
        self._install(candidate)
        ev = RetuneEvent(self.steps, 0.0, 0.0, True, True, snap.n_events,
                         len(candidate.configs) if hasattr(candidate, "configs") else 0, rt.policy_epoch(),
                         families=tuple(gated), source=source)
        self.retune_events.append(ev)
        return ev

    # -- public ---------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16, eos_id: int | None = None,
               priority: int = 0, latency_target_ms: float | None = None, uid: int | None = None) -> Ticket:
        """Enqueue one prompt; returns a streaming :class:`Ticket`."""
        req = Request(
            uid=uid if uid is not None else next(self._uid),
            prompt=np.asarray(prompt, dtype=np.int32),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            priority=priority,
            latency_target_ms=latency_target_ms,
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
        """One scheduling round (admit -> chunks -> grow/preempt -> decode ->
        watchdogs), in the reference's order.

        Returns False when no progress was possible (nothing admitted, no
        chunk run and no active lane decoded).  An offered deployment is
        adopted first and SLO mode is updated before admission; the health
        check, the rollback watchdog and (every ``retune_interval`` steps) the
        drift check run last.  The step's time on ``clock`` feeds SLO mode.
        """
        t0 = self._clock()
        offer = self._take_offer()
        if offer is not None:
            self.adopt_deployment(offer[0], source=offer[1])
        self._update_slo()
        self.scheduler.begin_step()  # a fresh prefill-token budget
        emitted: list[Request] = []
        preempted_once = False
        while len(self.scheduler):
            lane = self._free_lane()
            if lane is None or self._admit_blocked():
                break
            req = self.scheduler.pop_next(self.steps, fits=self._fits)
            if req is None:
                if preempted_once:
                    break
                preempted_once = True
                req = self._preempt_for_admission()
                if req is None:
                    break
                lane = self._free_lane()
            if self._admit(req, lane):
                emitted.append(req)  # legacy prefill emitted the first token
        # A lane whose final chunk lands this step emits its first token here
        # and joins this step's decode.
        progressed, activated = self._advance_prefills()
        emitted.extend(activated)
        self._grow_active()
        emitted.extend(self._decode_active())
        self._update_health()
        self.maybe_rollback()
        if self.retune_interval is not None and self.steps - self._last_retune_check >= self.retune_interval:
            self._last_retune_check = self.steps
            self.maybe_retune()
        dt_ms = (self._clock() - t0) * 1e3
        self._step_ms.append(dt_ms)
        for r in emitted:
            r.token_ms.append(dt_ms)
        return bool(emitted or progressed)

    def status(self) -> EngineStatus:
        """Live snapshot over this serving epoch (since the last drain):
        ``completed + in_flight + queued + preempted`` partitions it."""
        waiting = self.scheduler.waiting()
        preempted_now = sum(1 for r in waiting if r.state == "preempted")
        in_flight = sum(s is not None for s in self.slots)
        return EngineStatus(
            completed=sum(r.done for r in self._epoch_requests),
            in_flight=in_flight,
            queued=len(waiting) - preempted_now,
            steps=self.steps,
            exhausted=bool(waiting or in_flight),
            health=self.health,
            preempted=preempted_now,
            **self._pool_health(),
        )

    def _pool_health(self) -> dict:
        ps = self.pool.stats()
        return {"pool_utilization": ps["utilization"], "pool_fragmentation": ps["fragmentation"],
                "shared_blocks": ps["shared_blocks"], "prefix_hits": ps["prefix_hits"],
                "prefix_lookups": ps["prefix_lookups"]}

    def prefix_overlap(self, prompt) -> int:
        """Tokens of ``prompt`` this engine could serve from cached blocks: a
        read-only probe (hit-rate counters untouched) for the Router's prefix
        affinity; 0 when sharing is off here."""
        if not self._sharing:
            return 0
        body = np.asarray(prompt, dtype=np.int32)[:-1]
        return len(self.pool.match_prefix(body, peek=True)) * self.pool.block_size

    def drain(self, *, max_steps: int = 10_000) -> EngineStatus:
        """Serve everything submitted until done or the step budget runs out.

        Waiting requests left when the budget is exhausted (queued or
        preempted) are marked ``state="starved"`` and dropped from the queue
        (``done=False``).  Closes the serving epoch: the next drain reports
        only requests submitted after this one (in-flight survivors carry
        over).  ``preempted`` reports how many of the epoch's requests were
        evicted at least once.
        """
        while self.pending() and self.steps < max_steps:
            if not self.step():
                break
        exhausted = self.pending()
        starved = self.scheduler.clear()
        for r in starved:
            r.state = "starved"
        self._update_health()
        reqs = self._epoch_requests
        status = EngineStatus(
            completed=sum(r.done for r in reqs),
            in_flight=sum(s is not None for s in self.slots),
            queued=len(starved),
            steps=self.steps,
            exhausted=exhausted,
            health=self.health,
            preempted=sum(1 for r in reqs if r.preemptions),
            **self._pool_health(),
        )
        self._epoch_requests = [r for r in reqs if r.state == "active"]
        return status
