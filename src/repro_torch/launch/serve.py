"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up the serving engine on the port's model and drives a batch of
synthetic requests through submit/drain, on ``cuda`` unless ``--device cpu``
is given.  ``--reduced`` (the default) serves the tiny same-family config;
``--no-reduced`` serves at full width.  The reduced model runs in f32, as the
reference's launcher runs it; the full-width one in bf16, its serving dtype.
Weights come from a CPU generator seeded with 0 and are moved to the device,
so a ``cpu`` and a ``cuda`` run serve the same model.  On ``cuda`` the engine
serves through CUDA graphs, one per prefill bucket and decode width; the
programs and the seconds their warm-up and capture took are printed.

The kernel policy: ``--bundle b.json`` installs the ``DeploymentBundle``
entry resolved for this host (``--serve-device`` names another device;
``REPRO_DEVICE`` overrides detection), ``--deployment d.json`` a single
``Deployment``, and neither ``FixedPolicy()``.  :func:`build_engine` is the
same path for a caller that builds its own model:

  python -m repro_torch.launch.serve --arch rwkv6-7b --no-reduced --bundle build/bundle_h100.json

Continuous tuning and chaos, as the reference's launcher takes them:
``--retune-interval N`` checks telemetry drift every N steps and retunes,
canaries and hot-swaps the policy when it fires (``--drift-threshold``,
``--retune-min-events``); ``--chaos 'site:kind[:times[:after]],...'``
attaches a ``FaultPlan`` (``--chaos-seed``) whose faults the dispatch guard
and the engine contain, and the chaos report follows the run:

  python -m repro_torch.launch.serve --arch granite-8b --no-reduced --deployment build/deploy_h100.json \
      --chaos 'dispatch.matmul:compile_error,engine.prefill:compile_error' --retune-interval 6 --retune-min-events 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..core.retune import DEFAULT_DRIFT_THRESHOLD, DEFAULT_MIN_EVENTS
from ..core.runtime import KernelRuntime, check_compiled
from ..kernels.ops import FixedPolicy
from ..models.model import build_model
from ..serve.engine import ServingEngine


def build_engine(model, params, *, bundle=None, deployment=None, serve_device: str | None = None,
                 name: str = "serve", fault_plan=None, **engine_kwargs) -> ServingEngine:
    """The launcher's engine over ``model``: its own ``KernelRuntime`` holding the
    bundle's entry resolved for ``serve_device`` (default: this host), or the
    ``deployment``, or ``FixedPolicy()``, and ``fault_plan`` when given.
    ``bundle`` / ``deployment`` may be paths.  On a CUDA model either raises
    when it holds a config the port has not compiled."""
    rt = KernelRuntime(name=name)
    rt.set_fault_plan(fault_plan)
    if bundle is not None:
        return ServingEngine(model, params, bundle=bundle, device=serve_device, runtime=rt, **engine_kwargs)
    if deployment is not None:
        from ..core.dispatch import Deployment

        if not isinstance(deployment, Deployment):
            deployment = Deployment.load(deployment)
        # As a bundle's install does: a config outside the compiled space fails
        # here, not at its first launch inside a capture.
        check_compiled(deployment, model.device.type, deployment.device)
        rt.install(deployment)
    else:
        # The fixed default policy makes every selection consult the shape
        # cache, whose counters are printed.
        rt.install(FixedPolicy())
    return ServingEngine(model, params, runtime=rt, **engine_kwargs)


def main(argv=None) -> list[list[int]]:
    """Serve the synthetic requests; returns each request's generated tokens."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the tiny same-family config (--no-reduced: full width)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--deployment", default=None, help="single-device Deployment json")
    ap.add_argument("--bundle", default=None,
                    help="multi-device DeploymentBundle json (installs the entry resolved for this host)")
    ap.add_argument("--serve-device", default=None,
                    help="device name for --bundle resolution (default: detect; REPRO_DEVICE overrides)")
    ap.add_argument("--retune-interval", type=int, default=None, metavar="STEPS",
                    help="check telemetry drift every N decode steps and incrementally retune, canary and "
                         "hot-swap the policy when it fires")
    ap.add_argument("--drift-threshold", type=float, default=DEFAULT_DRIFT_THRESHOLD,
                    help="Jensen-Shannon divergence (0-1) that triggers a retune")
    ap.add_argument("--retune-min-events", type=int, default=DEFAULT_MIN_EVENTS,
                    help="telemetry floor before a drift check may trigger")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection plan 'site:kind[:times[:after]],...', e.g. "
                         "'dispatch.matmul:compile_error,engine.prefill:compile_error'; the dispatch guard and "
                         "the engine contain the faults and a report follows the run (nan/inf kinds poison "
                         "direct calls only, never a program's outputs)")
    ap.add_argument("--chaos-seed", type=int, default=0, help="seed for the fault plan's probabilistic specs")
    args = ap.parse_args(argv)
    if args.bundle and args.deployment:
        ap.error("--bundle and --deployment are exclusive")

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch finds no CUDA device; pass --device cpu to "
            "serve on the CPU with the kernels' plain versions"
        )
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = build_model(cfg, dtype=dtype, param_dtype=dtype, device=args.device)
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    plan = None
    if args.chaos:
        from ..core.faults import FaultPlan

        plan = FaultPlan.parse(args.chaos, seed=args.chaos_seed)
    engine = build_engine(model, params, bundle=args.bundle, deployment=args.deployment,
                          serve_device=args.serve_device, name=f"serve[{args.arch}]", fault_plan=plan,
                          max_batch=args.max_batch, cache_len=args.cache_len,
                          retune_interval=args.retune_interval, drift_threshold=args.drift_threshold,
                          retune_min_events=args.retune_min_events)
    rt = engine.runtime
    if args.bundle:
        requested, resolved = rt.device_resolution()
        print(f"bundle installed: serving with the {engine.device!r} deployment (requested {requested!r})")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tickets = [
        engine.submit(rng.integers(0, cfg.vocab, size=8).astype(np.int32),
                      max_new_tokens=args.max_new_tokens)
        for _ in range(args.requests)
    ]
    status = engine.drain()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    reqs = [t.request for t in tickets]
    toks = sum(len(r.output) for r in reqs)
    print(f"served {len(reqs)} requests on {args.device} ({cfg.name}, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, {str(dtype).removeprefix('torch.')}): {toks} tokens, {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s), {engine.steps} decode steps")
    built = engine.program_log
    how = "captured as CUDA graphs" if engine.cuda_graphs else "run eagerly"
    print(f"programs: {len(built)} {how} ({', '.join(f'{r.kind} {r.size}' for r in built)}); "
          f"{sum(r.seconds for r in built):.2f}s building them (warm-up{' and capture' * engine.cuda_graphs})")
    stats = rt.shape_cache_stats()
    print(f"kernel selections: {stats['hits'] + stats['misses']} "
          f"({stats['hits']} shape-cache hits) on runtime {rt.name!r}")
    if status.exhausted:
        print(f"WARNING: step budget exhausted with {status.in_flight} in-flight / "
              f"{status.queued} queued requests unfinished")
    for ev in engine.retune_events:
        if ev.rolled_back:
            verdict = "rolled back"
        elif ev.swapped:
            verdict = f"retuned {'+'.join(ev.families) or 'matmul'} + hot-swapped"
        elif ev.rejected:
            verdict = f"candidate rejected ({'+'.join(ev.rejected)})"
        elif ev.drift_score >= args.drift_threshold:
            verdict = f"below event floor ({ev.n_events}/{args.retune_min_events})"
        else:
            verdict = "no drift"
        print(f"  retune check @ step {ev.step}: drift {ev.drift_score:.3f} "
              f"(unseen {ev.unseen_fraction:.1%}) -> {verdict} "
              f"[{ev.n_configs} kernels, policy epoch {ev.epoch}]")
    if plan is not None:
        print(f"chaos: {len(plan.events)} faults fired, {rt.incident_count()} incidents contained, "
              f"{len(rt.quarantined())} configs in quarantine, {sum(r.retries for r in reqs)} request retries, "
              f"engine health {status.health!r}")
        for inc in rt.incidents()[-5:]:
            print(f"  incident #{inc['seq']} {inc['site']} [{inc['config']}] -> {inc['action']}: {inc['error']}")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.output[:10]}...")
    return [list(r.output) for r in reqs]


if __name__ == "__main__":
    main()
