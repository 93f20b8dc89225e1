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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..core.runtime import KernelRuntime
from ..kernels.ops import FixedPolicy
from ..models.model import build_model
from ..serve.engine import ServingEngine


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
    args = ap.parse_args(argv)

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
    # The launcher owns its runtime; the fixed default policy makes every
    # GEMM consult the shape cache, whose counters are printed below.
    rt = KernelRuntime(name=f"serve[{args.arch}]")
    rt.install(FixedPolicy())
    engine = ServingEngine(model, params, max_batch=args.max_batch,
                           cache_len=args.cache_len, runtime=rt)
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
    for r in reqs[:3]:
        print(f"  req {r.uid}: {r.output[:10]}...")
    return [list(r.output) for r in reqs]


if __name__ == "__main__":
    main()
