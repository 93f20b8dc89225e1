#!/usr/bin/env python3
"""Sweep the GEMM's split-k count at the served decode shapes on the card.

    python3 scripts/split_sweep.py [--out build/split_sweep.json]

For every decode-step GEMM (k, n) of full-width granite-8b, rwkv6-7b and
hymba-1.5b at 4 rows, and every compiled config, times ``matmul_cuda`` with
each split count the kernel's partition allows (ceil(steps / per) for a
whole number of k steps ``per``; at most 8 x 132 CTAs), by
``core/gpubench.time_ms`` (CUDA events, queued behind a device sleep,
weights rotated through more than the L2), beside the count
``kernels/matmul.split_k`` picks.  Then the host's cost of one call:
``matmul_cuda`` and ``torch.matmul`` enqueued 200 times back to back.
Needs the card; the numbers feed the split rule and ``PERF.md``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from gemm_ab import DECODE_KN, VOCAB_KN, host_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "split_sweep.json")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import matmul as mm

    if not torch.cuda.is_available():
        print("split_sweep: torch finds no CUDA device; the sweep runs only on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    rule = mm.split_k
    rows = []
    for k, n in dict.fromkeys(kn for kns in DECODE_KN.values() for kn in kns):
        out = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16
        a = torch.randn(4, k, device="cuda", generator=g).bfloat16()
        copies = max(1, -(-150_000_000 // (k * n * 2)))
        bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
        for cfg in mm.config_space():
            steps = -(-k // cfg.block_k)
            tiles = -(-4 // cfg.block_m) * -(-n // cfg.block_n)
            counts = sorted({-(-steps // per) for per in range(1, steps + 1)})
            counts = [s for s in counts if tiles * s <= 8 * sms]
            times = {}
            try:
                for s in counts:
                    mm.split_k = lambda *_, s=s: s
                    times[s] = time_ms(lambda i: mm.matmul_cuda(a, bs[i % copies], cfg, out_dtype=out),
                                       n_warm=3, n_runs=15)
            finally:
                mm.split_k = rule
            chosen = rule(4, n, k, cfg, sms)
            best = min(times, key=times.get)
            rows.append({"k": k, "n": n, "config": cfg.name(), "tiles": tiles, "steps": steps, "rule": chosen,
                         "rule_ms": times[chosen], "best": best, "best_ms": times[best], "ms": times})
            print(f"({k}, {n}) {cfg.name()} tiles {tiles} steps {steps}: rule {chosen} {times[chosen]:.4f} ms, "
                  f"best {best} {times[best]:.4f}; " + " ".join(f"{s}:{t:.4f}" for s, t in times.items()),
                  flush=True)
        del bs
    host = {}
    for k, n in ((4096, 4096), (1600, 1600)):
        a = torch.randn(4, k, device="cuda", generator=g).bfloat16()
        b = torch.randn(k, n, device="cuda", generator=g).bfloat16()
        for name, fn in ((cfg.name(), lambda c=cfg: mm.matmul_cuda(a, b, c)) for cfg in
                         (mm.MatmulConfig(16, 64, 128, "nmk"), mm.DEFAULT_CONFIG)):
            host[f"{k}x{n} {name}"] = host_us(torch, fn)
        host[f"{k}x{n} torch.matmul"] = host_us(torch, lambda: torch.matmul(a, b))
    for key, us in host.items():
        print(f"host us per call, {key}: {us:.2f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows, "host_us": host}, indent=1))
    worse = [r for r in rows if r["rule_ms"] > 1.1 * r["best_ms"]]
    print(f"rule within 10% of the best count at {len(rows) - len(worse)} of {len(rows)} (shape, config) pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
