#!/usr/bin/env python3
"""Sweep the selective-scan kernels' segment count on the card.

    python3 scripts/ssm_segment_sweep.py [--out build/ssm_segment_sweep.json] [--lengths 32,64,128,2048]

At hymba-1.5b's batch-1 prefill shape (1, S, 1600, 16), f32, for S in the
served buckets (32, 64, 128) and the long case 2048, and at (2, S, 100, 8),
times both entries (``ssm_cuda`` from dtx and dta, ``ssm_cuda_fused`` from x,
dt and a) under every compiled config with each segment count from 1 up to
the chunks' limit, by ``core/gpubench.time_ms`` (CUDA events, each call queued
behind a device sleep), beside the count ``kernels/ssm.launch_segments`` picks
there (``ssm_segments`` under the card's SM count and the kernel's occupancy).
Needs the card; the numbers feed the segment rule (``SEG_MIN_CHUNKS``,
``SEG_MIN_STEPS``) and ``PERF.md``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def inputs(torch, g, entry, b, s, d, n):
    """The operands of one entry, drawn as chip_smoke.py phase 3c draws them, no state."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    if entry == "dta":
        return randn(b, s, d) * 0.5, -torch.exp(randn(b, s, d, n) * 0.3), bv, cv
    return randn(b, s, d) * 0.5, torch.nn.functional.softplus(randn(b, s, d)), -torch.exp(randn(d, n) * 0.3), bv, cv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ssm_segment_sweep.json")
    ap.add_argument("--lengths", default="32,64,128,2048")
    ap.add_argument("--configs", default="", help="config names (default: all)")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import ssm as ss

    if not torch.cuda.is_available():
        print("ssm_segment_sweep: torch finds no CUDA device; the sweep runs only on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    configs = [c for c in ss.config_space() if not args.configs or c.name() in args.configs.split(",")]
    resident = {c.name(): {f"{e} N{n}": ss.resident_ctas(c, n, e == "fused", 0) for e in ss.ENTRIES for n in (8, 16)}
                for c in configs}
    print(f"output-pass CTAs an SM holds: {resident}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rule = ss.ssm_segments
    shapes = [(1, int(s), 1600, 16) for s in args.lengths.split(",")] + [(2, 128, 100, 8)]
    rows = []
    for b, s, d, n in shapes:
        for entry, kernel in (("fused", ss.ssm_cuda_fused), ("dta", ss.ssm_cuda)):
            operands = inputs(torch, g, entry, b, s, d, n)
            for cfg in configs:
                chosen = ss.launch_segments(b, s, d, n, cfg, entry == "fused", 0)
                reach = sorted({ss.reachable_segments(s, cfg, c) for c in COUNTS} | {chosen})
                times = {}
                try:
                    for count in reach:
                        ss.ssm_segments = lambda *_, c=count: c
                        times[count] = time_ms(lambda i: kernel(*operands, config=cfg), n_warm=3, n_runs=20)
                finally:
                    ss.ssm_segments = rule
                best = min(times, key=times.get)
                rows.append({"shape": [b, s, d, n], "entry": entry, "config": cfg.name(), "rule": chosen,
                             "rule_ms": times[chosen], "best": best, "best_ms": times[best], "ms": times})
                print(f"({b}, {s}, {d}, {n}) {entry:5} {cfg.name()}: rule {chosen} {times[chosen] * 1e3:.2f} us, "
                      f"best {best} {times[best] * 1e3:.2f} us; "
                      + " ".join(f"{c}:{t * 1e3:.2f}" for c, t in times.items()), flush=True)
            del operands
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "sms": sms, "resident": resident, "rows": rows}, indent=1))
    worse = [r for r in rows if r["rule_ms"] > 1.1 * r["best_ms"]]
    print(f"rule within 10% of the best count at {len(rows) - len(worse)} of {len(rows)} (shape, entry, config) rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
