#!/usr/bin/env python3
"""Sweep the attention kernel's KV split count at the decode shapes on the card.

    python3 scripts/attn_split_sweep.py [--out build/attn_split_sweep.json]

For every decode shape of ``chip_smoke.py`` phases 18 and 20 (sq = 1: granite-8b's
(1, 32, 1, skv, 128) and hymba-1.5b's (1, 25 or 32, 1, skv, 64) at skv in {4096,
32768}, and (1, 32, 1, 524288, 64)) plus a 4-row step at (1, 32, 4, 4096, 128),
and every compiled config, times ``attention_cuda`` (bf16, causal) with each
split count from 1 up to 32 (as far as the query block's KV blocks allow), by
``core/gpubench.time_ms`` (CUDA events, queued behind a device sleep; K and V
rotated through copies that exceed the 50 MB L2, as a decode step finds its
cache cold), beside the count ``kernels/attention.launch_splits`` picks there
(``kv_splits`` under the card's SM count and the kernel's occupancy).  Needs the
card; the numbers feed the split rule (``SPLIT_INFLIGHT_BYTES``, ``SPLIT_MIN_BLOCKS``)
and ``PERF.md``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(32, 1, 4096, 128), (32, 1, 32768, 128), (25, 1, 4096, 64), (25, 1, 32768, 64), (32, 1, 32768, 64),
          (32, 1, 524288, 64), (32, 4, 4096, 128)]
COUNTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "attn_split_sweep.json")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import attention as at

    if not torch.cuda.is_available():
        print("attn_split_sweep: torch finds no CUDA device; the sweep runs only on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = {c.name(): [at.resident_ctas(c, hd, 0) for hd in (64, 128)] for c in at.config_space()}
    print(f"CTAs an SM holds (hd 64, 128): {resident}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rule = at.kv_splits
    rows = []
    for heads, sq, skv, d in SHAPES:
        kv_bytes = 2 * heads * skv * d * 2
        copies = max(1, -(-150_000_000 // kv_bytes))
        q = torch.randn((1, heads, sq, d), device="cuda", generator=g).bfloat16()
        kvs = [tuple(torch.randn((1, heads, skv, d), device="cuda", generator=g).bfloat16() for _ in range(2))
               for _ in range(copies)]
        for cfg in at.config_space():
            blocks = at.kv_blocks(0, sq, skv, cfg, True)
            chosen = at.launch_splits(heads, sq, skv, d, cfg, True, 0)  # the rule, as a call on this card
            times = {}
            try:
                for s in sorted(c for c in {*COUNTS, chosen} if c <= blocks):
                    at.kv_splits = lambda *_, s=s: s
                    times[s] = time_ms(lambda i: at.attention_cuda(q, *kvs[i % copies], cfg), n_warm=3, n_runs=10)
            finally:
                at.kv_splits = rule
            best = min(times, key=times.get)
            rows.append({"shape": [heads, sq, skv, d], "config": cfg.name(), "blocks": blocks, "rule": chosen,
                         "rule_ms": times[chosen], "best": best, "best_ms": times[best], "ms": times})
            print(f"(1, {heads}, {sq}, {skv}, {d}) {cfg.name()} blocks {blocks}: rule {chosen} "
                  f"{times[chosen]:.4f} ms, best {best} ({heads * best} CTAs) {times[best]:.4f}; "
                  + " ".join(f"{s}:{t:.4f}" for s, t in times.items()), flush=True)
        del q, kvs
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "sms": sms, "resident": resident, "rows": rows}, indent=1))
    worse = [r for r in rows if r["rule_ms"] > 1.1 * r["best_ms"]]
    print(f"rule within 10% of the best count at {len(rows) - len(worse)} of {len(rows)} (shape, config) pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
