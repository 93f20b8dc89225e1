#!/usr/bin/env python3
"""Time the port's flash attention from two source trees in turns on one card.

    python3 scripts/attn_ab.py --base build/parent --out build/attn_ab.json

``--base`` is another checkout of the repository (for example ``git archive``
of a parent commit unpacked under ``build/``); the other tree is this one.
Each turn is a fresh process that builds and loads ``csrc/attention.cu`` from
its tree and times every compiled config, bf16, causal, at every problem of
``chip_smoke.py``'s phase 18 (the harvested attention problems of granite-8b
and hymba-1.5b at (1, 32) heads) and phase 20 (granite-8b's (1, 32, S, 128)
and hymba-1.5b's (1, 25, S, 64) at causal S in {512, 2048, 4096} and a decode
step at 4096 and 32768 cached tokens), with ``core/gpubench.time_ms`` (CUDA
events, each call queued behind a device sleep), beside SDPA with
``causal_lower_right`` (a yardstick only) and the bound max(FLOPs / 989e12,
bytes / 3.35e12).  The turns run base, this tree, this tree, base, so that
drift on the card falls on both alike; each tree's number is the mean of its
two turns.  ``chip_smoke.py`` calls :func:`run_turns` (phase 20c) when
``build/parent`` exists.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
# chip_smoke.py phase 18 (harvest_attn_problems of granite-8b and hymba-1.5b, at (1, 32) heads).
PHASE18 = [(32, 1, 32768, 64), (32, 1, 32768, 128), (32, 1, 524288, 64), (32, 2048, 4096, 64),
           (32, 2048, 4096, 128), (32, 2048, 32768, 64), (32, 2048, 32768, 128), (32, 4096, 4096, 64),
           (32, 4096, 4096, 128), (32, 32768, 32768, 64), (32, 32768, 32768, 128)]
# chip_smoke.py phase 20 (heads, sq, skv, d).
PHASE20 = [(heads, sq, skv, d) for heads, d in ((32, 128), (25, 64))
           for sq, skv in ((512, 512), (2048, 2048), (4096, 4096), (1, 4096), (1, 32768))]


def bound_ms(heads: int, sq: int, skv: int, d: int) -> tuple[float, str]:
    """chip_smoke.py's _attention_bound (causal): the useful FLOPs over the visible pairs
    and the bytes of q, k, v and o, each over the card's peak."""
    pairs = sum(min(skv, i + skv - sq + 1) for i in range(max(0, sq - skv), sq))
    t_ops = 4.0 * pairs * d * heads / BF16_FLOPS
    t_bytes = (2 * sq + 2 * skv) * d * heads * 2 / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def worker(src: Path, todo: list[tuple[int, int, int, int]]) -> dict:
    """Times ``todo`` with the attention kernel of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import attention as at

    if not torch.cuda.is_available():
        raise RuntimeError("attn_ab times on the card and torch finds no CUDA device")
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for heads, sq, skv, d in todo:
        q, k, v = (torch.randn((1, heads, n, d), device="cuda", generator=g).bfloat16() for n in (sq, skv, skv))
        runs = 5 if sq * skv >= 2048 * 32768 or skv >= 524288 else 10
        per_cfg = {c.name(): time_ms(lambda i, c=c: at.attention_cuda(q, k, v, c), n_warm=2, n_runs=runs)
                   for c in at.config_space()}
        mask = causal_lower_right(sq, skv)
        library = time_ms(lambda i: sdpa(q, k, v, attn_mask=mask), n_warm=2, n_runs=runs)
        rows.append({"shape": [heads, sq, skv, d], "per_config_ms": per_cfg, "library_ms": library})
        del q, k, v
        torch.cuda.empty_cache()
    return {"src": str(src), "default": at.DEFAULT_ATTN_CONFIG.name(), "rows": rows}


def _turn(src: Path, todo, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--shapes", json.dumps(todo),
                        "--out", str(out)], check=True, timeout=timeout)
        return json.loads(out.read_text())


def run_turns(base: Path, todo=None, timeout: float = 600.0) -> dict:
    """base, this tree, this tree, base: each tree's per-shape numbers, the mean of its two turns."""
    todo = [list(s) for s in (todo or dict.fromkeys(PHASE18 + PHASE20))]
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], todo, timeout))
    merged = {}
    for name, (t1, t2) in turns.items():
        rows = []
        for r1, r2 in zip(t1["rows"], t2["rows"]):
            per = {c: (r1["per_config_ms"][c] + r2["per_config_ms"][c]) / 2 for c in r1["per_config_ms"]}
            best = min(per, key=per.get)
            bnd, by = bound_ms(*r1["shape"])
            rows.append({"shape": r1["shape"], "default_ms": per[t1["default"]], "best_config": best,
                         "best_ms": per[best], "per_config_ms": per,
                         "library_ms": (r1["library_ms"] + r2["library_ms"]) / 2, "bound_ms": bnd, "bound_by": by,
                         "turns_best_ms": [min(r1["per_config_ms"].values()), min(r2["per_config_ms"].values())]})
        merged[name] = rows
    return {"order": ["base", "this", "this", "base"], "base": str(base), "trees": merged}


def verdict(result: dict) -> dict:
    """Per shape, this tree's best config against the base's best: the speedup; and two
    tests of a redesign: every decode shape (sq = 1) at least 2x the base, no prefill
    shape more than 5% slower."""
    out = []
    for b, t in zip(result["trees"]["base"], result["trees"]["this"]):
        out.append({"shape": t["shape"], "base_best_ms": b["best_ms"], "this_best_ms": t["best_ms"],
                    "speedup": b["best_ms"] / t["best_ms"], "decode": t["shape"][1] == 1})
    return {"rows": out,
            "decode_at_least_2x": all(r["speedup"] >= 2 for r in out if r["decode"]),
            "prefill_within_5pct": all(r["speedup"] >= 1 / 1.05 for r in out if not r["decode"])}


def report(result: dict) -> None:
    for b, t in zip(result["trees"]["base"], result["trees"]["this"]):
        heads, sq, skv, d = t["shape"]
        tflops = lambda ms: 4.0 * sum(min(skv, i + skv - sq + 1) for i in range(max(0, sq - skv), sq)) * d * heads \
            / ms / 1e9
        print(f"  (1, {heads}, {sq}, {skv}, {d}): best {b['best_config']} {b['best_ms']:.4f} -> {t['best_config']} "
              f"{t['best_ms']:.4f} ms ({b['best_ms'] / t['best_ms']:.2f}x; {tflops(t['best_ms']):.0f} TFLOP/s), "
              f"default {b['default_ms']:.4f} -> {t['default_ms']:.4f}; bound {t['bound_ms']:.4f} ({t['bound_by']}), "
              f"SDPA {t['library_ms']:.4f}")
    v = verdict(result)
    print(f"  every decode shape >= 2x the base: {v['decode_at_least_2x']}; no prefill shape > 5% slower: "
          f"{v['prefill_within_5pct']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "attn_ab.json")
    ap.add_argument("--report", type=Path, help="print the numbers of a saved result instead of measuring")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        result = worker(args.worker, [tuple(s) for s in json.loads(args.shapes)])
        args.out.write_text(json.dumps(result))
        return 0
    if args.report is not None:
        report(json.loads(args.report.read_text()))
        return 0
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "attention.cu").is_file():
        print(f"attn_ab: {args.base} holds no src/repro_torch/kernels/csrc/attention.cu", file=sys.stderr)
        return 2
    result = run_turns(args.base)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    report(result)
    print(f"  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
