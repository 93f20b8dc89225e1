#!/usr/bin/env python3
"""Time the port's selective scan from two source trees in turns on one card.

    python3 scripts/ssm_ab.py --base build/parent --out build/ssm_ab.json

``--base`` is another checkout of the repository (for example ``git archive``
of a parent commit unpacked under ``build/``); the other tree is this one.
Each turn is a fresh process that builds and loads ``csrc/ssm.cu`` from its
tree and times, at hymba-1.5b's batch-1 prefill shape (1, S, 1600, 16) in f32
for S in {32, 64, 128, 2048}, every compiled config of ``ssm_cuda`` (dtx and
dta in: the entry both trees have) and, where the tree has it,
``ssm_cuda_fused`` (x, dt and a in), with ``core/gpubench.time_ms`` (CUDA
events, each call queued behind a device sleep), on the same inputs drawn
from one seed.  The turns run base, this tree, this tree, base, so that drift
on the card falls on both alike; each tree's number is the mean of its two
turns.  ``chip_smoke.py`` calls :func:`run_turns` (phase 20d) when
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
LENGTHS = (32, 64, 128, 2048)
D, N = 1600, 16


def worker(src: Path, lengths) -> dict:
    """Times both entries (where the tree has them) with the kernels of the tree whose
    package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import ssm as ss

    if not torch.cuda.is_available():
        raise RuntimeError("ssm_ab times on the card and torch finds no CUDA device")
    rows = []
    for s in lengths:
        g = torch.Generator(device="cuda").manual_seed(19 + s)
        randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
        x, dt = randn(1, s, D) * 0.5, torch.nn.functional.softplus(randn(1, s, D))
        a = -torch.exp(randn(D, N) * 0.3)
        b, c = randn(1, s, N) * 0.5, randn(1, s, N) * 0.5
        dtx, dta = dt * x, dt[..., None] * a
        row = {"s": s, "dta": {cfg.name(): time_ms(lambda i, cfg=cfg: ss.ssm_cuda(dtx, dta, b, c, config=cfg),
                                                   n_warm=3, n_runs=20) for cfg in ss.config_space()}}
        if hasattr(ss, "ssm_cuda_fused"):
            row["fused"] = {cfg.name(): time_ms(lambda i, cfg=cfg: ss.ssm_cuda_fused(x, dt, a, b, c, config=cfg),
                                                n_warm=3, n_runs=20) for cfg in ss.config_space()}
        rows.append(row)
        del dta
        torch.cuda.empty_cache()
    return {"src": str(src), "default": ss.DEFAULT_SSM_CONFIG.name(), "rows": rows}


def _turn(src: Path, lengths, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--lengths", json.dumps(list(lengths)),
                        "--out", str(out)], check=True, timeout=timeout)
        return json.loads(out.read_text())


def run_turns(base: Path, lengths=LENGTHS, timeout: float = 600.0) -> dict:
    """base, this tree, this tree, base: each tree's per-length, per-entry numbers, the
    mean of its two turns."""
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], lengths, timeout))
    merged = {}
    for name, (t1, t2) in turns.items():
        rows = []
        for r1, r2 in zip(t1["rows"], t2["rows"]):
            row = {"s": r1["s"]}
            for entry in ("dta", "fused"):
                if entry in r1:
                    per = {c: (r1[entry][c] + r2[entry][c]) / 2 for c in r1[entry]}
                    best = min(per, key=per.get)
                    row[entry] = {"default_ms": per[t1["default"]], "best_config": best, "best_ms": per[best],
                                  "per_config_ms": per}
            rows.append(row)
        merged[name] = rows
    return {"order": ["base", "this", "this", "base"], "base": str(base), "trees": merged}


def report(result: dict) -> None:
    for b, t in zip(result["trees"]["base"], result["trees"]["this"]):
        line = (f"  (1, {t['s']}, {D}, {N}) dta entry: default {b['dta']['default_ms'] * 1e3:.2f} -> "
                f"{t['dta']['default_ms'] * 1e3:.2f} us ({b['dta']['default_ms'] / t['dta']['default_ms']:.2f}x), "
                f"best {b['dta']['best_ms'] * 1e3:.2f} -> {t['dta']['best_ms'] * 1e3:.2f}")
        if "fused" in t:
            line += (f"; fused entry: default {t['fused']['default_ms'] * 1e3:.2f} us "
                     f"({b['dta']['default_ms'] / t['fused']['default_ms']:.2f}x the base's dta entry)")
        print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ssm_ab.json")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--lengths", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        result = worker(args.worker, json.loads(args.lengths))
        args.out.write_text(json.dumps(result))
        return 0
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "ssm.cu").is_file():
        print(f"ssm_ab: {args.base} holds no src/repro_torch/kernels/csrc/ssm.cu", file=sys.stderr)
        return 2
    result = run_turns(args.base)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    report(result)
    print(f"  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
