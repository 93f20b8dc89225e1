#!/usr/bin/env python3
"""Time the port's selective scan from two source trees in turns on one card.

    python3 scripts/ssm_ab.py --base build/parent --out build/ssm_ab.json
    python3 scripts/ssm_ab.py --bwd --base build/parent --out build/ssm_ab_bwd.json

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

``--bwd`` times the backward kernel instead (:func:`run_bwd_turns`): both
entries' ``ssm_backward_cuda`` / ``ssm_fused_backward_cuda`` at hymba-1.5b's
training shape (8, 128, 1600, 16), and the fused entry at the long
(1, 2048, 1600, 16) call, under ``DEFAULT_SSM_CONFIG``, no initial state,
each call's full gradient, in the same turns; beside each, the shape's bytes
bound and, where the tree has ``ssm.bwd_residency``, the kernel's registers,
CTAs an SM and waves of its grid.  ``chip_smoke.py`` calls it in phase 25f-ii.
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


# The backward's shapes (B, S, d, N) and entries: hymba-1.5b's training step, and the long call.
BWD_SHAPES = (((8, 128, D, N), ("fused", "dta")), ((1, 2048, D, N), ("fused",)))
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate


def bwd_bytes(entry: str, b: int, s: int, d: int, n: int) -> int:
    """Bytes the backward must move, each input read once and each output written once (no
    initial state): fused x, dt, dy in, dx, d(dt) out, a, da, b, c, db, dc; dta entry dtx, dy,
    d(dtx), dta and d(dta), b, c, db, dc."""
    rows = b * s
    if entry == "fused":
        return (5 * rows * d + 2 * d * n + 4 * rows * n) * 4
    return (3 * rows * d + 2 * rows * d * n + 4 * rows * n) * 4


def worker_bwd(src: Path) -> dict:
    """Times the backward of both entries with the kernels of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import ssm as ss

    if not torch.cuda.is_available():
        raise RuntimeError("ssm_ab times on the card and torch finds no CUDA device")
    cfg = ss.DEFAULT_SSM_CONFIG
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (b, s, d, n), entries in BWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(31 + s)
        randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
        x, dt = randn(b, s, d) * 0.5, torch.nn.functional.softplus(randn(b, s, d))
        a = -torch.exp(randn(d, n) * 0.3)
        bv, cv, dy = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5, randn(b, s, d)
        for entry in entries:
            if entry == "fused":
                call = lambda i: ss.ssm_fused_backward_cuda(x, dt, a, bv, cv, None, dy, None, cfg)
            else:
                dtx, dta = dt * x, dt[..., None] * a
                call = lambda i: ss.ssm_backward_cuda(dtx, dta, bv, cv, None, dy, None, cfg)
            row = {"entry": entry, "shape": [b, s, d, n], "config": cfg.name(),
                   "ms": time_ms(call, n_warm=3, n_runs=20),
                   "bound_ms": bwd_bytes(entry, b, s, d, n) / HBM_BYTES_PER_S * 1e3}
            if hasattr(ss, "bwd_residency"):
                res = ss.bwd_residency(cfg, n, entry == "fused", 0)
                ctas = b * -(-d // cfg.block_d)
                row.update(res, grid=ctas, threads=cfg.bwd_threads(n), waves=ctas / (sms * res["ctas"]))
            rows.append(row)
            del call
        del x, dt, a, bv, cv, dy
        torch.cuda.empty_cache()
    return {"src": str(src), "rows": rows}


def _turn(src: Path, lengths, timeout: float, bwd: bool = False) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--lengths", json.dumps(list(lengths)),
                        "--out", str(out), *(["--bwd"] if bwd else [])], check=True, timeout=timeout)
        return json.loads(out.read_text())


def run_bwd_turns(base: Path, timeout: float = 600.0) -> dict:
    """The backward's turns (base, this tree, this tree, base); each tree's time a row, the mean
    of its two turns, beside this tree's residency."""
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], [], timeout, bwd=True))
    merged = {}
    for name, (t1, t2) in turns.items():
        merged[name] = [r1 | {"ms": (r1["ms"] + r2["ms"]) / 2, "turn_ms": [r1["ms"], r2["ms"]]}
                        for r1, r2 in zip(t1["rows"], t2["rows"])]
    return {"order": ["base", "this", "this", "base"], "base": str(base), "mode": "bwd", "trees": merged}


def report_bwd(result: dict) -> None:
    for b, t in zip(result["trees"]["base"], result["trees"]["this"]):
        res = (f"; {t['registers']} registers, {t['local_bytes']} spilled bytes a thread, {t['threads']} threads, "
               f"{t['ctas']} CTAs an SM, grid {t['grid']} = {t['waves']:.2f} waves") if "ctas" in t else ""
        print(f"  backward {t['entry']} entry {tuple(t['shape'])}, {t['config']}: {b['ms']:.4f} -> {t['ms']:.4f} ms "
              f"({b['ms'] / t['ms']:.2f}x; bound {t['bound_ms']:.4f} ms, bytes){res}")


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
    ap.add_argument("--out", type=Path, help="default build/ssm_ab.json, with --bwd build/ssm_ab_bwd.json")
    ap.add_argument("--bwd", action="store_true", help="time the backward kernel (module docstring)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--lengths", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        result = worker_bwd(args.worker) if args.bwd else worker(args.worker, json.loads(args.lengths))
        args.out.write_text(json.dumps(result))
        return 0
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "ssm.cu").is_file():
        print(f"ssm_ab: {args.base} holds no src/repro_torch/kernels/csrc/ssm.cu", file=sys.stderr)
        return 2
    result = run_bwd_turns(args.base) if args.bwd else run_turns(args.base)
    out = args.out or ROOT / "build" / ("ssm_ab_bwd.json" if args.bwd else "ssm_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    (report_bwd if args.bwd else report)(result)
    print(f"  -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
