#!/usr/bin/env python3
"""Time the port's GEMM from two source trees in turns on one card.

    python3 scripts/gemm_ab.py --base build/parent --out build/gemm_ab.json

``--base`` is another checkout of the repository (for example ``git archive``
of a parent commit unpacked under ``build/``); the other tree is this one.
Each turn is a fresh process that builds and loads ``csrc/matmul.cu`` from
its tree and times every compiled config at the decode-step GEMMs of
full-width granite-8b, rwkv6-7b and hymba-1.5b (4 rows: batch 4 folded) and
at one tall GEMM (16384, 4096, 14336), with ``core/gpubench.time_ms`` (CUDA
events, each call queued behind a device sleep; weights rotated through more
than the 50 MB L2), beside one call from an idle device, ``torch.matmul`` (a
yardstick only), the bound max(FLOPs / 989e12, bytes / 3.35e12) and the
host's time per call under ``DEFAULT_CONFIG`` (200 calls enqueued back to
back, at the decode shapes).  The
turns run base, this tree, this tree, base, so that drift on the card falls
on both alike; each tree's number is the mean of its two turns.
``chip_smoke.py`` calls :func:`run_turns` when ``build/parent`` exists.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
# GEMM launches per decode step (batch 4) of each served model, by (k, n), as chip_smoke.py
# phases 4, 8 and 12 count them; the vocab GEMMs emit f32 logits.
DECODE_STEP = {
    "granite-8b": {(4096, 4096): 72, (4096, 1024): 72, (4096, 14336): 72, (14336, 4096): 36, (4096, 49152): 1},
    "rwkv6-7b": {(4096, 4096): 192, (4096, 64): 32, (64, 4096): 32, (4096, 14336): 32, (14336, 4096): 32,
                 (4096, 65536): 1},
    "hymba-1.5b": {(1600, 1600): 96, (1600, 320): 64, (1600, 3200): 32, (1600, 48): 32, (48, 1600): 32,
                   (1600, 16): 64, (1600, 5504): 64, (5504, 1600): 32, (1600, 32128): 1},
}
DECODE_KN = {arch: list(step) for arch, step in DECODE_STEP.items()}
VOCAB_KN = {(4096, 49152), (4096, 65536), (1600, 32128)}
TALL = (16384, 4096, 14336)


def shapes() -> list[tuple[int, int, int]]:
    decode = dict.fromkeys((4, k, n) for kn in DECODE_KN.values() for k, n in kn)
    return [*decode, TALL]


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    out_bytes = 4 if (k, n) in VOCAB_KN else 2
    nbytes = (m * k + k * n) * 2 + m * n * out_bytes
    t_ops, t_bytes = 2 * m * k * n / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def worker(src: Path, todo: list[tuple[int, int, int]]) -> dict:
    """Times ``todo`` with the matmul of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import matmul as mm

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_ab times on the card and torch finds no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for m, k, n in todo:
        out = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16
        a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        copies = max(1, -(-150_000_000 // (k * n * 2)))
        bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
        runs = 5 if m > 1024 else 20
        per_cfg = {c.name(): time_ms(lambda i, c=c: mm.matmul_cuda(a, bs[i % copies], c, out_dtype=out),
                                     n_warm=3, n_runs=runs) for c in mm.config_space()}
        call = time_ms(lambda i: mm.matmul_cuda(a, bs[i % copies], out_dtype=out), n_warm=3, n_runs=runs,
                       queued=False)
        library = time_ms(lambda i: torch.matmul(a, bs[i % copies]).to(out), n_warm=3, n_runs=runs)
        host = host_us(torch, lambda: mm.matmul_cuda(a, bs[0], out_dtype=out)) if m <= 1024 else None
        rows.append({"m": m, "k": k, "n": n, "per_config_ms": per_cfg, "call_ms": call, "library_ms": library,
                     "host_us": host})
        del a, bs
    return {"src": str(src), "default": mm.DEFAULT_CONFIG.name(), "rows": rows}


def host_us(torch, fn, n: int = 200) -> float:
    """Host microseconds per call: ``n`` calls enqueued back to back, no sync between."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _turn(src: Path, todo, timeout: float) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--shapes", json.dumps(todo),
                        "--out", str(out)], check=True, timeout=timeout)
        return json.loads(out.read_text())


def run_turns(base: Path, todo=None, timeout: float = 600.0) -> dict:
    """base, this tree, this tree, base: each tree's per-shape numbers, the mean of its two turns."""
    todo = [list(s) for s in (todo or shapes())]
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], todo, timeout))
    merged = {}
    for name, (t1, t2) in turns.items():
        rows = []
        for r1, r2 in zip(t1["rows"], t2["rows"]):
            mean = lambda a, b: (a + b) / 2
            per = {c: mean(r1["per_config_ms"][c], r2["per_config_ms"][c]) for c in r1["per_config_ms"]}
            best = min(per, key=per.get)
            bnd, by = bound_ms(r1["m"], r1["k"], r1["n"])
            rows.append({"m": r1["m"], "k": r1["k"], "n": r1["n"], "default_ms": per[t1["default"]],
                         "best_config": best, "best_ms": per[best], "per_config_ms": per,
                         "call_ms": mean(r1["call_ms"], r2["call_ms"]),
                         "library_ms": mean(r1["library_ms"], r2["library_ms"]), "bound_ms": bnd, "bound_by": by,
                         "host_us": None if r1["host_us"] is None else mean(r1["host_us"], r2["host_us"]),
                         "turns_default_ms": [r1["per_config_ms"][t1["default"]], r2["per_config_ms"][t1["default"]]]})
        merged[name] = rows
    return {"order": ["base", "this", "this", "base"], "base": str(base), "trees": merged}


def step_sums(result: dict) -> dict:
    """One decode step's GEMM time of each model, per tree: each timed quantity summed
    over the step's launches."""
    sums = {}
    for arch, step in DECODE_STEP.items():
        sums[arch] = {}
        for tree, rows in result["trees"].items():
            dec = {(r["k"], r["n"]): r for r in rows if r["m"] == 4}
            for key in ("default_ms", "best_ms", "call_ms", "library_ms", "bound_ms", "host_us"):
                sums[arch][f"{tree}_{key}"] = sum(dec[kn][key] * c for kn, c in step.items())
    return sums


def report(result: dict) -> None:
    for base_row, row in zip(result["trees"]["base"], result["trees"]["this"]):
        host = "" if row["host_us"] is None else f", host {base_row['host_us']:.1f} -> {row['host_us']:.1f} us"
        print(f"  ({row['m']}, {row['k']}, {row['n']}): default {base_row['default_ms']:.4f} -> "
              f"{row['default_ms']:.4f} ms, best {base_row['best_ms']:.4f} -> {row['best_ms']:.4f}, one call "
              f"from idle {base_row['call_ms']:.4f} -> {row['call_ms']:.4f}{host}; bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}), torch.matmul {row['library_ms']:.4f}")
    for arch, s in step_sums(result).items():
        print(f"  {arch} decode step's GEMMs: default {s['base_default_ms']:.2f} -> {s['this_default_ms']:.2f} ms, "
              f"best per shape {s['base_best_ms']:.2f} -> {s['this_best_ms']:.2f}; one call from idle each "
              f"{s['base_call_ms']:.2f} -> {s['this_call_ms']:.2f}; host {s['base_host_us'] / 1e3:.2f} -> "
              f"{s['this_host_us'] / 1e3:.2f} ms; bound {s['this_bound_ms']:.2f}; torch.matmul "
              f"{s['this_library_ms']:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "gemm_ab.json")
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
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu").is_file():
        print(f"gemm_ab: {args.base} holds no src/repro_torch/kernels/csrc/matmul.cu", file=sys.stderr)
        return 2
    result = run_turns(args.base)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    report(result)
    print(f"  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
