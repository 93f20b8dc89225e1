#!/usr/bin/env python3
"""Time the port's GEMM from two source trees in turns on one card.

    python3 scripts/gemm_ab.py --base build/parent --out build/gemm_ab.json
    python3 scripts/gemm_ab.py --f32 --base build/parent --out build/gemm_ab_f32.json
    python3 scripts/gemm_ab.py --train --base build/parent --out build/gemm_ab_train.json

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
With ``--deployment build/deploy_h100.json`` (a tuned Deployment, as
``chip_smoke.py`` phase 17 writes it) the decode steps are also summed
under that Deployment's tree: at each decode shape the config it selects
for the engine's call (1 row, batch 4), from each tree's turns where that
tree compiles the config (else the shape's best there, marked).

    python3 scripts/gemm_ab.py --deployment build/deploy_h100.json --base build/parent

``--f32`` times the training path's f32 GEMMs instead (:func:`run_f32_turns`):
the forward, grad_lhs and grad_rhs GEMMs of one full-width granite-8b layer
at 1024 rows (batch 8 x seq 128) and seamless-m4t-large-v2's head gradient
(1024, 256256) @ (256256, 1024), each under ``DEFAULT_CONFIG`` (what
training launches) beside ``torch.matmul`` in f32 with TF32 off (a
yardstick only) and the bound 2mnk / 67e12 (operations: FP32 outside the
tensor cores), in the same turns; and, in each turn, the head gradient's
error against an f64 product, the kernel's beside ``torch.matmul``'s.
``chip_smoke.py`` runs it too when ``build/parent`` exists.

``--train`` times the bf16 training shapes instead (:func:`run_train_turns`):
the tall GEMM (16384, 4096, 14336) under every config, and the forward,
grad_lhs and grad_rhs GEMMs of one full-width granite-8b layer at 1024 rows
under ``DEFAULT_CONFIG`` (what training launches), each beside
``torch.matmul`` on the same operands (a yardstick only) and the bound
2mnk / 989e12, in the same turns.  The gradients' operands are what each
tree's backward hands its kernel: a tree whose ``matmul_cuda`` reads
transposed views (``rhs.t()``, ``lhs.t()``) gets the views; an older tree
gets row-major copies, and the copy's time is measured beside it (that
tree's backward makes it each step).  ``chip_smoke.py`` runs it in phase 25a
when ``build/parent`` exists.
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
F32_FLOPS = 67e12  # outside the tensor cores
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


# The f32 mode: one granite-8b layer's GEMMs by (k, n) and count (Q and O, K and V, gate and
# up, down) at TRAIN_ROWS rows, each as its forward and the two GEMMs of its backward; and
# seamless's head gradient, a K = 256,256 reduction over 64 output tiles of 128 x 128.
TRAIN_ROWS = 1024
GRANITE_LAYER = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}
SEAMLESS_HEAD_GRAD = (TRAIN_ROWS, 256256, 1024)


def layer_gemms(k: int, n: int) -> dict[str, tuple[int, int, int]]:
    """(m, k, n) of the forward and both gradient GEMMs of a (k, n) projection."""
    return {"forward": (TRAIN_ROWS, k, n), "grad_lhs": (TRAIN_ROWS, n, k), "grad_rhs": (k, TRAIN_ROWS, n)}


def train_shapes() -> list[list]:
    """(m, k, n, what) of the --train mode: the tall GEMM, then each granite-8b layer
    projection's forward, grad_lhs and grad_rhs at TRAIN_ROWS rows."""
    return [[*TALL, "tall"]] + [[*mkn, what] for k, n in GRANITE_LAYER for what, mkn in layer_gemms(k, n).items()]


def f32_shapes() -> list[tuple[int, int, int]]:
    layer = [mkn for k, n in GRANITE_LAYER for mkn in layer_gemms(k, n).values()]
    return [*dict.fromkeys(layer), SEAMLESS_HEAD_GRAD]


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


def worker_f32(src: Path, todo: list[tuple[int, int, int]]) -> dict:
    """Times ``todo`` in f32 with the matmul of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import matmul as mm

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_ab times on the card and torch finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    rows, exact = [], None
    for m, k, n in todo:
        a = torch.randn(m, k, device="cuda", generator=g)
        b = torch.randn(k, n, device="cuda", generator=g)
        ms = time_ms(lambda i: mm.matmul_cuda(a, b), n_warm=2, n_runs=5)
        library = time_ms(lambda i: torch.matmul(a, b), n_warm=2, n_runs=5)
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "library_ms": library})
        if (m, k, n) == SEAMLESS_HEAD_GRAD:
            e64 = a.double() @ b.double()
            scale = e64.abs().max().item()
            exact = {"kernel": (mm.matmul_cuda(a, b).double() - e64).abs().max().item() / scale,
                     "library": (torch.matmul(a, b).double() - e64).abs().max().item() / scale}
            del e64
        del a, b
    return {"src": str(src), "default": mm.DEFAULT_CONFIG.name(), "rows": rows, "against_f64": exact}


def worker_train(src: Path, todo: list[list]) -> dict:
    """Times ``todo`` (:func:`train_shapes`) in bf16 with the matmul of the tree whose
    package root is ``src``, each gradient on the operands that tree's backward passes."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.gpubench import time_ms
    from repro_torch.kernels import matmul as mm

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_ab times on the card and torch finds no CUDA device")
    views = hasattr(mm, "transposed")  # the tree reads transposed operands in place
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for m, k, n, what in todo:
        a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        b = torch.randn(k, n, device="cuda", generator=g).bfloat16()
        copy_ms = 0.0
        if what in ("grad_lhs", "grad_rhs"):
            lay = (b.t().contiguous() if what == "grad_lhs" else a.t().contiguous())  # the tensor as it lies
            view = lay.t()
            if not views:
                copy_ms = time_ms(lambda i: view.contiguous(), n_warm=3, n_runs=20)
                view = view.contiguous()
            a, b = (a, view) if what == "grad_lhs" else (view, b)
        runs = 5 if what == "tall" else 20
        cfgs = mm.config_space() if what == "tall" else [mm.DEFAULT_CONFIG]
        per_cfg = {c.name(): time_ms(lambda i, c=c: mm.matmul_cuda(a, b, c), n_warm=3, n_runs=runs) for c in cfgs}
        library = time_ms(lambda i: torch.matmul(a, b), n_warm=3, n_runs=runs)
        rows.append({"m": m, "k": k, "n": n, "what": what, "per_config_ms": per_cfg, "library_ms": library,
                     "copy_ms": copy_ms, "views": views})
        del a, b
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


def _turn(src: Path, todo, timeout: float, mode: str | None = None) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "turn.json"
        subprocess.run([sys.executable, __file__, "--worker", str(src), "--shapes", json.dumps(todo),
                        "--out", str(out), *([f"--{mode}"] if mode else [])], check=True, timeout=timeout)
        return json.loads(out.read_text())


def tree_picks(deployment: Path, todo) -> dict:
    """The config a tuned Deployment's tree selects at each decode shape (m rows as
    the engine calls it: ``ops.matmul`` on (m, 1, k), a problem of 1 row, batch m)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dispatch import Deployment

    dep = Deployment.load(str(deployment))
    return {f"{m}x{k}x{n}": dep.select_matmul(1, k, n, m).name() for m, k, n in todo if m == 4}


def run_turns(base: Path, todo=None, timeout: float = 600.0, deployment: Path | None = None) -> dict:
    """base, this tree, this tree, base: each tree's per-shape numbers, the mean of its
    two turns; with ``deployment``, each decode shape's time under its tree."""
    todo = [list(s) for s in (todo or shapes())]
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    picks = tree_picks(deployment, todo) if deployment else {}
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
            pick = picks.get(f"{r1['m']}x{r1['k']}x{r1['n']}")
            if pick is not None:
                rows[-1].update(tree_config=pick, tree_compiled=pick in per, tree_ms=per.get(pick, per[best]))
        merged[name] = rows
    out = {"order": ["base", "this", "this", "base"], "base": str(base), "trees": merged}
    return out | ({"deployment": str(deployment), "tree_picks": picks} if deployment else {})


def f32_bound_ms(m: int, k: int, n: int) -> float:
    return 2 * m * k * n / F32_FLOPS * 1e3  # operations bound them: 230-340 FLOP a byte


def run_f32_turns(base: Path, timeout: float = 900.0) -> dict:
    """The f32 mode's turns (base, this tree, this tree, base); each tree's per-shape
    numbers the mean of its two turns, with both turns' kernel times kept."""
    todo = [list(s) for s in f32_shapes()]
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], todo, timeout, mode="f32"))
    merged = {}
    for name, (t1, t2) in turns.items():
        merged[name] = {"rows": [{"m": r1["m"], "k": r1["k"], "n": r1["n"], "ms": (r1["ms"] + r2["ms"]) / 2,
                                  "turns_ms": [r1["ms"], r2["ms"]],
                                  "library_ms": (r1["library_ms"] + r2["library_ms"]) / 2,
                                  "bound_ms": f32_bound_ms(r1["m"], r1["k"], r1["n"])}
                                 for r1, r2 in zip(t1["rows"], t2["rows"])],
                        "against_f64": [t1["against_f64"], t2["against_f64"]]}
    return {"order": ["base", "this", "this", "base"], "base": str(base), "mode": "f32", "trees": merged}


def run_train_turns(base: Path, timeout: float = 900.0) -> dict:
    """The --train mode's turns (base, this tree, this tree, base); each tree's numbers
    the mean of its two turns, both turns' DEFAULT_CONFIG times kept."""
    todo = train_shapes()
    trees = {"base": base / "src", "this": ROOT / "src"}
    turns = {name: [] for name in trees}
    for name in ("base", "this", "this", "base"):
        turns[name].append(_turn(trees[name], todo, timeout, mode="train"))
    merged = {}
    for name, (t1, t2) in turns.items():
        rows = []
        for r1, r2 in zip(t1["rows"], t2["rows"]):
            per = {c: (r1["per_config_ms"][c] + r2["per_config_ms"][c]) / 2 for c in r1["per_config_ms"]}
            best = min(per, key=per.get)
            rows.append({"m": r1["m"], "k": r1["k"], "n": r1["n"], "what": r1["what"], "views": r1["views"],
                         "default_ms": per[t1["default"]], "best_config": best, "best_ms": per[best],
                         "per_config_ms": per, "turns_default_ms": [r1["per_config_ms"][t1["default"]],
                                                                    r2["per_config_ms"][t1["default"]]],
                         "library_ms": (r1["library_ms"] + r2["library_ms"]) / 2,
                         "copy_ms": (r1["copy_ms"] + r2["copy_ms"]) / 2,
                         "bound_ms": bound_ms(r1["m"], r1["k"], r1["n"])[0]})
        merged[name] = rows
    return {"order": ["base", "this", "this", "base"], "base": str(base), "mode": "train", "trees": merged}


def train_layer_sums(result: dict) -> dict:
    """Per tree: one granite-8b layer's forward / grad_lhs / grad_rhs GEMM time under
    DEFAULT_CONFIG, the copies its backward makes first, torch.matmul's time and the
    bound, in ms (each shape's number times its count in the layer)."""
    sums = {}
    for tree, rows in result["trees"].items():
        by = {(r["m"], r["k"], r["n"], r["what"]): r for r in rows}
        sums[tree] = {key: {what: sum(c * by[(*layer_gemms(k, n)[what], what)][key] for (k, n), c in
                                      GRANITE_LAYER.items())
                            for what in ("forward", "grad_lhs", "grad_rhs")}
                      for key in ("default_ms", "copy_ms", "library_ms", "bound_ms")}
    return sums


def report_train(result: dict) -> None:
    flops = 2 * TALL[0] * TALL[1] * TALL[2]
    for base_row, row in zip(result["trees"]["base"], result["trees"]["this"]):
        if row["what"] == "tall":
            print(f"  tall {TALL} bf16: DEFAULT_CONFIG {flops / base_row['default_ms'] / 1e9:.0f} -> "
                  f"{flops / row['default_ms'] / 1e9:.0f} TFLOP/s; best {base_row['best_config']} "
                  f"{flops / base_row['best_ms'] / 1e9:.0f} -> {row['best_config']} {flops / row['best_ms'] / 1e9:.0f}; "
                  f"torch.matmul {flops / row['library_ms'] / 1e9:.0f}; bound {row['bound_ms']:.3f} ms")
            continue
        copy = f" + copy {base_row['copy_ms']:.4f}" if base_row["copy_ms"] else ""
        print(f"  {row['what']} ({row['m']}, {row['k']}, {row['n']}) bf16, DEFAULT_CONFIG: {base_row['default_ms']:.4f}"
              f"{copy} -> {row['default_ms']:.4f}{' (views)' if row['views'] else ''} ms (turns "
              f"{[round(t, 4) for t in base_row['turns_default_ms']]} -> {[round(t, 4) for t in row['turns_default_ms']]});"
              f" torch.matmul {row['library_ms']:.4f}; bound {row['bound_ms']:.4f}")
    sums = train_layer_sums(result)
    for what in ("forward", "grad_lhs", "grad_rhs"):
        b, t = sums["base"], sums["this"]
        print(f"  one granite-8b layer's {what} GEMMs at {TRAIN_ROWS} rows, bf16: {b['default_ms'][what]:.3f} ms "
              f"(+ copies {b['copy_ms'][what]:.3f}) -> {t['default_ms'][what]:.3f} (+ copies {t['copy_ms'][what]:.3f}); "
              f"torch.matmul {t['library_ms'][what]:.3f}, {t['default_ms'][what] / t['library_ms'][what]:.2f}x it; "
              f"bound {t['bound_ms'][what]:.3f}")


def f32_layer_sums(result: dict) -> dict:
    """Per tree: one granite-8b layer's forward / grad_lhs / grad_rhs GEMM time (each
    shape's time times its count), its torch.matmul time and its bound, in ms."""
    sums = {}
    for tree, res in result["trees"].items():
        by = {(r["m"], r["k"], r["n"]): r for r in res["rows"]}
        sums[tree] = {key: {what: sum(c * by[layer_gemms(k, n)[what]][key] for (k, n), c in GRANITE_LAYER.items())
                            for what in ("forward", "grad_lhs", "grad_rhs")}
                      for key in ("ms", "library_ms", "bound_ms")}
    return sums


def report_f32(result: dict) -> None:
    for base_row, row in zip(result["trees"]["base"]["rows"], result["trees"]["this"]["rows"]):
        print(f"  f32 ({row['m']}, {row['k']}, {row['n']}): DEFAULT_CONFIG {base_row['ms']:.3f} -> {row['ms']:.3f} ms "
              f"(turns {[round(t, 3) for t in base_row['turns_ms']]} -> {[round(t, 3) for t in row['turns_ms']]}); "
              f"bound {row['bound_ms']:.3f} (operations); torch.matmul {row['library_ms']:.3f}")
    sums = f32_layer_sums(result)
    for what in ("forward", "grad_lhs", "grad_rhs"):
        print(f"  one granite-8b layer's {what} GEMMs at {TRAIN_ROWS} rows, f32: {sums['base']['ms'][what]:.3f} -> "
              f"{sums['this']['ms'][what]:.3f} ms; bound {sums['this']['bound_ms'][what]:.3f}; torch.matmul "
              f"{sums['this']['library_ms'][what]:.3f}")
    for tree in ("base", "this"):
        errs = result["trees"][tree]["against_f64"]
        print(f"  {tree}: {SEAMLESS_HEAD_GRAD} against an f64 product, relative to its max: kernel "
              f"{[format(e['kernel'], '.3g') for e in errs]}, torch.matmul "
              f"{[format(e['library'], '.3g') for e in errs]}")


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
            if all("tree_ms" in dec[kn] for kn in step):
                sums[arch][f"{tree}_tree_ms"] = sum(dec[kn]["tree_ms"] * c for kn, c in step.items())
                sums[arch][f"{tree}_tree_uncompiled"] = sorted({dec[kn]["tree_config"] for kn in step
                                                                if not dec[kn]["tree_compiled"]})
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
        if "this_tree_ms" in s:
            missing = s["base_tree_uncompiled"]
            print(f"  {arch} decode step's GEMMs under {result['deployment']}'s tree: {s['base_tree_ms']:.2f} -> "
                  f"{s['this_tree_ms']:.2f} ms ({s['this_tree_ms'] / s['base_tree_ms'] - 1:+.1%})"
                  + (f"; the base compiles no {missing}: its best config at those shapes" if missing else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "gemm_ab.json")
    ap.add_argument("--report", type=Path, help="print the numbers of a saved result instead of measuring")
    ap.add_argument("--f32", action="store_true", help="time the training path's f32 GEMMs (module docstring)")
    ap.add_argument("--train", action="store_true", help="time the bf16 training shapes (module docstring)")
    ap.add_argument("--deployment", type=Path, help="also sum the decode steps under this Deployment's tree")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        fn = worker_f32 if args.f32 else worker_train if args.train else worker
        result = fn(args.worker, [list(s) if args.train else tuple(s) for s in json.loads(args.shapes)])
        args.out.write_text(json.dumps(result))
        return 0
    reporter = {"f32": report_f32, "train": report_train}
    if args.report is not None:
        result = json.loads(args.report.read_text())
        reporter.get(result.get("mode"), report)(result)
        return 0
    if not (args.base / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu").is_file():
        print(f"gemm_ab: {args.base} holds no src/repro_torch/kernels/csrc/matmul.cu", file=sys.stderr)
        return 2
    result = (run_f32_turns(args.base) if args.f32 else run_train_turns(args.base) if args.train
              else run_turns(args.base, deployment=args.deployment))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    reporter.get(result.get("mode"), report)(result)
    print(f"  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
