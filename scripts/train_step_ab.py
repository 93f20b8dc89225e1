#!/usr/bin/env python3
"""Time granite-8b's training step with the embedding's two backwards, in turns on one card.

    python3 scripts/train_step_ab.py --out build/train_step_ab.json

The step is ``chip_smoke.py`` phase 25b's: granite-8b at full width, 2 of 36
layers, batch 8 x seq 128, AdamW through ``make_train_step``, in bf16 (the
GEMM's TMA path) and f32 (its f32 path).  The embedding's backward is either
the port's (``layers.table_grad``: an ordered f32 sum, bitwise repeatable) or
autograd's gradient of ``w[t]`` (an accumulating ``index_put_``: atomics, an
order that changes between runs), swapped in turns table_grad, w[t], w[t],
table_grad on one model, ``--steps`` warm steps a turn, each timed by the
host's clock after a synchronize.  Per variant and dtype: the step ms of its
turns, the peak memory a step allocates above what the turn started with,
and one warm step under ``torch.profiler``: device busy ms, the GEMM
kernels' ms, the ms of the kernels only that variant launches (its
embedding backward), and the idle share.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("table_grad", "w[t]")


def run(steps: int) -> dict:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("train_step_ab times on the card and torch finds no CUDA device")
    ordered = layers._TableRows.apply
    backward = {"table_grad": ordered, "w[t]": lambda w, t: w[t]}
    cfg = cs._train_cfg("granite-8b", n_layers=2)
    pipe = TokenPipeline(cfg, DataConfig(global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ))
    result = {}
    try:
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            rt = cs._train_runtime(f"train_step_ab[{name}]")
            with rt.activate():
                model = build_model(cfg, dtype=dtype, param_dtype=dtype, device="cuda")
                params = model.init(torch.Generator(device="cuda").manual_seed(0))
                opt = adamw.init(params)
                step_fn = make_train_step(model, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=1000))
                batches = [pipe.device_batch(i, dtype=dtype, device="cuda") for i in range(steps)]
                for variant in VARIANTS:  # warm: the first step builds the kernels
                    layers._TableRows.apply = backward[variant]
                    params, opt, _ = step_fn(params, opt, batches[0])
                torch.cuda.synchronize()
                rows = {v: {"step_ms": [], "peak_above_start": []} for v in VARIANTS}
                for variant in ("table_grad", "w[t]", "w[t]", "table_grad"):
                    layers._TableRows.apply = backward[variant]
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    start = torch.cuda.memory_allocated()
                    for batch in batches:
                        t0 = time.perf_counter()
                        params, opt, met = step_fn(params, opt, batch)
                        torch.cuda.synchronize()
                        rows[variant]["step_ms"].append((time.perf_counter() - t0) * 1e3)
                    rows[variant]["peak_above_start"].append(torch.cuda.max_memory_allocated() - start)
                for variant in VARIANTS:
                    layers._TableRows.apply = backward[variant]
                    holder = {}

                    def one_step():
                        holder["out"] = step_fn(params, opt, batches[0])

                    prof = cs._profile_window(torch, one_step, 1)
                    params, opt, _ = holder.pop("out")
                    rows[variant]["profile"] = {k: prof[k] for k in ("wall_ms", "busy_ms", "idle_share", "ms", "count")}
                    rows[variant]["gemm_ms"] = prof["ms"].get(cs.GEMM_KERNELS, 0.0)
                for variant, other in (VARIANTS, VARIANTS[::-1]):
                    own = {k: v for k, v in rows[variant]["profile"]["ms"].items()
                           if k not in rows[other]["profile"]["ms"]}
                    rows[variant]["own_kernels_ms"] = own
                for row in rows.values():
                    row["median_ms"] = statistics.median(row["step_ms"])
                result[name] = rows
                del model, params, opt, step_fn, batches
                cs._free(torch)
    finally:
        layers._TableRows.apply = ordered
    return result


def report(result: dict) -> None:
    for name, rows in result["dtypes"].items():
        for variant, row in rows.items():
            prof = row["profile"]
            own = ", ".join(f"{k} {v:.3f}" for k, v in sorted(row["own_kernels_ms"].items(), key=lambda kv: -kv[1]))
            print(f"  {name} {variant}: step ms median {row['median_ms']:.2f} of "
                  f"{[round(t, 2) for t in row['step_ms']]}; peak above the turn's start "
                  f"{[round(b / 1e9, 3) for b in row['peak_above_start']]} GB; profiled step: wall "
                  f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f}, GEMM kernels {row['gemm_ms']:.2f}, "
                  f"idle share {prof['idle_share']:.3f}; kernels only this variant launches: {own or 'none'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "train_step_ab.json")
    ap.add_argument("--steps", type=int, default=4, help="warm steps a turn")
    ap.add_argument("--report", type=Path, help="print the numbers of a saved result instead of measuring")
    args = ap.parse_args(argv)
    if args.report is not None:
        report(json.loads(args.report.read_text()))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    result = {"card": card, "order": ["table_grad", "w[t]", "w[t]", "table_grad"], "steps_a_turn": args.steps,
              "dtypes": run(args.steps)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    report(result)
    print(f"  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
