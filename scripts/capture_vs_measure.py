"""Serve with CUDA graphs on one thread while another measures a tuning table, with
and without the card lock (``core/gpubench.py``'s ``CARD_LOCK``).

A control plane measures tables on its worker thread while the serving engine
captures its programs on the main thread.  This script shows what happens on
the card when the two run together:

  * a worker thread runs ``gpubench.measure_matmul`` over granite-8b's decode
    GEMMs in a loop (allocations, queued timed calls, event synchronisations);
  * the main thread serves a reduced granite-8b (bf16) through a
    ``ServingEngine`` with CUDA graphs and forces every program to be
    captured again before each drain (a new policy object moves the epoch).

``--mode unlocked`` replaces ``CARD_LOCK`` with a no-op in both
(``gpubench`` and ``serve/engine.py``); ``--mode locked`` runs the code as it
is.  Each mode runs in a process of its own, because a failed capture can
leave the CUDA context unusable.  Run on the card (both modes, ~1 min):

    python scripts/capture_vs_measure.py [--drains 20] [--out chiprun_out/capture_vs_measure.json]

It prints one JSON line per mode: drains completed, the failures each thread
raised (first three messages), the engine's incidents (a contained retry
counts as a failure here), tables measured, and the seconds.  It exits
non-zero when the locked mode saw any failure.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROBLEMS = [(1, 4096, n, 4) for n in (1024, 4096, 14336)] + [(1, 14336, 4096, 4)]


def run(mode: str, drains: int) -> dict:
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import gpubench
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve import engine as engine_mod

    if not torch.cuda.is_available():
        raise SystemExit("capture_vs_measure: torch finds no CUDA device")
    _build.load_all(["matmul"])
    if mode == "unlocked":
        gpubench.CARD_LOCK = contextlib.nullcontext()
        engine_mod.CARD_LOCK = contextlib.nullcontext()
    cfg = registry.get("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rt = KernelRuntime(name=f"capture_vs_measure[{mode}]")
    rt.install(FixedPolicy())
    eng = engine_mod.ServingEngine(model, params, max_batch=2, cache_len=64, runtime=rt)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in (9, 27)]
    for p in prompts:  # warm: the kernels loaded, the first programs captured, before the worker starts
        eng.submit(p, max_new_tokens=4)
    eng.drain()

    stop = threading.Event()
    worker = {"tables": 0, "errors": []}

    def measure():
        while not stop.is_set():
            try:
                gpubench.measure_matmul(PROBLEMS, mm.config_space()[:4])
                worker["tables"] += 1
            except Exception as e:  # noqa: BLE001 — every failure is the finding
                worker["errors"].append(f"{type(e).__name__}: {e}")
                time.sleep(0.05)

    thread = threading.Thread(target=measure, name="measure", daemon=True)
    main = {"drains_ok": 0, "errors": [], "programs_captured": 0}
    t0 = time.perf_counter()
    thread.start()
    time.sleep(0.2)
    for _ in range(drains):
        rt.install(FixedPolicy())  # a new epoch: every program is captured again
        built = len(eng.program_log)
        try:
            for p in prompts:
                eng.submit(p, max_new_tokens=4)
            status = eng.drain()
            if status.completed == len(prompts):
                main["drains_ok"] += 1
            main["programs_captured"] += sum(r.captured for r in eng.program_log[built:])
        except Exception as e:  # noqa: BLE001 — every failure is the finding
            main["errors"].append(f"{type(e).__name__}: {e}")
            break  # the engine's state is unknown after an uncontained failure
    stop.set()
    thread.join(timeout=120)
    torch.cuda.synchronize()
    return {"mode": mode, "drains": drains, "drains_ok": main["drains_ok"],
            "programs_captured": main["programs_captured"], "main_errors": main["errors"][:3],
            "n_main_errors": len(main["errors"]), "incidents": [
                {k: r[k] for k in ("site", "error", "action")} for r in rt.incidents()][:3],
            "n_incidents": rt.incident_count(), "tables": worker["tables"], "worker_errors": worker["errors"][:3],
            "n_worker_errors": len(worker["errors"]), "seconds": time.perf_counter() - t0,
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("unlocked", "locked"), default=None,
                    help="run one mode in this process (default: both, each in a child process)")
    ap.add_argument("--drains", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if args.mode is not None:
        print(json.dumps(run(args.mode, args.drains)))
        return 0
    results = []
    for mode in ("unlocked", "locked"):
        proc = subprocess.run([sys.executable, __file__, "--mode", mode, "--drains", str(args.drains)],
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {"mode": mode}
        res["exit_code"] = proc.returncode
        if proc.returncode != 0:
            res["stderr_tail"] = proc.stderr[-2000:]
        results.append(res)
        print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in results) + "\n")
    locked = results[-1]
    clean = (locked.get("exit_code") == 0 and locked.get("n_main_errors") == 0 and locked.get("n_incidents") == 0
             and locked.get("n_worker_errors") == 0 and locked.get("drains_ok") == locked.get("drains"))
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
