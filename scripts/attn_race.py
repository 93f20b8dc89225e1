#!/usr/bin/env python3
"""Look for a ring race in the port's kernels on one card, by running and by reading SASS.

    python3 scripts/attn_race.py --calls 3000 --base build/parent --out build/attn_race.json
    python3 scripts/attn_race.py --calls 0 --repeat-calls 200 --out build/ring_repeat.json

Two checks, each run from every tree given (``--base``, another checkout of the
repository such as ``git archive`` of a parent commit unpacked under ``build/``,
then this tree), each in a fresh process that builds the kernels from its tree:

* **Repeat.** The attention configs that read their TMA-fed ring with
  ``ldmatrix`` (block_q 32: ``fa_bq32_bkv{32,64,128}``) at (1, 32, 4096, 4096,
  64) bf16, causal and not, ``--calls`` calls each on the same inputs, alone
  and with a bf16 GEMM queued on a second stream before every fourth call.
  It counts the calls whose output is not bitwise equal to the first call's.
  A kernel without a race gives 0 everywhere.
* **Repeat of the other rings** (``--repeat-calls``, per kernel, config and
  case): the scan kernels (``ssm_cuda`` and ``ssm_cuda_fused``, which launch
  ``ssm_output_kernel`` and, where a call is cut into segments,
  ``ssm_state_kernel``; ``ssm_backward_cuda`` and ``ssm_fused_backward_cuda``,
  ``ssm_bwd_kernel``) at every compiled config, at hymba-1.5b's training
  shape (8, 128, 1600, 16) and the long (1, 2048, 1600, 16) call; the WKV
  kernels (``wkv_cuda``: state pass and output kernel; ``wkv_backward_cuda``:
  the walk, and the state kernel where it cuts a head) at every config at
  (8, 128, 64, 64) and (1, 2048, 64, 64); and the GEMM's persistent kernel
  at every config that launches it (``matmul.uses_persistent``) on
  (2048, 4096, 4096) bf16, with each operand also passed as a transposed
  view.  Each alone and with a bf16 GEMM queued on a second stream before
  every fourth call; the count is of calls not bitwise equal to the first.
* **SASS.** ``cuobjdump -sass`` of every library of the tree (``--libs``). For
  each ``mbarrier`` arrive that releases a stage (not a producer's
  ``expect_tx`` arrive), it lists the shared-memory loads (``LDS``, ``LDSM``)
  before it in the same straight-line run whose scoreboard no instruction up to
  and including the arrive waits on. Such a load can still be in flight when
  the arrive lets the producer refill its stage. The count is of candidates,
  by kernel: the SASS does not say which stage a load reads, so an arrive that
  releases another stage than the loads in flight read is counted too (the
  GEMM's mma.sync path releases the previous stage, ``csrc/matmul.cu``), and
  a ring filled by ``cp.async`` (generic proxy) is ordered by the arrive's
  release semantics where a TMA (async proxy) is not. Read each candidate
  against its source.

``chip_smoke.py`` phase 16 calls :func:`overtaking_arrives` on the attention
library, whose every stage release is right after a full-barrier wait, so
that any candidate there is a fault.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (1, 32, 4096, 4096, 64)  # (batch, heads, sq = skv, d): phase 16's largest prefill
RACE_CONFIGS = ("fa_bq32_bkv64", "fa_bq32_bkv32", "fa_bq32_bkv128")
LIBS = ("attention", "matmul", "ssm", "wkv", "wkv_bwd")

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\* (0x[0-9a-f]{16}) \*/")
_CTL = re.compile(r"^\s*/\* (0x[0-9a-f]{16}) \*/")
# Instructions that end a straight-line run: past them ptxas resolves or waits.
_RUN_ENDS = ("BRA", "BSYNC", "BSSY", "EXIT", "RET", "CALL", "BAR", "WARPSYNC.COLLECTIVE")


def parse_sass(text: str) -> dict[str, list[tuple[str, str, dict]]]:
    """Function name -> [(address, instruction, control)] where control holds the write
    scoreboard ``wr`` (7: none) and the ``wait`` mask of the instruction's control bits."""
    funcs: dict[str, list] = {}
    cur = None
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
        m = _INS.search(line)
        if m and cur is not None and i + 1 < len(lines) and (c := _CTL.match(lines[i + 1])):
            ctl = int(c.group(1), 16) >> 41
            funcs[cur].append((m.group(1), m.group(2).strip(), {"wr": (ctl >> 5) & 7, "wait": (ctl >> 11) & 0x3F}))
            i += 1
        i += 1
    return funcs


def _op(text: str) -> str:
    parts = text.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def _is_release(text: str) -> bool:
    # A consumer's release is SYNCS.ARRIVE.*.A1T0 (arrive one, no bytes; .RED for another
    # CTA's barrier in a cluster); a producer's expect_tx arrive carries a byte count and
    # releases nothing.
    op = _op(text)
    return op.startswith("SYNCS.ARRIVE") and "A1T0" in op


def release_arrives(ins: list[tuple[str, str, dict]]) -> int:
    """The stage-releasing arrives of one function."""
    return sum(_is_release(text) for _, text, _ in ins)


def overtaken_loads(ins: list[tuple[str, str, dict]]) -> list[dict]:
    """Every stage-releasing arrive of one function with the shared loads it can overtake."""
    found = []
    for k, (addr, text, _) in enumerate(ins):
        if not _is_release(text):
            continue
        loads = []
        for j in range(k - 1, -1, -1):
            t = ins[j][1]
            if _op(t).startswith(_RUN_ENDS) or "TRYWAIT" in t:
                break
            if _op(t).startswith(("LDS", "LDSM")) and ins[j][2]["wr"] != 7:
                loads.append(j)
        late = [ins[j][:2] for j in loads
                if not any(ins[x][2]["wait"] >> ins[j][2]["wr"] & 1 for x in range(j + 1, k + 1))]
        if late:
            found.append({"arrive": addr, "loads": [f"{a} {t}" for a, t in late]})
    return found


def overtaking_arrives(libs=LIBS, cuobjdump: str | None = None, dump_dir: Path | None = None,
                       releases: dict | None = None) -> dict:
    """{library: {kernel: candidate arrives, "functions": kernels read}} over every
    function of this tree's built libraries (building them if needed); where
    ``releases`` is a dict, it receives {library: {kernel: stage-releasing arrives}}."""
    from repro_torch.kernels import _build

    tool = cuobjdump or str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    _build.load_all(list(libs))
    out = {}
    for name in libs:
        so = _build.library_path(name, _build.nvcc_path())
        text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
        if dump_dir is not None:
            dump_dir.mkdir(parents=True, exist_ok=True)
            (dump_dir / f"{name}.sass").write_text(text)
        funcs = parse_sass(text)
        if not funcs:
            raise RuntimeError(f"cuobjdump gave no SASS functions for {so}")
        out[name] = {fn: len(found) for fn, ins in funcs.items() if (found := overtaken_loads(ins))}
        out[name]["functions"] = len(funcs)
        if releases is not None:
            releases[name] = {fn: n for fn, ins in funcs.items() if (n := release_arrives(ins))}
    return out


def _repeat(torch, fn, calls: int, busy: bool, side, load) -> tuple[int, float]:
    """``calls`` calls of ``fn`` (a tuple of tensors, or None among them) against
    the first; with ``busy`` a GEMM on ``side`` queued before every fourth."""
    first = fn()
    differ, worst = 0, 0.0
    for i in range(calls):
        if busy and i % 4 == 0:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                load @ load
        got = fn()
        if not all(x is y or torch.equal(x, y) for x, y in zip(got, first)):
            differ += 1
            worst = max(worst, max((x.float() - y.float()).abs().max().item()
                                   for x, y in zip(got, first) if x is not None))
    torch.cuda.synchronize()
    return differ, worst


def repeat_rings(torch, calls: int) -> list[dict]:
    """The repeat of the scan, WKV and persistent GEMM kernels (module docstring)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    g = torch.Generator(device="cuda").manual_seed(6)
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    side, load = torch.cuda.Stream(), torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    cases = []
    for b, s, d, n in ((8, 128, 1600, 16), (1, 2048, 1600, 16)):
        dtx, dta = randn(b, s, d) * 0.5, -torch.exp(randn(b, s, d, n) * 0.3)
        x, dt, a = randn(b, s, d) * 0.5, torch.nn.functional.softplus(randn(b, s, d)), -torch.exp(randn(d, n) * 0.3)
        bv, cv, st = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5, randn(b, d, n) * 0.1
        dy, ds = randn(b, s, d), randn(b, d, n)
        for cfg in ss.config_space():
            where = (cfg.name(), (b, s, d, n))
            cases += [("ssm_cuda", *where, lambda c=cfg, t=(dtx, dta, bv, cv, st): ss.ssm_cuda(*t, config=c)),
                      ("ssm_cuda_fused", *where,
                       lambda c=cfg, t=(x, dt, a, bv, cv, st): ss.ssm_cuda_fused(*t, config=c)),
                      ("ssm_backward_cuda", *where,
                       lambda c=cfg, t=(dtx, dta, bv, cv, st, dy, ds): ss.ssm_backward_cuda(*t, config=c)),
                      ("ssm_fused_backward_cuda", *where,
                       lambda c=cfg, t=(x, dt, a, bv, cv, st, dy, ds): ss.ssm_fused_backward_cuda(*t, config=c))]
    for b, s, h, hd in ((8, 128, 64, 64), (1, 2048, 64, 64)):
        r, k, v = randn(b, s, h, hd) * 0.5, randn(b, s, h, hd) * 0.5, randn(b, s, h, hd)
        logw, u, st = -torch.exp(randn(b, s, h, hd) * 0.5).clamp(1e-3, 5.0), randn(h, hd) * 0.3, randn(b, h, hd, hd)
        do, ds = randn(b, s, h, hd), randn(b, h, hd, hd)
        for cfg in wk.config_space():
            where = (cfg.name(), (b, s, h, hd))
            cases += [("wkv_cuda", *where, lambda c=cfg, t=(r, k, v, logw, u, st): wk.wkv_cuda(*t, config=c)),
                      ("wkv_backward_cuda", *where,
                       lambda c=cfg, t=(r, k, v, logw, u, st, do, ds): wk.wkv_backward_cuda(*t, config=c))]
    m, k, n = 2048, 4096, 4096
    a16, b16 = randn(m, k).bfloat16(), randn(k, n).bfloat16()
    at, bt = a16.t().contiguous().t(), b16.t().contiguous().t()  # transposed views of row-major copies
    persistent = getattr(mm, "uses_persistent", lambda *a: False)  # a tree without the persistent kernel
    for cfg in mm.config_space():
        if persistent(m, n, k, cfg):
            for name, lhs, rhs in (("matmul_cuda", a16, b16), ("matmul_cuda lhs view", at, b16),
                                   ("matmul_cuda rhs view", a16, bt)):
                cases.append((name, cfg.name(), (m, k, n), lambda c=cfg, l=lhs, r_=rhs: (mm.matmul_cuda(l, r_, c),)))
    rows = []
    for kernel, config, shape, fn in cases:
        for busy in (False, True):
            differ, worst = _repeat(torch, fn, calls, busy, side, load)
            rows.append({"kernel": kernel, "config": config, "shape": list(shape), "busy": busy, "calls": calls,
                         "differ": differ, "worst_abs_diff": worst})
    return rows


def worker(src: Path, calls: int, libs: tuple[str, ...], repeat_calls: int = 0) -> dict:
    """The checks with the kernels of the tree whose package root is ``src``."""
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.kernels import attention as at

    if not torch.cuda.is_available():
        raise RuntimeError("attn_race runs on the card and torch finds no CUDA device")
    res = {"sass": overtaking_arrives(libs)}
    cfgs = {c.name(): c for c in at.config_space()}
    b, h, s, _, d = SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((b, h, s, d), device="cuda", generator=g).bfloat16() for _ in range(3))
    side, a = torch.cuda.Stream(), torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    rows = []
    for name in RACE_CONFIGS:
        for causal in (False, True):
            for busy in (False, True):
                first = at.attention_cuda(q, k, v, cfgs[name], causal=causal)
                differ, worst = 0, 0.0
                for i in range(calls):
                    if busy and i % 4 == 0:
                        side.wait_stream(torch.cuda.current_stream())
                        with torch.cuda.stream(side):
                            a @ a
                    got = at.attention_cuda(q, k, v, cfgs[name], causal=causal)
                    if not torch.equal(got, first):
                        differ += 1
                        worst = max(worst, (got.float() - first.float()).abs().max().item())
                torch.cuda.synchronize()
                rows.append({"config": name, "causal": causal, "busy": busy, "calls": calls,
                             "differ": differ, "worst_abs_diff": worst})
    res["repeat"] = rows
    if repeat_calls:
        res["repeat_rings"] = repeat_rings(torch, repeat_calls)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--base", type=Path, help="another checkout of the repository, run first")
    ap.add_argument("--repeat-calls", type=int, default=0,
                    help="calls of each scan / WKV / persistent GEMM case (0: none)")
    ap.add_argument("--libs", default=",".join(LIBS))
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    libs = tuple(x for x in args.libs.split(",") if x)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.calls, libs, args.repeat_calls)))
        return 0
    trees = ([("base", args.base.resolve())] if args.base else []) + [("this", ROOT)]
    out = {"shape": SHAPE, "calls": args.calls}
    for label, tree in trees:
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(tree / "src"),
                                   "--calls", str(args.calls), "--libs", ",".join(libs),
                                   "--repeat-calls", str(args.repeat_calls)],
                                  capture_output=True, text=True, cwd=tmp)
        if proc.returncode != 0:
            raise RuntimeError(f"attn_race worker for {tree} failed:\n{proc.stderr[-4000:]}")
        out[label] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label} ({tree}):")
        for lib, kernels in out[label]["sass"].items():
            bad = {fn: n for fn, n in kernels.items() if fn != "functions"}
            print(f"  sass {lib}: {kernels['functions']} kernels, {sum(bad.values())} candidate arrives in "
                  f"{len(bad)} kernels" + (f", e.g. {sorted(bad)[0]}" if bad else ""))
        for r in out[label]["repeat"]:
            print(f"  {r['config']} causal={r['causal']} busy={r['busy']}: {r['differ']} of {r['calls']} calls "
                  f"differ from the first (worst abs diff {r['worst_abs_diff']:.4g})")
        rings = out[label].get("repeat_rings", [])
        by_kernel = {}
        for r in rings:
            tot = by_kernel.setdefault(r["kernel"], [0, 0, 0])
            tot[0] += r["calls"]
            tot[1] += r["differ"]
            tot[2] += 1
        for kernel, (calls, differ, cases) in by_kernel.items():
            print(f"  repeat {kernel}: {differ} of {calls} calls differ from their case's first ({cases} cases: "
                  f"configs x shapes x alone / beside a GEMM)")
        for r in rings:
            if r["differ"]:
                print(f"    {r['kernel']} {r['config']} {r['shape']} busy={r['busy']}: {r['differ']} of {r['calls']} "
                      f"(worst abs diff {r['worst_abs_diff']:.4g})")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
