#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU and the CUDA toolkit; exits non-zero without them.
Phases (each one fails the run if its check fails):

1. card: the GPU's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (matmul, wkv, ssm, attention), one nvcc per source, all started together;
3. GEMM against plain: every compiled matmul config, in bf16->bf16,
   bf16->f32 and f32->f32, at ragged shapes, at the split-k boundaries (k <
   block_k, k not a multiple of block_k x splits, m = 1, n = 16), at a
   16-byte-misaligned base (the cp.async path) and at every GEMM shape that
   full-width granite-8b, rwkv6-7b and hymba-1.5b serving give the kernel, against
   ``matmul_plain`` (TF32 off), each config called twice in a row on the same
   inputs: both within the limit and bitwise equal (the split-k counters are
   left at 0 and the partials summed in split order); then 8 more passes over
   the bf16 pairs with fresh inputs, for races.  Error = max|kernel -
   plain| / max|plain|; limits 1e-2 (bf16 out), 1e-3 (f32 out from bf16), 1e-5
   (f32 in);
3b. WKV against plain: every compiled chunk config, r/k/v in bf16 and f32,
   head dims 16 and 64, S in {1, 7, 16, 50, 128, 300} (and the served
   (1, S, 64, 64) at S in {32, 64, 128}), with and without an initial state,
   nonzero u, decays drawn as the reference test draws them, at the clamp
   (-5) and a -5 / -1e-3 mix, and one long case (1, 2048, 64, 64) in bf16
   with a state, against ``wkv_plain`` (TF32 off), each config called twice
   on the same inputs.  Limit 1e-4 relative to max|plain| for the output and
   the final state; every output finite; both calls bitwise equal;
4. full-width granite-8b serving: unreduced (d_model 4096, 32 heads, 8 KV
   heads, d_ff 14336, vocab 49152, 36 layers), bf16, random weights from a
   CUDA generator, ServingEngine(max_batch=4, cache_len=256), which serves
   through CUDA graphs (one per prefill bucket and decode width), 4 requests
   of 8-100 tokens, 16 new tokens each, twice on one engine: a cold drain
   (every program warmed up and captured) and a warm drain (replays only),
   with equal streams; tokens/s, prefill times and the decode step for both.
   The wrappers count launches in Python, so they count each program's
   warm-up and capture: the GEMM launches must be 2 x (7 * n_layers + 1) per
   program, every one on the TMA path, none in the warm drain; the selection
   consulted once per call of each program's warm-up (in the scanned
   granite-8b and rwkv6-7b once per layer body: layer 0's calls and the
   head's) and pinned for its capture; the engine's replays must equal the
   forwards (phases 8, 12 and 19 likewise);
5. selection reaches the kernel: one request under a FixedPolicy with a
   non-default matmul config launches that config and not the default;
5b. profile (torch.profiler, which sees the kernels inside a replay): two warm
   decode replays and one warm prefill replay at bucket 32, each with 7 *
   n_layers + 1 GEMM kernels a forward, one window each and an exact count;
   device time by kernel, idle share (1 - busy / the window's host wall), and
   from the device timeline the idle time inside each replay's span and
   between the replays;
5c. the eager engine (``cuda_graphs=False``) on the same weights and
   requests (its programs warmed up once, then one warm drain): a captured
   decode replay bitwise equal to its body run eagerly; token streams equal
   to the graphed engine's; warm decode step, idle share
   (profiled, and an estimate from the unprofiled median), tokens/s, seconds
   building programs and memory reserved side by side
   (phases 9c and 13c likewise);
6. CPU against card: the serving CLI on reduced granite-8b in f32, once with
   ``--device cuda`` and once with ``--device cpu``, same seed: equal greedy
   token streams;
7. GEMM timing: each served granite GEMM shape with CUDA events (median of 20
   after warm-up, each call queued behind a device sleep so that the events
   hold device time, weights rotated through more than the 50 MB L2), beside
   its bound max(FLOPs / 989e12, bytes / 3.35e12), one call from an idle
   device (host launch work included), the plain version and torch.matmul (a
   yardstick only: the port never calls it); and the tall harvest GEMM
   (16384, 4096, 14336) under every config with its TFLOP/s;
8. full-width rwkv6-7b serving, after granite's weights are released:
   unreduced (32 layers, d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab
   65536), bf16, the same engine and requests.  A forward launches the
   GEMM 10 * n_layers + 1 times, a prefill the WKV kernel n_layers times and
   a decode step 0 times (counted at warm-ups and captures);
9. selection reaches the WKV kernel: one request under
   FixedPolicy(wkv_config=WkvConfig(64)) launches wkv_c64 and not wkv_c16;
9b. profile: as 5b; the prefill replay runs n_layers of each WKV kernel;
9c. eager against graphed, as 5c;
10. CPU against card: the serving CLI on reduced rwkv6-7b in f32, cuda and
   cpu: equal greedy token streams;
11. timing: the WKV kernels at (1, S, 64, 64), S in {32, 64, 128, 2048},
   every chunk config, beside its bound max(bytes / 3.35e12, 5 hd^2 f32
   operations per token and head / 67e12) and the plain version, and the
   kernels one call launches (the state pass and the output kernel); the
   GEMM at rwkv6-7b's decode shapes as in phase 7;
3c. (run with phase 3) SSM against plain: both entries (``ssm_cuda`` from dtx
   and dta, ``ssm_cuda_fused`` from x, dt and a) at every compiled (block_d,
   chunk) config, state sizes 8 and 16, with and without an initial state, S
   in {1, 7, 50, 128, 300} at a ragged d = 100 and at d = 50 (not a multiple
   of 4: the 4-byte copies), the served (1, S, 1600, 16) at S in {32, 64,
   128}, and (1, 2048, 1600, 16) with a state, dta drawn as the reference test
   draws it (-exp(0.3 normal)) and dt * a alike, against ``ssm_plain`` /
   ``ssm_fused_plain``, each config called twice on the same inputs, each call
   launching the segments ``ssm.launch_segments`` names, the 300- and
   2048-step cases also cut into 2, 3, 5 and 7 segments (as far as the chunks
   reach).  Limit 1e-4 relative to max|plain| for y and the final state; every
   output finite; both calls bitwise equal;
12. full-width hymba-1.5b serving, after rwkv6-7b's weights are released:
   unreduced (32 layers, d_model 1600, 25 heads, 5 KV heads of 64, d_ff 5504,
   vocab 32001, ssm_state 16, window 2048), bf16, the same engine and
   requests.  A forward launches the GEMM 13 * n_layers + 1 times, a
   prefill the SSM kernel n_layers times, all through ``ssm_cuda_fused``
   (none through the dta entry), and a decode step 0 times;
13. selection reaches the SSM kernel: one request under
   FixedPolicy(ssm_config=SsmConfig(8, 16)) launches ssm_bd8_c16 n_layers
   times at its prefill program's warm-up and again at its capture, and the
   default not at all;
13b. profile: as 5b; the prefill replay runs n_layers ``ssm_output_kernel``;
13c. eager against graphed, as 5c; then a cut SSM call on a stream with no
   workspace yet raises under a capture (a workspace is allocated only outside
   one, at its fixed bound);
14. CPU against card on Hymba, in process: reduced hymba-1.5b at 4 layers
   (one sliding-window layer, window 32), f32, cache_len 128, prompts of 20
   and 45 tokens (buckets 32 and 64: the ring is written by the ring-buffer
   prefill and wraps in decode), 16 new tokens each: equal greedy token
   streams on cuda and cpu;
15. timing: both SSM entries at (1, S, 1600, 16), S in {32, 64, 128, 2048},
   every config, each beside its own bound max(bytes / 3.35e12, 6 f32
   operations per (t, channel, state) / 67e12) (the fused entry reads x, dt
   and a; the dta entry dtx and the (B, S, d, N) dta), the plain version, the
   segments the default config launches and the kernels one call launches
   (torch.profiler: ssm_output_kernel, and ssm_state_kernel where the call is
   cut); the GEMM at hymba-1.5b's decode shapes as in phase 7;
16. attention against plain: every compiled (block_q, block_kv) config, q/k/v in
   bf16 and f32, head dims 64 and 128, causal and not, at (2, 3) heads for (sq,
   skv) in {(1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000), (300,
   200), (1, 4103), (4, 4103), (1, 32768), (4, 32768)} and (40, 24) (sq > skv:
   the rows that see nothing must be zeros), and at the served (1, 32, 1, 32768)
   and (1, 32, 4096, 4096), against ``attention_plain`` (TF32 off), each config
   called twice in a row (bitwise equal: the split-KV combine runs in split
   order and leaves its counters at 0), on the path its block_q names (wgmma at
   64 and 128, mma.sync at 32, SIMT for f32), split into as many KV splits as
   ``attention.launch_splits`` names (every decode shape splits); then 8 more
   passes over the bf16 shapes with fresh inputs.  Limits relative to
   max|plain|: 1e-2 for a bf16 output, 1e-4 for f32; every output finite;
17. tune on the card, every family, as the fleet of the card and host_cpu:
   ``python -m repro_torch.launch.tune --devices <card>,host_cpu --archs
   granite-8b,rwkv6-7b,hymba-1.5b --n-kernels 4 --cpu-problems 8 --bundle
   build/bundle_h100.json --out build/deploy_h100.json`` in process (one
   tune: ``--out`` is the fleet's card Deployment): the matmul (99 problems x 10 configs), attention (11 x 9), WKV
   (4 x 5, through ``wkv_cuda`` at 64 heads, bf16) and scan (3 x 9, through
   ``ssm_cuda_fused``) tables measured with the port's kernels, every cell
   (``measured_fraction`` 1.0, full config-space widths, every family's
   launch counter moving), the paper's pipeline, the bundle and the Deployment
   written; the seconds and the oracle and classifier fractions of each family
   (and each deployment's oracle over the whole measured table);
17b. the staged bring-up: the same tune with ``--transfer-from`` phase 17's
   deployment, ``--prune-ratio 0.5`` and ``--measure-budget auto``: each
   family's measured fraction at most its resolved budget; its measured
   cells, seconds against phase 17's, the H100 model's error on the measured
   cells, and the staged deployment's oracle fraction over phase 17's full
   table;
17c. the fleet bundle of phase 17, loaded back (v6, checksums verified, no load
   errors); detection resolves the card's entry, and ``REPRO_DEVICE="NVIDIA
   A100-SXM4-80GB"`` resolves it through the same-platform step; the
   reference's TPU fixture ``tests/data/bundle_v5.json`` must not install on
   the card. Then rwkv6-7b and hymba-1.5b, full width in f32, serve phase 8's
   and 12's batches from the bundle through ``launch.serve``'s ``--bundle``
   path (``build_engine``) under CUDA graphs, beside the ``FixedPolicy()``
   engine: the WKV and scan configs the served prefills launched, by
   bucket, are the tree's; whether the greedy streams are equal.  The
   logits of each prompt's captured prefill program against
   ``FixedPolicy()``'s: within 1e-4 of max|FixedPolicy()'s| on engines of
   the model's first 8 layers built the same way (required), and at full
   depth (reported: a deep random-weight model amplifies f32 rounding);
18. the quickstart's path: the Deployment loaded into a fresh KernelRuntime
   (selection logging on); under ``rt.activate()``, ``ops.attention`` at every
   harvested attention problem at (1, 32) heads in bf16, twice (the second a
   shape-cache hit), each call launching exactly the config
   ``Deployment.select_attention`` names (every decode problem split into more
   than one KV split) and matching the plain version within 1e-2;
   ``ops.matmul`` at the quickstart's two shapes launching the tree's matmul
   config.  Each problem's path, KV splits, kernel, plain and SDPA times beside
   its bound;
19. full-width granite-8b served as in phase 4 under the tuned Deployment: 7 *
   n_layers + 1 GEMM launches per forward, the split over the deployed configs,
   tokens/s, the decode step, and one decode step's GEMM device time under the
   tree's choices (from phase 7's per-config times) beside the default config's
   and each shape's best; whether the greedy streams equal phase 4's;
19b. profile: as 5b, under the tuned tree;
19c. ``FixedPolicy()`` installed mid-run in the tuned engine's runtime: the
   programs are captured again under the new epoch (prefill and decode), and
   their launches take the default config;
20. attention timing: every config at granite-8b's (1, 32, S, 128) and
   hymba-1.5b's (1, 25, S, 64), causal S in {512, 2048, 4096} and a decode step
   at 4096 and 32768 cached tokens, beside the bound max(FLOPs / 989e12, bytes /
   3.35e12), one call from an idle device, the plain version and SDPA with
   ``causal_lower_right`` (a yardstick only: the port never calls it);
20b. only where ``build/parent`` holds another checkout (the parent commit):
   ``scripts/gemm_ab.py`` times its GEMM and this tree's in turns (parent,
   this, this, parent) at every decode-step GEMM shape of the three models and
   the tall GEMM, and one decode step's GEMM time of each model, summed with
   the launch counts of phases 4, 8 and 12;
20c. only where ``build/parent`` holds the parent commit: ``scripts/attn_ab.py``
   times its attention kernel and this tree's in turns (parent, this, this,
   parent), every config at every problem of phases 18 and 20, and checks
   each decode shape at least 2x the parent and no prefill shape more than 5%
   slower (reported, not required);
20d. only where ``build/parent`` holds the parent commit: ``scripts/ssm_ab.py``
   times its selective scan and this tree's in turns (parent, this, this,
   parent) at (1, S, 1600, 16), S in {32, 64, 128, 2048}, every config of the
   dta entry (both trees have it) and of the fused entry (this tree);
21. fault containment and continuous tuning on the tuned granite-8b (run after
   19c, before its weights go):
   21a. guarded dispatch on direct ``ops`` calls: ``dispatch.matmul:compile_error``
   keyed on the config the tree serves at a decode shape is redirected to
   ``DEFAULT_CONFIG``, bitwise equal to a direct launch, incident ``quarantined``;
   ``QUARANTINE_BACKOFF`` more calls: redirected, then one re-probe, absolved; a
   ``nan`` fault caught by output validation and redirected; the same redirect for
   ``ops.wkv`` (1, 32, 64, 64) and ``ops.ssm_scan_fused`` (1, 32, 1600, 16); a fault
   on ``DEFAULT_CONFIG`` itself raises with ``unrecoverable``; host µs per eager
   call (direct ``matmul_cuda``, ``ops.matmul`` with no plan and with an armed plan
   that never fires);
   21b. phase 19's batch drained under ``engine.prefill:compile_error,
   engine.decode:compile_error:1:5,dispatch.matmul:compile_error`` under CUDA
   graphs: every request completes, 2 engine retries, the programs dropped and
   captured again (and their seconds), health back to healthy, greedy streams
   equal to phase 19's;
   21c. an engine served from phase 17's bundle adopts the card's bundle entry
   (offered, loaded again) at a step boundary, then, with ``retune_interval``,
   drains the batch (whose buckets the harvest lacks), retunes matmul on
   ``gpubench`` tables of the drifted problems, canaries the candidate on the
   card (``matmul_cuda`` at its config; an ``attention_cuda`` probe too) and
   hot-swaps it: events, seconds to measure, fit and canary, epochs, programs
   captured again, warm decode median before and after; a
   ``canary.matmul:nan`` candidate rejected; a forced swap rolled back by
   ``rollback_threshold`` injected decode faults (captured again);
   21d. ``OnlinePolicy`` with the CUDA-event measurer on direct ``ops.matmul``
   calls at granite-8b's decode shapes: warm-up cost, commits per bucket, how
   many equal phase 7's per-shape best;
22. no Python collection ran during any CUDA graph capture (one there could
   free a dead engine's graphs and invalidate the capture); the ``kernels``
   JSON line, then the card line, then the result line.

Each phase's header shows the seconds since the start.

Everything measured also goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
TOL = {("bf16", "bf16"): 1e-2, ("bf16", "f32"): 1e-3, ("f32", "f32"): 1e-5}
GEMM_PAIRS = [f"{src}->{dst}" for src, dst in TOL]
WKV_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's tolerance
WKV_LONG = 2048  # a long prompt: 128 chunks of 16 through the state pass, a 268 MB workspace at chunk 8
GRANITE_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 49152)]
RWKV_KN = [(4096, 4096), (4096, 64), (64, 4096), (4096, 14336), (14336, 4096), (4096, 65536)]
HYMBA_KN = [(1600, 1600), (1600, 320), (1600, 3200), (1600, 48), (48, 1600), (1600, 16), (1600, 5504),
            (5504, 1600), (1600, 32128)]
VOCAB_KN = {(4096, 49152), (4096, 65536), (1600, 32128)}
SSM_TOL = 1e-4  # both sides compute in f32 from the same values; the reference kernel test's rtol
SSM_LONG = 2048  # a long prompt: the harvest's shortest long length, cut into segments across CTAs
PROMPT_LENGTHS = (8, 37, 64, 100)
# What a wrapper's launch counter counts on the served paths: the engine captures each
# program as a CUDA graph, so a wrapper call launches onto the card at the program's one
# eager warm-up and into the graph at its capture. A replay launches the captured kernels
# without a wrapper call: the profiler counts them in the profiled replays
# (kernels_in_profiled_replays), and the engine counts its replays (program_replays).
LAUNCHES_COUNTED_AS = ("wrapper calls: per program built, one at its warm-up (run on the card) and one at its "
                       "capture (recorded into the graph); replays make none (see kernels_in_profiled_replays "
                       "and program_replays)")
# Attention against plain, relative to max |plain|: a bf16 output is one rounding (2^-8) from
# the f32 answer on each side; f32 sums in another order.
ATTN_TOL = {"bf16": 1e-2, "f32": 1e-4}
TUNED_ARCHS = ("granite-8b", "rwkv6-7b", "hymba-1.5b")
DEPLOY_PATH = ROOT / "build" / "deploy_h100.json"
STAGED_PATH = ROOT / "build" / "deploy_h100_staged.json"
BUNDLE_PATH = ROOT / "build" / "bundle_h100.json"
TPU_FIXTURE = ROOT / "tests" / "data" / "bundle_v5.json"
SERVED_ARCHS = ("rwkv6-7b", "hymba-1.5b")  # phase 17c serves them from the bundle
LOGIT_DEPTH = 8  # 17c: layers over which bundle and FixedPolicy() logits must agree within WKV_TOL
TALL = (16384, 4096, 14336)  # the harvest's tallest single GEMM (core/gpubench.FOLD_ROWS rows)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Split-k boundaries: k < block_k, k not a multiple of block_k x splits, m = 1, n = 16 (< block_n).
# An odd n (4, 4100, 97) takes the cp.async path, splits k and stores element by element.
SPLIT_SHAPES = [(1, 48, 1600), (4, 1000, 16), (3, 4100, 96), (1, 64, 4096), (4, 1600, 48), (4, 4104, 1024),
                (4, 4100, 97)]


def _misaligned(torch, x):
    """A contiguous copy of ``x`` whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = flat[1 : 1 + x.numel()].view(x.shape)
    out.copy_(x)
    return out


# Extra passes of phase 3 over the bf16 pairs, with fresh inputs: a race between the TMA
# ring's stages once showed in only one of several such passes before it was fixed.
RACE_PASSES = 8


def phase_kernel_vs_plain(torch, mm) -> dict:
    """Every compiled config against the plain version, all three type pairs,
    each config twice in a row on the same inputs; then RACE_PASSES more
    passes over the bf16 pairs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    shapes = [(m, k, n) for m in (1, 4, 37, 128) for k in (100, 4100) for n in (96, 1024)]
    shapes += SPLIT_SHAPES
    shapes += [(m, k, n) for m in (1, 4, 32, 64, 128) for k, n in dict.fromkeys(GRANITE_KN + RWKV_KN + HYMBA_KN)]
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {pair: {"rel": 0.0, "abs": 0.0} for pair in TOL}
    checks = 0
    mm.reset_launches()
    cases = [(*shape, False) for shape in shapes] + [(4, 4096, 1024, True)]
    for m, k, n, misaligned, pairs in [(*c, TOL) for c in cases] + [
            (*c, {p: t for p, t in TOL.items() if p[0] == "bf16"}) for _ in range(RACE_PASSES) for c in cases]:
        a32 = torch.randn(m, k, device="cuda", generator=g)
        b32 = torch.randn(k, n, device="cuda", generator=g)
        for (src, dst), tol in pairs.items():
            a, b = a32.to(dt[src]), b32.to(dt[src])
            if misaligned:
                a = _misaligned(torch, a)
            want = mm.matmul_plain(a, b, dt[dst]).float()
            scale = want.abs().max().item()
            for cfg in mm.config_space():
                first = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst])
                second = mm.matmul_cuda(a, b, cfg, out_dtype=dt[dst])
                where = f"{cfg.name()} {src}->{dst} at {(m, k, n)}{' (misaligned base)' if misaligned else ''}"
                for got in (first.float(), second.float()):
                    err = (got - want).abs().max().item()
                    require(err / scale <= tol, f"{where}: rel err {err / scale:.3g} > {tol}")
                    w = worst[(src, dst)]
                    w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                    checks += 1
                require(torch.equal(first, second), f"{where}: two calls in a row differ")
    torch.cuda.synchronize()
    paths = dict(mm.PATH_LAUNCHES)
    require(all(paths.values()), f"a kernel path was never launched: {paths}")
    for (src, dst), w in worst.items():
        print(f"  {src}->{dst}: worst rel err {w['rel']:.3g} (limit {TOL[(src, dst)]}), "
              f"worst abs err {w['abs']:.3g}")
    print(f"  {checks} checks over {len(cases)} shapes x {len(mm.config_space())} configs x 2 calls (3 type pairs, then "
          f"{RACE_PASSES} passes of the 2 bf16 pairs): all within tolerance, both calls bitwise equal; launches by "
          f"path {paths}")
    return {f"{s}->{d}": w for (s, d), w in worst.items()} | {"checks": checks, "paths": paths}


def _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state):
    """r/k/v/u in ``dtype``, logw and the state in f32, drawn as the reference's
    kernel test draws them; ``decay`` picks logw: 'dist', 'clamp' or 'mix'."""
    shape = (b, s, h, hd)
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    r, k, v = randn(*shape) * 0.5, randn(*shape) * 0.5, randn(*shape)
    logw = -torch.exp(randn(*shape) * 0.5).clamp(1e-3, 5.0)
    if decay == "clamp":
        logw = torch.full(shape, -5.0, device="cuda")
    elif decay == "mix":
        logw = torch.where(torch.rand(shape, device="cuda", generator=g) < 0.5, -5.0, -1e-3)
    u = randn(h, hd) * 0.3
    state = randn(b, h, hd, hd) * 0.1 if with_state else None
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u.to(dtype), state


def phase_wkv_vs_plain(torch, wk) -> dict:
    """Every compiled chunk config against the plain version, each config
    called twice on the same inputs (both calls bitwise equal), and one long
    case at (1, 2048, 64, 64) in bf16 with a state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4)
    shapes = [(2, s, 3, hd) for hd in (16, 64) for s in (1, 7, 16, 50, 128, 300)]
    shapes += [(1, s, 64, 64) for s in (32, 64, 128)]  # what rwkv6-7b prefill gives the kernel
    cases = [(shape, dtype, decay, with_state) for shape in shapes for dtype in (torch.bfloat16, torch.float32)
             for decay in ("dist", "clamp", "mix") for with_state in (True, False)]
    cases.append(((1, WKV_LONG, 64, 64), torch.bfloat16, "dist", True))
    worst = {"rel": 0.0, "abs": 0.0}
    clamp_finite = {c.name(): True for c in wk.config_space()}
    checks = 0
    for (b, s, h, hd), dtype, decay, with_state in cases:
        args = _wkv_inputs(torch, g, b, s, h, hd, dtype, decay, with_state)
        want = wk.wkv_plain(*args)
        scales = [w.abs().max().item() for w in want]
        for cfg in wk.config_space():
            first = wk.wkv_cuda(*args, config=cfg)
            second = wk.wkv_cuda(*args, config=cfg)
            where = f"{cfg.name()} at {(b, s, h, hd)} {dtype} {decay} state={with_state}"
            require(all(torch.equal(x, y) for x, y in zip(first, second)), f"{where}: two calls differ")
            for name, x, w, scale in zip(("o", "state"), first, want, scales):
                finite = bool(torch.isfinite(x).all())
                require(finite, f"{where}: {name} not finite")
                err = (x - w).abs().max().item()
                require(err <= WKV_TOL * scale, f"{where}: {name} rel err {err / scale:.3g} > {WKV_TOL}")
                worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
                if decay != "dist":
                    clamp_finite[cfg.name()] &= finite
            checks += 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 dtypes x 3 decays x 2 states, and (1, {WKV_LONG}, 64, 64) "
          f"bf16 with a state, x {len(wk.config_space())} configs, each called twice): worst rel err "
          f"{worst['rel']:.3g} (limit {WKV_TOL}), worst abs err {worst['abs']:.3g}; both calls bitwise equal; "
          f"finite at logw = -5 and the -5 / -1e-3 mix: {clamp_finite}")
    return worst | {"checks": checks, "clamp_finite": clamp_finite}


def _ssm_inputs(torch, g, b, s, d, n, with_state):
    """dtx, dta, b, c (and the state) in f32, drawn as the reference's kernel
    test draws them (tests/test_ssm_kernel.py:_inputs)."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    dtx, dta = randn(b, s, d) * 0.5, -torch.exp(randn(b, s, d, n) * 0.3)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    return dtx, dta, bv, cv, (randn(b, d, n) * 0.1 if with_state else None)


def _ssm_fused_inputs(torch, g, b, s, d, n, with_state):
    """x, dt (softplus of a normal, as models/mamba.py makes it), a (-exp of 0.3 normal:
    dt * a lies where the reference test's dta does), b, c (and the state), all f32."""
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g)
    x, dt = randn(b, s, d) * 0.5, torch.nn.functional.softplus(randn(b, s, d))
    a = -torch.exp(randn(d, n) * 0.3)
    bv, cv = randn(b, s, n) * 0.5, randn(b, s, n) * 0.5
    return x, dt, a, bv, cv, (randn(b, d, n) * 0.1 if with_state else None)


# Segment counts forced at the cut cases of phase 3c besides the rule's own (2, 3, 5 and a
# count whose segments are uneven), so every fold length runs whatever the rule picks.
SSM_FORCED_SEGMENTS = (1, 2, 3, 5, 7)


def phase_ssm_vs_plain(torch, ss) -> dict:
    """Both entries (dta and fused) at every compiled (block_d, chunk) config against
    the plain version, each called twice (bitwise equal), each call launching the
    segments ``ssm.launch_segments`` names; the long case also under forced segment
    counts."""
    g = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(2, s, d, n) for d in (100, 50) for n in (8, 16) for s in (1, 7, 50, 128, 300)]
    shapes += [(1, s, 1600, 16) for s in (32, 64, 128)]  # what hymba-1.5b prefill gives the kernel
    cases = [(shape, with_state) for shape in shapes for with_state in (True, False)]
    cases.append(((1, SSM_LONG, 1600, 16), True))
    entries = {"dta": (_ssm_inputs, ss.ssm_cuda, ss.ssm_plain),
               "fused": (_ssm_fused_inputs, ss.ssm_cuda_fused, ss.ssm_fused_plain)}
    worst = {e: {"rel": 0.0, "abs": 0.0} for e in entries}
    checks, cut = 0, 0
    rule = ss.ssm_segments
    for (b, s, d, n), with_state in cases:
        for entry, (draw, kernel, plain) in entries.items():
            args = draw(torch, g, b, s, d, n, with_state)
            want = plain(*args)
            scales = [w.abs().max().item() for w in want]
            for cfg in ss.config_space():
                segs = ss.launch_segments(b, s, d, n, cfg, entry == "fused", 0)
                forced = SSM_FORCED_SEGMENTS if s in (300, SSM_LONG) else ()
                # The rule's count (unforced), then each forced count the chunks reach.
                counts = [None] + sorted({ss.reachable_segments(s, cfg, f) for f in forced} - {segs})
                for count in counts:
                    where = f"{cfg.name()} {entry} at {(b, s, d, n)} state={with_state} segments={count or segs}"
                    before = ss.SEGMENTS_LAUNCHED[cfg.name()]
                    try:
                        if count is not None:
                            ss.ssm_segments = lambda *_, c=count: c
                        first = kernel(*args, config=cfg)
                        second = kernel(*args, config=cfg)
                    finally:
                        ss.ssm_segments = rule
                    ran = ss.SEGMENTS_LAUNCHED[cfg.name()] - before
                    require(ran == 2 * (count or segs), f"{where}: launched {ran / 2} segments a call")
                    require(all(torch.equal(x, y) for x, y in zip(first, second)), f"{where}: two calls differ")
                    for name, x, w, scale in zip(("y", "state"), first, want, scales):
                        require(bool(torch.isfinite(x).all()), f"{where}: {name} not finite")
                        err = (x - w).abs().max().item()
                        require(err <= SSM_TOL * scale, f"{where}: {name} rel err {err / scale:.3g} > {SSM_TOL}")
                        w_ = worst[entry]
                        w_["rel"], w_["abs"] = max(w_["rel"], err / scale), max(w_["abs"], err)
                    checks += 1
                    cut += (count or segs) > 1
    torch.cuda.synchronize()
    print(f"  {checks} checks ({len(shapes)} shapes x 2 states and (1, {SSM_LONG}, 1600, 16) with a state, x 2 "
          f"entries x {len(ss.config_space())} configs, the 300- and {SSM_LONG}-step cases also at segments "
          f"{SSM_FORCED_SEGMENTS}; {cut} of them cut into segments), each called twice: worst rel err "
          + ", ".join(f"{e} {w['rel']:.3g} (abs {w['abs']:.3g})" for e, w in worst.items())
          + f" (limit {SSM_TOL}); every output finite; both calls bitwise equal; segments as launch_segments says")
    return {"rel": max(w["rel"] for w in worst.values()), "abs": max(w["abs"] for w in worst.values()),
            "by_entry": worst, "checks": checks, "cut": cut}


# Per arch: GEMM launches per forward, and launches per prefill of each
# sequence kernel (every decode step launches none of them).
# Models whose layer loop runs through ops.scan_layers, as the reference scans its layers:
# a program build selects layer 0's kernels once and every later layer reuses them.
SCANNED = ("granite-8b", "rwkv6-7b")


def _expected(cfg) -> tuple[int, dict[str, int]]:
    n = cfg.n_layers
    if cfg.name == "granite-8b":
        require((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (4096, 32, 8, 14336, 49152),
                f"unexpected granite-8b config {cfg}")
        return 7 * n + 1, {"wkv": 0, "ssm": 0}
    if cfg.name == "rwkv6-7b":
        require((n, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab)
                == (32, 4096, 64, 64, 14336, 65536), f"unexpected rwkv6-7b config {cfg}")
        return 10 * n + 1, {"wkv": n, "ssm": 0}
    require((n, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.ssm_state,
             cfg.window) == (32, 1600, 25, 5, 64, 5504, 32001, 16, 2048), f"unexpected hymba-1.5b config {cfg}")
    return 13 * n + 1, {"wkv": 0, "ssm": n}


def _selections_per_build(cfg, launches: int) -> int:
    """Selections one program build makes for ``launches`` kernel calls per forward:
    one per call, or, in a scanned model, layer 0's and the head's."""
    if cfg.name not in SCANNED:
        return launches
    body, head = divmod(launches, cfg.n_layers)
    return body + head


_FAMILY = {"wkv": "wkv", "ssm": "ssm_scan"}  # launch counter -> selection family


def _drain(torch, engine, prompts, mm, seq: dict) -> dict:
    """Serve ``prompts`` x 16 tokens through ``engine`` (submit, drain), timing every
    forward on the host clock after a synchronize. Per forward: (kind, size, GEMM
    launches counted, {sequence kernel: launches counted}, programs built, seconds)."""
    events: list[tuple[str, int, int, dict, int, float]] = []
    mark = {"gemm": mm.total_launches(), "built": len(engine.program_log)} | {
        name: mod.total_launches() for name, mod in seq.items()}

    def record(kind):
        def hook(size):
            torch.cuda.synchronize()
            now, gemm, built = time.perf_counter(), mm.total_launches(), len(engine.program_log)
            counts = {name: mod.total_launches() for name, mod in seq.items()}
            events.append((kind, size, gemm - mark["gemm"], {k: v - mark[k] for k, v in counts.items()},
                           built - mark["built"], now - mark["t"]))
            mark.update(counts, gemm=gemm, built=built, t=now)
        return hook

    engine.on_prefill, engine.on_decode = record("prefill"), record("decode")
    torch.cuda.synchronize()
    mark["t"] = t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.on_prefill = engine.on_decode = None
    require(status.completed == len(prompts) and not status.exhausted, f"not every request completed: {status}")
    require(all(len(t.request.output) == 16 for t in tickets), "a request got fewer than 16 tokens")
    toks = sum(len(t.request.output) for t in tickets)
    decode_ms = [sec * 1e3 for kind, *_, sec in events if kind == "decode"]
    return {"events": events, "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
            "prefill_ms": [round(sec * 1e3, 3) for kind, *_, sec in events if kind == "prefill"],
            "prefill_buckets": [size for kind, size, *_ in events if kind == "prefill"],
            "decode_ms": decode_ms, "decode_median_ms": statistics.median(decode_ms),
            "decode_min_ms": min(decode_ms), "decode_max_ms": max(decode_ms),
            "outputs": [list(t.request.output) for t in tickets]}


def _print_drain(name: str, d: dict) -> None:
    print(f"  {name}: {d['tokens']} tokens in {d['wall_s']:.3f}s ({d['tok_per_s']:.1f} tok/s); prefill ms "
          f"{d['prefill_ms']} (buckets {d['prefill_buckets']}); decode step ms median {d['decode_median_ms']:.3f} "
          f"(min {d['decode_min_ms']:.3f}, max {d['decode_max_ms']:.3f}) over {len(d['decode_ms'])} steps")


def phase_serve(torch, mm, seq: dict, arch: str, policy=None) -> dict:
    """Serve 4 requests x 16 tokens at full width through the engine's CUDA graphs,
    twice on one engine: a cold drain (every program warmed up and captured) and a
    warm drain (replays only). ``policy`` (default ``FixedPolicy()``) is installed in
    the engine's runtime.

    The kernels' launch counters count in Python, so they count a program's warm-up
    and its capture (each one forward), never a replay: every program built adds
    2 x per_forward GEMM launches (a prefill program also 2 x n_layers WKV / SSM
    launches), and the warm drain adds none. The engine counts its replays."""
    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = registry.get(arch)
    per_forward, per_prefill = _expected(cfg)
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {arch} full width: {cfg.n_layers} layers (no depth cut), d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16; weights {weight_bytes / 1e9:.2f} GB, "
          f"init {init_s:.1f}s")

    # A direct prefill: finite f32 logits over the padded vocab (also warms up).
    tokens = torch.randint(0, cfg.vocab, (1, 32), device="cuda")
    logits, _ = model.prefill(params, {"tokens": tokens}, 256)
    require(tuple(logits.shape) == (1, 1, cfg.padded_vocab()) and logits.dtype == torch.float32,
            f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    rt = KernelRuntime(name=f"chip_smoke[{arch}]")
    rt.install(FixedPolicy() if policy is None else policy)
    rt.set_selection_logging(True, cap=1 << 16)
    engine = ServingEngine(model, params, max_batch=4, cache_len=256, runtime=rt)
    require(engine.cuda_graphs, "the engine does not take CUDA graphs on a CUDA model")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]

    # The main path, both drains: counts to 0 just before, read just after.
    torch.cuda.synchronize()
    mm.reset_launches()
    for mod in seq.values():
        mod.reset_launches()
    encodes = mm.map_encodes()
    cold = _drain(torch, engine, prompts, mm, seq)
    launches_cold = mm.total_launches()
    warm = _drain(torch, engine, prompts, mm, seq)
    launches = dict(mm.LAUNCHES)
    paths = dict(mm.PATH_LAUNCHES)
    encodes = mm.map_encodes() - encodes
    seq_launches = {name: dict(mod.LAUNCHES) for name, mod in seq.items()}
    seq_entries = {name: dict(mod.ENTRY_LAUNCHES) for name, mod in seq.items() if hasattr(mod, "ENTRY_LAUNCHES")}

    built = engine.program_log
    programs = engine.programs()
    require(all(r.captured for r in built) and all(
        isinstance(p.graph, torch.cuda.CUDAGraph) for c in (engine._prefill_cache, engine._decode_cache)
        for p in c.values()), f"a program was not captured: {built}")
    require(len(built) == len(programs), f"programs built {built} but live {sorted(programs)}")
    n_prefill_progs = sum(r.kind == "prefill" for r in built)
    forwards = len(cold["events"]) + len(warm["events"])
    replays = sum(v["runs"] for v in programs.values())
    require(replays == forwards, f"{replays} replays for {forwards} forwards")
    replays_by_program = {f"{kind} {size}": v["runs"] for (kind, size), v in programs.items()}
    require(warm["outputs"] == cold["outputs"], "the warm drain's streams differ from the cold drain's")
    total = sum(launches.values())
    require(total == launches_cold == 2 * per_forward * len(built),
            f"GEMM launches {launches_cold} (cold) / {total} (both drains): want 2 x {per_forward} x "
            f"{len(built)} programs (a warm-up and a capture each), none in the warm drain")
    bad = [(kind, size, n, b) for kind, size, n, _, b, _ in cold["events"] + warm["events"] if n != 2 * per_forward * b]
    require(not bad, f"forwards whose GEMM launches are not 2 x {per_forward} x programs built: {bad}")
    require(paths["tma"] == total, f"served bf16 GEMMs off the TMA path: {paths}")
    stats = rt.shape_cache_stats()
    fam = stats["per_family"]
    for name in seq:
        want = 2 * per_prefill[name] * n_prefill_progs
        got = sum(seq_launches[name].values())
        require(got == want, f"{name} launches {got}: want 2 x {per_prefill[name]} x {n_prefill_progs} prefill programs")
    # One consultation per program build: its warm-up selects (once per call, or once per
    # scanned layer body) and pins the configs, and the capture launches them again.
    pins = {}
    for cache in (engine._prefill_cache, engine._decode_cache):
        for prog in cache.values():
            for op, _problem, _cfg in prog.pins.entries:
                pins[op] = pins.get(op, 0) + 1
    per_build = {"matmul": _selections_per_build(cfg, per_forward)} | {
        _FAMILY[k]: _selections_per_build(cfg, v) for k, v in per_prefill.items() if v}
    for op, n in [("matmul", total)] + [(_FAMILY[k], sum(v.values())) for k, v in seq_launches.items()]:
        got = fam.get(op, {"hits": 0, "misses": 0})
        builds = len(built) if op == "matmul" else n_prefill_progs
        want = per_build.get(op, 0) * builds
        require(got["hits"] + got["misses"] == pins.get(op, 0) == want,
                f"{op}: {got} selections, {pins.get(op, 0)} pinned, want one per call of each build's "
                f"warm-up ({per_build.get(op, 0)} x {builds} builds) for {n} launches")
    require(fam["matmul"]["hits"] > 0, f"matmul shape cache never hit: {fam}")
    # GEMM launches per width-4 decode forward, per (k, n), from the selection log: one entry
    # per call of each width-4 decode build (each layer body's once in a scanned model).
    decode4 = sum(1 for r in built if r.kind == "decode" and r.size == 4)
    counts: dict[str, int] = {}
    for op, problem, _cfg in rt.selection_log():
        # Decode GEMMs have 4 rows: a (4, 1, D) activation is (m, batch) = (1, 4), and Mamba's
        # output projection of a (4, D) one is (4, 1). Prefill GEMMs have >= 32 rows.
        if op == "matmul" and problem[0] * problem[3] == 4:
            kn = f"{problem[1]}x{problem[2]}"
            layers = cfg.n_layers if arch in SCANNED and (problem[1], problem[2]) not in VOCAB_KN else 1
            counts[kn] = counts.get(kn, 0) + layers
    per_step = {kn: c / decode4 for kn, c in counts.items()}
    decode_configs = sorted({(f"{p[1]}x{p[2]}", c.name()) for op, p, c in rt.selection_log()
                             if op == "matmul" and p[0] * p[3] == 4})
    require(sum(per_step.values()) == per_forward, f"decode-step GEMMs by shape {per_step} do not sum to {per_forward}")
    capture_s = sum(r.seconds for r in built)
    _print_drain("cold drain (captures included)", cold)
    _print_drain("warm drain (replays only)", warm)
    print(f"  programs: {len(built)} captured ({', '.join(f'{r.kind} {r.size}' for r in built)}) in "
          f"{capture_s:.3f}s (warm-up and capture), {replays} replays over both drains {replays_by_program}; "
          f"warm / cold streams equal")
    seq_text = "; ".join(f"{name.upper()} launches: {sum(seq_launches[name].values())} = 2 x {per_prefill[name]} x "
                         f"{n_prefill_progs} prefill programs" for name in seq)
    print(f"  GEMM launches (counted in Python: warm-ups and captures): {total} = 2 x {per_forward} per forward x "
          f"{len(built)} programs, 0 in the warm drain, all on the TMA path ({paths}), {encodes} tensor maps "
          f"encoded; {seq_text}; selection consulted once per call of each build's warm-up, pinned for its "
          f"capture ({per_build} a build; shape cache {stats['hits']} hits / {stats['misses']} misses)")
    print(f"  width-4 decode-step GEMM launches per (k x n): {per_step}")
    return {
        "arch": arch, "n_layers": cfg.n_layers, "weight_bytes": weight_bytes, "cold": cold, "warm": warm,
        "tokens": cold["tokens"], "wall_s": cold["wall_s"], "tok_per_s": cold["tok_per_s"],
        "prefill_ms": cold["prefill_ms"], "prefill_buckets": cold["prefill_buckets"], "decode_ms": cold["decode_ms"],
        "programs": [dataclasses.asdict(r) for r in built], "capture_s": capture_s, "replays": replays,
        "program_replays": replays_by_program,
        "launches": launches, "path_launches": paths, "map_encodes": encodes, "per_forward": per_forward,
        "forwards": forwards, "per_decode_step": per_step,
        "shape_cache": {k: stats[k] for k in ("hits", "misses")}, "per_family": fam,
        "decode_configs": decode_configs, "outputs": cold["outputs"],
        "engine": engine, "model": model, "params": params, "prompts": prompts, "policy": policy,
    } | {f"{name}_launches": seq_launches[name] for name in seq} | {
        f"{name}_entry_launches": launches for name, launches in seq_entries.items()} | {
        f"{name}_per_prefill": per_prefill[name] for name in seq}


def _programs_built(engine, kind: str | None = None) -> int:
    return sum(1 for r in engine.program_log if kind is None or r.kind == kind)


def phase_policy(mm, serve: dict) -> dict:
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    other = mm.MatmulConfig(16, 128, 64, "nmk")
    require(other in mm.config_space() and other != mm.DEFAULT_CONFIG, "bad choice of config")
    rt = KernelRuntime(name="chip_smoke-fixed")
    rt.install(FixedPolicy(matmul_config=other))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mm.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, default = mm.LAUNCHES[other.name()], mm.LAUNCHES[mm.DEFAULT_CONFIG.name()]
    want = 2 * serve["per_forward"] * _programs_built(engine)
    require(got == want and default == 0,
            f"FixedPolicy({other.name()}) launched it {got} times (want {want}), the default {default} times")
    print(f"  FixedPolicy({other.name()}): {got} launches of it at its {_programs_built(engine)} programs' warm-ups and "
          f"captures, {default} of the default")
    return {"config": other.name(), "launches": got, "default_launches": default}


def phase_seq_policy(mod, name: str, other, serve: dict) -> dict:
    """One request under ``FixedPolicy(<name>_config=other)`` launches the
    sequence kernel's config ``other`` n_layers times at its prefill program's
    warm-up and again at its capture, and the default config not at all."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    default = getattr(mod, f"DEFAULT_{name.upper()}_CONFIG")
    require(other in mod.config_space() and other != default, f"bad choice of {name} config")
    rt = KernelRuntime(name=f"chip_smoke-{other.name()}")
    rt.install(FixedPolicy(**{f"{name}_config": other}))
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt)
    mod.reset_launches()
    engine.submit(serve["prompts"][0], max_new_tokens=4)
    engine.drain()
    got, n_default = mod.LAUNCHES[other.name()], mod.LAUNCHES[default.name()]
    want = 2 * serve[f"{name}_per_prefill"] * _programs_built(engine, "prefill")
    require(got == want and n_default == 0 and mod.total_launches() == got,
            f"FixedPolicy({name}_config={other.name()}) launched it {got} times (want {want}), the default "
            f"{n_default} times")
    print(f"  FixedPolicy({name}_config={other.name()}): {got} launches of it (one prefill program: its warm-up and "
          f"capture), {n_default} of {default.name()}")
    return {"config": other.name(), "launches": got, "default_launches": n_default}


def phase_hymba_cpu_vs_card(torch) -> dict:
    """Reduced hymba-1.5b at 4 layers (its layer 1 slides a 32-token window),
    served in process on cuda and on cpu from the same weights."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(registry.get("hymba-1.5b").reduced(), n_layers=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (20, 45)]
    streams = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        require(model._layer_kinds() == ["global", "swa", "global", "global"], "no sliding-window layer")
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        rt = KernelRuntime(name=f"chip_smoke-hymba4[{dev}]")
        rt.install(FixedPolicy())
        engine = ServingEngine(model, params, max_batch=2, cache_len=128, runtime=rt)
        ring = engine.pool.specs["['layer1']['k']"]
        require(ring.kind == "lane", f"the 32-token ring should be a lane leaf, got {ring}")
        tickets = [engine.submit(p, max_new_tokens=16) for p in prompts]
        status = engine.drain()
        require(status.completed == 2, f"hymba4 on {dev}: {status}")
        streams[dev] = [list(t.request.output) for t in tickets]
    if streams["cuda"] != streams["cpu"]:
        print(f"  cuda {streams['cuda']}\n  cpu  {streams['cpu']}")
    require(streams["cuda"] == streams["cpu"], "hymba4: greedy token streams differ between cuda and cpu")
    n_tok = sum(map(len, streams["cpu"]))
    print(f"  reduced hymba-1.5b at 4 layers, f32, prompts of 20 and 45 tokens (buckets 32, 64; ring 32): "
          f"cuda and cpu token streams equal ({n_tok} tokens)")
    return {"equal": True, "tokens": n_tok}


def phase_cpu_vs_card(arch: str) -> dict:
    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", arch, "--reduced", "--requests", "4", "--max-new-tokens", "8"]
    card = serve_cli.main(argv + ["--device", "cuda"])
    cpu = serve_cli.main(argv + ["--device", "cpu"])
    if card != cpu:
        _report_divergence(arch, card, cpu)
    require(card == cpu, f"{arch}: greedy token streams differ between cuda and cpu")
    print(f"  reduced {arch} f32: cuda and cpu token streams equal ({sum(map(len, cpu))} tokens)")
    return {"equal": True, "tokens": sum(map(len, cpu))}


def _report_divergence(arch, card, cpu) -> None:
    """Top-2 logit gap at the first token where the streams part."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.model import build_model

    i = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(card[i], cpu[i])) if a != b)
    cfg = registry.get(arch).reduced()
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(len(card), 8))[i]
    seq = torch.as_tensor(np.concatenate([prompt, cpu[i][:j]]))[None]
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device=dev)
        params = model.init(torch.Generator(device="cpu").manual_seed(0))
        logits, _ = model.prefill(params, {"tokens": seq.to(dev)}, 128)
        top = torch.topk(logits[0, -1].float().cpu(), 2)
        print(f"  divergence at request {i} token {j}: {dev} top-2 {top.indices.tolist()} "
              f"gap {(top.values[0] - top.values[1]).item():.3g}")


GEMM_KERNELS = "matmul (gemm_*_kernel)"


def _kernel_name(key: str) -> str:
    """The port's kernels by name (cuBLAS kernels, which the models' plain attention
    reaches through einsum, also hold "gemm_" in theirs)."""
    if any(f"gemm_{path}_kernel" in key for path in ("tma", "bf16", "f32")):
        return GEMM_KERNELS
    for kernel in ("wkv_state_kernel", "wkv_output_kernel", "ssm_state_kernel", "ssm_output_kernel"):
        if kernel in key:
            return f"{kernel.split('_')[0].replace('ssm', 'ssm_scan')} ({kernel})"
    return key[:60]


def _profile_window(torch, fn, runs: int) -> dict:
    """``fn()``, which runs ``runs`` programs in turn, under torch.profiler (device
    activity only): host wall ms (after a synchronize), device ms and kernel count by
    kernel, and from the device's timeline (host copies left out) the ms one program
    run spans on the device, the idle ms inside the runs (the gaps between a run's
    device operations) and between them (the ``runs`` - 1 widest gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = _kernel_name(evt.key)
        ms[name] = ms.get(name, 0.0) + us / 1e3
        count[name] = count.get(name, 0) + evt.count
    busy = sum(ms.values())
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "HtoD" not in e.name and "DtoH" not in e.name)
    timeline = {}
    if spans:
        gaps, end = [], spans[0][1]
        for start, stop in spans[1:]:
            if start > end:
                gaps.append(start - end)
            end = max(end, stop)
        between = sorted(gaps)[len(gaps) - runs + 1:]
        run_us = end - spans[0][0] - sum(between)
        inside = sum(gaps) - sum(between)
        timeline = {"run_ms": run_us / runs / 1e3, "idle_in_runs_ms": inside / 1e3,
                    "idle_share_in_runs": inside / run_us, "between_runs_ms": sum(between) / 1e3,
                    "outside_device_span_ms": wall_ms - (end - spans[0][0]) / 1e3}
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms if busy else None,
            "ms": ms, "count": count, "timeline": timeline}


def phase_profile(torch, serve: dict, engine=None) -> dict:
    """Two windows under torch.profiler on warm programs: two decode steps at width
    4, and one prefill replay at bucket 32 alone. The profiler sees the kernels
    inside a graph replay: every window's GEMM kernels must be per_forward a forward,
    its WKV / SSM kernels n_layers a prefill (0 a decode step). ``engine`` defaults
    to the served (graphed) one."""
    import numpy as np

    engine = engine or serve["engine"]
    prompts, per_forward = serve["prompts"], serve["per_forward"]
    kinds = "graphed" if engine.cuda_graphs else "eager"

    engine.drain()
    for p in prompts:
        engine.submit(p, max_new_tokens=4)
    engine.step()  # 4 prefills + a decode step, outside the window
    decode = _profile_window(torch, lambda: (engine.step(), engine.step()), 2)
    engine.drain()
    prog = engine._prefill_fn(32)
    require(prog.runs > 0, "the bucket-32 prefill program was not warm")
    tokens = np.zeros((1, 32), dtype=np.int64)
    tokens[0, -len(prompts[0]):] = prompts[0]  # left-padded, as the engine stages it
    prog.stage(tokens=tokens)
    prefill = _profile_window(torch, lambda: prog.run(engine.runtime), 1)
    per_prefill = {"wkv": serve.get("wkv_per_prefill", 0), "ssm": serve.get("ssm_per_prefill", 0)}
    for what, window, forwards, prefills in (("2 decode steps", decode, 2, 0), ("1 prefill", prefill, 1, 1)):
        c = window["count"]
        if not c:
            print(f"  {what}: the profiler recorded no device time: not measured")
            continue
        got = c.get(GEMM_KERNELS, 0)
        require(got == per_forward * forwards, f"{kinds} {what}: the profiler saw {got} GEMM kernels, want "
                                               f"{per_forward} x {forwards}")
        for kernel, fam in (("wkv_state_kernel", "wkv"), ("wkv_output_kernel", "wkv"), ("ssm_output_kernel", "ssm")):
            n = c.get(_kernel_name(kernel), 0)
            require(n == per_prefill[fam] * prefills, f"{kinds} {what}: the profiler saw {n} {kernel}, want "
                                                      f"{per_prefill[fam]} x {prefills}")
        top = sorted(window["ms"].items(), key=lambda kv: -kv[1])[:6]
        print(f"  {kinds} {what}: wall {window['wall_ms']:.2f} ms, device busy {window['busy_ms']:.2f} ms, idle share "
              f"{window['idle_share']:.3f}; kernels seen: {got} GEMM (= {per_forward} x {forwards})"
              + "".join(f", {c[_kernel_name(k)]} {k}" for k in ("wkv_state_kernel", "wkv_output_kernel",
                                                               "ssm_state_kernel", "ssm_output_kernel")
                        if c.get(_kernel_name(k))))
        t = window["timeline"]
        print(f"    device timeline: one {'replay' if engine.cuda_graphs else 'eager run'} spans {t['run_ms']:.3f} ms, "
              f"idle inside the runs {t['idle_in_runs_ms']:.3f} ms (share {t['idle_share_in_runs']:.3f}), between "
              f"them {t['between_runs_ms']:.3f} ms, outside the device's span {t['outside_device_span_ms']:.3f} ms")
        for name, ms in top:
            print(f"    {ms:9.3f} ms  {name}")
    d, pf = decode["ms"], prefill["ms"]
    return {"decode": decode, "prefill": prefill, "wall_ms": decode["wall_ms"], "busy_ms": decode["busy_ms"],
            "idle_share": decode["idle_share"], "busy_per_step_ms": decode["busy_ms"] / 2,
            "wkv_state_ms": pf.get("wkv (wkv_state_kernel)", 0.0), "wkv_output_ms": pf.get("wkv (wkv_output_kernel)", 0.0),
            "ssm_state_ms": pf.get("ssm_scan (ssm_state_kernel)", 0.0),
            "ssm_output_ms": pf.get("ssm_scan (ssm_output_kernel)", 0.0),
            "gemm_decode_ms": d.get(GEMM_KERNELS, 0.0)}


def phase_eager(torch, mm, seq: dict, serve: dict, graphed_profile: dict) -> dict:
    """The graphed engine against the eager one (``cuda_graphs=False``, the same
    programs' bodies run op by op) on the same model, weights, policy and requests:
    a captured decode replay equal bitwise to its body run eagerly; memory reserved
    with the graphed engine's programs and after dropping them; then the eager
    engine's same programs, each warmed up once, and a warm drain whose token
    streams must equal the graphed engine's, and its profile; warm numbers side
    by side."""
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels.ops import FixedPolicy
    from repro_torch.serve.engine import ServingEngine

    graphed = serve["engine"]
    prog, pool = graphed._decode_cache[4], graphed.pool
    snap = {k: t.clone() for k, t in pool._store.items()}
    prog.replay()
    replayed = prog.outputs["logits"].clone()
    for k, t in pool._store.items():
        t.copy_(snap[k])
    with graphed.runtime.activate():
        eager_logits = prog.body()["logits"]
    require(torch.equal(replayed, eager_logits), "a captured decode replay differs from its body run eagerly")
    for k, t in pool._store.items():
        t.copy_(snap[k])
    del snap, replayed, eager_logits, prog
    with_graphs = _reserved(torch)
    graphed._prefill_cache.clear()
    graphed._rejit_decode()
    without = _reserved(torch)

    rt = KernelRuntime(name=f"chip_smoke-eager[{serve['arch']}]")
    rt.install(FixedPolicy() if serve["policy"] is None else serve["policy"])
    engine = ServingEngine(serve["model"], serve["params"], max_batch=4, cache_len=256, runtime=rt, cuda_graphs=False)
    require(not engine.cuda_graphs, "cuda_graphs=False took graphs")
    # The programs the graphed engine's drains built, warmed up without a drain of their own.
    for kind, size in sorted({(r["kind"], r["size"]) for r in serve["programs"]}):
        (engine._prefill_fn if kind == "prefill" else engine._decode_fn)(size)
    warm = _drain(torch, engine, serve["prompts"], mm, seq)
    per_forward = serve["per_forward"]
    bad = [(kind, size, n, b) for kind, size, n, _, b, _ in warm["events"] if n != per_forward or b]
    require(not bad, f"warm eager forwards whose GEMM launches are not {per_forward}, or that built a program: {bad}")
    require(warm["outputs"] == serve["outputs"],
            f"{serve['arch']}: the eager engine's token streams differ from the graphed engine's")
    profile = phase_profile(torch, serve, engine)
    eager_reserved = _reserved(torch)
    g, e = serve["warm"], warm
    # The profiler slows the host around every launch and traces every device operation.
    # An estimate without it mixes two drains: the profiled busy time per step over the
    # unprofiled warm median.
    unprofiled = lambda prof, drain: 1 - prof["busy_per_step_ms"] / drain["decode_median_ms"]
    timeline = lambda prof, key: prof["decode"]["timeline"].get(key)
    rows = {
        "decode step ms, median": (g["decode_median_ms"], e["decode_median_ms"]),
        "decode step ms, min": (g["decode_min_ms"], e["decode_min_ms"]),
        "decode step ms, max": (g["decode_max_ms"], e["decode_max_ms"]),
        "idle share, 2 profiled decode steps": (graphed_profile["idle_share"], profile["idle_share"]),
        "device busy ms per decode step (profiled)": (graphed_profile["busy_per_step_ms"],
                                                      profile["busy_per_step_ms"]),
        "idle share inside a step's device span (profiled timeline)": (
            timeline(graphed_profile, "idle_share_in_runs"), timeline(profile, "idle_share_in_runs")),
        "ms between the 2 profiled steps' device spans (timeline)": (
            timeline(graphed_profile, "between_runs_ms"), timeline(profile, "between_runs_ms")),
        "estimate: 1 - profiled busy per step / unprofiled warm median": (unprofiled(graphed_profile, g),
                                                                          unprofiled(profile, e)),
        "tokens/s": (g["tok_per_s"], e["tok_per_s"]),
        "seconds building programs (warm-up, capture)": (serve["capture_s"],
                                                         sum(r.seconds for r in engine.program_log)),
        "memory reserved GB, engine live, after empty_cache": (with_graphs / 1e9, eager_reserved / 1e9),
    }
    print(f"  {serve['arch']}: eager and graphed token streams equal (warm drains); a captured decode "
          f"replay equals its body run eagerly, bitwise")
    print(f"  {'warm, same card, same run':<60} {'graphed':>10} {'eager':>10}")
    for name, (gv, ev) in rows.items():
        fmt = (lambda v: "n/m" if v is None else f"{v:10.3f}")
        print(f"  {name:<60} {fmt(gv):>10} {fmt(ev):>10}")
    print(f"  warm tokens/s, graphed / eager: {g['tok_per_s'] / e['tok_per_s']:.2f}x; decode step median: "
          f"{e['decode_median_ms'] / g['decode_median_ms']:.2f}x shorter; the graphed engine's programs hold "
          f"{(with_graphs - without) / 1e9:.3f} GB reserved ({with_graphs / 1e9:.3f} with them, "
          f"{without / 1e9:.3f} after dropping them)")
    return {"warm": warm, "profile": profile, "side_by_side": rows,
            "memory_reserved": {"with_graphs": with_graphs, "without_graphs": without, "eager": eager_reserved}}


def _reserved(torch) -> int:
    """Bytes the caching allocator holds once its free cached blocks are released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase_ssm_capture_guard(torch, ss) -> dict:
    """A cut selective-scan call on a stream that has no workspace yet raises while a
    CUDA graph is being captured: the workspace is allocated (at its fixed bound)
    only outside a capture, so no graph captures one that could move."""
    g = torch.Generator(device="cuda").manual_seed(14)
    b, s, d, n = 1, 2048, 64, 16
    x, dt, bv, cv = (torch.randn(shape, device="cuda", generator=g)
                     for shape in ((b, s, d), (b, s, d), (b, s, n), (b, s, n)))
    a = -torch.rand((d, n), device="cuda", generator=g)
    segments = ss.launch_segments(b, s, d, n, ss.DEFAULT_SSM_CONFIG, True, 0)
    require(segments > 1, f"(1, {s}, {d}, {n}) is not cut ({segments} segment)")
    from repro_torch.serve.engine import _no_gc

    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    require((0, stream.cuda_stream) not in ss._WORKSPACE, "the fresh stream already holds an ssm workspace")
    err = None
    try:
        with _no_gc(), torch.cuda.graph(graph, stream=stream):
            ss.ssm_cuda_fused(x, dt.abs(), a, bv, cv)
    except RuntimeError as e:
        err = f"{e} / {e.__context__}"
    require(err is not None and "ssm workspace" in err, f"a workspace allocation during a capture did not raise: {err}")
    torch.cuda.synchronize()
    del graph
    print(f"  a cut call ({segments} segments) on a fresh stream under capture raised: {err.split(';')[0]}")
    return {"segments": segments, "raised": err}


def phase_reinstall(torch, mm, serve: dict) -> dict:
    """Install another policy mid-run on the tuned engine's runtime: every program
    is captured again under the new epoch, and its launches take the new policy's
    config."""
    from repro_torch.kernels.ops import FixedPolicy

    engine = serve["engine"]
    rt = engine.runtime
    epoch0 = rt.policy_epoch()
    prompts = serve["prompts"]
    for p in prompts[:2]:
        engine.submit(p, max_new_tokens=6)
    engine.step()
    engine.step()
    n0 = len(engine.program_log)
    mm.reset_launches()
    rt.install(FixedPolicy())
    for p in prompts[2:]:  # their prefills, and the decodes, after the install
        engine.submit(p, max_new_tokens=6)
    status = engine.drain()
    require(status.completed == 4 and not status.exhausted, f"after the install: {status}")
    new = engine.program_log[n0:]
    live = engine.programs()
    require(new and all(r.epoch == epoch0 + 1 and r.captured for r in new), f"programs after the install: {new}")
    require({r.kind for r in new} == {"prefill", "decode"}, f"not every kind of program was captured again: {new}")
    require(all(v["epoch"] == epoch0 + 1 for v in live.values()), f"a live program of an old epoch: {live}")
    got = {name: c for name, c in mm.LAUNCHES.items() if c}
    want = {mm.DEFAULT_CONFIG.name(): 2 * serve["per_forward"] * len(new)}
    require(got == want, f"GEMM launches after the install {got}, want {want}")
    print(f"  installed FixedPolicy() mid-run (epoch {epoch0} -> {epoch0 + 1}): {len(new)} programs captured again "
          f"({', '.join(f'{r.kind} {r.size}' for r in new)}); their GEMM launches {got}")
    return {"epoch": epoch0 + 1, "recaptured": [dataclasses.asdict(r) for r in new], "launches": got}


def _time_ms(fn, n_warm=3, n_runs=20, queued=True) -> float:
    """Median time of one call of ``fn`` between CUDA events, by the tuning
    tables' clock (``core/gpubench.time_ms``: queued behind a device sleep
    unless ``queued`` is false), at the smoke's counts."""
    from repro_torch.core.gpubench import time_ms

    return time_ms(fn, n_warm=n_warm, n_runs=n_runs, queued=queued)


def phase_timing(torch, mm, per_step: dict, kn_list, ms=(4, 128)) -> list[dict]:
    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    for m in ms:
        for k, n in kn_list:
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else torch.bfloat16  # the vocab GEMM emits f32 logits
            a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            b_bytes = k * n * 2
            copies = max(1, -(-150_000_000 // b_bytes))  # rotate weights through > 3x the L2
            bs = [torch.randn(k, n, device="cuda", generator=g).bfloat16() for _ in range(copies)]
            out_bytes = m * n * (4 if out_dtype == torch.float32 else 2)
            flops = 2 * m * k * n
            nbytes = m * k * 2 + b_bytes + out_bytes
            bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            per_cfg = {
                cfg.name(): _time_ms(lambda i, c=cfg: mm.matmul_cuda(a, bs[i % copies], c, out_dtype=out_dtype))
                for cfg in mm.config_space()
            }
            call = _time_ms(lambda i: mm.matmul_cuda(a, bs[i % copies], out_dtype=out_dtype), queued=False)
            plain = _time_ms(lambda i: mm.matmul_plain(a, bs[i % copies], out_dtype))
            library = _time_ms(lambda i: torch.matmul(a, bs[i % copies]).to(out_dtype))
            best = min(per_cfg, key=per_cfg.get)
            row = {
                "m": m, "k": k, "n": n, "out": str(out_dtype).replace("torch.", ""),
                "ms": per_cfg[mm.DEFAULT_CONFIG.name()], "best_config": best, "best_ms": per_cfg[best],
                "call_ms": call, "plain_ms": plain, "library_ms": library, "bound_ms": bound,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
                "launches_per_decode_step": per_step.get(f"{k}x{n}", 0) if m == 4 else None,
                "per_config_ms": per_cfg,
            }
            rows.append(row)
            print(f"  m={m:<4} k={k:<6} n={n:<6} {row['out']:>8}: kernel {row['ms']:.4f} ms "
                  f"(best {best} {per_cfg[best]:.4f}; one call from idle {call:.4f}), bound {bound:.4f} ms "
                  f"({row['bound_by']}), plain {plain:.4f}, torch.matmul {library:.4f}"
                  + (f", {row['launches_per_decode_step']:g} launches/decode step" if m == 4 else ""))
            del bs
    return rows


def phase_tall(torch, mm) -> dict:
    """The harvest's tallest GEMM, (16384, 4096, 14336) bf16, under every config."""
    m, k, n = TALL
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn(m, k, device="cuda", generator=g).bfloat16()
    b = torch.randn(k, n, device="cuda", generator=g).bfloat16()
    flops = 2 * m * k * n
    bound = max(flops / BF16_FLOPS, (m * k + k * n + m * n) * 2 / HBM_BYTES_PER_S) * 1e3
    per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: mm.matmul_cuda(a, b, c), n_runs=5) for cfg in mm.config_space()}
    library = _time_ms(lambda i: torch.matmul(a, b), n_runs=5)
    tflops = {name: flops / ms / 1e9 for name, ms in per_cfg.items()}
    best = min(per_cfg, key=per_cfg.get)
    print(f"  {TALL} bf16: {mm.DEFAULT_CONFIG.name()} {per_cfg[mm.DEFAULT_CONFIG.name()]:.3f} ms "
          f"({tflops[mm.DEFAULT_CONFIG.name()]:.1f} TFLOP/s), best {best} {per_cfg[best]:.3f} ms; bound {bound:.3f} ms "
          f"(operations); torch.matmul {library:.3f} ms ({flops / library / 1e9:.1f} TFLOP/s)")
    print("    " + ", ".join(f"{name} {t:.0f}" for name, t in tflops.items()) + " TFLOP/s")
    return {"shape": list(TALL), "per_config_ms": per_cfg, "tflops": tflops, "bound_ms": bound,
            "library_ms": library, "library_tflops": flops / library / 1e9}


def phase_parent_ab(serves: dict) -> dict | None:
    """The parent's GEMM against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "matmul.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import gemm_ab

    for arch, serve in serves.items():
        counted = {tuple(map(int, kn.split("x"))): c for kn, c in serve["per_decode_step"].items()}
        require(counted == gemm_ab.DECODE_STEP[arch], f"{arch}: decode-step GEMMs {counted} are not "
                                                       f"scripts/gemm_ab.py's {gemm_ab.DECODE_STEP[arch]}")
    result = gemm_ab.run_turns(base)
    gemm_ab.report(result)
    steps = gemm_ab.step_sums(result)
    return result | {"decode_steps": steps}


def phase_attention_parent_ab() -> dict | None:
    """The parent's attention kernel against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "attention.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import attn_ab

    result = attn_ab.run_turns(base)
    attn_ab.report(result)
    return result | {"verdict": attn_ab.verdict(result)}


def phase_ssm_parent_ab() -> dict | None:
    """The parent's selective scan against this one, in turns, where build/parent holds the parent's tree."""
    base = ROOT / "build" / "parent"
    if not (base / "src" / "repro_torch" / "kernels" / "csrc" / "ssm.cu").is_file():
        print("  no build/parent: the parent's kernel is not measured in this run")
        return None
    sys.path.insert(0, str(ROOT / "scripts"))
    import ssm_ab

    result = ssm_ab.run_turns(base)
    ssm_ab.report(result)
    return result


def phase_wkv_timing(torch, wk) -> list[dict]:
    """The WKV kernel at what rwkv6-7b's batch-1 prefill gives it (bf16 r/k/v
    and u, f32 logw, a zero f32 state), every config, beside its bound."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, hd = 1, 64, 64
    for s in (32, 64, 128, WKV_LONG):
        r, k, v, logw, u, _ = _wkv_inputs(torch, g, b, s, h, hd, torch.bfloat16, "dist", False)
        state = torch.zeros((b, h, hd, hd), device="cuda")
        args = (r, k, v, logw, u, state)
        # Each input read once, each output written once.
        nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * h * hd * 4 + b * h * hd * hd * 4
        # The recurrent form's count, the fewest for this function: per token and head,
        # o = r.S (2 hd^2), S = w (.) S + k v^T (3 hd^2), the u-bonus (4 hd).
        ops = b * s * h * (5 * hd * hd + 4 * hd)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: wk.wkv_cuda(*args, config=c))
                   for cfg in wk.config_space()}
        call = _time_ms(lambda i: wk.wkv_cuda(*args), queued=False)
        plain = _time_ms(lambda i: wk.wkv_plain(*args))
        launches = _kernel_launches(lambda: wk.wkv_cuda(*args), ("wkv_state_kernel", "wkv_output_kernel"))
        require(launches is None or set(launches.values()) == {1.0},
                f"one wkv_cuda call should launch the state pass and the output kernel once each: {launches}")
        best = min(per_cfg, key=per_cfg.get)
        row = {"s": s, "shape": [b, s, h, hd], "ms": per_cfg[wk.DEFAULT_WKV_CONFIG.name()], "best_config": best,
               "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain, "bound_ms": bound,
               "bytes": nbytes, "ops": ops,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
               "per_config_ms": per_cfg, "kernel_launches_per_call": launches}
        rows.append(row)
        cfgs = ", ".join(f"{name} {ms:.4f}" for name, ms in per_cfg.items())
        print(f"  (1, {s}, 64, 64) bf16: {cfgs} ms; bound {bound:.4f} ms ({row['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {wk.DEFAULT_WKV_CONFIG.name()} call from idle "
              f"{call:.4f} ms; plain {plain:.4f} ms; kernel launches per call {launches}")
    return rows


def _kernel_launches(fn, names, calls=4) -> dict | None:
    """Device kernels per call of ``fn`` whose names hold one of ``names``, by
    name, over ``calls`` calls (torch.profiler); None where it records none.
    A small torch op opens the window: the profiler may drop its first kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts = {n: sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and n in e.key)
              for n in names}
    return {n: c / calls for n, c in counts.items()} if any(counts.values()) else None


def phase_ssm_timing(torch, ss) -> list[dict]:
    """Both SSM entries at what hymba-1.5b's batch-1 prefill gives them (f32, no
    initial state), S in the served buckets and SSM_LONG, every config, each beside
    its own bound, the plain version, and the kernels one call launches."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(8)
    b, d, n = 1, 1600, 16
    entries = {"fused": (_ssm_fused_inputs, ss.ssm_cuda_fused, ss.ssm_fused_plain),
               "dta": (_ssm_inputs, ss.ssm_cuda, ss.ssm_plain)}
    for s in (32, 64, 128, SSM_LONG):
        for entry, (draw, kernel, plain_fn) in entries.items():
            args = draw(torch, g, b, s, d, n, False)[:-1]
            # Each input read once (no initial state on the served path), y and the final
            # state written once: the fused entry reads x, dt, a, b, c; the dta entry dtx,
            # dta (B, S, d, N), b, c.
            nbytes = sum(t.numel() * t.element_size() for t in args) + b * s * d * 4 + b * d * n * 4
            # Per (t, channel, state): exp, dtx * b, the fma into h, h * c and its sum: 6 f32 operations
            # (the fused entry's dt * x and dt * a add 1 + 1 / N).
            ops = 6 * b * s * d * n
            bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
            per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: kernel(*args, config=c)) for cfg in ss.config_space()}
            call = _time_ms(lambda i: kernel(*args), queued=False)
            plain = _time_ms(lambda i: plain_fn(*args), n_runs=5 if s == SSM_LONG else 20)
            segments = ss.launch_segments(b, s, d, n, ss.DEFAULT_SSM_CONFIG, entry == "fused", 0)
            launches = _kernel_launches(lambda: kernel(*args), ("ssm_state_kernel", "ssm_output_kernel"))
            want = {"ssm_state_kernel": float(segments > 1), "ssm_output_kernel": 1.0}
            require(launches is None or launches == want,
                    f"one {entry} call at S = {s} ({segments} segments) should launch {want}: {launches}")
            best = min(per_cfg, key=per_cfg.get)
            row = {"s": s, "entry": entry, "shape": [b, s, d, n], "ms": per_cfg[ss.DEFAULT_SSM_CONFIG.name()],
                   "best_config": best, "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain,
                   "bound_ms": bound, "bytes": nbytes, "ops": ops,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
                   "segments": segments, "kernel_launches_per_call": launches, "per_config_ms": per_cfg}
            rows.append(row)
            cfgs = ", ".join(f"{name} {ms * 1e3:.2f}" for name, ms in per_cfg.items())
            print(f"  (1, {s}, 1600, 16) f32 {entry}: {cfgs} us; bound {bound * 1e3:.2f} us ({row['bound_by']}: "
                  f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop f32); one {ss.DEFAULT_SSM_CONFIG.name()} call from "
                  f"idle {call * 1e3:.2f} us; plain {plain:.4f} ms; {segments} segments, kernels per call {launches}")
    return rows


def _attention_bound(sq: int, skv: int, d: int, heads: int, causal: bool) -> tuple[float, str]:
    """(least ms, what bounds it) for one bf16 attention call: the larger of
    the useful FLOPs (both products over the visible (row, column) pairs of
    this call's mask) over the bf16 tensor-core peak and the bytes of q, k, v
    and the output (each read or written once) over the memory rate."""
    if causal:  # row i sees min(skv, i + skv - sq + 1) columns; rows below sq - skv see none
        pairs = sum(min(skv, i + skv - sq + 1) for i in range(max(0, sq - skv), sq))
    else:
        pairs = sq * skv
    flops = 4.0 * pairs * d * heads
    nbytes = (2 * sq + 2 * skv) * d * heads * 2
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attn_inputs(torch, g, lead, sq, skv, d, dtype):
    randn = lambda *sh: torch.randn(sh, device="cuda", generator=g, dtype=torch.float32).to(dtype)
    return randn(*lead, sq, d), randn(*lead, skv, d), randn(*lead, skv, d)


def _plain_by_head(at, q, k, v, causal=True):
    """The plain version head by head (its f32 logits of a 32768 x 32768 head
    take 4.3 GB; of all 32 heads at once, 137 GB)."""
    out = q.new_empty(q.shape)
    for h in range(q.shape[1]):
        out[:, h] = at.attention_plain(q[:, h], k[:, h], v[:, h], causal=causal)
    return out


# Phase 16's shapes: (leading dims, sq, skv). (40, 24) and (300, 200) have rows that see nothing
# (at (300, 200) whole query blocks); sq in {1, 4} at skv in {4103, 32768} take the split path; the
# last two are what granite-8b serving would give the kernel.
ATTN_SHAPES = [((2, 3), sq, skv) for sq, skv in ((1, 1), (1, 300), (7, 7), (50, 130), (128, 128), (64, 1000),
                                                  (40, 24), (300, 200), (1, 4103), (4, 4103), (1, 32768),
                                                  (4, 32768))]
ATTN_SHAPES += [((1, 32), 1, 32768), ((1, 32), 4096, 4096)]


def phase_attention_vs_plain(torch, at) -> dict:
    """Every compiled attention config against the plain version, each called twice in a
    row on the same inputs (bitwise equal), on the path its block_q names and split where
    kv_splits says so; then RACE_PASSES more passes over the bf16 shapes with fresh inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)
    worst = {name: {"rel": 0.0, "abs": 0.0} for name in ATTN_TOL}
    checks, splits_seen = 0, {}
    at.reset_launches()
    dtypes = (("bf16", torch.bfloat16), ("f32", torch.float32))
    passes = [(lead, sq, skv, dtypes) for lead, sq, skv in ATTN_SHAPES]
    passes += [(lead, sq, skv, dtypes[:1]) for _ in range(RACE_PASSES) for lead, sq, skv in ATTN_SHAPES]
    for lead, sq, skv, kinds in passes:
        bh = lead[0] * lead[1]
        for d in (64, 128):
            for name, dtype in kinds:
                q, k, v = _attn_inputs(torch, g, lead, sq, skv, d, dtype)
                for causal in (True, False):
                    want = _plain_by_head(at, q, k, v, causal=causal).float()
                    scale = want.abs().max().item()
                    for cfg in at.config_space():
                        paths, launched = dict(at.PATH_LAUNCHES), at.SPLITS_LAUNCHED[cfg.name()]
                        first = at.attention_cuda(q, k, v, cfg, causal=causal)
                        second = at.attention_cuda(q, k, v, cfg, causal=causal)
                        where = f"{cfg.name()} {name} {(*lead, sq, skv, d)} causal={causal}"
                        for got in (first.float(), second.float()):
                            require(bool(torch.isfinite(got).all()), f"{where}: output not finite")
                            if causal and sq > skv:
                                require(bool((got[..., : sq - skv, :] == 0).all()), f"{where}: rows that see "
                                                                                      f"nothing are not zeros")
                            err = (got - want).abs().max().item()
                            require(err <= ATTN_TOL[name] * scale, f"{where}: rel err {err / scale:.3g} > "
                                                                   f"{ATTN_TOL[name]}")
                            w = worst[name]
                            w["rel"], w["abs"] = max(w["rel"], err / scale), max(w["abs"], err)
                            checks += 1
                        require(torch.equal(first, second), f"{where}: two calls in a row differ")
                        path = cfg.bf16_path() if name == "bf16" else "simt_f32"
                        splits = at.launch_splits(bh, sq, skv, d, cfg, causal, 0) if name == "bf16" else 1
                        delta = {p: c - paths[p] for p, c in at.PATH_LAUNCHES.items() if c != paths[p]}
                        launched = at.SPLITS_LAUNCHED[cfg.name()] - launched
                        require(delta == {path: 2, **({"split": 2} if splits > 1 else {})} and
                                launched == (2 * splits if splits > 1 else 0),
                                f"{where}: launches by path {delta}, {launched} splits; want {path}, {splits} splits")
                        if splits > 1:
                            splits_seen[f"{(*lead, sq, skv, d)} causal={causal} {cfg.name()}"] = splits
                del q, k, v
    torch.cuda.synchronize()
    paths = dict(at.PATH_LAUNCHES)
    require(all(paths.values()), f"an attention path was never launched: {paths}")
    # Every wgmma config took the wgmma path at sq >= 64, and every call whose rule splits
    # launched that many splits (checked per call above); the decode shapes did split:
    require(all(any(f"(2, 3, 1, {skv}, {d}) causal={c} {cfg.name()}" in splits_seen for c in (True, False))
                for skv in (4103, 32768) for d in (64, 128) for cfg in at.config_space()),
            f"a decode shape did not split: {sorted(splits_seen)}")
    for name, w in worst.items():
        print(f"  {name}: worst rel err {w['rel']:.3g} (limit {ATTN_TOL[name]}), worst abs err {w['abs']:.3g}")
    print(f"  {checks} checks ({len(ATTN_SHAPES)} shapes x 2 head dims x 2 dtypes x 2 masks x "
          f"{len(at.config_space())} configs x 2 calls, then {RACE_PASSES} bf16 passes with fresh inputs): every "
          f"output finite, both calls bitwise equal; at (40, 24) and (300, 200) causal the rows that see nothing are "
          f"zeros; launches by path {paths}; {len(splits_seen)} (shape, mask, config) triples split KV, "
          f"{min(splits_seen.values())}-{max(splits_seen.values())} splits")
    return {"worst": worst, "checks": checks, "paths": paths, "splits": splits_seen}


def _full_tables(result) -> dict:
    """Per family: {problem: row over the whole config space} of a tune that measured
    every cell (phase 17): matmul's train and test splits, each family's own table."""
    from repro_torch.core.families import get_family

    out = {"matmul": {tuple(p): row for ds in (result.train, result.test) for p, row in zip(ds.problems, ds.perf)}}
    for name, fr in result.family_results.items():
        require(fr.kept == tuple(range(len(get_family(name).config_space()))), f"{name}: not the whole space")
        out[name] = {tuple(p): row for p, row in zip(fr.problems, fr.perf)}
    return out


def _oracle_on(table: dict, configs, family: str) -> float:
    """Oracle fraction of the deployed ``configs`` over a full measured table."""
    import numpy as np

    from repro_torch.core.families import get_family
    from repro_torch.core.selection import achievable_fraction

    space = list(get_family(family).config_space())
    perf = np.stack([table[p] for p in sorted(table)])
    return achievable_fraction(perf, sorted({space.index(c) for c in configs}))


def phase_tune(torch, mm, at, wk, ss) -> dict:
    """The tuning entry point on the card, in process, every family, as a fleet of the
    card and host_cpu: measured tables -> cluster-select -> decision trees ->
    build/bundle_h100.json, and the card's Deployment from the same run ->
    build/deploy_h100.json."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.families import family_names, get_family
    from repro_torch.core.gpubench import card_name
    from repro_torch.launch import tune as tune_cli

    card = card_name()
    mods = {"matmul": mm, "attention": at, "wkv": wk, "ssm_scan": ss}
    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    fleet = tune_cli.main(["--devices", f"{card},host_cpu", "--archs", ",".join(TUNED_ARCHS), "--n-kernels", "4",
                           "--cpu-problems", "8", "--bundle", str(BUNDLE_PATH), "--out", str(DEPLOY_PATH)])
    wall = time.perf_counter() - t0
    launches = {fam: mod.total_launches() for fam, mod in mods.items()}
    require(sorted(fleet.results) == sorted([card, "host_cpu"]), f"fleet tuned {sorted(fleet.results)}")
    result = fleet.results[card]
    dep = result.deployment
    require(DEPLOY_PATH.is_file() and BUNDLE_PATH.is_file(), f"{DEPLOY_PATH} or {BUNDLE_PATH} not written")
    require(Deployment.load(DEPLOY_PATH).to_blob() == dep.to_blob(), "--out is not the fleet's card Deployment")
    require(result.train.source == "measured" and dep.device == card,
            f"not a measured card table: {result.train.source} on {dep.device}")
    lineage, tables, seconds = dep.meta["tuning_lineage"], dep.meta["tables"], dep.meta["measure_seconds"]
    require(set(tables) == set(family_names()) == set(mods), f"families tuned: {sorted(tables)}")
    for fam in tables:
        require(tables[fam][1] == len(get_family(fam).config_space()), f"{fam}: table {tables[fam]} is not the "
                                                                       f"full config space")
        require(lineage[fam]["measured_fraction"] == 1.0, f"{fam}: not every cell measured: {lineage[fam]}")
        require(launches[fam] > 0, f"{fam}: no launches while measuring: {launches}")
    full = _full_tables(result)
    fractions = {"matmul": [result.oracle_fraction, result.classifier_fraction]} | {
        name: [r.oracle_fraction, r.classifier_fraction] for name, r in result.family_results.items()}
    out = {
        "device": dep.device, "wall_s": wall, "tables": tables, "measure_seconds": seconds,
        "deployed": {fam: [c.name() for c in dep.family_tuning(fam).configs] for fam in tables},
        "fractions": fractions,
        "oracle_on_full_table": {fam: _oracle_on(full[fam], dep.family_tuning(fam).configs, fam) for fam in tables},
        "launches_while_measuring": launches, "full": full,
        "fleet": {name: {"oracle": r.oracle_fraction, "classifier": r.classifier_fraction}
                  for name, r in fleet.results.items()},
    }
    print(f"  fleet {sorted(fleet.results)} tuned in {wall:.1f}s; {dep.device}: tables {tables} (problems x configs), "
          f"measured in {seconds} s; launches while measuring {launches}; host_cpu: oracle "
          f"{out['fleet']['host_cpu']['oracle']:.4f} / classifier {out['fleet']['host_cpu']['classifier']:.4f}")
    for fam in tables:
        print(f"  {fam}: oracle {fractions[fam][0]:.4f} / classifier {fractions[fam][1]:.4f} "
              f"(oracle over the whole table {out['oracle_on_full_table'][fam]:.4f}); deployed {out['deployed'][fam]}")
    return out


def phase_staged(torch, mods: dict, tuning: dict) -> dict:
    """The staged bring-up on the card: phase 17's deployment as donor, half of each
    config space pruned on the H100 model, the budget sized from the donor's lineage;
    each family's measured cells against its budget, its seconds against phase 17's, the
    model's error on the measured cells, and the staged deployment's oracle fraction over
    phase 17's full measured table."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.pipeline import resolve_measure_budget
    from repro_torch.launch import tune as tune_cli

    for mod in mods.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    result = tune_cli.main(["--archs", ",".join(TUNED_ARCHS), "--n-kernels", "4", "--transfer-from", str(DEPLOY_PATH),
                            "--prune-ratio", "0.5", "--measure-budget", "auto", "--out", str(STAGED_PATH)])
    wall = time.perf_counter() - t0
    launches = {fam: mod.total_launches() for fam, mod in mods.items()}
    dep, donor = result.deployment, Deployment.load(DEPLOY_PATH)
    lineage, seconds = dep.meta["tuning_lineage"], dep.meta["measure_seconds"]
    rows = {}
    for fam in mods:
        rec = lineage[fam]
        budget = resolve_measure_budget("auto", donor, family=fam)
        require(budget is not None and rec["measured_fraction"] <= budget,
                f"{fam}: measured {rec['measured_fraction']} of the cells, budget {budget}")
        require(rec["source_device"] == donor.device, f"{fam}: donor {rec['source_device']}")
        rows[fam] = {
            "n_measured": rec["n_measured"], "full_cost": rec["full_cost"],
            "measured_fraction": rec["measured_fraction"], "budget": budget, "prune_ratio": rec["prune_ratio"],
            "seconds": seconds[fam], "seconds_phase_17": tuning["measure_seconds"][fam],
            "model_error": rec["model_error"],
            "oracle_on_full_table": _oracle_on(tuning["full"][fam], dep.family_tuning(fam).configs, fam),
            "oracle_on_full_table_phase_17": tuning["oracle_on_full_table"][fam],
            "deployed": [c.name() for c in dep.family_tuning(fam).configs],
            "launches_while_measuring": launches[fam],
        }
        r = rows[fam]
        print(f"  {fam}: measured {r['n_measured']}/{r['full_cost']} cells ({r['measured_fraction']:.3f}, budget "
              f"{budget:.3f}, kept {r['prune_ratio']:.2f} of the space) in {r['seconds']:.2f}s (phase 17: "
              f"{r['seconds_phase_17']:.2f}s); model error {r['model_error']}; oracle over phase 17's full table "
              f"{r['oracle_on_full_table']:.4f} (phase 17's own deployment: {r['oracle_on_full_table_phase_17']:.4f})")
    print(f"  staged tune in {wall:.1f}s (phase 17: {tuning['wall_s']:.1f}s)")
    return {"wall_s": wall, "families": rows}


def _first_layers(tree, n: int):
    """The stacked per-layer weights of a params subtree, cut to the first ``n`` layers."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _bucket_configs(rt, family: str) -> dict:
    """{prefill bucket: config name} of ``family``'s selections in ``rt``'s log."""
    return {problem[0]: cfg.name() for op, problem, cfg in rt.selection_log() if op == family}


def _served_prefill_logits(torch, eng, prompt):
    """The logits of the captured prefill program ``eng`` admits ``prompt`` with:
    its bucket's program (``_prefill_fn``), staged as ``_admit`` stages it (left-
    padded with 0) and replayed."""
    import numpy as np

    from repro_torch.serve.engine import _bucket

    plen = _bucket(len(prompt), eng._ladder)
    tokens = np.zeros((1, plen), dtype=np.int64)
    tokens[0, plen - len(prompt):] = prompt
    prog = eng._prefill_fn(plen)
    require(prog.graph is not None, f"{eng.runtime.name}: prefill {plen} is not a captured program")
    prog.stage(tokens=tokens)
    logits = prog.run(eng.runtime)["logits"].clone()
    require(bool(torch.isfinite(logits).all()), f"{eng.runtime.name}: non-finite prefill logits at {plen}")
    return plen, logits


def phase_fleet_serve(torch, mods: dict, tuning: dict) -> dict:
    """The fleet bundle of phase 17 (the card and host_cpu), loaded into a fresh
    runtime (checksums verified), resolved by detection and by REPRO_DEVICE, then
    rwkv6-7b and hymba-1.5b served from it through launch.serve's --bundle path under
    CUDA graphs, beside the FixedPolicy() engine; a TPU bundle must not install."""
    from repro_torch import load_bundle
    from repro_torch.configs import registry
    from repro_torch.core import devices
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import build_model

    card = tuning["device"]
    bundle = load_bundle(BUNDLE_PATH)
    require(bundle.load_errors == [] and bundle.devices == sorted([card, "host_cpu"]),
            f"bundle {bundle.devices}, load errors {bundle.load_errors}")
    blob = json.loads(BUNDLE_PATH.read_text())
    require(blob["version"] == 6 and blob["checksums"], f"not a v6 bundle with checksums: {blob.get('version')}")
    detected = devices.detect_device(env={})
    a100 = devices.detect_device(env={devices.DEVICE_ENV_VAR: "NVIDIA A100-SXM4-80GB"})
    require(devices.resolve_device(detected, bundle.devices) == card, f"detected {detected} resolves elsewhere")
    # The A100 has no entry and no FALLBACKS chain: the same-platform step picks the card.
    require(a100 not in bundle.devices and not devices.fallback_order(a100) and a100.startswith("gpu_")
            and devices.resolve_device(a100, bundle.devices, strict=True) == card,
            f"REPRO_DEVICE A100 ({a100}) does not resolve to {card} by platform")
    rt = bundle.runtime()
    require(rt.active_device() == card, f"fresh runtime serves {rt.active_device()}")
    try:
        KernelRuntime(name="tpu-fixture").install_bundle(TPU_FIXTURE)
        tpu_err = None
    except ValueError as e:
        tpu_err = str(e)
    require(tpu_err is not None and "compiled space" in tpu_err, "a TPU bundle installed for the card")
    print(f"  bundle of phase 17: {bundle.devices}, v6, {len(blob['checksums'])} checksums verified, "
          f"load_errors []; detected {detected} -> {card}; REPRO_DEVICE A100 -> {a100} -> {card} (same platform); "
          f"TPU fixture refused: {tpu_err[:120]}...")
    card_dep = bundle.deployments[card]
    served = {}
    for arch in SERVED_ARCHS:
        cfg = registry.get(arch)
        per_forward, per_prefill = _expected(cfg)
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        rng = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).numpy() for n in PROMPT_LENGTHS]
        engines = {
            "bundle": serve_cli.build_engine(model, params, bundle=str(BUNDLE_PATH), name=f"bundle[{arch}]",
                                             max_batch=4, cache_len=256),
            "fixed": serve_cli.build_engine(model, params, name=f"fixed[{arch}]", max_batch=4, cache_len=256),
        }
        require(engines["bundle"].device == card and engines["bundle"].cuda_graphs, "bundle engine")
        outs, counts = {}, {}
        for label, eng in engines.items():
            eng.runtime.set_selection_logging(True, cap=1 << 16)
            torch.cuda.synchronize()
            for mod in mods.values():  # the main path: counts to 0 just before, read just after
                mod.reset_launches()
            tickets = [eng.submit(p, max_new_tokens=16) for p in prompts]
            status = eng.drain()
            torch.cuda.synchronize()
            require(status.completed == 4 and all(len(t.request.output) == 16 for t in tickets), f"{label}: {status}")
            require(all(r.captured for r in eng.program_log), f"{label}: a program was not captured")
            outs[label] = [list(t.request.output) for t in tickets]
            counts[label] = {fam: dict(mod.LAUNCHES) for fam, mod in mods.items()}
        seq_fam, seq_mod = ("wkv", "wkv") if cfg.family == "ssm" else ("ssm_scan", "ssm_scan")
        by_bucket = _bucket_configs(engines["bundle"].runtime, seq_fam)
        want = {s: card_dep.select(seq_fam, (s, 64 if seq_fam == "wkv" else cfg.d_model)).name() for s in by_bucket}
        require(by_bucket == want and by_bucket, f"{arch}: served {seq_fam} configs {by_bucket}, the tree names {want}")
        launched = {n: c for n, c in counts["bundle"][seq_mod].items() if c}
        require(set(launched) == set(by_bucket.values()), f"{arch}: launched {launched}, selected {by_bucket}")
        n_prefill = sum(r.kind == "prefill" for r in engines["bundle"].program_log)
        key = "wkv" if seq_fam == "wkv" else "ssm"
        require(sum(launched.values()) == 2 * per_prefill[key] * n_prefill,
                f"{arch}: {seq_fam} launches {launched}, want 2 x {per_prefill[key]} x {n_prefill} prefill programs")
        # Prefill logits of each prompt from each engine's captured prefill program (the
        # one it served the prompt with) against FixedPolicy()'s. Two configs of the WKV /
        # scan kernel sum in other orders, and a deep random-weight model amplifies f32
        # rounding, so the gate is WKV_TOL on engines of the model's first LOGIT_DEPTH
        # layers (the same weights), built through the same build_engine path; the full-
        # depth engines' difference is reported.
        shallow = dataclasses.replace(cfg, n_layers=LOGIT_DEPTH)
        shallow_model = build_model(shallow, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
        shallow_params = dict(params, blocks=_first_layers(params["blocks"], LOGIT_DEPTH))
        gate = {
            "bundle": serve_cli.build_engine(shallow_model, shallow_params, bundle=str(BUNDLE_PATH),
                                             name=f"bundle[{arch}, {LOGIT_DEPTH} layers]", max_batch=4,
                                             cache_len=256),
            "fixed": serve_cli.build_engine(shallow_model, shallow_params, name=f"fixed[{arch}, {LOGIT_DEPTH} layers]",
                                            max_batch=4, cache_len=256),
        }
        gate["bundle"].runtime.set_selection_logging(True, cap=1 << 16)
        rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
        logit_rows = []
        for p in prompts:
            plen, full_b = _served_prefill_logits(torch, engines["bundle"], p)
            _, full_f = _served_prefill_logits(torch, engines["fixed"], p)
            _, gate_b = _served_prefill_logits(torch, gate["bundle"], p)
            _, gate_f = _served_prefill_logits(torch, gate["fixed"], p)
            row = {"bucket": plen, f"first_{LOGIT_DEPTH}_layers": rel(gate_b, gate_f),
                   "full_depth": rel(full_b, full_f)}
            require(row[f"first_{LOGIT_DEPTH}_layers"] <= WKV_TOL,
                    f"{arch}: the bundle engine's captured prefill logits over the first {LOGIT_DEPTH} layers differ "
                    f"from FixedPolicy()'s by {row[f'first_{LOGIT_DEPTH}_layers']:.3g} (rel) > {WKV_TOL}")
            logit_rows.append(row)
            del full_b, full_f, gate_b, gate_f
        gate_by_bucket = _bucket_configs(gate["bundle"].runtime, seq_fam)
        require(gate_by_bucket == {b: by_bucket[b] for b in gate_by_bucket} and gate_by_bucket,
                f"{arch}: the {LOGIT_DEPTH}-layer bundle engine launched {gate_by_bucket}, the served one {by_bucket}")
        del gate, shallow_model, shallow_params
        served[arch] = {
            "device": engines["bundle"].device, f"{seq_fam}_configs_by_bucket": by_bucket,
            "default": (mods[seq_mod].DEFAULT_WKV_CONFIG if seq_fam == "wkv" else mods[seq_mod].DEFAULT_SSM_CONFIG).name(),
            "launches": {label: {fam: sum(c.values()) for fam, c in cnt.items()} for label, cnt in counts.items()},
            "prefill_logits": logit_rows, "streams_equal": outs["bundle"] == outs["fixed"],
            "programs": {label: len(eng.program_log) for label, eng in engines.items()},
        }
        print(f"  {arch} (f32, full width) from the bundle ({engines['bundle'].device}): {seq_fam} configs by prefill "
              f"bucket {by_bucket} (default {served[arch]['default']}), launches {launched}; greedy streams equal "
              f"FixedPolicy()'s: {served[arch]['streams_equal']}")
        for row in logit_rows:
            print(f"    bucket {row['bucket']}: captured prefill logits vs FixedPolicy()'s (rel): first {LOGIT_DEPTH} "
                  f"layers {row[f'first_{LOGIT_DEPTH}_layers']:.3g} (limit {WKV_TOL}); full depth "
                  f"{row['full_depth']:.3g} (reported)")
        del engines, model, params
        gc.collect()
        torch.cuda.empty_cache()
    return {"devices": bundle.devices, "checksums": len(blob["checksums"]),
            "detected": detected, "a100": a100, "tpu_fixture_refused": tpu_err, "served": served}


def phase_quickstart(torch, mm, at, ops) -> dict:
    """The quickstart's path on the card: the tuned Deployment in a fresh
    runtime, ops.attention at every harvested attention problem at (1, 32)
    heads in bf16 and ops.matmul at the quickstart's two shapes, each call
    launching exactly the config the Deployment's tree names."""
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.core.attnmodel import harvest_attn_problems
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import KernelRuntime

    dep = Deployment.load(DEPLOY_PATH)
    rt = KernelRuntime(name="chip_smoke-tuned")
    rt.install(dep)
    rt.set_selection_logging(True)
    problems = harvest_attn_problems(list(TUNED_ARCHS))
    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(12)
    heads = 32
    # The main path: counts to 0 just before, read just after; every call's
    # output is checked afterwards, and the timing launches come after the read.
    torch.cuda.synchronize()
    at.reset_launches()
    mm.reset_launches()
    calls = []
    for sq, skv, d in problems:
        q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
        want_cfg = dep.select_attention(sq, skv, d)
        for _ in range(2):  # the second call is a shape-cache hit
            before, paths = dict(at.LAUNCHES), dict(at.PATH_LAUNCHES)
            splits = at.SPLITS_LAUNCHED[want_cfg.name()]
            with rt.activate():
                got = ops.attention(q, k, v)
            delta = {n: c - before[n] for n, c in at.LAUNCHES.items() if c != before[n]}
            require(delta == {want_cfg.name(): 1}, f"ops.attention at {(sq, skv, d)} launched {delta}, the tree "
                                                   f"names {want_cfg.name()}")
            route = {p: c - paths[p] for p, c in at.PATH_LAUNCHES.items() if c != paths[p]}
            splits = at.SPLITS_LAUNCHED[want_cfg.name()] - splits or 1
            require(sq > 1 or (route.get("split") == 1 and splits > 1),
                    f"decode ops.attention at {(sq, skv, d)} did not split KV: {route}, {splits} splits")
        calls.append(((sq, skv, d), want_cfg, (q, k, v), got, "+".join(sorted(route)), splits))
    mm_calls = []
    for m, k, n in ((512, 784, 512), (1, 4096, 512)):  # the quickstart's two GEMMs
        a = torch.randn((m, k), device="cuda", generator=g).bfloat16()
        b = torch.randn((k, n), device="cuda", generator=g).bfloat16()
        want_cfg = dep.select_matmul(m, k, n, 1)
        before = dict(mm.LAUNCHES)
        with rt.activate():
            got = ops.matmul(a, b)
        delta = {name: c - before[name] for name, c in mm.LAUNCHES.items() if c != before[name]}
        require(delta == {want_cfg.name(): 1}, f"ops.matmul at {(m, k, n)} launched {delta}, the tree names "
                                               f"{want_cfg.name()}")
        mm_calls.append(((m, k, n, 1), want_cfg, a, b, got))
    torch.cuda.synchronize()
    launches = {"attention": dict(at.LAUNCHES), "matmul": dict(mm.LAUNCHES)}
    paths = dict(mm.PATH_LAUNCHES)
    attn_paths, attn_splits = dict(at.PATH_LAUNCHES), sum(at.SPLITS_LAUNCHED.values())
    stats = rt.shape_cache_stats()["per_family"]
    require(stats["attention"]["misses"] == len(problems) and stats["attention"]["hits"] == len(problems),
            f"attention shape cache {stats['attention']}")

    rows, worst = [], {"rel": 0.0, "abs": 0.0}
    while calls:
        (sq, skv, d), cfg, (q, k, v), got, route, splits = calls.pop(0)
        want = _plain_by_head(at, q, k, v).float()
        got = got.float()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL["bf16"] * scale,
                f"ops.attention at {(sq, skv, d)}: rel err {err / scale:.3g} > {ATTN_TOL['bf16']}")
        worst["rel"], worst["abs"] = max(worst["rel"], err / scale), max(worst["abs"], err)
        bound, bound_by = _attention_bound(sq, skv, d, heads, True)
        mask = causal_lower_right(sq, skv)
        row = {"problem": [sq, skv, d], "config": cfg.name(), "path": route, "splits": splits, "rel_err": err / scale,
               "ms": _time_ms(lambda i: at.attention_cuda(q, k, v, cfg), n_runs=10),
               "plain_ms": _time_ms(lambda i: _plain_by_head(at, q, k, v), n_warm=1, n_runs=3),
               "library_ms": _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask), n_runs=10),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        print(f"  {(sq, skv, d)}: {row['config']} (tree) on {route}, {splits} KV split(s), rel err "
              f"{row['rel_err']:.2g}; kernel {row['ms']:.4f} ms, "
              f"bound {bound:.4f} ({bound_by}), plain {row['plain_ms']:.3f}, SDPA {row['library_ms']:.4f}")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    mm_rows = []
    for problem, cfg, a, b, got in mm_calls:
        want = mm.matmul_plain(a, b).float()
        scale = want.abs().max().item()
        err = (got.float() - want).abs().max().item()
        require(err <= TOL[("bf16", "bf16")] * scale, f"ops.matmul at {problem}: rel err {err / scale:.3g}")
        mm_rows.append({"problem": list(problem), "config": cfg.name(), "rel_err": err / scale})
    print(f"  ops.matmul at the quickstart's shapes: {[(r['problem'], r['config']) for r in mm_rows]}")
    print(f"  attention launches {sum(launches['attention'].values())} "
          f"({ {n: c for n, c in launches['attention'].items() if c} }), by path {attn_paths}, {attn_splits} KV splits "
          f"in the split launches; shape cache {stats}")
    return {"rows": rows, "matmul": mm_rows, "worst": worst, "launches": launches, "paths": paths,
            "attention_paths": attn_paths, "attention_splits": attn_splits, "shape_cache": stats}


def phase_attention_timing(torch, at) -> list[dict]:
    """Every config at the served shapes of granite-8b (32 heads of 128) and
    hymba-1.5b (25 heads of 64): causal prefill S in {512, 2048, 4096} and a
    decode step at 4096 and 32768 cached tokens, bf16."""
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention  # the library yardstick: timed only
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for arch, heads, d in (("granite-8b", 32, 128), ("hymba-1.5b", 25, 64)):
        for sq, skv in ((512, 512), (2048, 2048), (4096, 4096), (1, 4096), (1, 32768)):
            q, k, v = _attn_inputs(torch, g, (1, heads), sq, skv, d, torch.bfloat16)
            bound, bound_by = _attention_bound(sq, skv, d, heads, True)
            per_cfg = {cfg.name(): _time_ms(lambda i, c=cfg: at.attention_cuda(q, k, v, c))
                       for cfg in at.config_space()}
            call = _time_ms(lambda i: at.attention_cuda(q, k, v), queued=False)
            plain = _time_ms(lambda i: at.attention_plain(q, k, v), n_runs=5)
            mask = causal_lower_right(sq, skv)
            library = _time_ms(lambda i: sdpa(q, k, v, attn_mask=mask))
            best = min(per_cfg, key=per_cfg.get)
            row = {"arch": arch, "shape": [1, heads, sq, skv, d], "ms": per_cfg[at.DEFAULT_ATTN_CONFIG.name()],
                   "best_config": best, "best_ms": per_cfg[best], "call_ms": call, "plain_ms": plain,
                   "library_ms": library, "bound_ms": bound, "bound_by": bound_by, "per_config_ms": per_cfg}
            rows.append(row)
            print(f"  {arch} (1, {heads}, {sq}, {skv}, {d}): default {row['ms']:.4f} ms, best {best} {per_cfg[best]:.4f}; "
                  f"bound {bound:.4f} ({bound_by}); one call from idle {call:.4f}; plain {plain:.3f}; "
                  f"SDPA {library:.4f}")
            del q, k, v
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _release(torch, serve: dict) -> None:
    for key in ("engine", "model", "params", "prompts"):
        serve.pop(key)
    torch.cuda.empty_cache()


CHAOS = "engine.prefill:compile_error,engine.decode:compile_error:1:5,dispatch.matmul:compile_error"


def _incident_summary(rt) -> dict:
    out: dict[str, int] = {}
    for rec in rt.incidents():
        out[rec["action"]] = out.get(rec["action"], 0) + 1
    return out


def _rebuilt(engine, start: int = 0) -> list:
    """Builds from ``program_log[start:]`` of a (kind, size) built before: programs
    dropped (a retry, a swap, a rollback) and captured again."""
    seen = {(r.kind, r.size) for r in engine.program_log[:start]}
    out = []
    for r in engine.program_log[start:]:
        if (r.kind, r.size) in seen:
            out.append(r)
        seen.add((r.kind, r.size))
    return out


def _tree_pick(dep, family: str, problem: tuple, default, space):
    """The tuned tree's config for ``problem``, else (when the tree serves the
    default there) the first other compiled config: a fault needs a config the
    breaker can redirect from."""
    cfg = dep.select(family, problem)
    if cfg != default:
        return cfg, "tree"
    return next(c for c in space if c != default), "not the tree's (it serves the default here)"


def phase_guard(torch, mods: dict) -> dict:
    """21a: the guard on direct ops calls on the card."""
    from repro_torch.core import faults
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import QUARANTINE_BACKOFF, KernelRuntime
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import FixedPolicy

    mm, wk, ss = mods["matmul"], mods["wkv"], mods["ssm_scan"]
    dep = Deployment.load(DEPLOY_PATH)
    g = torch.Generator(device="cuda").manual_seed(21)
    out: dict = {}
    # The GEMM: the first served decode shape (batch 4) whose tree config is not the default.
    picks = [((1, k, n, 4), dep.select_matmul(1, k, n, 4)) for k, n in GRANITE_KN if (k, n) not in VOCAB_KN]
    problem, cfg = next(((p, c) for p, c in picks if c != mm.DEFAULT_CONFIG), picks[0])
    policy, why = dep, "tree"
    if cfg == mm.DEFAULT_CONFIG:  # the tree serves the default at every decode shape
        cfg = next(c for c in mm.config_space() if c != mm.DEFAULT_CONFIG)
        policy, why = FixedPolicy(matmul_config=cfg), "not the tree's (it serves the default there)"
    _, k, n, _ = problem
    x = torch.randn((4, 1, k), device="cuda", generator=g, dtype=torch.bfloat16)
    w = torch.randn((k, n), device="cuda", generator=g, dtype=torch.bfloat16)
    direct = mm.matmul_cuda(x.reshape(4, k), w, mm.DEFAULT_CONFIG).reshape(4, 1, n)
    rt = KernelRuntime(name="chip_smoke-guard")
    rt.install(policy)
    plan = faults.FaultPlan()
    plan.inject("dispatch.matmul", "compile_error", times=1, match=cfg.name())
    rt.set_fault_plan(plan)
    mm.reset_launches()
    with rt.activate():
        got = ops.matmul(x, w)
        require(torch.equal(got, direct), "the redirected GEMM is not bitwise equal to a direct DEFAULT_CONFIG launch")
        require([i["action"] for i in rt.incidents()] == ["quarantined"], f"incidents {rt.incidents()}")
        require(mm.LAUNCHES[cfg.name()] == 0 and mm.LAUNCHES[mm.DEFAULT_CONFIG.name()] == 1,
                f"launches {dict(mm.LAUNCHES)}")
        states = []
        for _ in range(QUARANTINE_BACKOFF):
            ops.matmul(x, w)
            states.append([e["state"] for e in rt.quarantined()] or ["closed"])
    torch.cuda.synchronize()
    require([i["action"] for i in rt.incidents()] == ["quarantined", "absolved"] and not rt.quarantined(),
            f"breaker did not re-probe and absolve: {rt.incidents()} {rt.quarantined()}")
    require(mm.LAUNCHES[cfg.name()] == 1 and mm.LAUNCHES[mm.DEFAULT_CONFIG.name()] == QUARANTINE_BACKOFF,
            f"after the cycle: {dict(mm.LAUNCHES)}")
    out["matmul"] = {"problem": problem, "config": cfg.name(), "picked_by": why, "redirect": mm.DEFAULT_CONFIG.name(),
                     "bitwise_equal_direct": True, "breaker_states": states, "incidents": _incident_summary(rt)}
    print(f"  ops.matmul at {problem}: dispatch.matmul:compile_error on {cfg.name()} ({why}) -> redirected to "
          f"{mm.DEFAULT_CONFIG.name()}, bitwise equal to a direct launch; quarantined, then {QUARANTINE_BACKOFF} "
          f"calls (states {states}): {QUARANTINE_BACKOFF - 1} redirected, 1 re-probe at {cfg.name()}, absolved")
    # NaN under output validation, on the eager path.
    rt2 = KernelRuntime(name="chip_smoke-nan")
    rt2.install(policy)
    plan2 = faults.FaultPlan()
    plan2.inject("dispatch.matmul", "nan", times=1, match=cfg.name())
    rt2.set_fault_plan(plan2)
    with rt2.activate():
        got = ops.matmul(x, w)
    require(bool(torch.isfinite(got).all()) and torch.equal(got, direct), "the NaN was served")
    require(rt2.incidents()[0]["error"].startswith("NonFiniteOutputError"), f"{rt2.incidents()}")
    out["nan"] = {"contained": True, "incident": rt2.incidents()[0]["error"]}
    print(f"  dispatch.matmul:nan on {cfg.name()}: caught by output validation, redirected, finite and equal")
    # WKV and the scan, at their served prefill shapes.
    r, kk, v = (torch.randn((1, 32, 64, 64), device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(3))
    logw = -torch.rand((1, 32, 64, 64), device="cuda", generator=g) * 4.99 - 1e-3
    u = torch.randn((64, 64), device="cuda", generator=g, dtype=torch.bfloat16)
    xs, dt = (torch.randn((1, 32, 1600), device="cuda", generator=g) for _ in range(2))
    dt = dt.abs() * 0.1
    a = -torch.rand((1600, 16), device="cuda", generator=g) - 0.1
    bs, cs = (torch.randn((1, 32, 16), device="cuda", generator=g) for _ in range(2))
    for fam, mod, default, field, call, direct_fn, prob in (
            ("wkv", wk, wk.DEFAULT_WKV_CONFIG, "wkv_config", lambda: ops.wkv(r, kk, v, logw, u),
             lambda c: wk.wkv_cuda(r, kk, v, logw, u, None, c), (32, 64)),
            ("ssm_scan", ss, ss.DEFAULT_SSM_CONFIG, "ssm_config", lambda: ops.ssm_scan_fused(xs, dt, a, bs, cs),
             lambda c: ss.ssm_cuda_fused(xs, dt, a, bs, cs, None, c), (32, 1600))):
        served, why = _tree_pick(dep, fam, prob, default, mod.config_space())
        rt3 = KernelRuntime(name=f"chip_smoke-{fam}")
        rt3.install(dep if why == "tree" else FixedPolicy(**{field: served}))
        rt3.set_fault_plan(faults.FaultPlan.parse(f"dispatch.{fam}:compile_error"))
        mod.reset_launches()
        with rt3.activate():
            got = call()
        want = direct_fn(default)
        require(all(torch.equal(gt, wt) for gt, wt in zip(got, want)),
                f"{fam}: the redirected call is not bitwise equal to a direct {default.name()} launch")
        require([(i["action"], i["config"]) for i in rt3.incidents()] == [("quarantined", served.name())],
                f"{fam}: {rt3.incidents()}")
        require(mod.LAUNCHES[served.name()] == 0 and mod.LAUNCHES[default.name()] == 2, f"{dict(mod.LAUNCHES)}")
        out[fam] = {"config": served.name(), "picked_by": why, "redirect": default.name(), "bitwise_equal_direct": True}
        print(f"  ops.{'wkv' if fam == 'wkv' else 'ssm_scan_fused'} at {prob}: dispatch.{fam}:compile_error on "
              f"{served.name()} ({why}) -> {default.name()}, bitwise equal to a direct launch")
    # A fault on the default config itself: nothing compiled is left.
    rt4 = KernelRuntime(name="chip_smoke-unrecoverable")
    rt4.install(FixedPolicy())
    rt4.set_fault_plan(faults.FaultPlan.parse("dispatch.matmul:compile_error"))
    try:
        with rt4.activate():
            ops.matmul(x, w)
        raised = None
    except faults.InjectedCompileError as e:
        raised = type(e).__name__
    require(raised and [i["action"] for i in rt4.incidents()] == ["unrecoverable"], f"{raised} {rt4.incidents()}")
    out["unrecoverable"] = {"raised": raised, "incident": "unrecoverable"}
    print(f"  a fault on {mm.DEFAULT_CONFIG.name()} itself: raised {raised}, incident 'unrecoverable'")
    # The guard's host cost per eager call: no plan, and a plan that is armed but never fires.
    never = faults.FaultPlan()
    never.inject("dispatch.matmul", "compile_error", times=None, match="never-a-config")

    def host_us(fn, calls=300, reps=9):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(times)

    rt5 = KernelRuntime(name="chip_smoke-cost")
    rt5.install(policy)
    x2 = x.reshape(4, k)
    with rt5.activate():
        cost = {"direct matmul_cuda": host_us(lambda: mm.matmul_cuda(x2, w, cfg)),
                "ops.matmul, no plan": host_us(lambda: ops.matmul(x, w))}
        rt5.set_output_validation(True)  # what an attached plan turns on: a host sync per call
        cost["ops.matmul, output validation only"] = host_us(lambda: ops.matmul(x, w))
        rt5.set_output_validation(False)
        rt5.set_fault_plan(never)
        cost["ops.matmul, armed plan that never fires (validation on)"] = host_us(lambda: ops.matmul(x, w))
    out["host_us_per_call"] = cost
    out["launches"] = {"matmul": mm.total_launches(), "wkv": wk.total_launches(), "ssm_scan": ss.total_launches()}
    print(f"  host µs per eager call ({problem}, {cfg.name()}, median of 9 x 300 calls): "
          + ", ".join(f"{name} {v:.2f}" for name, v in cost.items()))
    return out


def phase_engine_chaos(torch, mm, seq: dict, tuned: dict) -> dict:
    """21b: phase 19's batch drained under CHAOS on the tuned granite-8b (CUDA graphs)."""
    from repro_torch.core import faults
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    rt = KernelRuntime(name="chip_smoke-chaos")
    rt.install(Deployment.load(DEPLOY_PATH))
    plan = faults.FaultPlan.parse(CHAOS, seed=0)
    rt.set_fault_plan(plan)
    engine = ServingEngine(tuned["model"], tuned["params"], max_batch=4, cache_len=256, runtime=rt)
    mm.reset_launches()
    for mod in seq.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(pr, max_new_tokens=16) for pr in tuned["prompts"]]
    status = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outputs = [list(t.request.output) for t in tickets]
    rebuilt = _rebuilt(engine)
    res = {
        "submitted": len(tickets), "completed": status.completed, "exhausted": status.exhausted,
        "retries": sum(t.request.retries for t in tickets), "incidents": _incident_summary(rt),
        "faults_fired": [(e.site, e.kind, e.key) for e in plan.events],
        "programs_built": len(engine.program_log), "programs_captured_again": [(r.kind, r.size) for r in rebuilt],
        "recapture_s": sum(r.seconds for r in rebuilt), "capture_s": sum(r.seconds for r in engine.program_log),
        "health_events": engine.health_events, "health": status.health, "wall_s": wall,
        "streams_equal_phase_19": outputs == tuned["outputs"],
        "launches": {"matmul": mm.total_launches()} | {_FAMILY[k]: mod.total_launches() for k, mod in seq.items()},
    }
    require(status.completed == len(tickets) and not status.exhausted, f"requests dropped under chaos: {status}")
    require(res["incidents"].get("retry") == 2, f"want 2 engine retries, got {res['incidents']}")
    require(rebuilt, "no program was dropped and captured again")
    require(status.health == "healthy" and engine.health_events and engine.health_events[-1][1] == "healthy",
            f"health did not end healthy: {engine.health_events} / {status.health}")
    require(res["streams_equal_phase_19"], "the greedy streams under chaos differ from phase 19's clean drain")
    print(f"  {CHAOS}: {status.completed}/{len(tickets)} completed, {res['retries']} request retries, incidents "
          f"{res['incidents']}, faults {res['faults_fired']}")
    print(f"  programs captured again: {res['programs_captured_again']} in {res['recapture_s']:.3f}s (all captures "
          f"{res['capture_s']:.3f}s); health {engine.health_events}; streams equal phase 19's: True")
    return res


def phase_retune_on_card(torch, mm, at, seq: dict, tuned: dict) -> dict:
    """21c: on the tuned granite-8b served from phase 17's bundle, an adoption at a
    step boundary, then drift -> retune on measured tables -> canary on the card ->
    hot swap, a rejected candidate, and a rollback."""
    from repro_torch.core import faults, retune
    from repro_torch.core.bundle import DeploymentBundle
    from repro_torch.core.gpubench import build_gpu_dataset
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.serve.engine import ServingEngine

    measured: list[float] = []

    def gpu_table(problems, device):
        ds, sec = build_gpu_dataset("matmul", problems)
        measured.append(sec)
        return ds

    rt = KernelRuntime(name="chip_smoke-retune")
    # Served from phase 17's fleet bundle, as launch.serve --bundle serves: the card's entry.
    engine = ServingEngine(tuned["model"], tuned["params"], max_batch=4, cache_len=256, runtime=rt,
                           bundle=BUNDLE_PATH, retune_min_events=16, retune_dataset_builder=gpu_table)
    dep = engine.deployment
    rt.set_selection_logging(True, cap=1 << 16)
    prompts = tuned["prompts"]
    mm.reset_launches()
    at.reset_launches()
    _drain(torch, engine, prompts, mm, seq)
    before = _drain(torch, engine, prompts, mm, seq)
    # Adoption of phase 17's bundle entry for this card, loaded again (the incumbent's own
    # tune, so the canary passes), at a step boundary.
    offered = DeploymentBundle.load(BUNDLE_PATH).deployments[engine.device]
    built_a = len(engine.program_log)
    engine.submit(prompts[0], max_new_tokens=16)
    engine.step()
    step0 = engine.steps
    engine.offer_deployment(offered)
    engine.drain()
    ev = engine.retune_events[0]
    require(ev.source == "control-plane" and ev.swapped and ev.step == step0 and engine.deployment is offered,
            f"adoption: {ev}; incidents {rt.incidents()[-2:]}")
    adopt_recaptured = [r for r in engine.program_log[built_a:] if r.epoch >= ev.epoch]
    require(adopt_recaptured, "the adoption did not capture the programs again")
    adopt = dataclasses.asdict(ev)
    print(f"  offer_deployment(phase 17's {engine.device} bundle entry): adopted at step {ev.step} (the boundary after "
          f"step {step0 - 1}), epoch {ev.epoch}, canaried {ev.families}; its drain captured "
          f"{[(r.kind, r.size) for r in adopt_recaptured]} again")
    # Drift: the served buckets are not in the harvest; the check runs every 4 steps.
    n_ev = len(engine.retune_events)
    epoch0, built0 = rt.policy_epoch(), len(engine.program_log)
    engine.retune_interval = 4
    during = _drain(torch, engine, prompts, mm, seq)  # the first drift check swaps
    engine.retune_interval = None
    swaps = [e for e in engine.retune_events[n_ev:] if e.swapped]
    require(swaps and swaps[0].families == ("matmul",),
            f"no matmul retune swapped in: {engine.retune_events[n_ev:]}; incidents {rt.incidents()[-2:]}")
    epoch1 = rt.policy_epoch()
    after = _drain(torch, engine, prompts, mm, seq)
    # Every build after the swap captures a program the swap dropped.
    recaptured = [r for r in engine.program_log[built0:] if r.epoch >= epoch1]
    require(recaptured, f"programs not captured again after the swap: {engine.program_log[built0:]}")
    adopt["programs_captured_again"] = [(r.kind, r.size) for r in engine.program_log[built_a:]
                                        if adopt["epoch"] <= r.epoch < epoch1]
    res = {"adopt": adopt, "events": [dataclasses.asdict(e) for e in engine.retune_events[n_ev:]],
           "seconds": engine.retune_seconds,
           "measure_s": measured, "epoch_before": epoch0, "epoch_after": epoch1,
           "programs_captured_again": [(r.kind, r.size) for r in recaptured],
           "recapture_s": sum(r.seconds for r in recaptured),
           "warm_decode_median_ms_before": before["decode_median_ms"],
           "warm_decode_median_ms_after": after["decode_median_ms"],
           "streams_equal_phase_19": [during["outputs"], after["outputs"]] == [tuned["outputs"]] * 2,
           "new_configs": [c.name() for c in engine.deployment.configs]}
    print(f"  retune events: {[(e.step, round(e.drift_score, 4), e.swapped, e.families) for e in engine.retune_events[n_ev:]]}")
    print(f"  swap: epoch {epoch0} -> {epoch1}; seconds {engine.retune_seconds} (gpubench tables {measured}); "
          f"{len(recaptured)} programs captured again (this drain and the next) in {res['recapture_s']:.3f}s; "
          f"deployed {res['new_configs']}")
    print(f"  warm decode median {before['decode_median_ms']:.3f} ms before, {after['decode_median_ms']:.3f} after; "
          f"zero drops; streams equal phase 19's: {res['streams_equal_phase_19']}")
    # The canary's attention probe on the card (granite-8b's traffic calls no ops.attention).
    ok, why = retune._numeric_agreement("attention", dep.select_attention(1, 4096, 128), rt, device="cuda")
    require(ok, f"attention canary probe: {why}")
    # A NaN-poisoned candidate: rejected, never installed.
    incumbent = engine.deployment
    rt.set_fault_plan(faults.FaultPlan.parse("canary.matmul:nan:-1"))
    ev = engine.maybe_retune(force=True)
    rt.set_fault_plan(None)
    require(ev is not None and not ev.swapped and "matmul" in ev.rejected and rt.policy() is incumbent,
            f"a NaN-poisoned candidate was not rejected: {ev}")
    res["rejected"] = dataclasses.asdict(ev) | {"reason": rt.incidents()[-1]["error"]}
    print(f"  canary.matmul:nan candidate: rejected {ev.rejected} ({res['rejected']['reason']}), incumbent kept "
          f"(epoch {rt.policy_epoch()})")
    # A forced swap (its canary off: the H100 model may score a second retune of the same
    # traffic below the first), then rollback_threshold injected incidents roll it back.
    engine.canary = False
    ev = engine.maybe_retune(force=True)
    engine.canary = True
    require(ev is not None and ev.swapped, f"forced retune did not swap: {ev}")
    epoch2, built2 = rt.policy_epoch(), len(engine.program_log)
    rt.set_fault_plan(faults.FaultPlan.parse(f"engine.decode:oom:{engine.rollback_threshold}"))
    tickets = [engine.submit(pr, max_new_tokens=16) for pr in prompts]
    status = engine.drain()
    rt.set_fault_plan(None)
    rolled = [e for e in engine.retune_events if e.rolled_back]
    require(len(rolled) == 1 and engine.deployment is incumbent and status.completed == len(tickets),
            f"no rollback: {engine.retune_events[-2:]} {status}")
    rb_recaptured = _rebuilt(engine, built2)
    require(rt.policy_epoch() > epoch2 and rb_recaptured, "the rollback did not move the epoch and capture again")
    res["rollback"] = {"event": dataclasses.asdict(rolled[0]), "epoch": [epoch2, rt.policy_epoch()],
                       "programs_captured_again": [(r.kind, r.size) for r in rb_recaptured],
                       "streams_equal_phase_19": [list(t.request.output) for t in tickets] == tuned["outputs"]}
    print(f"  forced swap (canary off) then {engine.rollback_threshold} injected engine.decode faults: rolled back at step "
          f"{rolled[0].step}, epoch {epoch2} -> {rt.policy_epoch()}, {len(rb_recaptured)} programs captured again; "
          f"{status.completed}/{len(tickets)} completed")
    res["launches"] = {"matmul": mm.total_launches(), "attention": at.total_launches()}
    return res


def phase_online(torch, mm, rows: list) -> dict:
    """21d: OnlinePolicy with the CUDA-event measurer on direct ops.matmul calls at
    granite-8b's served decode shapes."""
    from repro_torch.core.dispatch import Deployment
    from repro_torch.core.online import OnlinePolicy, cuda_event_measure, shape_bucket
    from repro_torch.core.runtime import KernelRuntime
    from repro_torch.kernels import ops

    pol = OnlinePolicy(cuda_event_measure(), mm.config_space(), prior=Deployment.load(DEPLOY_PATH))
    rt = KernelRuntime(name="chip_smoke-online")
    rt.install(pol)
    g = torch.Generator(device="cuda").manual_seed(4)
    mm.reset_launches()
    shapes = [(k, n) for k, n in GRANITE_KN]
    with rt.activate():
        for k, n in shapes:
            x = torch.randn((4, 1, k), device="cuda", generator=g, dtype=torch.bfloat16)
            w = torch.randn((k, n), device="cuda", generator=g, dtype=torch.bfloat16)
            out_dtype = torch.float32 if (k, n) in VOCAB_KN else None
            for _ in range(len(mm.config_space()) + 1):
                ops.matmul(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    committed = {str(b): c.name() for b, c in pol.committed().items()}
    best = {shape_bucket((1, r["k"], r["n"], 4)): r["best_config"] for r in rows if r["m"] == 4}
    agree = sum(pol.committed().get(b) is not None and pol.committed()[b].name() == name for b, name in best.items())
    require(len(committed) == len(shapes), f"not every shape committed: {committed}")
    res = {"warmup_cost_s": pol.warmup_cost(), "committed": committed, "stats": dict(pol.stats),
           "phase_7_best": {str(b): c for b, c in best.items()}, "commits_equal_phase_7_best": agree,
           "launches": {"matmul": mm.total_launches()}}
    print(f"  warm-up cost {pol.warmup_cost() * 1e3:.3f} ms over {pol.stats['explore']} measured arms; commits "
          f"{committed}; {agree} of {len(best)} equal phase 7's per-shape best")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as at
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm as ss
    from repro_torch.kernels import wkv as wk

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        print(f"{title} (at {time.perf_counter() - t_start:.1f}s)")

    # Python's cyclic collector must never run during a capture: it may free a dead
    # engine's graphs, which invalidates the capture (the engine holds it off).
    collected_in_capture: list[int] = []

    def watch_gc(stage: str, info: dict) -> None:
        if stage == "start" and torch.cuda.is_current_stream_capturing():
            collected_in_capture.append(info["generation"])

    gc.callbacks.append(watch_gc)

    phase("[1] card")
    card = card_line()
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase("[2] build")
    t0 = time.perf_counter()
    _build.load_all(["matmul", "wkv", "ssm", "attention"])
    tiles, wkv_cfgs, ssm_cfgs = mm.compiled_tiles(), wk.compiled_configs(), ss.compiled_configs()
    attn_cfgs = at.compiled_configs()
    print(f"  matmul.cu, wkv.cu, ssm.cu and attention.cu -> sm_90a in {time.perf_counter() - t0:.1f}s (nvcc in "
          f"parallel: {', '.join(f'{k} {v:.1f}s' for k, v in _build.build_seconds.items())})")
    print(f"  matmul tiles (bm, bn, bk, smem bf16, smem f32): {tiles}")
    print(f"  wkv instantiations (chunk, hd, smem): {wkv_cfgs}")
    print(f"  ssm instantiations (block_d, chunk, N, threads): {ssm_cfgs}")
    print(f"  attention instantiations (block_q, block_kv, hd, bf16 threads, stages, smem, f32 threads, smem): "
          f"{attn_cfgs}")
    resident = {c.name(): [at.resident_ctas(c, hd, 0) for hd in (64, 128)] for c in at.config_space()}
    print(f"  attention bf16 CTAs an SM holds (hd 64, 128): {resident}")
    for name in ("matmul", "wkv", "ssm", "attention"):
        log = _build.build_log(name).splitlines()
        regs = [line.split(":", 1)[1].strip() for line in log if "registers" in line]
        spills = sorted({line.strip() for line in log if "spill" in line and "0 bytes spill" not in line})
        print(f"  ptxas {name}: {len(regs)} kernels; {sorted(set(regs))}; spills {spills or 'none'}")

    phase("[3] GEMM against plain")
    errors = phase_kernel_vs_plain(torch, mm)
    phase("[3b] WKV against plain")
    wkv_errors = phase_wkv_vs_plain(torch, wk)
    phase("[3c] SSM against plain")
    ssm_errors = phase_ssm_vs_plain(torch, ss)
    seq = {"wkv": wk, "ssm": ss}

    phase("[4] full-width granite-8b serving")
    serve = phase_serve(torch, mm, seq, "granite-8b")
    phase("[5] selection reaches the kernel")
    policy = phase_policy(mm, serve)
    phase("[5b] where a granite-8b decode step's and prefill's time goes (warm replays)")
    profile = phase_profile(torch, serve)
    phase("[5c] granite-8b: the eager engine against the graphed one")
    eager = {"granite-8b": phase_eager(torch, mm, seq, serve, profile)}
    _release(torch, serve)  # granite's weights go before rwkv6-7b's load

    phase("[6] cpu against card, granite-8b")
    parity = phase_cpu_vs_card("granite-8b")

    phase("[7] GEMM timing, granite-8b shapes (bf16, DEFAULT_CONFIG = the config served)")
    rows = phase_timing(torch, mm, serve["per_decode_step"], GRANITE_KN)
    tall = phase_tall(torch, mm)

    phase("[8] full-width rwkv6-7b serving")
    rwkv = phase_serve(torch, mm, seq, "rwkv6-7b")
    phase("[9] selection reaches the WKV kernel")
    wkv_policy = phase_seq_policy(wk, "wkv", wk.WkvConfig(64), rwkv)
    phase("[9b] where an rwkv6-7b decode step's and prefill's time goes (warm replays)")
    rwkv_profile = phase_profile(torch, rwkv)
    phase("[9c] rwkv6-7b: the eager engine against the graphed one")
    eager["rwkv6-7b"] = phase_eager(torch, mm, seq, rwkv, rwkv_profile)
    _release(torch, rwkv)

    phase("[10] cpu against card, rwkv6-7b")
    rwkv_parity = phase_cpu_vs_card("rwkv6-7b")

    phase("[11] WKV timing (DEFAULT_WKV_CONFIG = the config served), GEMM timing at rwkv6-7b decode shapes")
    wkv_rows = phase_wkv_timing(torch, wk)
    rwkv_rows = phase_timing(torch, mm, rwkv["per_decode_step"], RWKV_KN, ms=(4,))

    phase("[12] full-width hymba-1.5b serving")
    hymba = phase_serve(torch, mm, seq, "hymba-1.5b")
    want = {"fused": sum(hymba["ssm_launches"].values()), "dta": 0}
    require(hymba["ssm_entry_launches"] == want and want["fused"] > 0,
            f"hymba-1.5b prefills should reach the SSM only through ssm_cuda_fused: {hymba['ssm_entry_launches']}")
    print(f"  SSM launches by entry: {hymba['ssm_entry_launches']} (ssm_cuda_fused only)")
    phase("[13] selection reaches the SSM kernel")
    ssm_policy = phase_seq_policy(ss, "ssm", ss.SsmConfig(8, 16), hymba)
    phase("[13b] where a hymba-1.5b decode step's and prefill's time goes (warm replays)")
    hymba_profile = phase_profile(torch, hymba)
    phase("[13c] hymba-1.5b: the eager engine against the graphed one; the SSM workspace under capture")
    eager["hymba-1.5b"] = phase_eager(torch, mm, seq, hymba, hymba_profile)
    ssm_guard = phase_ssm_capture_guard(torch, ss)
    _release(torch, hymba)

    phase("[14] cpu against card, hymba-1.5b at 4 layers")
    hymba_parity = phase_hymba_cpu_vs_card(torch)

    phase("[15] SSM timing (DEFAULT_SSM_CONFIG = the config served), GEMM timing at hymba-1.5b decode shapes")
    ssm_rows = phase_ssm_timing(torch, ss)
    hymba_rows = phase_timing(torch, mm, hymba["per_decode_step"], HYMBA_KN, ms=(4,))

    phase("[16] attention against plain")
    attn_errors = phase_attention_vs_plain(torch, at)
    phase("[17] tune on the card, every family: measured tables -> cluster-select -> decision trees -> Deployment")
    tuning = phase_tune(torch, mm, at, wk, ss)
    mods = {"matmul": mm, "attention": at, "wkv": wk, "ssm_scan": ss}
    phase("[17b] the staged bring-up: phase 17's deployment as donor, pruned, measured within the auto budget")
    staged = phase_staged(torch, mods, tuning)
    phase("[17c] the fleet bundle (card + host_cpu), installed and served: rwkv6-7b and hymba-1.5b from the bundle")
    fleet = phase_fleet_serve(torch, mods, tuning)
    phase("[18] the quickstart's path: the tuned Deployment in a fresh runtime, ops.attention and ops.matmul")
    quick = phase_quickstart(torch, mm, at, ops)
    phase("[19] full-width granite-8b served under the tuned Deployment")
    from repro_torch.core.dispatch import Deployment

    tuned = phase_serve(torch, mm, seq, "granite-8b", policy=Deployment.load(DEPLOY_PATH))
    phase("[19b] where a tuned granite-8b decode step's and prefill's time goes (warm replays)")
    tuned_profile = phase_profile(torch, tuned)
    phase("[19c] another policy installed mid-run: the programs are captured again")
    reinstall = phase_reinstall(torch, mm, tuned)
    phase("[21a] guarded dispatch on the card: redirect, quarantine, re-probe, absolve; NaN; unrecoverable; cost")
    guard = phase_guard(torch, mods)
    phase("[21b] engine chaos: phase 19's batch under " + CHAOS)
    chaos = phase_engine_chaos(torch, mm, seq, tuned)
    phase("[21c] retune on the card: drift -> measured retune -> canary -> hot swap; rejection; rollback; adoption")
    retuned = phase_retune_on_card(torch, mm, at, seq, tuned)
    phase("[21d] OnlinePolicy on the card: CUDA-event arms at granite-8b's decode shapes")
    online = phase_online(torch, mm, rows)
    _release(torch, tuned)
    # One granite decode step's GEMMs at m=4: sum of count x time over the shapes it launches,
    # under the default config, each shape's best compiled config, and the tree's choices.
    step = [r for r in rows if r["m"] == 4]
    total = lambda key: sum(r[key] * r["launches_per_decode_step"] for r in step)
    tree_cfg = dict(tuned["decode_configs"])
    require(len(tree_cfg) == len(tuned["decode_configs"]), f"one (k, n) decode GEMM selected two configs: "
                                                            f"{tuned['decode_configs']}")
    tuned_step_ms = sum(r["per_config_ms"][tree_cfg[f"{r['k']}x{r['n']}"]] * r["launches_per_decode_step"]
                        for r in step)
    tuned["gemm_step_ms"] = {"default": total("ms"), "best_per_shape": total("best_ms"), "tree": tuned_step_ms,
                             "bound": total("bound_ms")}
    tuned["streams_equal_phase_4"] = tuned["outputs"] == serve["outputs"]
    split = {name: n for name, n in tuned["launches"].items() if n}
    print(f"  GEMM launches by config: {split}; decode-step GEMM configs {tree_cfg}")
    print(f"  one decode step's GEMMs (CUDA-event device time from phase 7, summed over shapes): tree "
          f"{tuned_step_ms:.2f} ms, default {total('ms'):.2f}, best per shape {total('best_ms'):.2f}, "
          f"bound {total('bound_ms'):.2f}; greedy streams equal phase 4's: {tuned['streams_equal_phase_4']}")
    phase("[20] attention timing at the served shapes")
    attn_rows = phase_attention_timing(torch, at)
    phase("[20b] GEMM: the parent's kernel against this one, in turns")
    parent_ab = phase_parent_ab({"granite-8b": serve, "rwkv6-7b": rwkv, "hymba-1.5b": hymba})
    phase("[20c] attention: the parent's kernel against this one, in turns")
    attn_parent_ab = phase_attention_parent_ab()
    phase("[20d] selective scan: the parent's kernel against this one, in turns")
    ssm_parent_ab = phase_ssm_parent_ab()
    # The rwkv6-7b run's WKV launches: n_layers per prefill, at each prefill's bucket.
    by_s = {r["s"]: r for r in wkv_rows}
    wkv_total = lambda key: rwkv["wkv_per_prefill"] * sum(by_s[s][key] for s in rwkv["prefill_buckets"])
    # The hymba-1.5b run's SSM launches: n_layers per prefill, at each prefill's bucket, through the
    # fused entry (the dta entry's time over the same launches beside it).
    ssm_by = {(r["s"], r["entry"]): r for r in ssm_rows}
    ssm_total = lambda key, entry="fused": hymba["ssm_per_prefill"] * sum(ssm_by[s, entry][key]
                                                                         for s in hymba["prefill_buckets"])
    gemm_launches = {run["arch"]: sum(run["launches"].values()) for run in (serve, rwkv, hymba)}
    gemm_launches["granite-8b (tuned)"] = sum(tuned["launches"].values())
    gemm_launches["quickstart"] = sum(quick["launches"]["matmul"].values())
    # Every family's launches on the tuning paths: the tables measured in phases 17 and 17b,
    # and the bundle's serving of rwkv6-7b and hymba-1.5b in 17c.
    tune_launches = {fam: {"tables, phase 17": tuning["launches_while_measuring"][fam],
                           "tables, phase 17b (staged)": staged["families"][fam]["launches_while_measuring"]} | {
        f"{arch} from the bundle (17c)": run["launches"]["bundle"][fam] for arch, run in fleet["served"].items()}
        for fam in ("matmul", "attention", "wkv", "ssm_scan")}
    # Phase 21's paths: the guard's direct calls, the chaos drain's builds, the retune's
    # gpubench tables and on-card canary probes, the OnlinePolicy's measured arms.
    resilience = {"guard (21a)": guard["launches"], "engine chaos (21b)": chaos["launches"],
                  "retune: tables, canary probes, captures (21c)": retuned["launches"],
                  "OnlinePolicy arms and calls (21d)": online["launches"]}
    for fam, paths in tune_launches.items():
        paths.update({path: counts[fam] for path, counts in resilience.items() if counts.get(fam)})
    gemm_launches.update(tune_launches["matmul"])
    gemm_routes = {path: sum(run["path_launches"][path] for run in (serve, rwkv, hymba, tuned))
                   + quick["paths"][path] for path in ("tma", "cp_async")}
    kernels = {"kernels": [{
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:120",
        "launches": sum(gemm_launches.values()),
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {run["arch"] + (" (tuned)" if run is tuned else ""): {
            "2 decode replays": prof["decode"]["count"].get(GEMM_KERNELS, 0),
            "1 prefill replay": prof["prefill"]["count"].get(GEMM_KERNELS, 0)}
            for run, prof in ((serve, profile), (rwkv, rwkv_profile), (hymba, hymba_profile), (tuned, tuned_profile))},
        "program_replays": {run["arch"] + (" (tuned)" if run is tuned else ""): run["program_replays"]
                            for run in (serve, rwkv, hymba, tuned)},
        "launches_by_path": gemm_launches,
        "launches_by_route": gemm_routes,
        "max_abs_err": max(errors[pair]["abs"] for pair in GEMM_PAIRS),
        "max_rel_err": max(errors[pair]["rel"] for pair in GEMM_PAIRS),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes",
        "library_ms": total("library_ms"),
        "timed_as": "all GEMMs of one granite-8b decode step (batch 4), summed over shapes, DEFAULT_CONFIG",
        "tuned_ms": tuned_step_ms,
        "best_per_shape_ms": total("best_ms"),
        "tall_tflops": tall["tflops"][mm.DEFAULT_CONFIG.name()],
    }, {
        "name": "wkv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/wkv.py:114",
        "launches": sum(rwkv["wkv_launches"].values()) + sum(tune_launches["wkv"].values()),
        "launches_by_path": {"rwkv6-7b (phase 8)": sum(rwkv["wkv_launches"].values())} | tune_launches["wkv"],
        "served_configs_from_bundle": fleet["served"]["rwkv6-7b"]["wkv_configs_by_bucket"],
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {f"1 prefill replay, {k}": rwkv_profile["prefill"]["count"].get(
            _kernel_name(k), 0) for k in ("wkv_state_kernel", "wkv_output_kernel")},
        "program_replays": rwkv["program_replays"],
        "max_abs_err": wkv_errors["abs"],
        "max_rel_err": wkv_errors["rel"],
        "ms": wkv_total("ms"),
        "plain_ms": wkv_total("plain_ms"),
        "bound_ms": wkv_total("bound_ms"),
        "bound_by": ("bytes" if all(by_s[s]["bound_by"] == "bytes" for s in rwkv["prefill_buckets"])
                     else "operations"),
        "library_ms": None,
        "library_note": "no single PyTorch call computes the chunked WKV recurrence",
        "design": "a chunk-parallel pair per call: wkv_state_kernel carries the state over the chunk boundaries "
                  "into a workspace (producer warps load and prepare k^, consumer warps update), then "
                  "wkv_output_kernel computes every chunk's output at once",
        "kernel_launches_per_call": by_s[min(by_s)]["kernel_launches_per_call"],
        "timed_as": f"all WKV launches of the rwkv6-7b run's prefills (buckets {rwkv['prefill_buckets']}, "
                    f"{rwkv['wkv_per_prefill']} each), summed from per-length medians",
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm.cu",
        "replaces": "src/repro/kernels/ssm.py:90",
        "launches": sum(hymba["ssm_launches"].values()) + sum(tune_launches["ssm_scan"].values()),
        "launches_by_path": {"hymba-1.5b (phase 12)": sum(hymba["ssm_launches"].values())} | tune_launches["ssm_scan"],
        "served_configs_from_bundle": fleet["served"]["hymba-1.5b"]["ssm_scan_configs_by_bucket"],
        "launches_counted_as": LAUNCHES_COUNTED_AS,
        "kernels_in_profiled_replays": {f"1 prefill replay, {k}": hymba_profile["prefill"]["count"].get(
            _kernel_name(k), 0) for k in ("ssm_state_kernel", "ssm_output_kernel")},
        "program_replays": hymba["program_replays"],
        "launches_by_entry": hymba["ssm_entry_launches"],
        "max_abs_err": ssm_errors["abs"],
        "max_rel_err": ssm_errors["rel"],
        "ms": ssm_total("ms"),
        "plain_ms": ssm_total("plain_ms"),
        "bound_ms": ssm_total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in ssm_rows) else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the selective scan",
        "dta_entry_ms": ssm_total("ms", "dta"),
        "dta_entry_bound_ms": ssm_total("bound_ms", "dta"),
        "dta_entry_plain_ms": ssm_total("plain_ms", "dta"),
        "design": "per CTA block_d channels of 4 threads (N / 4 states each), a ring of cp.async stages on "
                  "mbarriers, dt * x and dt * a formed in registers (fused entry); where the grid is under one "
                  "wave the sequence is cut into segments: ssm_state_kernel (each segment's end state and decay "
                  "product) then ssm_output_kernel (the earlier segments folded in order, then y)",
        "timed_as": f"all SSM launches of the hymba-1.5b run's prefills (buckets {hymba['prefill_buckets']}, "
                    f"{hymba['ssm_per_prefill']} each, all through the fused entry), summed from per-length "
                    f"medians; dta_entry_*: the dta entry over the same launches",
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention.py:98",
        "launches": sum(quick["launches"]["attention"].values()) + sum(tune_launches["attention"].values()),
        "launches_by_path": {"quickstart (phase 18)": sum(quick["launches"]["attention"].values())} | tune_launches[
            "attention"],
        "launches_by_kernel_path": quick["attention_paths"],
        "kv_splits_launched": quick["attention_splits"],
        "max_abs_err": max([w["abs"] for w in attn_errors["worst"].values()] + [quick["worst"]["abs"]]),
        "max_rel_err": max([w["rel"] for w in attn_errors["worst"].values()] + [quick["worst"]["rel"]]),
        "ms": sum(r["ms"] for r in quick["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in quick["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in quick["rows"]),
        "bound_by": max(("operations", "bytes"), key=lambda b: sum(r["bound_ms"] for r in quick["rows"]
                                                                    if r["bound_by"] == b)),
        "library_ms": sum(r["library_ms"] for r in quick["rows"]),
        "library_note": "scaled_dot_product_attention with causal_lower_right (a yardstick only)",
        "timed_as": f"phase 18's ops.attention calls: one per harvested attention problem of {', '.join(TUNED_ARCHS)} "
                    f"({len(quick['rows'])}) at (1, 32) heads, bf16, causal, under the tree's config, summed "
                    f"(the run made each call twice, the second a shape-cache hit)",
    }]}
    gc.callbacks.remove(watch_gc)
    require(not collected_in_capture, f"Python collections ran during a capture: generations {collected_in_capture}")
    print("  no Python collection ran during a CUDA graph capture")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": _build.build_seconds, "errors": errors, "wkv_errors": wkv_errors,
        "serve": serve, "policy": policy, "profile": profile, "cpu_vs_card": parity, "timing": rows, "tall": tall,
        "parent_ab": parent_ab, "attention_parent_ab": attn_parent_ab, "ssm_parent_ab": ssm_parent_ab,
        "rwkv_serve": rwkv, "wkv_policy": wkv_policy, "rwkv_profile": rwkv_profile,
        "rwkv_cpu_vs_card": rwkv_parity, "wkv_timing": wkv_rows, "rwkv_timing": rwkv_rows,
        "ssm_errors": ssm_errors, "hymba_serve": hymba, "ssm_policy": ssm_policy, "hymba_profile": hymba_profile,
        "hymba_cpu_vs_card": hymba_parity, "ssm_timing": ssm_rows, "hymba_timing": hymba_rows,
        "attention_errors": attn_errors, "tuning": {k: v for k, v in tuning.items() if k != "full"},
        "staged": staged, "fleet": fleet, "quickstart": quick, "tuned_serve": tuned,
        "tuned_profile": tuned_profile, "eager_vs_graphed": eager, "ssm_capture_guard": ssm_guard,
        "reinstall": reinstall,
        "guard": guard, "engine_chaos": chaos, "retune_on_card": retuned, "online": online,
        "attention_timing": attn_rows,
        "kernels": kernels["kernels"], "seconds": time.perf_counter() - t_start,
    }, indent=1, default=str))
    print(f"[22] done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
