"""Measured H100 benchmark tables: the card's own data for the tuning pipeline.

The counterpart of ``repro/core/cpubench.py``: the paper's claim is that
tuning needs nothing but benchmark data, so the port's tables are timed on
the card with the port's own kernels, never taken from a model (the H100
model, ``core/perfmodel.py``, only fills the cells a staged tune chose not
to measure).  Every config of a family's compiled space is timed on every
problem, in the dtypes the served path passes the kernel, with CUDA events (:func:`time_ms`, the clock ``chip_smoke.py`` times with too);
each timed call is queued behind a device sleep, so that the events hold the
device's time and not the host's launch work.  The loop is adaptive: at
least 2 timed runs, more until about 20 ms of device time (at most 10), and
the median is kept.  A table holds GFLOP/s.

  * **matmul**: ``ops.matmul`` runs a problem ``(m, k, n, batch)`` as one
    ``(m * batch, k, n)`` GEMM, so the table times that GEMM, with its rate
    2 (m batch) k n / t, up to ``FOLD_ROWS`` rows: a decode problem ``(1, k,
    n, 128)`` is timed as the 128-row GEMM it launches.  Above the cap the
    batch is cut to the most whole instances that fit, at least one: the
    harvest's batched prefill shapes reach m x batch ~ 10^6 rows (e.g.
    ``(32768, 4096, 14336, 32)``), which would cost seconds and tens of GB
    per config, and a cut problem is ranked by its ``FOLD_ROWS``-row (or
    one-instance) GEMM, a ranking no run has held against the full call.
    The weights rotate through copies that outgrow the L2, as a decode step
    reads each layer's weights from memory.
  * **attention**: a problem ``(sq, skv, d)`` is timed at leading dims
    ``(1, heads)`` (32 by default, granite-8b's head count) through
    ``attention_cuda`` under the causal mask; its rate counts useful FLOPs as
    the reference's ``predict_attn_gflops`` does: 4 sq skv d per head, halved
    when sq == skv.  Each problem's buffers are released before the next
    (``(1, 524288, 64)`` at 32 heads holds 4.3 GB of K/V).
  * **wkv**: a problem ``(s, hd)`` is timed through ``wkv_cuda`` at leading
    dims (1, heads of the harvesting arch: ``recmodel.wkv_heads``, rwkv6-7b's
    64), in the dtypes the served prefill passes it (r/k/v and u in bf16,
    logw in f32, decays in [-5, -1e-3] as the model clamps them); its rate
    is the reference's useful FLOPs, 8 s hd^2 per head.  At (32768, 64) each
    f32 operand is 0.54 GB and the chunk-8 workspace 4.3 GB, so each
    problem's buffers are released before the next.
  * **ssm_scan**: a problem ``(s, d)`` is timed through ``ssm_cuda_fused``,
    the entry ``mamba_layer`` serves through, at batch 1 with N = 16 (f32
    x, dt, a, b, c); its rate is the reference's useful FLOPs, 6 s d N.

A config that cannot launch at a problem raises (the wrappers raise on a
failed launch); no cell is quietly set to 0.

There is no fallback: with no card, or asked to time on the CPU, it raises.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .dataset import TuningDataset
from .devices import canonical_device_name

SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's 1.98 GHz boost clock: covers one launch's host work
BUDGET_MS = 20.0
MIN_RUNS, MAX_RUNS = 2, 10
FOLD_ROWS = 16384  # the harvest's tallest single GEMM
ROTATE_BYTES = 150_000_000  # > 3x the H100's 50 MB L2
ATTN_HEADS = 32


def _cuda_device(device=None) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"gpubench times kernels on a CUDA device, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gpubench needs a CUDA device: the tuning tables are measured on the card, "
            "and torch finds none"
        )
    return dev


def card_name(device=None) -> str:
    """The canonical name of the card a table is measured on."""
    dev = _cuda_device(device)
    return canonical_device_name(torch.cuda.get_device_name(dev), "gpu")


def time_ms(fn, *, n_warm: int = 1, n_runs: int | None = None, queued: bool = True) -> float:
    """Median time of one call ``fn(i)`` (``i`` counts the calls) between CUDA events, in ms.

    ``queued``: each call is enqueued behind a ~1 ms device sleep, so the
    host's launch work overlaps the sleep and the events hold the device's
    time alone (a call whose host work outlasts the sleep still shows the
    rest).  Otherwise each call starts from an idle device and the events
    also hold the host's launch work: what one eager call costs.
    ``n_runs=None`` is the adaptive loop of the module docstring; a number
    times exactly that many calls.
    """
    for i in range(n_warm):
        fn(i)
    times: list[float] = []
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(len(times))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if n_runs is not None:
            done = len(times) >= n_runs
        else:
            done = len(times) >= MIN_RUNS and (sum(times) >= BUDGET_MS or len(times) >= MAX_RUNS)
        if done:
            return statistics.median(times)


def folded_rows(m: int, batch: int) -> int:
    """Rows of the GEMM the table times for a problem ``(m, k, n, batch)``."""
    return m * max(1, min(batch, FOLD_ROWS // m))


def measure_matmul(problems, configs, device=None, *, seed: int = 0) -> np.ndarray:
    """(problems x configs) GFLOP/s of ``matmul_cuda`` in bf16."""
    from ..kernels.matmul import matmul_cuda

    dev = _cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perf = np.zeros((len(problems), len(configs)))
    for i, (m, k, n, batch) in enumerate(problems):
        rows = folded_rows(m, batch)
        a = torch.randn((rows, k), device=dev, generator=gen, dtype=torch.bfloat16)
        copies = max(1, -(-ROTATE_BYTES // (k * n * 2)))
        bs = [torch.randn((k, n), device=dev, generator=gen, dtype=torch.bfloat16) for _ in range(copies)]
        for j, cfg in enumerate(configs):
            ms = time_ms(lambda r, c=cfg: matmul_cuda(a, bs[r % copies], c))
            perf[i, j] = 2.0 * rows * k * n / (ms * 1e-3) / 1e9
        del a, bs
    return perf


def attention_flops(sq: int, skv: int, d: int, heads: int = 1, causal: bool = True) -> float:
    """Useful FLOPs of one call, as the reference's ``predict_attn_gflops`` counts them."""
    return 4.0 * sq * skv * d * heads * (0.5 if causal and sq == skv else 1.0)


def measure_attention(problems, configs, device=None, *, heads: int = ATTN_HEADS, causal: bool = True,
                      seed: int = 0) -> np.ndarray:
    """(problems x configs) GFLOP/s of ``attention_cuda`` in bf16 at ``(1, heads)``."""
    from ..kernels.attention import attention_cuda

    dev = _cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perf = np.zeros((len(problems), len(configs)))
    for i, (sq, skv, d) in enumerate(problems):
        q = torch.randn((1, heads, sq, d), device=dev, generator=gen, dtype=torch.bfloat16)
        k = torch.randn((1, heads, skv, d), device=dev, generator=gen, dtype=torch.bfloat16)
        v = torch.randn((1, heads, skv, d), device=dev, generator=gen, dtype=torch.bfloat16)
        flops = attention_flops(sq, skv, d, heads, causal)
        for j, cfg in enumerate(configs):
            ms = time_ms(lambda r, c=cfg: attention_cuda(q, k, v, c, causal=causal))
            perf[i, j] = flops / (ms * 1e-3) / 1e9
        del q, k, v
        torch.cuda.empty_cache()
    return perf


def measure_wkv(problems, configs, device=None, *, seed: int = 0) -> np.ndarray:
    """(problems x configs) GFLOP/s of ``wkv_cuda`` at (1, S, heads, hd), bf16 r/k/v."""
    from ..kernels.wkv import wkv_cuda
    from .recmodel import wkv_flops, wkv_heads

    dev = _cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perf = np.zeros((len(problems), len(configs)))
    for i, (s, hd) in enumerate(problems):
        h = wkv_heads(hd)
        shape = (1, s, h, hd)
        r, k, v = (torch.randn(shape, device=dev, generator=gen, dtype=torch.bfloat16) for _ in range(3))
        logw = -torch.rand(shape, device=dev, generator=gen).mul_(5.0).clamp_(min=1e-3)
        u = torch.randn((h, hd), device=dev, generator=gen, dtype=torch.bfloat16)
        flops = wkv_flops(s, hd, h)
        for j, cfg in enumerate(configs):
            ms = time_ms(lambda _, c=cfg: wkv_cuda(r, k, v, logw, u, None, c))
            perf[i, j] = flops / (ms * 1e-3) / 1e9
        del r, k, v, logw, u
        torch.cuda.empty_cache()
    return perf


def measure_ssm(problems, configs, device=None, *, n_state: int = 16, seed: int = 0) -> np.ndarray:
    """(problems x configs) GFLOP/s of ``ssm_cuda_fused`` at (1, S, d, N), f32."""
    from ..kernels.ssm import ssm_cuda_fused
    from .recmodel import ssm_flops

    dev = _cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    perf = np.zeros((len(problems), len(configs)))
    for i, (s, d) in enumerate(problems):
        x = torch.randn((1, s, d), device=dev, generator=gen)
        dt = torch.nn.functional.softplus(torch.randn((1, s, d), device=dev, generator=gen) - 2.0)
        a = -torch.exp(0.3 * torch.randn((d, n_state), device=dev, generator=gen))
        b, c = (torch.randn((1, s, n_state), device=dev, generator=gen) for _ in range(2))
        flops = ssm_flops(s, d, n_state)
        for j, cfg in enumerate(configs):
            ms = time_ms(lambda _, cf=cfg: ssm_cuda_fused(x, dt, a, b, c, None, cf))
            perf[i, j] = flops / (ms * 1e-3) / 1e9
        del x, dt, a, b, c
        torch.cuda.empty_cache()
    return perf


_MEASURE = {"matmul": measure_matmul, "attention": measure_attention, "wkv": measure_wkv,
            "ssm_scan": measure_ssm}


def measure(family: str, problems, configs, device=None) -> np.ndarray:
    """The family's measured table; raises for a family with no measured source."""
    if family not in _MEASURE:
        raise NotImplementedError(f"no measured H100 source for the {family!r} family")
    return _MEASURE[family](problems, configs, device)


def build_gpu_dataset(family: str, problems, configs=None, device=None) -> tuple[TuningDataset, float]:
    """Measure the full (problems x configs) table on the card.

    Returns the ``TuningDataset`` (``source="measured"``, ``device`` the card's
    canonical name) and the seconds spent measuring.
    """
    from .families import get_family

    fam = get_family(family)
    configs = list(configs if configs is not None else fam.config_space())
    name = card_name(device)
    t0 = time.perf_counter()
    perf = measure(fam.name, list(problems), configs, device)
    seconds = time.perf_counter() - t0
    ds = TuningDataset(device=name, problems=list(problems), configs=configs, perf=perf,
                       source="measured", family=fam.name)
    return ds, seconds
