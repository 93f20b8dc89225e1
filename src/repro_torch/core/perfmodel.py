"""Analytic H100 performance model: the model side of the staged tuning pipeline.

The counterpart of ``repro/core/perfmodel.py``.  The port's benchmark tables
are measured on the card (``core/gpubench.py``), so this module holds only
what a *model* can know before anything runs: a smooth roofline over the
port's compiled Hopper configs, with no simulated "texture" (the reference
adds one to stand in for measurements it cannot make; here the measurements
are real).  The staged pipeline (``core/pipeline.py``) prunes on it, plans
its measurement budget with it, fills the cells it does not measure from it,
and records its error against the cells it does (``model_error``).

The GEMM model follows how ``csrc/matmul.cu`` runs a problem: ``ops.matmul``
folds ``(m, k, n, batch)`` into one ``(m * batch, k, n)`` GEMM, the table
times it at :func:`~repro_torch.core.gpubench.folded_rows` rows, and the
model predicts the same GEMM:

  * the (m, n) grid of CTA tiles, times the k splits ``matmul.split_k``
    launches, runs in waves over the SMs, two CTAs to an SM where the TMA
    ring fits twice in shared memory;
  * ``wgmma`` consumers at 64- and 128-row tiles, ``mma.sync`` at 16- and
    32-row tiles, each at its own fraction of the tensor-core peak, and a
    CTA tile narrower than 128 columns at its share of it;
  * HBM traffic: each operand once, with the slow axis's operand read again
    per band of 8 tiles of the fast one when it outgrows the L2 (the raster
    ``order``), the output once, and each split's partial tile through L2;
  * a config whose shared memory exceeds ``SMEM_LIMIT`` predicts infinitely
    slow (0 GFLOP/s), as the reference's VMEM overflow does.

Constants: the card's figures are NVIDIA's published H100 SXM5 numbers (the
card of ``PERF.md``, NVIDIA H100 80GB HBM3 at 700 W): 989.4 TFLOP/s dense
bf16 on the tensor cores, 66.9 TFLOP/s f32 outside them, 3.35 TB/s HBM3,
132 SMs, 50 MB of L2, 227 KB of shared memory a CTA, a 1.98 GHz boost
clock.  The efficiencies and overheads below them are model assumptions,
named as such, not measurements; the pipeline's ``model_error`` says how
far the model is from the card's table.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..kernels.matmul import H100_SMS, SMEM_LIMIT, MatmulConfig, split_k


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float  # FLOP/s, dense bf16 on the tensor cores
    f32_flops: float  # FLOP/s, f32 FMA outside the tensor cores
    hbm_bw: float  # bytes/s
    sms: int
    l2_bytes: int
    smem_per_cta: int  # bytes of shared memory one CTA may use
    clock_hz: float  # boost clock
    launch_overhead: float  # s per kernel launch (model assumption)
    wave_overhead: float  # s per wave of CTAs: prologue, pipeline fill, epilogue (model assumption)


# NVIDIA's published H100 SXM5 figures; the last two are model assumptions.
H100_SXM5 = DeviceModel(
    name="gpu_nvidia_h100_80gb_hbm3",
    peak_flops=989.4e12,
    f32_flops=66.9e12,
    hbm_bw=3.35e12,
    sms=H100_SMS,
    l2_bytes=50 * 1024 * 1024,
    smem_per_cta=SMEM_LIMIT,
    clock_hz=1.98e9,
    launch_overhead=3e-6,
    wave_overhead=1.5e-6,
)

DEVICES = {d.name: d for d in (H100_SXM5,)}

# Model assumptions: the fraction of the tensor-core peak each consumer path sustains.
MMA_EFFICIENCY = {"wgmma": 0.75, "mma_sync": 0.40}
SM_SMEM = 228 * 1024  # bytes of shared memory an SM holds (1 KB of it reserved per CTA)
BAND = 8  # csrc/matmul.cu: the fast raster axis is walked in bands of 8 tiles


def device_model(device_name: str | None) -> DeviceModel:
    """The model of ``device_name``; any other card falls back to the H100's,
    as the reference falls back to its primary target."""
    return DEVICES.get(device_name or H100_SXM5.name, H100_SXM5)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def resident_gemm_ctas(cfg: MatmulConfig, device: DeviceModel = H100_SXM5) -> int:
    """CTAs of ``cfg`` one SM holds: two where the TMA ring fits twice in an
    SM's shared memory (csrc/matmul.cu sizes the ring for that), else one."""
    return 2 if 2 * (cfg.smem_bytes("tma") + 1024) <= SM_SMEM else 1


def predict_time(problem: tuple[int, int, int, int], cfg: MatmulConfig,
                 device: DeviceModel = H100_SXM5) -> float:
    """Predicted seconds of the bf16 GEMM the table times for ``problem``; inf
    for a config the card cannot launch."""
    from .gpubench import folded_rows

    m, k, n, batch = problem
    if max(cfg.smem_bytes(p) for p in ("tma", "cp_async")) > device.smem_per_cta:
        return math.inf
    rows = folded_rows(m, batch)
    bm, bn, bk = cfg.block_m, cfg.block_n, cfg.block_k
    tm, tn = _ceil(rows, bm), _ceil(n, bn)
    splits = split_k(rows, n, k, cfg, device.sms)
    ctas = tm * tn * splits
    resident = resident_gemm_ctas(cfg, device)
    waves = _ceil(ctas, device.sms * resident)
    # Compute: each wave's CTAs share the SMs; a CTA's tile runs at its path's share
    # of the peak, padded to whole tiles and k steps.
    path = "wgmma" if bm >= 64 else "mma_sync"
    eff = MMA_EFFICIENCY[path] * min(bn, 128) / 128
    k_split = _ceil(_ceil(k, bk), splits) * bk
    cta_flops = 2.0 * bm * bn * k_split
    per_sm_rate = device.peak_flops * eff / device.sms
    t_compute = waves * resident * cta_flops / per_sm_rate
    # Memory: operands once, the slow axis's operand again per band when it outgrows L2.
    a_bytes, b_bytes = rows * k * 2.0, k * n * 2.0
    if cfg.order == "mnk":  # n tiles fastest: CTAs sharing an A row-block run together
        b_reads = 1 if b_bytes <= device.l2_bytes / 2 else _ceil(tm, BAND)
        a_reads = 1
    else:
        a_reads = 1 if a_bytes <= device.l2_bytes / 2 else _ceil(tn, BAND)
        b_reads = 1
    traffic = a_reads * a_bytes + b_reads * b_bytes + rows * n * 2.0
    t_mem = traffic / device.hbm_bw
    t_split = 0.0
    if splits > 1:  # every split's f32 partial tile written and read back through L2
        t_split = 2.0 * tm * tn * splits * bm * bn * 4 / (2 * device.hbm_bw)
    return max(t_compute, t_mem) + t_split + waves * device.wave_overhead + device.launch_overhead


def predict_gflops(problem: tuple[int, int, int, int], cfg: MatmulConfig,
                   device: DeviceModel = H100_SXM5) -> float:
    """Useful GFLOP/s of the timed GEMM (2 rows k n / t), 0 where it cannot launch."""
    from .gpubench import folded_rows

    t = predict_time(problem, cfg, device)
    if not np.isfinite(t) or t <= 0:
        return 0.0
    m, k, n, batch = problem
    return 2.0 * folded_rows(m, batch) * k * n / t / 1e9


def build_perf_matrix(problems: list[tuple[int, int, int, int]], configs: list[MatmulConfig],
                      device: DeviceModel | str | None = H100_SXM5) -> np.ndarray:
    """(n_problems, n_configs) model GFLOP/s: the matmul family's ``model_matrix``."""
    if not isinstance(device, DeviceModel):
        device = device_model(device)
    out = np.zeros((len(problems), len(configs)))
    for i, p in enumerate(problems):
        for j, c in enumerate(configs):
            out[i, j] = predict_gflops(p, c, device)
    return out
