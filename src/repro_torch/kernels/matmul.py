"""Tiled GEMM for Hopper: the port of ``repro/kernels/matmul.py::matmul_pallas``.

The kernel itself is CUDA C++ in ``csrc/matmul.cu`` (for bf16 inputs a TMA
ring fed by a producer warp into ``wgmma`` (64- and 128-row tiles) or
``mma.sync`` (16- and 32-row tiles), with in-kernel split-k; a ``cp.async``
kernel for shapes TMA cannot take; a full-f32 SIMT path for f32 inputs),
built by ``_build.load`` and called through a plain C interface.  This module
holds:

  * :class:`MatmulConfig` — one compiled instantiation: a ``(block_m, block_n,
    block_k)`` CTA tile and an ``order`` that picks which of M/N tiles runs
    fastest (``mnk``: n tiles, so CTAs that share an A row-block launch
    together; ``nmk``: m tiles, sharing a B column-block; the bf16 kernels
    walk the fast axis in bands of 8 tiles);
  * :func:`config_space` — exactly the compiled set, each under both orders;
  * :func:`split_k` — how many k splits a bf16 call launches, and
    :func:`k_ranges`, the k range of each split as the kernel computes it;
  * :func:`matmul_cuda` — the wrapper: checks, picks the path, allocates,
    launches, counts;
  * :func:`matmul_plain` — the plain PyTorch version, for CPU tensors and for
    holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters, and ``PATH_LAUNCHES`` — the
    same launches per kernel path (``tma``, ``cp_async``, ``simt_f32``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import launch_error, refuse_under_capture
from .ref import matmul_ref

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use (227 KB)
CP_ASYNC_STAGES = 3  # cp.async ring depth of the fallback bf16 kernel (csrc/matmul.cu kStages)
RING_BUDGET = 110 * 1024  # TMA ring bytes per CTA, so two CTAs share an SM (kRingBudget)
MAX_TMA_STAGES = 8  # kMaxTmaStages
H100_SMS = 132

# The compiled (block_m, block_n, block_k) tiles; csrc/matmul.cu
# REPRO_MATMUL_TILES lists the same set, checked when the library loads.
_TILES = (
    (16, 64, 128),
    (16, 128, 64),
    (32, 64, 64),
    (64, 128, 32),
    (128, 128, 32),
)
_ORDERS = ("mnk", "nmk")
PATHS = ("tma", "cp_async", "simt_f32")


@dataclasses.dataclass(frozen=True, order=True)
class MatmulConfig:
    """One deployable kernel instantiation: a CTA tile and a raster order."""

    block_m: int
    block_n: int
    block_k: int
    order: str = "mnk"  # 'mnk': n tiles run fastest; 'nmk': m tiles run fastest

    def name(self) -> str:
        return f"mm_bm{self.block_m}_bn{self.block_n}_bk{self.block_k}_{self.order}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "MatmulConfig":
        return MatmulConfig(**d)

    def tma_stages(self) -> int:
        """Depth of the TMA ring (csrc/matmul.cu TmaTile::STAGES)."""
        stage = (self.block_m * self.block_k + self.block_k * self.block_n) * 2
        return min(MAX_TMA_STAGES, RING_BUDGET // stage)

    def smem_bytes(self, path: str = "tma") -> int:
        """Dynamic shared memory one CTA needs on ``path`` (csrc/matmul.cu TmaTile,
        Bf16Tile, F32Tile)."""
        bm, bn, bk = self.block_m, self.block_n, self.block_k
        if path == "simt_f32":
            return (bk * bm + bk * bn) * 4
        if path == "cp_async":
            return CP_ASYNC_STAGES * (bm * (bk + 8) + bk * (bn + 8)) * 2
        # 1 KB of alignment slack, the ring, a full and an empty mbarrier per stage, a flag.
        stages = self.tma_stages()
        return 1024 + stages * (bm * bk + bk * bn) * 2 + 2 * stages * 8 + 16

    def is_valid(self) -> bool:
        if self.order not in _ORDERS:
            return False
        if (self.block_m, self.block_n, self.block_k) not in _TILES:
            return False  # only compiled tiles can launch
        return max(self.smem_bytes(p) for p in PATHS) <= SMEM_LIMIT


@functools.cache
def config_space() -> tuple[MatmulConfig, ...]:
    """Every compiled tile under both raster orders."""
    out = tuple(MatmulConfig(bm, bn, bk, o) for bm, bn, bk in _TILES for o in _ORDERS)
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_CONFIG = MatmulConfig(block_m=128, block_n=128, block_k=32, order="mnk")
# What the wrapper passes for each compiled config: (bm, bn, bk, order index).
_CONFIG_ARGS = {c: (c.block_m, c.block_n, c.block_k, _ORDERS.index(c.order)) for c in config_space()}

# Launch counters: config name -> launches.  matmul_cuda adds one per kernel
# launch and nowhere else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}
# The same launches by kernel path: the TMA kernel, the cp.async kernel (bf16 shapes
# TMA cannot take) and the f32 SIMT kernel.
PATH_LAUNCHES: dict[str, int] = {p: 0 for p in PATHS}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for key in counts:
            counts[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# split-k
# ---------------------------------------------------------------------------
# Split-k targets, from scripts/split_sweep.py on the H100 (PERF.md): at the served
# decode shapes 64 CTAs already stream the weights at the rate the card reaches, and each
# extra split costs a partial's round trip through L2, so k is split only until the grid
# holds 64 CTAs, and never below 128 KB of weights per split.
SPLIT_CTAS = 64
SPLIT_MIN_BYTES = 128 * 1024


@functools.lru_cache(maxsize=4096)
def split_k(m: int, n: int, k: int, config: MatmulConfig, sm_count: int = H100_SMS) -> int:
    """How many splits of k a bf16 call of ``config`` launches along ``blockIdx.z``.

    One when the (m, n) grid of output tiles already holds
    min(SPLIT_CTAS, sm_count) CTAs.  Otherwise enough splits to reach that
    many CTAs, as far as the ceil(k / block_k) steps allow with at least
    SPLIT_MIN_BYTES of the weight (block_k x block_n bf16 a step) per split.
    The kernel gives every split but the last ceil(steps / splits) steps
    (:func:`k_ranges`); the count is normalised to ceil(steps / per) for a
    step count ``per``, which leaves no split empty.
    """
    tiles = -(-m // config.block_m) * -(-n // config.block_n)
    target = min(SPLIT_CTAS, sm_count)
    if tiles >= target:
        return 1
    steps = -(-k // config.block_k)
    min_steps = -(-SPLIT_MIN_BYTES // (config.block_k * config.block_n * 2))
    want = min(-(-target // tiles), max(1, steps // min_steps))
    per = -(-steps // want)
    return -(-steps // per)


def k_ranges(k: int, block_k: int, splits: int) -> list[tuple[int, int]]:
    """The [start, stop) range of k that each split sums, as csrc/matmul.cu
    ``split_range`` computes it: whole ``block_k`` steps, the last split
    ending at k."""
    steps = -(-k // block_k)
    per = -(-steps // splits)
    return [(z * per * block_k, min(k, (z + 1) * per * block_k)) for z in range(splits)]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``lhs @ rhs`` in f32, cast once: what the kernel computes, in plain PyTorch.

    On the card this is compared with the kernel under
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32 products).
    """
    return matmul_ref(lhs, rhs, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("matmul")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_matmul_bf16.argtypes = [i, i, i, i, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr]
    lib.repro_matmul_bf16.restype = i
    lib.repro_matmul_f32.argtypes = [i, i, i, i, ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_matmul_f32.restype = i
    lib.repro_matmul_tiles.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_matmul_tiles.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_matmul_map_encodes.argtypes = []
    lib.repro_matmul_map_encodes.restype = ctypes.c_longlong
    compiled = compiled_tiles(lib)
    want = [tile_row(MatmulConfig(bm, bn, bk)) for bm, bn, bk in _TILES]
    if compiled != want:
        raise RuntimeError(f"compiled matmul tiles {compiled} != config space {want}")
    return lib


def tile_row(config: MatmulConfig) -> tuple[int, ...]:
    """(bm, bn, bk, TMA stages, TMA smem, cp.async smem, f32 smem): what
    ``repro_matmul_tiles`` reports for the config's tile."""
    return (config.block_m, config.block_n, config.block_k, config.tma_stages(),
            *(config.smem_bytes(p) for p in PATHS))


def compiled_tiles(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """:func:`tile_row` of every tile the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (7 * 64))()
    n = lib.repro_matmul_tiles(buf, 64)
    return [tuple(buf[7 * i : 7 * i + 7]) for i in range(n)]


def map_encodes() -> int:
    """Tensor maps the library has encoded (cached maps are not encoded again)."""
    return _lib().repro_matmul_map_encodes()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (f32 workspace, int32 per-tile counters). One pair per
# stream, so two streams never share partials or counters. A split call has fewer than
# SPLIT_CTAS tiles and at most ceil(SPLIT_CTAS / tiles) splits, so it needs fewer than
# 2 * SPLIT_CTAS tile-sized slots: the first allocation holds that many of the largest
# tile and stays at one address; a larger need would grow it. The kernel leaves every
# counter at 0. A CUDA graph bakes the addresses in, so the pair is never allocated during
# a capture (the counters' zeroing would be captured, not run): a warm-up call on the
# capture stream allocates it first.
WORKSPACE_FLOATS = 2 * SPLIT_CTAS * max(bm * bn for bm, bn, _ in _TILES)
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int, tiles: int) -> tuple[int, int]:
    key = (device.index, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < tiles:
        refuse_under_capture("the matmul split-k workspace")
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, WORKSPACE_FLOATS), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 2 * SPLIT_CTAS), dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


_PAIRS = {
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32),
}


def matmul_cuda(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    config: MatmulConfig = DEFAULT_CONFIG,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``lhs (m, k) @ rhs (k, n)`` through the CUDA kernel instantiation ``config``.

    Takes 2-D row-major contiguous CUDA tensors of one dtype (bf16 or f32) on
    one device; bf16 inputs may ask for an f32 output.  bf16 inputs take the
    TMA kernel when k and n are multiples of 8 and both bases 16-byte aligned
    (what a tensor map needs), else the cp.async kernel; either splits k as
    :func:`split_k` says.  Raises on anything the kernel does not take, and
    when the launch reports an error.
    """
    out_dtype = out_dtype or lhs.dtype
    if lhs.device.type != "cuda" or rhs.device != lhs.device:
        raise ValueError(f"matmul_cuda needs both operands on one CUDA device, got {lhs.device} and {rhs.device}")
    if lhs.ndim != 2 or rhs.ndim != 2:
        raise ValueError(f"matmul_cuda expects 2-D operands, got {tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("matmul_cuda expects row-major contiguous operands")
    if lhs.dtype != rhs.dtype or (lhs.dtype, out_dtype) not in _PAIRS:
        raise TypeError(f"matmul_cuda does not take {lhs.dtype} @ {rhs.dtype} -> {out_dtype}")
    m, k = lhs.shape
    k2, n = rhs.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    if min(m, k, n) == 0:
        raise ValueError(f"matmul_cuda needs non-empty dims, got m={m} k={k} n={n}")
    tile = _CONFIG_ARGS.get(config)
    if tile is None:
        raise ValueError(f"{config} is not a compiled matmul config")
    bm, bn, bk, order = tile
    lib = _lib()
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    # The raw handle: torch.cuda.current_stream() builds a Stream object, ~5 us a call.
    stream = torch._C._cuda_getCurrentRawStream(lhs.device.index)
    a, b = lhs.data_ptr(), rhs.data_ptr()
    if lhs.dtype == torch.bfloat16:
        path = "tma" if k % 8 == 0 and n % 8 == 0 and a % 16 == 0 and b % 16 == 0 else "cp_async"
        splits = split_k(m, n, k, config, _sm_count(lhs.device.index))
        ws = counters = None
        if splits > 1:
            tiles = -(-m // bm) * -(-n // bn)
            ws, counters = _workspace(lhs.device, stream, tiles * splits * bm * bn, tiles)
        err = lib.repro_matmul_bf16(bm, bn, bk, order, int(out_dtype == torch.float32), int(path == "tma"),
                                    a, b, out.data_ptr(), m, n, k, splits, ws, counters, stream)
    else:
        path = "simt_f32"
        err = lib.repro_matmul_f32(bm, bn, bk, order, a, b, out.data_ptr(), m, n, k, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise launch_error(err, f"matmul kernel {config.name()} ({path}) failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    PATH_LAUNCHES[path] += 1
    return out
