"""Tiled GEMM for Hopper: the port of ``repro/kernels/matmul.py::matmul_pallas``.

The kernel itself is CUDA C++ in ``csrc/matmul.cu`` (tensor cores through
``mma.sync`` for bf16 inputs, a full-f32 SIMT path for f32 inputs), built by
``_build.load`` and called through a plain C interface.  This module holds:

  * :class:`MatmulConfig` — one compiled instantiation: a ``(block_m, block_n,
    block_k)`` CTA tile and an ``order`` that picks which of M/N tiles runs
    along ``blockIdx.x`` (``mnk``: n tiles, so CTAs that share an A row-block
    launch together; ``nmk``: m tiles, sharing a B column-block);
  * :func:`config_space` — exactly the compiled set, each under both orders;
  * :func:`matmul_cuda` — the wrapper: checks, allocates, launches, counts;
  * :func:`matmul_plain` — the plain PyTorch version, for CPU tensors and for
    holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .ref import matmul_ref

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use (227 KB)
STAGES = 3  # cp.async ring depth of the bf16 kernel (csrc/matmul.cu kStages)

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


@dataclasses.dataclass(frozen=True, order=True)
class MatmulConfig:
    """One deployable kernel instantiation: a CTA tile and a raster order."""

    block_m: int
    block_n: int
    block_k: int
    order: str = "mnk"  # 'mnk': n tiles on blockIdx.x; 'nmk': m tiles on blockIdx.x

    def name(self) -> str:
        return f"mm_bm{self.block_m}_bn{self.block_n}_bk{self.block_k}_{self.order}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "MatmulConfig":
        return MatmulConfig(**d)

    def smem_bytes(self, dtype_bytes: int = 2) -> int:
        """Dynamic shared memory one CTA needs (csrc/matmul.cu Bf16Tile/F32Tile)."""
        bm, bn, bk = self.block_m, self.block_n, self.block_k
        if dtype_bytes == 4:
            return (bk * bm + bk * bn) * 4
        return STAGES * (bm * (bk + 8) + bk * (bn + 8)) * 2

    def is_valid(self) -> bool:
        if self.order not in _ORDERS:
            return False
        if (self.block_m, self.block_n, self.block_k) not in _TILES:
            return False  # only compiled tiles can launch
        return max(self.smem_bytes(2), self.smem_bytes(4)) <= SMEM_LIMIT


@functools.cache
def config_space() -> tuple[MatmulConfig, ...]:
    """Every compiled tile under both raster orders."""
    out = tuple(MatmulConfig(bm, bn, bk, o) for bm, bn, bk in _TILES for o in _ORDERS)
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_CONFIG = MatmulConfig(block_m=128, block_n=128, block_k=32, order="mnk")

# Launch counters: config name -> launches.  matmul_cuda adds one per kernel
# launch and nowhere else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


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
    lib.repro_matmul_bf16.argtypes = [i, i, i, i, i, ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_matmul_bf16.restype = i
    lib.repro_matmul_f32.argtypes = [i, i, i, i, ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_matmul_f32.restype = i
    lib.repro_matmul_tiles.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_matmul_tiles.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    compiled = compiled_tiles(lib)
    want = [(bm, bn, bk, MatmulConfig(bm, bn, bk).smem_bytes(2), MatmulConfig(bm, bn, bk).smem_bytes(4))
            for bm, bn, bk in _TILES]
    if compiled != want:
        raise RuntimeError(f"compiled matmul tiles {compiled} != config space {want}")
    return lib


def compiled_tiles(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(bm, bn, bk, bf16 smem, f32 smem) of every tile the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (5 * 64))()
    n = lib.repro_matmul_tiles(buf, 64)
    return [tuple(buf[5 * i : 5 * i + 5]) for i in range(n)]


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
    one device; bf16 inputs may ask for an f32 output.  Raises on anything the
    kernel does not take, and when the launch reports an error.
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
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled matmul config")
    lib = _lib()
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    order = _ORDERS.index(config.order)
    bm, bn, bk = config.block_m, config.block_n, config.block_k
    if lhs.dtype == torch.bfloat16:
        err = lib.repro_matmul_bf16(bm, bn, bk, order, int(out_dtype == torch.float32),
                                    lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k, stream)
    else:
        err = lib.repro_matmul_f32(bm, bn, bk, order,
                                   lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"matmul kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    return out
