"""Mamba selective scan for Hopper: the port of ``repro/kernels/ssm.py::ssm_scan_pallas``.

The kernel itself is CUDA C++ in ``csrc/ssm.cu`` (one CTA per (batch element,
block of ``block_d`` channels), one thread per (channel, state index) holding
its state in a register, a loop over the sequence in chunks whose loads are
issued before the chunk's recurrence runs), built by ``_build.load`` and
called through a plain C interface.  This module holds:

  * :class:`SsmConfig` — one compiled (block_d, chunk) pair;
  * :func:`config_space` — exactly the compiled set;
  * :func:`ssm_cuda` — the wrapper: checks, allocates, launches, counts;
  * :func:`ssm_plain` — the plain PyTorch version, for CPU tensors and for
    holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters.

Layout at the public functions is the reference's ``ops.ssm_scan``: dtx
(B, S, d), dta (B, S, d, N), b/c (B, S, N), state (B, d, N) or None, all
f32; they return (y (B, S, d) f32, final state (B, d, N) f32).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .ref import ssm_scan_ref

_BLOCK_DS = (8, 16, 32)  # csrc/ssm.cu REPRO_SSM_BLOCK_DS
_CHUNKS = (8, 16, 32)  # csrc/ssm.cu REPRO_SSM_CHUNKS
_STATES = (8, 16)  # csrc/ssm.cu REPRO_SSM_STATES: 16 is hymba-1.5b, 8 its reduced config


@dataclasses.dataclass(frozen=True, order=True)
class SsmConfig:
    """One deployable kernel instantiation: channels per CTA x steps per load batch."""

    block_d: int = 16
    chunk: int = 32

    def name(self) -> str:
        return f"ssm_bd{self.block_d}_c{self.chunk}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SsmConfig":
        return SsmConfig(**d)

    def is_valid(self) -> bool:
        return self.block_d in _BLOCK_DS and self.chunk in _CHUNKS


@functools.cache
def config_space() -> tuple[SsmConfig, ...]:
    """Every compiled (block_d, chunk) pair."""
    return tuple(SsmConfig(bd, c) for bd in _BLOCK_DS for c in _CHUNKS)


DEFAULT_SSM_CONFIG = SsmConfig(16, 32)

# Launch counters: config name -> launches.  ssm_cuda adds one per kernel
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
def ssm_plain(dtx, dta, b, c, state=None):
    """What the kernel computes, in plain PyTorch: ``ref.ssm_scan_ref``, the
    sequential recurrence in f32."""
    return ssm_scan_ref(dtx, dta, b, c, state)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("ssm")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssm.argtypes = [i, i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_ssm.restype = i
    lib.repro_ssm_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_ssm_configs.restype = i
    lib.repro_ssm_error_string.argtypes = [i]
    lib.repro_ssm_error_string.restype = ctypes.c_char_p
    compiled = compiled_configs(lib)
    want = [(c.block_d, c.chunk, n, c.block_d * n) for c in config_space() for n in _STATES]
    if compiled != want:
        raise RuntimeError(f"compiled ssm configs {compiled} != config space {want}")
    return lib


def compiled_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(block_d, chunk, N, threads per CTA) of every instantiation the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (4 * 64))()
    n = lib.repro_ssm_configs(buf, 64)
    return [tuple(buf[4 * i : 4 * i + 4]) for i in range(n)]


def ssm_cuda(dtx, dta, b, c, state=None, config: SsmConfig = DEFAULT_SSM_CONFIG):
    """Selective scan through the CUDA kernel under ``config``.

    dtx: (B, S, d); dta: (B, S, d, N); b/c: (B, S, N); state: (B, d, N) or
    None (zeros).  All f32, contiguous, on one CUDA device, N in {8, 16}.
    Returns (y (B, S, d) f32, final state (B, d, N) f32).  Raises on anything
    the kernel does not take, and when the launch reports an error.
    """
    dev = dtx.device
    tensors = (dtx, dta, b, c) + ((state,) if state is not None else ())
    if dtx.ndim != 3 or dta.ndim != 4:
        raise ValueError(f"ssm_cuda expects dtx (B, S, d) and dta (B, S, d, N), "
                         f"got {tuple(dtx.shape)} and {tuple(dta.shape)}")
    bsz, s, d = dtx.shape
    n = dta.shape[3]
    if (tuple(dta.shape) != (bsz, s, d, n) or tuple(b.shape) != (bsz, s, n) or tuple(c.shape) != (bsz, s, n)
            or (state is not None and tuple(state.shape) != (bsz, d, n))):
        raise ValueError(f"shapes do not match (B, S, d, N) = {(bsz, s, d, n)}: dta {tuple(dta.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"state {None if state is None else tuple(state.shape)}")
    if n not in _STATES:
        raise ValueError(f"ssm_cuda is compiled for state sizes {_STATES}, not {n}")
    if min(bsz, s, d) == 0:
        raise ValueError(f"ssm_cuda needs non-empty dims, got (B, S, d) = {(bsz, s, d)}")
    if max(bsz, s, d) >= 2**31:
        raise ValueError(f"ssm_cuda takes dims below 2**31, got (B, S, d) = {(bsz, s, d)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssm_cuda takes f32 operands, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_cuda expects contiguous operands")
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled ssm config")
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"ssm_cuda needs every operand on one CUDA device, got {[str(t.device) for t in tensors]}")
    lib = _lib()
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    s_out = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_ssm(
        config.block_d, config.chunk, n, dtx.data_ptr(), dta.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), s_out.data_ptr(), bsz, s, d, stream,
    )
    if err != 0:
        msg = lib.repro_ssm_error_string(err).decode()
        raise RuntimeError(f"ssm kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    return y, s_out
