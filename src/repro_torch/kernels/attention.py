"""Flash attention for Hopper: the port of ``repro/kernels/attention.py::flash_attention_pallas``.

The kernel itself is CUDA C++ in ``csrc/attention.cu`` (one CTA per (block
of query rows, batch x head), K/V tiles through a 2-stage ``cp.async`` ring,
``mma.sync`` for both products in bf16, a full-f32 SIMT path for f32 inputs),
built by ``_build.load`` and called through a plain C interface.  This
module holds:

  * :class:`AttentionConfig` — one compiled instantiation: ``block_q`` query
    rows per CTA (16 per warp) and ``block_kv`` key/value rows per inner step.
    The field names, ``name()`` form and ``to_dict``/``from_dict`` are the
    reference's; the values are Hopper's (shared memory and warps), not the
    TPU's VMEM tiles;
  * :func:`config_space` — exactly the compiled set, checked when the library
    loads;
  * :func:`attention_cuda` — the wrapper: checks, allocates, launches, counts;
  * :func:`attention_plain` — the plain PyTorch version, for CPU tensors and
    for holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters.

Layout at the public functions is the reference's: q (..., sq, d) and k/v
(..., skv, d) with the same leading dims (no GQA broadcast), returning
(..., sq, d) in q's dtype.  Under ``causal`` the diagonal is aligned to the
end of KV: row i sees columns j <= i + (skv - sq).

**Rows with nothing to see.**  With ``causal`` and sq > skv the first
sq - skv rows have no visible column.  The reference's oracle returns NaN
there (a softmax over nothing) and its Pallas kernel a finite row (its
-1e30 fill makes every masked column weigh exp(0)).  The port defines such a
row as zeros, in the kernel and the plain version alike.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch

from .ref import flash_attention_ref

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use (227 KB)

# The compiled configs; csrc/attention.cu REPRO_ATTENTION_CONFIGS and
# REPRO_ATTENTION_HEAD_DIMS list the same set, checked when the library loads.
_BLOCK_Q = (32, 64, 128)  # 2, 4 or 8 warps of 16 query rows
_BLOCK_KV = (32, 64, 128)
_HEAD_DIMS = (64, 128)  # hymba-1.5b, granite-8b


@dataclasses.dataclass(frozen=True, order=True)
class AttentionConfig:
    """One deployable kernel instantiation: query rows per CTA x KV rows per step."""

    block_q: int
    block_kv: int

    def name(self) -> str:
        return f"fa_bq{self.block_q}_bkv{self.block_kv}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AttentionConfig":
        return AttentionConfig(**d)

    def threads(self) -> int:
        return self.block_q // 16 * 32

    def smem_bytes(self, hd: int, dtype_bytes: int = 2) -> int:
        """Dynamic shared memory one CTA needs (csrc/attention.cu AttnTile)."""
        if dtype_bytes == 4:  # Q, and one stage of K and V with rows padded by one
            return (self.block_q * hd + 2 * self.block_kv * (hd + 1)) * 4
        # Q, and two stages of K and V, rows padded by 8 elements
        return (self.block_q + 4 * self.block_kv) * (hd + 8) * 2

    def is_valid(self) -> bool:
        if self.block_q not in _BLOCK_Q or self.block_kv not in _BLOCK_KV:
            return False  # only compiled configs can launch
        return all(max(self.smem_bytes(hd, 2), self.smem_bytes(hd, 4)) <= SMEM_LIMIT for hd in _HEAD_DIMS)


@functools.cache
def config_space() -> tuple[AttentionConfig, ...]:
    """Every compiled (block_q, block_kv) pair."""
    out = tuple(AttentionConfig(bq, bkv) for bq, bkv in itertools.product(_BLOCK_Q, _BLOCK_KV))
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_ATTN_CONFIG = AttentionConfig(block_q=64, block_kv=64)

# Launch counters: config name -> launches.  attention_cuda adds one per
# kernel launch and nowhere else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """What the kernel computes, in plain PyTorch: ``ref.flash_attention_ref``,
    an f32 softmax under an explicit end-aligned mask, cast once to q's dtype
    (rows with no visible column are zeros).

    On the card it is compared with the kernel under
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32 products).
    """
    return flash_attention_ref(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_attention.argtypes = [i, i, i, i, ptr, ptr, ptr, ptr, i, i, i, ctypes.c_float, i, ptr]
    lib.repro_attention.restype = i
    lib.repro_attention_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_attention_configs.restype = i
    lib.repro_attention_error_string.argtypes = [i]
    lib.repro_attention_error_string.restype = ctypes.c_char_p
    compiled = compiled_configs(lib)
    want = [(c.block_q, c.block_kv, hd, c.threads(), c.smem_bytes(hd, 2), c.smem_bytes(hd, 4))
            for c in config_space() for hd in _HEAD_DIMS]
    if compiled != want:
        raise RuntimeError(f"compiled attention configs {compiled} != config space {want}")
    return lib


def compiled_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(block_q, block_kv, hd, threads, bf16 smem, f32 smem) of every instantiation."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (6 * 64))()
    n = lib.repro_attention_configs(buf, 64)
    return [tuple(buf[6 * i : 6 * i + 6]) for i in range(n)]


def attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    config: AttentionConfig = DEFAULT_ATTN_CONFIG,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention through the CUDA kernel instantiation ``config``.

    q: (..., sq, d), k/v: (..., skv, d) with the same leading dims; all of one
    dtype (bf16 or f32), contiguous, on one CUDA device; d in {64, 128}.
    Returns (..., sq, d) in q's dtype.  Raises on anything the kernel does not
    take, and when the launch reports an error.
    """
    tensors = (q, k, v)
    if q.ndim < 2 or k.ndim != q.ndim or v.ndim != q.ndim:
        raise ValueError(f"attention_cuda expects q (..., sq, d) and k/v (..., skv, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    *lead, sq, d = q.shape
    skv = k.shape[-2]
    if tuple(k.shape) != (*lead, skv, d) or tuple(v.shape) != (*lead, skv, d):
        raise ValueError(f"k and v must be {(*lead, 'skv', d)}, got {tuple(k.shape)} and {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attention_cuda is compiled for head dims {_HEAD_DIMS}, not {d}")
    bh = 1
    for n in lead:
        bh *= n
    if min(bh, sq, skv) == 0:
        raise ValueError(f"attention_cuda needs non-empty dims, got (BH, sq, skv) = {(bh, sq, skv)}")
    if bh > 65535 or sq * d >= 2**31 or skv * d >= 2**31:
        raise ValueError(f"attention_cuda takes BH <= 65535 and rows x d below 2**31, got "
                         f"(BH, sq, skv, d) = {(bh, sq, skv, d)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"attention_cuda takes bf16 or f32 operands of one dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_cuda expects contiguous operands")
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled attention config")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"attention_cuda needs every operand on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention_cuda expects 16-byte aligned operands")
    scale = scale if scale is not None else 1.0 / d**0.5
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_attention(
        config.block_q, config.block_kv, d, int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), bh, sq, skv, float(scale), int(causal), stream,
    )
    if err != 0:
        msg = lib.repro_attention_error_string(err).decode()
        raise RuntimeError(f"attention kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    return out
