"""Chunked RWKV6 WKV for Hopper: the port of ``repro/kernels/wkv.py::wkv_pallas``.

The kernels are CUDA C++ in ``csrc/wkv.cu``, a chunk-parallel pair: a state
pass that walks the chunk boundaries and writes each chunk's starting state
into a workspace ``hs``, then an output kernel that computes every chunk's
output at once from ``hs``.  Both are built by ``_build.load`` and called
through one plain C entry point.  This module holds:

  * :class:`WkvConfig` — one compiled chunk length (the tunable knob, as on
    the TPU);
  * :func:`config_space` — exactly the compiled set;
  * :func:`wkv_cuda` — the wrapper: checks, allocates, launches, counts;
  * :func:`wkv_plain` — the plain PyTorch version, for CPU tensors and for
    holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters.

Layout at the public functions is the reference's: r/k/v/logw (B, S, H, hd),
u (H, hd), state (B, H, hd, hd) or None; they return (o (B, S, H, hd) f32,
final state f32), as ``ops.wkv`` does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .ref import wkv_ref

_CHUNKS = (8, 16, 32, 64, 128)  # csrc/wkv.cu REPRO_WKV_CHUNKS
_HEAD_DIMS = (16, 64)  # csrc/wkv.cu REPRO_WKV_HEAD_DIMS: 64 is rwkv6-7b, 16 its reduced config
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use (227 KB)


def value_block(chunk: int, hd: int) -> int:
    """Value columns of one output-kernel CTA (csrc/wkv.cu value_block): the
    whole head, but 16 at chunk 128, where the whole head's tiles do not fit
    in shared memory."""
    return 16 if chunk >= 128 else hd


@dataclasses.dataclass(frozen=True, order=True)
class WkvConfig:
    """One deployable kernel instantiation: the chunk length."""

    chunk: int = 16

    def name(self) -> str:
        return f"wkv_c{self.chunk}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "WkvConfig":
        return WkvConfig(**d)

    def smem_bytes(self, hd: int) -> int:
        """Dynamic shared memory of the largest of the two kernels' CTAs over
        the r/k/v types (csrc/wkv.cu WkvOutSmem, WkvStateSmem)."""
        L, vb = self.chunk, value_block(self.chunk, hd)
        output = 4 * (4 * L * (hd + 4) + L * (L + 4) + L * vb + hd * vb + hd)
        kr = hd // 2 if hd > 16 else hd  # the state pass's key rows a CTA
        state = 0
        for size in (2, 4):  # the state pass's ring of (k, v, logw) stages and their decays
            stage = L * (kr * size + hd * size + kr * 4)
            stages = 4 if 4 * (stage + kr * 4) <= SMEM_LIMIT else 3
            state = max(state, stages * (stage + kr * 4))
        return max(output, state)

    def is_valid(self) -> bool:
        return self.chunk in _CHUNKS and all(self.smem_bytes(hd) <= SMEM_LIMIT for hd in _HEAD_DIMS)


@functools.cache
def config_space() -> tuple[WkvConfig, ...]:
    """Every compiled chunk length."""
    out = tuple(WkvConfig(c) for c in _CHUNKS)
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_WKV_CONFIG = WkvConfig(16)

# Launch counters: config name -> calls.  wkv_cuda adds one per call (its
# two kernel launches) and nowhere else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def wkv_plain(r, k, v, logw, u, state=None):
    """What the kernel computes, in plain PyTorch: the reference's
    ``wkv_chunked`` (chunk 16, zero-decay zero-k/v padding, f32 math).

    On the card it is compared with the kernel under
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (full f32 products).
    """
    return wkv_ref(r, k, v, logw, u, state)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("wkv")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv.argtypes = [i, i, i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_wkv.restype = i
    lib.repro_wkv_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_wkv_configs.restype = i
    lib.repro_wkv_error_string.argtypes = [i]
    lib.repro_wkv_error_string.restype = ctypes.c_char_p
    compiled = compiled_configs(lib)
    want = [(c, hd, WkvConfig(c).smem_bytes(hd)) for c in _CHUNKS for hd in _HEAD_DIMS]
    if compiled != want:
        raise RuntimeError(f"compiled wkv configs {compiled} != config space {want}")
    return lib


def compiled_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(chunk, hd, smem bytes) of every instantiation the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (3 * 64))()
    n = lib.repro_wkv_configs(buf, 64)
    return [tuple(buf[3 * i : 3 * i + 3]) for i in range(n)]


def launch_chunk(config: WkvConfig, s: int) -> int:
    """The compiled chunk length a call of ``s`` tokens runs under ``config``.

    The reference runs ``min(config.chunk, max(s, 8))``.  Below
    ``config.chunk`` that is a single chunk holding the whole sequence, which
    the smallest compiled chunk that covers it computes identically (its
    masked tail is the reference's padding).
    """
    if s >= config.chunk:
        return config.chunk
    return min(c for c in _CHUNKS if c >= max(s, 8))


def workspace_bytes(b: int, s: int, h: int, hd: int, config: WkvConfig = DEFAULT_WKV_CONFIG) -> int:
    """Bytes of ``hs``, the f32 state at the start of every chunk, that a
    ``wkv_cuda`` call allocates: B x H x n_chunks x hd x hd x 4."""
    return b * h * -(-s // launch_chunk(config, s)) * hd * hd * 4


def wkv_cuda(r, k, v, logw, u, state=None, config: WkvConfig = DEFAULT_WKV_CONFIG):
    """Chunked WKV through the CUDA kernel under ``config``.

    r/k/v: (B, S, H, hd) bf16 or f32, one dtype; logw: (B, S, H, hd) f32;
    u: (H, hd) in r's dtype or f32; state: (B, H, hd, hd) f32 or None
    (zeros).  All contiguous, on one CUDA device, hd in {16, 64}.  Returns
    (o (B, S, H, hd) f32, final state (B, H, hd, hd) f32).  Raises on anything
    the kernel does not take, and when either launch reports an error.

    Each call allocates the workspace ``hs`` (:func:`workspace_bytes`) with
    ``torch.empty`` and launches the state pass, then the output kernel, on
    the current stream, with no host sync.  Both read r/k/v/logw (and the
    state) in 16-byte pieces, so one of them whose base is not 16-byte
    aligned is copied to a fresh tensor first.
    """
    dev = r.device
    tensors = (r, k, v, logw, u) + ((state,) if state is not None else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"wkv_cuda needs every operand on one CUDA device, got {[str(t.device) for t in tensors]}")
    if r.ndim != 4:
        raise ValueError(f"wkv_cuda expects r/k/v/logw of shape (B, S, H, hd), got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r/k/v/logw shapes differ: {[tuple(t.shape) for t in (r, k, v, logw)]}")
    if tuple(u.shape) != (h, hd) or (state is not None and tuple(state.shape) != (b, h, hd, hd)):
        raise ValueError(f"u {tuple(u.shape)} / state {None if state is None else tuple(state.shape)} "
                         f"do not match (B, S, H, hd) = {(b, s, h, hd)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"wkv_cuda is compiled for head dims {_HEAD_DIMS}, not {hd}")
    if min(b, s, h) == 0:
        raise ValueError(f"wkv_cuda needs non-empty dims, got (B, S, H) = {(b, s, h)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv_cuda expects contiguous operands")
    if r.dtype not in (torch.bfloat16, torch.float32) or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_cuda takes r/k/v in one of bf16/f32, got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or (state is not None and state.dtype != torch.float32):
        raise TypeError("wkv_cuda takes logw and the state in f32")
    if u.dtype not in (r.dtype, torch.float32):
        raise TypeError(f"wkv_cuda takes u in {r.dtype} or f32, got {u.dtype}")
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled wkv config")
    lib = _lib()
    r, k, v, logw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, logw))
    if state is not None and state.data_ptr() % 16:
        state = state.clone()
    chunk = launch_chunk(config, s)
    o = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    hs = torch.empty((b, h, -(-s // chunk), hd, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.repro_wkv(
        chunk, hd, int(r.dtype == torch.bfloat16), int(u.dtype == torch.float32),
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), o.data_ptr(), s_out.data_ptr(), hs.data_ptr(), b, s, h,
        stream,
    )
    if err != 0:
        msg = lib.repro_wkv_error_string(err).decode()
        raise RuntimeError(f"wkv kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    return o, s_out
