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
  * :func:`wkv_backward_cuda` — the VJP through ``csrc/wkv_bwd.cu``'s walk
    (one CTA a head walks its positions in reverse in blocks of up to 16 rows,
    carrying the state's gradient in registers and reading the forward's
    ``hs``; :func:`bwd_segment_len` cuts a head's chunks into segments where
    heads are few), and :func:`wkv_backward_plain`, the same function chunk by
    chunk in PyTorch;
  * ``LAUNCHES`` / ``BWD_LAUNCHES`` — per-config launch counters.

Layout at the public functions is the reference's: r/k/v/logw (B, S, H, hd),
u (H, hd), state (B, H, hd, hd) or None; they return (o (B, S, H, hd) f32,
final state f32), as ``ops.wkv`` does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import KernelLaunchError, launch_error
from .ref import wkv_backward_ref, wkv_ref

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

    def bwd_smem_bytes(self, hd: int) -> int:
        """Dynamic shared memory of the larger of the backward's two kernels
        (csrc/wkv_bwd.cu WalkSmem, BwdStateSmem).  The walk's: a ring of two
        stages of a block of m = min(chunk, 16) rows (r, k, v, logw, do and the
        block's start state, rows padded to hd + 4 floats), the state's
        gradient (or, at hd 16, the pair pass's dk partials), A's partials (a
        warp's at hd 64), k^, dA, D and four vectors; the same at every chunk
        from 16 on, since longer chunks are walked in blocks of 16."""
        L = self.chunk
        m, ps = min(L, 16), hd + 4
        stage = 5 * m * ps + hd * ps
        partials = 8 if hd == 64 else max(1, hd // 32)
        walk = 4 * (2 * stage + max(hd * ps, 256 * m) + partials * m * m + m * ps + m * m + m + 3 * hd + 256)
        kr = hd // 2 if hd > 16 else hd
        return max(walk, 4 * (2 * L * kr + L * hd + kr))

    def is_valid(self) -> bool:
        return self.chunk in _CHUNKS and all(max(self.smem_bytes(hd), self.bwd_smem_bytes(hd)) <= SMEM_LIMIT
                                             for hd in _HEAD_DIMS)


@functools.cache
def config_space() -> tuple[WkvConfig, ...]:
    """Every compiled chunk length."""
    out = tuple(WkvConfig(c) for c in _CHUNKS)
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_WKV_CONFIG = WkvConfig(16)

# Launch counters: config name -> calls.  wkv_cuda adds one to LAUNCHES per call
# (its two kernel launches), wkv_backward_cuda one to BWD_LAUNCHES per call (the
# walk, and the reverse pass where the call is cut into segments), and nowhere
# else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}
BWD_LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for key in counts:
            counts[key] = 0


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


def wkv_backward_plain(r, k, v, logw, u, state, do, ds_out, chunk: int, hs=None, s_final=None):
    """The WKV's VJP in plain PyTorch, by the algorithm of ``csrc/wkv_bwd.cu``
    (``ref.wkv_backward_ref``): (dr, dk, dv, dlogw, du, dstate) in their
    inputs' dtypes, dstate None without a state."""
    return wkv_backward_ref(r, k, v, logw, u, state, do, ds_out, chunk, hs, s_final)


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("wkv_bwd")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_wkv_bwd.argtypes = [i, i, i, i] + [ptr] * 17 + [i, i, i, i, ptr]
    lib.repro_wkv_bwd.restype = i
    lib.repro_wkv_bwd_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_wkv_bwd_configs.restype = i
    lib.repro_wkv_bwd_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.repro_wkv_bwd_occupancy.restype = i
    lib.repro_wkv_bwd_error_string.argtypes = [i]
    lib.repro_wkv_bwd_error_string.restype = ctypes.c_char_p
    compiled = compiled_bwd_configs(lib)
    want = [(c, hd, WkvConfig(c).bwd_smem_bytes(hd)) for c in _CHUNKS for hd in _HEAD_DIMS]
    if compiled != want:
        raise RuntimeError(f"compiled wkv backward configs {compiled} != config space {want}")
    return lib


def compiled_bwd_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(chunk, hd, smem bytes) of every instantiation the backward's library holds."""
    lib = lib or _bwd_lib()
    buf = (ctypes.c_int * (3 * 64))()
    n = lib.repro_wkv_bwd_configs(buf, 64)
    return [tuple(buf[3 * i : 3 * i + 3]) for i in range(n)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def bwd_residency(config: WkvConfig, hd: int, index: int, bf16: bool = False, u_f32: bool = True) -> dict[str, int]:
    """The compiled backward walk of ``config`` at head dim ``hd`` (r/k/v bf16 or
    f32, u f32 or in r's type) on CUDA device ``index``: the CTAs one SM holds at
    once (``ctas``), registers a thread (``registers``) and spilled bytes a
    thread (``local_bytes``), from the occupancy calculator and the function's
    attributes."""
    regs = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        got = _bwd_lib().repro_wkv_bwd_occupancy(config.chunk, hd, int(bf16), int(u_f32), regs)
    if got < 1:
        raise KernelLaunchError(f"wkv backward {config.name()} (hd {hd}): occupancy query failed ({got})")
    return {"ctas": got, "registers": regs[0], "local_bytes": regs[1]}


def bwd_segment_len(bh: int, n_chunks: int, sm_count: int, resident: int) -> int:
    """Chunks a segment of the backward walk: all of a head's (one segment, one
    kernel) where its B·H CTAs fill the card's CTA slots (``sm_count`` ×
    ``resident``); else the chunks cut into as many segments as the slots hold
    copies of the B·H heads, so every slot gets a CTA (the reverse pass then
    writes the state's gradient at the segments' ends)."""
    slots = sm_count * resident
    n_seg = min(n_chunks, slots // bh) if bh < slots else 1
    return -(-n_chunks // max(1, n_seg))


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


def _check(name, r, k, v, logw, u, state, config: WkvConfig) -> None:
    """Raise on anything the kernels do not take."""
    dev = r.device
    tensors = (r, k, v, logw, u) + ((state,) if state is not None else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got {[str(t.device) for t in tensors]}")
    if r.ndim != 4:
        raise ValueError(f"{name} expects r/k/v/logw of shape (B, S, H, hd), got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r/k/v/logw shapes differ: {[tuple(t.shape) for t in (r, k, v, logw)]}")
    if tuple(u.shape) != (h, hd) or (state is not None and tuple(state.shape) != (b, h, hd, hd)):
        raise ValueError(f"u {tuple(u.shape)} / state {None if state is None else tuple(state.shape)} "
                         f"do not match (B, S, H, hd) = {(b, s, h, hd)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name} is compiled for head dims {_HEAD_DIMS}, not {hd}")
    if min(b, s, h) == 0:
        raise ValueError(f"{name} needs non-empty dims, got (B, S, H) = {(b, s, h)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} expects contiguous operands")
    if r.dtype not in (torch.bfloat16, torch.float32) or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"{name} takes r/k/v in one of bf16/f32, got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or (state is not None and state.dtype != torch.float32):
        raise TypeError(f"{name} takes logw and the state in f32")
    if u.dtype not in (r.dtype, torch.float32):
        raise TypeError(f"{name} takes u in {r.dtype} or f32, got {u.dtype}")
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled wkv config")


def wkv_cuda(r, k, v, logw, u, state=None, config: WkvConfig = DEFAULT_WKV_CONFIG, keep_states: bool = False):
    """Chunked WKV through the CUDA kernel under ``config``.

    r/k/v: (B, S, H, hd) bf16 or f32, one dtype; logw: (B, S, H, hd) f32;
    u: (H, hd) in r's dtype or f32; state: (B, H, hd, hd) f32 or None
    (zeros).  All contiguous, on one CUDA device, hd in {16, 64}.  Returns
    (o (B, S, H, hd) f32, final state (B, H, hd, hd) f32), and with
    ``keep_states`` the workspace ``hs`` too, the backward's input.  Raises on
    anything the kernel does not take, and when either launch reports an error.

    Each call allocates the workspace ``hs`` (:func:`workspace_bytes`) with
    ``torch.empty`` and launches the state pass, then the output kernel, on
    the current stream, with no host sync.  Both read r/k/v/logw (and the
    state) in 16-byte pieces, so one of them whose base is not 16-byte
    aligned is copied to a fresh tensor first.
    """
    _check("wkv_cuda", r, k, v, logw, u, state, config)
    b, s, h, hd = r.shape
    dev = r.device
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
        raise launch_error(err, f"wkv kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    return (o, s_out, hs) if keep_states else (o, s_out)


def wkv_backward_cuda(r, k, v, logw, u, state, do, ds_out, config: WkvConfig = DEFAULT_WKV_CONFIG, states=None):
    """The WKV's VJP through ``csrc/wkv_bwd.cu`` under ``config`` (the forward's).

    Operands as :func:`wkv_cuda` takes them; ``do`` (B, S, H, hd) f32 and
    ``ds_out`` (B, H, hd, hd) f32 or None are the cotangents of the output and
    the final state; ``states`` the forward's (hs, final state) at ``config``,
    or None: then :func:`wkv_cuda` runs once more to make them.  Returns (dr,
    dk, dv, dlogw, du, dstate) in their inputs' dtypes, dstate None without a
    state.  Raises on anything the kernels do not take, and when a launch
    reports an error.

    Each call allocates its outputs and du's partials (B, H, segments, hd),
    launches the walk (one CTA a head and segment) on the current stream, and
    sums the partials over B and the segments (``torch.sum``, a fixed order),
    with no host sync.  The segments are :func:`bwd_segment_len`'s under the
    device's SM count and the walk's residency; with more than one, the
    reverse pass runs first and writes the state's gradient at the segments'
    ends into a workspace (B, H, segments - 1, hd, hd).  A chunk of 64 or 128
    also takes a workspace of its blocks' start states (B, H, segments,
    chunk / 16 - 2, hd, hd).  Inputs whose base is not 16-byte aligned are
    copied first (the walk reads them in 16-byte pieces).
    """
    return _backward(r, k, v, logw, u, state, do, ds_out, config, states)


def _backward(r, k, v, logw, u, state, do, ds_out, config: WkvConfig, states, seg_len: int | None = None):
    """:func:`wkv_backward_cuda` with ``seg_len`` chunks a segment, or
    :func:`bwd_segment_len`'s where None (any value from 1 to the chunks a head
    holds gives the same function)."""
    _check("wkv_backward_cuda", r, k, v, logw, u, state, config)
    b, s, h, hd = r.shape
    dev = r.device
    chunk = launch_chunk(config, s)
    n = -(-s // chunk)
    if seg_len is None:
        res = bwd_residency(WkvConfig(chunk), hd, dev.index, r.dtype == torch.bfloat16, u.dtype == torch.float32)
        seg_len = bwd_segment_len(b * h, n, _sm_count(dev.index), res["ctas"])
    if not 1 <= seg_len <= n:
        raise ValueError(f"wkv_backward_cuda: segment length {seg_len} outside 1 .. {n}")
    if states is None:
        _, s_fin, hs = wkv_cuda(r, k, v, logw, u, state, config, keep_states=True)
    else:
        hs, s_fin = states
    want = {"do": (do, (b, s, h, hd)), "ds_out": (ds_out, (b, h, hd, hd)), "hs": (hs, (b, h, n, hd, hd)),
            "final state": (s_fin, (b, h, hd, hd))}
    for what, (t, shape) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"wkv_backward_cuda: {what} must be a contiguous f32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _bwd_lib()
    r, k, v, logw, do, hs = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, logw, do, hs))
    n_seg = -(-n // seg_len)
    blocks = chunk // min(chunk, 16)
    dsw = torch.empty((b, h, n_seg - 1, hd, hd), dtype=torch.float32, device=dev) if n_seg > 1 else None
    ws = torch.empty((b, h, n_seg, blocks - 2, hd, hd), dtype=torch.float32, device=dev) if blocks > 2 else None
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    du_part = torch.empty((b, h, n_seg, hd), dtype=torch.float32, device=dev)
    dstate = None if state is None else torch.empty_like(state)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.repro_wkv_bwd(
        chunk, hd, int(r.dtype == torch.bfloat16), int(u.dtype == torch.float32),
        *(ptr(t) for t in (r, k, v, logw, u, do, ds_out, hs, s_fin, dsw, ws, dr, dk, dv, dlogw, du_part, dstate)),
        b, s, h, seg_len, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.repro_wkv_bwd_error_string(err).decode()
        raise launch_error(err, f"wkv backward kernel {config.name()} failed to launch: cudaError {err} ({msg})")
    BWD_LAUNCHES[config.name()] += 1
    du = du_part.sum(dim=(0, 2)).to(u.dtype)
    return dr, dk, dv, dlogw, du, dstate
