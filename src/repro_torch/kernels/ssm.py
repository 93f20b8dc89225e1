"""Mamba selective scan for Hopper: the port of ``repro/kernels/ssm.py::ssm_scan_pallas``.

The kernels are CUDA C++ in ``csrc/ssm.cu``: per CTA ``block_d`` channels of
4 threads each (a thread holds N / 4 state indices in registers), once for
each time group of 8 steps of a chunk (``chunk`` / 8 groups run a chunk's
steps at once and fold their states in order), a ring of cp.async stages of
``chunk`` steps, and, where a long call's grid is under a third of a wave,
the sequence cut into segments across CTAs (``ssm_state_kernel`` over every
segment but the last, then ``ssm_output_kernel`` over all of them).  They are
built by ``_build.load`` and called through a plain C interface with two
entries:

  * :func:`ssm_cuda` — the TPU kernel's function: dtx (B, S, d) and dta
    (B, S, d, N) in, as ``ops.ssm_scan`` gives them;
  * :func:`ssm_cuda_fused` — the same function from x, dt (B, S, d) and
    a (d, N): the kernel forms dtx = dt * x and dta = dt * a in registers, so
    the (B, S, d, N) dta never reaches device memory (``ops.ssm_scan_fused``,
    the Hymba prefill's path).

This module also holds :class:`SsmConfig` (one compiled (block_d, chunk)
pair), :func:`config_space`, the segment rule :func:`ssm_segments` (and
:func:`launch_segments`, what a call on the card does), the plain versions
:func:`ssm_plain` and :func:`ssm_fused_plain`, and the launch counters.

Layout at the public functions is the reference's ``ops.ssm_scan``: dtx
(B, S, d), dta (B, S, d, N), b/c (B, S, N), state (B, d, N) or None, all
f32; they return (y (B, S, d) f32, final state (B, d, N) f32).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ._build import refuse_under_capture
from .ref import ssm_scan_ref

_BLOCK_DS = (8, 16, 32)  # csrc/ssm.cu REPRO_SSM_BLOCK_DS
_CHUNKS = (8, 16, 32)  # csrc/ssm.cu REPRO_SSM_CHUNKS
_STATES = (8, 16)  # csrc/ssm.cu REPRO_SSM_STATES: 16 is hymba-1.5b, 8 its reduced config
LANES = 4  # csrc/ssm.cu LANES: threads a channel
GROUP_STEPS = 8  # csrc/ssm.cu Ring::L: steps a time group takes of each chunk
H100_SMS = 132
ENTRIES = ("fused", "dta")


@dataclasses.dataclass(frozen=True, order=True)
class SsmConfig:
    """One deployable kernel instantiation: channels per CTA x steps per ring stage.

    ``block_d`` channels make one CTA, 4 threads a channel for each of the
    ``chunk`` / 8 time groups (:meth:`threads`); ``chunk`` steps make one stage
    of the CTA's cp.async ring, computed by those groups at once, and the unit
    segments are cut in.
    """

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

    def time_groups(self) -> int:
        """Groups of GROUP_STEPS steps a chunk is computed in at once (csrc/ssm.cu Ring::W)."""
        return self.chunk // GROUP_STEPS

    def threads(self) -> int:
        """Threads of one CTA: LANES a channel, for each time group."""
        return LANES * self.block_d * self.time_groups()

    def smem_bytes(self, n: int, fused: bool) -> int:
        """Dynamic shared memory of the output pass (csrc/ssm.cu Ring): STAGES stages of
        ``chunk`` steps of x/dtx (block_d floats), dt (block_d) or dta (block_d * N), b and
        c; then, with more than one time group, two buffers of every group's (P, E) pair."""
        stages, d_step = (3, self.block_d) if fused else (2, self.block_d * n)
        w = self.time_groups()
        pairs = 2 * w * 2 * self.block_d * n if w > 1 else 0
        return (stages * self.chunk * (self.block_d + d_step + 2 * n) + pairs) * 4


@functools.cache
def config_space() -> tuple[SsmConfig, ...]:
    """Every compiled (block_d, chunk) pair."""
    return tuple(SsmConfig(bd, c) for bd in _BLOCK_DS for c in _CHUNKS)


DEFAULT_SSM_CONFIG = SsmConfig(16, 32)

# Launch counters.  LAUNCHES: config name -> calls (one per call, whatever number of
# kernels it runs); ENTRY_LAUNCHES: calls per entry ("fused", "dta"); SEGMENTS_LAUNCHED:
# config name -> segments those calls ran.  The wrappers add to them per launch and nowhere
# else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}
ENTRY_LAUNCHES: dict[str, int] = {e: 0 for e in ENTRIES}
SEGMENTS_LAUNCHED: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for counts in (LAUNCHES, ENTRY_LAUNCHES, SEGMENTS_LAUNCHED):
        for key in counts:
            counts[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
# A call runs B x ceil(d / block_d) CTAs, each walking its channels through the whole
# sequence, chunk after chunk.  Where the call has SEG_CUT_CHUNKS chunks or more and that
# grid is under one wave of the CTAs the card holds at once, the sequence is cut into
# segments of at least SEG_MIN_CHUNKS whole chunks, one CTA each, until the grid fills the
# wave; a cut into fewer than SEG_MIN_CUT segments is not made.  A cut call is two launches
# and runs every segment but the last twice (state pass, output pass): on the H100 that
# costs more than it saves at the served lengths (scripts/ssm_segment_sweep.py, PERF.md).
SEG_CUT_CHUNKS = 12
SEG_MIN_CHUNKS = 2
SEG_MIN_CUT = 3


def segment_len(s: int, config: SsmConfig, segments: int) -> int:
    """Steps per segment (csrc/ssm.cu run): whole chunks, as even as they go."""
    n_chunks = -(-s // config.chunk)
    return -(-n_chunks // segments) * config.chunk


@functools.lru_cache(maxsize=4096)
def ssm_segments(b: int, s: int, d: int, config: SsmConfig, sm_count: int = H100_SMS, resident: int = 1) -> int:
    """How many segments a call of ``config`` cuts the sequence into (1: one launch).

    Only a call of at least SEG_CUT_CHUNKS chunks is cut.  The grid holds b x
    ceil(d / block_d) CTAs; a cut multiplies it by as much as one wave
    (``sm_count`` x ``resident``, the CTAs one SM holds) allows, keeping each
    segment at least SEG_MIN_CHUNKS chunks, and is made only into SEG_MIN_CUT
    segments or more.  The count is one the kernel's whole-chunk segments reach
    exactly (:func:`reachable_segments`).
    """
    n_chunks = -(-s // config.chunk)
    if n_chunks < SEG_CUT_CHUNKS:
        return 1
    ctas = b * -(-d // config.block_d)
    g = min(sm_count * resident // ctas, n_chunks // SEG_MIN_CHUNKS)
    return 1 if g < SEG_MIN_CUT else reachable_segments(s, config, g)


def reachable_segments(s: int, config: SsmConfig, segments: int) -> int:
    """The segments a cut into ``segments`` pieces of whole chunks gives: ceil(S /
    segment_len), at most ``segments``, none empty (the count csrc/ssm.cu takes)."""
    return -(-s // segment_len(s, config, segments))


def workspace_floats(b: int, d: int, n: int, segments: int) -> int:
    """f32 values of the workspace a cut call needs: each segment but the last's end
    state and decay product, (B, segments - 1, d, N) each."""
    return 2 * b * (segments - 1) * d * n


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def ssm_plain(dtx, dta, b, c, state=None):
    """What the kernel computes, in plain PyTorch: ``ref.ssm_scan_ref``, the
    sequential recurrence in f32."""
    return ssm_scan_ref(dtx, dta, b, c, state)


def ssm_fused_plain(x, dt, a, b, c, state=None):
    """What the fused entry computes: dtx = dt * x and dta = dt[..., None] * a
    (as ``models/mamba.py`` formed them for the dta entry), then :func:`ssm_plain`."""
    return ssm_plain(dt * x, dt[..., None] * a, b, c, state)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("ssm")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssm.argtypes = [i, i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, i, ptr]
    lib.repro_ssm.restype = i
    lib.repro_ssm_fused.argtypes = [i, i, i, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i, i, i, i, ptr]
    lib.repro_ssm_fused.restype = i
    lib.repro_ssm_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_ssm_configs.restype = i
    lib.repro_ssm_occupancy.argtypes = [i, i, i, i]
    lib.repro_ssm_occupancy.restype = i
    lib.repro_ssm_error_string.argtypes = [i]
    lib.repro_ssm_error_string.restype = ctypes.c_char_p
    compiled = compiled_configs(lib)
    want = [(c.block_d, c.chunk, n, c.threads(), c.smem_bytes(n, False), c.smem_bytes(n, True))
            for c in config_space() for n in _STATES]
    if compiled != want:
        raise RuntimeError(f"compiled ssm configs {compiled} != config space {want}")
    return lib


def compiled_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """(block_d, chunk, N, threads per CTA, smem of the dta entry, of the fused entry) of
    every instantiation the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (6 * 64))()
    n = lib.repro_ssm_configs(buf, 64)
    return [tuple(buf[6 * i : 6 * i + 6]) for i in range(n)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def resident_ctas(config: SsmConfig, n: int, fused: bool, index: int) -> int:
    """CTAs of the output pass of ``config`` one SM of CUDA device ``index`` holds at
    once (the occupancy calculator on the compiled kernel)."""
    with torch.cuda.device(index):
        got = _lib().repro_ssm_occupancy(config.block_d, config.chunk, n, int(fused))
    if got < 1:
        raise RuntimeError(f"ssm kernel {config.name()} (N {n}, fused {fused}): occupancy query failed ({got})")
    return got


def launch_segments(b: int, s: int, d: int, n: int, config: SsmConfig, fused: bool, index: int) -> int:
    """The segments an :func:`ssm_cuda` (``fused`` False) or :func:`ssm_cuda_fused` call
    launches on CUDA device ``index``: :func:`ssm_segments` under the device's SM count
    and the kernel's occupancy."""
    return ssm_segments(b, s, d, config, _sm_count(index), resident_ctas(config, n, fused, index))


@functools.cache
def workspace_bound(index: int) -> int:
    """f32 values the workspace of any cut call on CUDA device ``index`` may need.  A
    call is cut into at most sm_count x resident // ctas segments, with ctas = B x
    ceil(d / block_d), so its 2 B (segments - 1) d N values stay below 2 x sm_count x
    resident x block_d x N: the largest of these over the compiled configs."""
    return max(2 * _sm_count(index) * resident_ctas(c, n, fused, index) * c.block_d * n
               for c in config_space() for n in _STATES for fused in (False, True))


# (device index, stream) -> the f32 workspace of cut calls, one per stream so two streams
# never share it. The first allocation holds workspace_bound values, the most any call
# needs, and stays at one address; as the GEMM's, it is never allocated during a CUDA
# graph capture.
_WORKSPACE: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, floats: int) -> int:
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < floats:
        refuse_under_capture(f"the ssm workspace ({floats} floats)")
        ws = torch.empty(max(floats, workspace_bound(device.index)), dtype=torch.float32, device=device)
        _WORKSPACE[key] = ws
    return ws.data_ptr()


def _check(name: str, operands, n: int, config: SsmConfig) -> None:
    """Raise on anything the kernels do not take.  ``operands``: (tensor or None, the
    shape it must have) pairs, the first (B, S, d)."""
    bsz, s, d = operands[0][1]
    tensors = [t for t, _ in operands if t is not None]
    if any(tuple(t.shape) != shape for t, shape in operands if t is not None):
        raise ValueError(f"{name}: shapes do not match (B, S, d, N) = {(bsz, s, d, n)}: "
                         f"{[None if t is None else tuple(t.shape) for t, _ in operands]}")
    if n not in _STATES:
        raise ValueError(f"{name} is compiled for state sizes {_STATES}, not {n}")
    if min(bsz, s, d) == 0:
        raise ValueError(f"{name} needs non-empty dims, got (B, S, d) = {(bsz, s, d)}")
    if max(bsz, s, d) >= 2**31:
        raise ValueError(f"{name} takes dims below 2**31, got (B, S, d) = {(bsz, s, d)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes f32 operands, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} expects contiguous operands")
    if not config.is_valid():
        raise ValueError(f"{config} is not a compiled ssm config")
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device, got {[str(t.device) for t in tensors]}")


def _launch(entry: str, fn, seq, b, c, state, n, config):
    """Allocate, launch ``fn`` (repro_ssm or repro_ssm_fused) on the current stream, count."""
    x = seq[0]
    dev = x.device
    bsz, s, d = x.shape
    # The kernels copy 16 bytes at a time from 16-byte-aligned bases.
    seq = [t if t.data_ptr() % 16 == 0 else t.clone() for t in seq]
    b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (b, c))
    segments = launch_segments(bsz, s, d, n, config, entry == "fused", dev.index)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    s_out = torch.empty((bsz, d, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, workspace_floats(bsz, d, n, segments)) if segments > 1 else None
    err = fn(config.block_d, config.chunk, n, *(t.data_ptr() for t in seq), b.data_ptr(), c.data_ptr(),
             None if state is None else state.data_ptr(), y.data_ptr(), s_out.data_ptr(), ws, bsz, s, d,
             segments, stream)
    if err != 0:
        msg = _lib().repro_ssm_error_string(err).decode()
        raise RuntimeError(f"ssm kernel {config.name()} ({entry} entry, {segments} segments) failed to launch: "
                           f"cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    ENTRY_LAUNCHES[entry] += 1
    SEGMENTS_LAUNCHED[config.name()] += segments
    return y, s_out


def ssm_cuda(dtx, dta, b, c, state=None, config: SsmConfig = DEFAULT_SSM_CONFIG):
    """Selective scan through the CUDA kernels under ``config``, from dtx and dta.

    dtx: (B, S, d); dta: (B, S, d, N); b/c: (B, S, N); state: (B, d, N) or
    None (zeros).  All f32, contiguous, on one CUDA device, N in {8, 16}.
    Returns (y (B, S, d) f32, final state (B, d, N) f32).  Raises on anything
    the kernel does not take, and when a launch reports an error.  A call cut
    into :func:`launch_segments` > 1 segments uses the stream's workspace.
    """
    if dtx.ndim != 3 or dta.ndim != 4:
        raise ValueError(f"ssm_cuda expects dtx (B, S, d) and dta (B, S, d, N), "
                         f"got {tuple(dtx.shape)} and {tuple(dta.shape)}")
    bsz, s, d = dtx.shape
    n = dta.shape[3]
    _check("ssm_cuda", [(dtx, (bsz, s, d)), (dta, (bsz, s, d, n)), (b, (bsz, s, n)), (c, (bsz, s, n)),
                        (state, (bsz, d, n))], n, config)
    return _launch("dta", _lib().repro_ssm, [dtx, dta], b, c, state, n, config)


def ssm_cuda_fused(x, dt, a, b, c, state=None, config: SsmConfig = DEFAULT_SSM_CONFIG):
    """Selective scan through the CUDA kernels under ``config``, forming dt * x and
    dt * a in the kernel.

    x/dt: (B, S, d); a: (d, N); b/c: (B, S, N); state: (B, d, N) or None
    (zeros).  All f32, contiguous, on one CUDA device, N in {8, 16}.  Computes
    :func:`ssm_fused_plain`; returns (y (B, S, d) f32, final state (B, d, N)
    f32).  Raises as :func:`ssm_cuda` does.
    """
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"ssm_cuda_fused expects x (B, S, d) and a (d, N), "
                         f"got {tuple(x.shape)} and {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    _check("ssm_cuda_fused", [(x, (bsz, s, d)), (dt, (bsz, s, d)), (a, (d, n)), (b, (bsz, s, n)),
                              (c, (bsz, s, n)), (state, (bsz, d, n))], n, config)
    return _launch("fused", _lib().repro_ssm_fused, [x, dt, a], b, c, state, n, config)
