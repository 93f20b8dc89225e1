"""Flash attention for Hopper: the port of ``repro/kernels/attention.py::flash_attention_pallas``.

The kernel itself is CUDA C++ in ``csrc/attention.cu``, built by
``_build.load`` and called through a plain C interface.  bf16 inputs take a
TMA ring fed by a producer into ``wgmma`` consumer warpgroups (``block_q`` 64
and 128) or ``mma.sync`` warps (``block_q`` 32), with the KV blocks split
across CTAs (flash-decoding) wherever the grid is under the card; f32 inputs
take a full-f32 SIMT path.  This module holds:

  * :class:`AttentionConfig` — one compiled instantiation: ``block_q`` query
    rows per CTA (16 per warp) and ``block_kv`` key/value rows per inner step.
    The field names, ``name()`` form and ``to_dict``/``from_dict`` are the
    reference's; the values are Hopper's (shared memory and warps), not the
    TPU's VMEM tiles;
  * :func:`config_space` — exactly the compiled set, checked when the library
    loads;
  * :func:`kv_splits` — how many KV splits a bf16 call launches, and
    :func:`kv_ranges`, the columns of each split as the kernel computes them;
  * :func:`attention_cuda` — the wrapper: checks, picks the split, allocates,
    launches, counts;
  * :func:`attention_plain` — the plain PyTorch version, for CPU tensors and
    for holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters; ``PATH_LAUNCHES`` — the same
    launches by kernel path (``wgmma``, ``mma_sync``, ``simt_f32``), and under
    ``split`` those of them that split KV; ``SPLITS_LAUNCHED`` — the KV
    splits those launches ran, per config.

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

from ._build import KernelLaunchError, launch_error, refuse_under_capture
from .ref import flash_attention_ref

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 CTA may use (227 KB)
H100_SMS = 132

# The compiled configs; csrc/attention.cu REPRO_ATTENTION_CONFIGS and
# REPRO_ATTENTION_HEAD_DIMS list the same set, checked when the library loads.
_BLOCK_Q = (32, 64, 128)  # 2, 4 or 8 warps of 16 query rows
_BLOCK_KV = (32, 64, 128)
_HEAD_DIMS = (64, 128)  # hymba-1.5b, granite-8b
# Kernel paths: the bf16 TMA kernel's wgmma consumers (block_q 64, 128) or mma.sync
# consumers (block_q 32), the f32 SIMT kernel; "split" counts the bf16 launches that
# split KV across CTAs (each is also counted under its consumers' path).
PATHS = ("wgmma", "mma_sync", "simt_f32", "split")


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

    def bf16_path(self) -> str:
        """The consumers of the bf16 kernel: wgmma warpgroups of 64 rows, or mma.sync warps."""
        return "wgmma" if self.block_q >= 64 else "mma_sync"

    def threads(self, path: str) -> int:
        """Threads of one CTA on ``path`` (csrc/attention.cu TmaTile, F32Tile): a warp per 16
        query rows, plus on the bf16 path a producer warpgroup (wgmma) or warp (mma.sync)."""
        if path == "simt_f32":
            return self.block_q // 16 * 32
        return 2 * self.block_q + (128 if self.bf16_path() == "wgmma" else 32)

    def _tma_smem(self, hd: int, stages: int) -> int:
        # 1 KB of alignment slack, Q, `stages` of K and V, a Q barrier, a full and an empty
        # barrier per stage, the split flag.
        return 1024 + self.block_q * hd * 2 + stages * 4 * self.block_kv * hd + (2 * stages + 1) * 8 + 16

    def stages(self, hd: int) -> int:
        """Depth of the bf16 kernel's K/V ring: 3 where they fit, else 2 (TmaTile::STAGES)."""
        return 3 if self._tma_smem(hd, 3) <= SMEM_LIMIT else 2

    def smem_bytes(self, hd: int, path: str) -> int:
        """Dynamic shared memory one CTA needs on ``path`` (csrc/attention.cu TmaTile, F32Tile)."""
        if path == "simt_f32":  # Q, and one stage of K and V with rows padded by one
            return (self.block_q * hd + 2 * self.block_kv * (hd + 1)) * 4
        return self._tma_smem(hd, self.stages(hd))

    def is_valid(self) -> bool:
        if self.block_q not in _BLOCK_Q or self.block_kv not in _BLOCK_KV:
            return False  # only compiled configs can launch
        return all(self.smem_bytes(hd, p) <= SMEM_LIMIT for hd in _HEAD_DIMS for p in (self.bf16_path(), "simt_f32"))


@functools.cache
def config_space() -> tuple[AttentionConfig, ...]:
    """Every compiled (block_q, block_kv) pair."""
    out = tuple(AttentionConfig(bq, bkv) for bq, bkv in itertools.product(_BLOCK_Q, _BLOCK_KV))
    assert all(c.is_valid() for c in out)
    return out


DEFAULT_ATTN_CONFIG = AttentionConfig(block_q=64, block_kv=64)

# Launch counters: config name -> launches, path -> launches, config name -> KV splits
# run by its split launches.  attention_cuda adds to them once per kernel launch and
# nowhere else; callers reset with reset_launches().
LAUNCHES: dict[str, int] = {c.name(): 0 for c in config_space()}
PATH_LAUNCHES: dict[str, int] = {p: 0 for p in PATHS}
SPLITS_LAUNCHED: dict[str, int] = {c.name(): 0 for c in config_space()}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES, SPLITS_LAUNCHED):
        for key in counts:
            counts[key] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


# ---------------------------------------------------------------------------
# split-KV
# ---------------------------------------------------------------------------
# Split targets, from scripts/attn_split_sweep.py on the H100 (PERF.md): a decode step is
# bound by the bytes of K and V, and it streams them at the card's rate once each SM holds
# SPLIT_INFLIGHT_BYTES of K/V ring (a CTA's 2-3 stages; more CTAs of a small ring) and the
# grid fits in one wave of those CTAs: a split count past the wave runs a second, nearly
# empty one. So KV is split until the grid fills that wave, and never into splits of fewer
# than SPLIT_MIN_BLOCKS blocks.
SPLIT_INFLIGHT_BYTES = 64 * 1024
SPLIT_MIN_BLOCKS = 4


def kv_blocks(q0: int, sq: int, skv: int, config: AttentionConfig, causal: bool) -> int:
    """KV blocks the query block [q0, q0 + block_q) needs (csrc/attention.cu kv_blocks):
    all of them, or under the causal mask those up to the last column its last live row
    sees (0 when that row sees none)."""
    n = -(-skv // config.block_kv)
    if causal:
        last_col = min(q0 + config.block_q, sq) - 1 + skv - sq
        n = 0 if last_col < 0 else min(n, last_col // config.block_kv + 1)
    return n


def split_target(config: AttentionConfig, hd: int, sm_count: int = H100_SMS, resident: int = 1) -> int:
    """CTAs of ``config`` at head dim ``hd`` the card should run at once for a split call:
    per SM, as many as hold SPLIT_INFLIGHT_BYTES of K/V ring, at least one and at most the
    ``resident`` CTAs one SM can hold (the occupancy of the compiled kernel)."""
    ring = config.stages(hd) * 4 * config.block_kv * hd
    return sm_count * max(1, min(resident, -(-SPLIT_INFLIGHT_BYTES // ring)))


@functools.lru_cache(maxsize=4096)
def kv_splits(bh: int, sq: int, skv: int, config: AttentionConfig, causal: bool = True,
              sm_count: int = H100_SMS, hd: int = 128, resident: int = 1) -> int:
    """How many KV splits a bf16 call of ``config`` launches along ``blockIdx.z``.

    The grid holds ceil(sq / block_q) x bh CTAs before the split; the split
    multiplies it by as much as :func:`split_target` allows (one wave), so one
    when the grid already fills half the target or more.  As far as the
    blocks allow: every query block that sees a column gets at least
    SPLIT_MIN_BLOCKS blocks a split, so no split of such a block is empty (the
    kernel splits a query block's :func:`kv_blocks` as evenly as they go,
    :func:`kv_ranges`).
    """
    ctas = -(-sq // config.block_q) * bh
    want = split_target(config, hd, sm_count, resident) // ctas
    if want < 2:
        return 1
    # The lightest query block that sees a column limits the split: under the causal
    # mask the first such block, else any.
    fewest = min((n for q0 in range(0, sq, config.block_q) if (n := kv_blocks(q0, sq, skv, config, causal))),
                 default=0)
    return max(1, min(want, fewest // SPLIT_MIN_BLOCKS))


def kv_ranges(q0: int, sq: int, skv: int, config: AttentionConfig, causal: bool, splits: int) -> list[tuple[int, int]]:
    """The [start, stop) columns each split of the query block at ``q0`` covers, as
    csrc/attention.cu computes them: split z takes blocks [n z / splits, n (z + 1) / splits)
    of the n that :func:`kv_blocks` names, the last ending at skv."""
    n = kv_blocks(q0, sq, skv, config, causal)
    bkv = config.block_kv
    return [(n * z // splits * bkv, min(skv, n * (z + 1) // splits * bkv)) for z in range(splits)]


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
    lib.repro_attention.argtypes = [i, i, i, i, ptr, ptr, ptr, ptr, i, i, i, ctypes.c_float, i, i, ptr, ptr, ptr]
    lib.repro_attention.restype = i
    lib.repro_attention_configs.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_attention_configs.restype = i
    lib.repro_attention_occupancy.argtypes = [i, i, i]
    lib.repro_attention_occupancy.restype = i
    lib.repro_attention_error_string.argtypes = [i]
    lib.repro_attention_error_string.restype = ctypes.c_char_p
    compiled = compiled_configs(lib)
    want = [config_row(c, hd) for c in config_space() for hd in _HEAD_DIMS]
    if compiled != want:
        raise RuntimeError(f"compiled attention configs {compiled} != config space {want}")
    return lib


def config_row(config: AttentionConfig, hd: int) -> tuple[int, ...]:
    """(block_q, block_kv, hd, bf16 threads, bf16 stages, bf16 smem, f32 threads, f32 smem):
    what ``repro_attention_configs`` reports for one instantiation."""
    path = config.bf16_path()
    return (config.block_q, config.block_kv, hd, config.threads(path), config.stages(hd),
            config.smem_bytes(hd, path), config.threads("simt_f32"), config.smem_bytes(hd, "simt_f32"))


def compiled_configs(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """:func:`config_row` of every instantiation the library holds."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (8 * 64))()
    n = lib.repro_attention_configs(buf, 64)
    return [tuple(buf[8 * i : 8 * i + 8]) for i in range(n)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def resident_ctas(config: AttentionConfig, hd: int, index: int) -> int:
    """CTAs of the bf16 kernel of ``config`` one SM of CUDA device ``index`` holds at once
    (the occupancy calculator on the compiled kernel)."""
    with torch.cuda.device(index):
        n = _lib().repro_attention_occupancy(config.block_q, config.block_kv, hd)
    if n < 1:
        raise KernelLaunchError(f"attention kernel {config.name()} at head dim {hd}: occupancy query failed ({n})")
    return n


def launch_splits(bh: int, sq: int, skv: int, d: int, config: AttentionConfig, causal: bool, index: int) -> int:
    """The KV splits a bf16 :func:`attention_cuda` call launches on CUDA device ``index``:
    :func:`kv_splits` under the device's SM count and the kernel's occupancy."""
    return kv_splits(bh, sq, skv, config, causal, _sm_count(index), d, resident_ctas(config, d, index))


# (device index, stream) -> (f32 workspace, int32 per-(query block, head) counters). One
# pair per stream, so two streams never share partials or counters.  A split call runs at
# most split_target CTAs, each with a slot of block_q x (hd + 8) floats, and has at most
# half as many (query block, head) counters.  The first allocation holds the most any
# config needs on an H100 (whose occupancy caps the target at 3 x 132 CTAs of the smallest
# slots; 132 of the largest) and stays at one address; a card with more SMs would grow it.
# The kernel leaves every counter at 0. As the GEMM's, it is never allocated during a CUDA
# graph capture.
WORKSPACE_FLOATS = max(split_target(c, hd, H100_SMS, 64) * c.block_q * (hd + 8)
                       for c in config_space() for hd in _HEAD_DIMS)
WORKSPACE_COUNTERS = max(split_target(c, hd, H100_SMS, 64) for c in config_space() for hd in _HEAD_DIMS) // 2
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int, tiles: int) -> tuple[int, int]:
    key = (device.index, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < tiles:
        refuse_under_capture("the attention split-KV workspace")
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, WORKSPACE_FLOATS), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, WORKSPACE_COUNTERS), dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


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
    bf16 takes the TMA kernel (``wgmma`` or ``mma.sync`` by ``block_q``) with
    :func:`kv_splits` splits, f32 the SIMT kernel.  Returns (..., sq, d) in
    q's dtype.  Raises on anything the kernel does not take, and when the
    launch reports an error.
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
    # The raw handle: torch.cuda.current_stream() builds a Stream object, ~5 us a call.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    splits, ws, counters = 1, None, None
    if q.dtype == torch.bfloat16:
        path = config.bf16_path()
        splits = launch_splits(bh, sq, skv, d, config, causal, dev.index)
        if splits > 1:
            tiles = -(-sq // config.block_q) * bh
            ws, counters = _workspace(dev, stream, tiles * splits * config.block_q * (d + 8), tiles)
    else:
        path = "simt_f32"
    err = lib.repro_attention(
        config.block_q, config.block_kv, d, int(path == "simt_f32"), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), bh, sq, skv, float(scale), int(causal), splits, ws, counters, stream,
    )
    if err != 0:
        msg = lib.repro_attention_error_string(err).decode()
        raise launch_error(err, f"attention kernel {config.name()} ({path}) failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    PATH_LAUNCHES[path] += 1
    if splits > 1:
        PATH_LAUNCHES["split"] += 1
        SPLITS_LAUNCHED[config.name()] += splits
    return out
