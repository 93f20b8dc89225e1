"""Tiled GEMM for Hopper: the port of ``repro/kernels/matmul.py::matmul_pallas``.

The kernel itself is CUDA C++ in ``csrc/matmul.cu``, built by ``_build.load``
and called through a plain C interface:

  * bf16 inputs: a TMA ring fed by a producer warp into ``wgmma`` (64- and
    128-row tiles) or ``mma.sync`` (16- and 32-row tiles), with in-kernel
    split-k; for the compute-bound calls (:func:`uses_persistent`) a
    persistent, warp-specialised kernel in clusters of 2 that multicast B;
    a ``cp.async`` kernel for shapes TMA cannot take.  The TMA kernels read
    a transposed operand in place (an ``lhs.t()`` or ``rhs.t()`` view of a
    row-major tensor: the backward's operands); the other paths copy it
    (``TRANSPOSE_COPIES``);
  * f32 inputs (the training path): full-f32 FFMA, no TF32, bound by the
    card's 67 TFLOP/s of FP32 operations.  A ring of 3-4 ``cp.async`` stages
    of A and B tiles (:meth:`MatmulConfig.f32_stages`), A kept m-major and
    read as ``float4`` along k (a broadcast within each quarter-warp, so no
    bank conflict), warp-tiled register micro-tiles of contiguous 4-wide
    fragments (8 x 8 a thread at 128 x 128, one ``LDS.128`` per 16 FFMA), and
    in-kernel split-k along ``blockIdx.z`` through the bf16 path's ordered
    epilogue, as :func:`split_k_f32` says.

This module holds:

  * :class:`MatmulConfig` — one compiled instantiation: a ``(block_m, block_n,
    block_k)`` CTA tile and an ``order`` that picks which of M/N tiles runs
    fastest (``mnk``: n tiles, so CTAs that share an A row-block launch
    together; ``nmk``: m tiles, sharing a B column-block; the bf16 kernels
    walk the fast axis in bands of 8 tiles);
  * :func:`config_space` — exactly the compiled set, each under both orders;
  * :func:`split_k` — how many k splits a bf16 call launches,
    :func:`split_k_f32` its f32 counterpart, and :func:`k_ranges`, the k
    range of each split as the kernel computes it;
  * :func:`f32_limit` — the tolerance of an f32 GEMM against another f32
    sum of the same terms, by reduction length;
  * :func:`matmul_cuda` — the wrapper: checks, picks the path, allocates,
    launches, counts;
  * :func:`matmul_plain` — the plain PyTorch version, for CPU tensors and for
    holding the kernel to account on the card;
  * ``LAUNCHES`` — per-config launch counters, ``PATH_LAUNCHES`` — the
    same launches per kernel path (``tma``, ``cp_async``, ``simt_f32``),
    ``SPLIT_LAUNCHES`` — those of them that split k, per path,
    ``TMA_KERNEL_LAUNCHES`` — the ``tma`` launches by kernel (``ring``,
    ``persistent``), ``TRANSPOSED_READS`` — TMA launches that read an
    operand transposed in place, and ``TRANSPOSE_COPIES`` — the transposed
    operands copied, per path.
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
RING_BUDGET = 110 * 1024  # TMA and f32 ring bytes per CTA, so two CTAs share an SM (kRingBudget)
WIDE_RING_BUDGET = 200 * 1024  # the TMA ring of a 128 x 256 tile, one CTA an SM (kWideRingBudget)
MAX_TMA_STAGES = 8  # kMaxTmaStages
F32_STAGES = (3, 4)  # the f32 ring's depth within RING_BUDGET (kMinF32Stages, kMaxF32Stages)
H100_SMS = 132

# The compiled (block_m, block_n, block_k) tiles; csrc/matmul.cu
# REPRO_MATMUL_TILES lists the same set, checked when the library loads.
_TILES = (
    (16, 64, 128),
    (16, 128, 64),
    (32, 64, 64),
    (64, 128, 32),
    (128, 128, 32),
    (128, 256, 64),
)
# The tile a config's cp.async and f32 launches run, where it is not its own: a 128 x 256
# register tile fits a thread of neither kernel (csrc/matmul.cu REPRO_MATMUL_TILES).
_PATH_TILES = {(128, 256, 64): (128, 128, 32)}
# The tiles of the persistent kernel (csrc/matmul.cu REPRO_MATMUL_PERSISTENT_TILES) and
# its shared memory: the ring beside each consumer warp's epilogue staging (kEpiWarpBytes),
# one CTA an SM (kMaxPersistStages).
PERSISTENT_TILES = ((128, 128, 32), (128, 256, 64))
EPI_WARP_BYTES = 16 * 160
MAX_PERSISTENT_STAGES = 8
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

    def tile(self) -> tuple[int, int, int]:
        return self.block_m, self.block_n, self.block_k

    def on_path(self, path: str) -> "MatmulConfig":
        """The config whose tile ``path``'s launches of this config run: itself on the
        TMA path (ring or persistent), and on the others unless ``_PATH_TILES`` names
        another tile."""
        if path not in ("cp_async", "simt_f32") or self.tile() not in _PATH_TILES:
            return self
        return MatmulConfig(*_PATH_TILES[self.tile()], self.order)

    def tma_stages(self) -> int:
        """Depth of the TMA ring (csrc/matmul.cu TmaTile::STAGES)."""
        stage = (self.block_m * self.block_k + self.block_k * self.block_n) * 2
        budget = WIDE_RING_BUDGET if self.block_m * self.block_n >= 128 * 256 else RING_BUDGET
        return min(MAX_TMA_STAGES, budget // stage)

    def f32_stages(self) -> int:
        """Depth of the f32 kernel's cp.async ring at this config's f32 tile (csrc/matmul.cu F32Tile::STAGES)."""
        c = self.on_path("simt_f32")
        stage = (c.block_m * c.block_k + c.block_k * c.block_n) * 4
        return max(F32_STAGES[0], min(F32_STAGES[1], RING_BUDGET // stage))

    def persistent_stage_k(self) -> int:
        """k a stage of the persistent kernel holds (csrc/matmul.cu PersistTile::SK): at
        least 64, so a 32-deep tile's stage holds two of its k steps."""
        return max(self.block_k, 64)

    def persistent_stages(self) -> int:
        """Depth of the persistent kernel's ring (csrc/matmul.cu PersistTile::STAGES)."""
        sk = self.persistent_stage_k()
        stage = (self.block_m * sk + sk * self.block_n) * 2
        epi = (self.block_m // 64) * 4 * EPI_WARP_BYTES
        return min(MAX_PERSISTENT_STAGES, (SMEM_LIMIT - 1024 - epi - 256) // stage)

    def smem_bytes(self, path: str = "tma") -> int:
        """Dynamic shared memory one CTA needs on ``path`` (csrc/matmul.cu TmaTile,
        Bf16Tile, F32Tile at the path's tile; ``persistent``: PersistTile)."""
        c = self.on_path(path)
        bm, bn, bk = c.block_m, c.block_n, c.block_k
        if path == "simt_f32":
            return self.f32_stages() * (bm * bk + bk * bn) * 4
        if path == "cp_async":
            return CP_ASYNC_STAGES * (bm * (bk + 8) + bk * (bn + 8)) * 2
        if path == "persistent":
            # 1 KB of alignment slack, the ring, the epilogue's staging, a full and an empty mbarrier a stage.
            stages, sk = self.persistent_stages(), self.persistent_stage_k()
            return 1024 + stages * (bm * sk + sk * bn) * 2 + (bm // 64) * 4 * EPI_WARP_BYTES + 2 * stages * 8
        # 1 KB of alignment slack, the ring, a full and an empty mbarrier per stage, a flag.
        stages = self.tma_stages()
        return 1024 + stages * (bm * bk + bk * bn) * 2 + 2 * stages * 8 + 16

    def is_valid(self) -> bool:
        if self.order not in _ORDERS:
            return False
        if (self.block_m, self.block_n, self.block_k) not in _TILES:
            return False  # only compiled tiles can launch
        paths = PATHS + (("persistent",) if self.tile() in PERSISTENT_TILES else ())
        return max(self.smem_bytes(p) for p in paths) <= SMEM_LIMIT


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
# TMA cannot take) and the f32 kernel.
PATH_LAUNCHES: dict[str, int] = {p: 0 for p in PATHS}
# Of those, the launches that split k (more than one CTA along blockIdx.z), per path.
SPLIT_LAUNCHES: dict[str, int] = {p: 0 for p in PATHS}
# The tma launches by kernel: the ring kernel (split-k, one tile row, the small tiles)
# and the persistent one (uses_persistent).
TMA_KERNEL_LAUNCHES: dict[str, int] = {"ring": 0, "persistent": 0}
# The tma launches that read an operand transposed where it lies ("lhs", "rhs"), and the
# transposed operands copied to row-major before a launch, per path (the cp.async and
# f32 kernels read row-major operands only).
TRANSPOSED_READS: dict[str, int] = {"lhs": 0, "rhs": 0}
TRANSPOSE_COPIES: dict[str, int] = {p: 0 for p in PATHS}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES, SPLIT_LAUNCHES, TMA_KERNEL_LAUNCHES, TRANSPOSED_READS, TRANSPOSE_COPIES):
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


# The f32 kernel is bound by operations, so its grid should keep every SM's FP32 pipes
# busy: it splits only an (m, n) grid smaller than the card, and into at most one split
# per F32_SPLIT_MIN_STEPS k steps (each split costs a partial tile's round trip through
# L2 and a ring fill). Its ring lets F32_CTAS_PER_SM CTAs share an SM.
F32_SPLIT_MIN_STEPS = 8
F32_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=4096)
def split_k_f32(m: int, n: int, k: int, config: MatmulConfig, sm_count: int = H100_SMS) -> int:
    """How many splits of k an f32 call of ``config`` launches along ``blockIdx.z``.

    One when the (m, n) grid of output tiles holds ``sm_count`` tiles.
    Otherwise, of the counts up to one split per F32_SPLIT_MIN_STEPS k steps
    and F32_CTAS_PER_SM CTAs an SM, the one whose grid fills the largest
    share of the SMs in its last wave (tiles x splits over sm_count x waves),
    the larger count on a tie: it sums fewer terms a thread and has more
    warps an SM.  Each count is normalised as :func:`split_k`'s, so no split
    is empty.
    """
    tiles = -(-m // config.block_m) * -(-n // config.block_n)
    if tiles >= sm_count:
        return 1
    steps = -(-k // config.block_k)
    cap = min(max(1, steps // F32_SPLIT_MIN_STEPS), F32_CTAS_PER_SM * sm_count // tiles)
    best, best_fill = 1, 0.0
    for want in range(1, cap + 1):
        splits = -(-steps // -(-steps // want))
        ctas = tiles * splits
        fill = ctas / (sm_count * -(-ctas // sm_count))
        if fill >= best_fill:
            best, best_fill = splits, fill
    return best


def uses_persistent(m: int, n: int, k: int, config: MatmulConfig, sm_count: int = H100_SMS) -> bool:
    """Whether a TMA-path bf16 call of ``config`` runs the persistent kernel: a tile it
    compiles, one split (:func:`split_k`), and more than one tile row, so that a
    cluster's two CTAs have a tile each (the ring kernel keeps the decode and
    single-row calls, where its 64-row slabs and split-k matter)."""
    return (config.tile() in PERSISTENT_TILES and m > config.block_m
            and split_k(m, n, k, config, sm_count) == 1)


def k_ranges(k: int, block_k: int, splits: int) -> list[tuple[int, int]]:
    """The [start, stop) range of k that each split sums, as csrc/matmul.cu
    ``split_range`` computes it: whole ``block_k`` steps, the last split
    ending at k."""
    steps = -(-k // block_k)
    per = -(-steps // splits)
    return [(z * per * block_k, min(k, (z + 1) * per * block_k)) for z in range(splits)]


# An f32 GEMM against another f32 sum of the same K terms (the plain version, or the
# kernel under another split), relative to max |reference|: 1e-5 up to K = F32_K_ANCHOR
# terms, then growing as sqrt(K). Two f32 sums of K terms in other orders drift apart as
# a random walk of K roundings, while the largest output grows as sqrt(K) too only for
# random signs.
F32_TOL = 1e-5
F32_K_ANCHOR = 16384


def f32_limit(k_red: int) -> float:
    """The relative limit of an f32 GEMM whose outputs sum ``k_red`` terms."""
    return F32_TOL * max(1.0, k_red / F32_K_ANCHOR) ** 0.5


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
    lib.repro_matmul_bf16.argtypes = [i, i, i, i, i, i, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr]
    lib.repro_matmul_bf16.restype = i
    lib.repro_matmul_f32.argtypes = [i, i, i, i, ptr, ptr, ptr, i, i, i, i, ptr, ptr, ptr]
    lib.repro_matmul_f32.restype = i
    lib.repro_matmul_tiles.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_matmul_tiles.restype = i
    lib.repro_matmul_persistent_tiles.argtypes = [ctypes.POINTER(ctypes.c_int), i]
    lib.repro_matmul_persistent_tiles.restype = i
    lib.repro_matmul_persistent_residency.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.repro_matmul_persistent_residency.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_matmul_map_encodes.argtypes = []
    lib.repro_matmul_map_encodes.restype = ctypes.c_longlong
    compiled = compiled_tiles(lib)
    want = [tile_row(MatmulConfig(bm, bn, bk)) for bm, bn, bk in _TILES]
    if compiled != want:
        raise RuntimeError(f"compiled matmul tiles {compiled} != config space {want}")
    persistent = compiled_persistent_tiles(lib)
    want = [persistent_row(MatmulConfig(*t)) for t in PERSISTENT_TILES]
    if persistent != want:
        raise RuntimeError(f"compiled persistent tiles {persistent} != {want}")
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


def persistent_row(config: MatmulConfig) -> tuple[int, ...]:
    """(bm, bn, bk, ring stages, smem, threads) of the persistent kernel at the config's
    tile: what ``repro_matmul_persistent_tiles`` reports."""
    return (*config.tile(), config.persistent_stages(), config.smem_bytes("persistent"),
            (config.block_m // 64 + 1) * 128)


def compiled_persistent_tiles(lib: ctypes.CDLL | None = None) -> list[tuple[int, ...]]:
    """:func:`persistent_row` of every tile the library's persistent kernel runs."""
    lib = lib or _lib()
    buf = (ctypes.c_int * (6 * 16))()
    n = lib.repro_matmul_persistent_tiles(buf, 16)
    return [tuple(buf[6 * i : 6 * i + 6]) for i in range(n)]


def persistent_residency(config: MatmulConfig) -> dict[str, int]:
    """The persistent kernel at ``config``'s tile on this card: registers a thread at
    launch (setmaxnreg moves them between the warpgroups after), local-memory bytes a
    thread (spills), and the clusters of 2 it launches at most (what the card holds at
    once: one CTA an SM)."""
    lib = _lib()
    buf = (ctypes.c_int * 3)()
    err = lib.repro_matmul_persistent_residency(*config.tile(), buf)
    if err != 0:
        raise launch_error(err, f"persistent residency query of {config.name()}: cudaError {err}")
    return {"registers": buf[0], "local_bytes": buf[1], "clusters": buf[2]}


def map_encodes() -> int:
    """Tensor maps the library has encoded (cached maps are not encoded again)."""
    return _lib().repro_matmul_map_encodes()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (f32 workspace, int32 per-tile counters). One pair per
# stream, so two streams never share partials or counters. A bf16 split call has fewer
# than SPLIT_CTAS tiles and at most ceil(SPLIT_CTAS / tiles) splits, so it needs fewer than
# 2 * SPLIT_CTAS tile-sized slots; an f32 one at most F32_CTAS_PER_SM * H100_SMS on this
# card, and fewer than H100_SMS tiles. The first allocation holds the larger count of
# the largest tile and stays at one address; a larger need (a card with more SMs) would
# grow it. The kernel leaves every counter at 0. A CUDA graph bakes the addresses in, so
# the pair is never allocated during a capture (the counters' zeroing would be captured,
# not run): a warm-up call on the capture stream allocates it first.
WORKSPACE_SLOTS = max(2 * SPLIT_CTAS, F32_CTAS_PER_SM * H100_SMS)
WORKSPACE_FLOATS = WORKSPACE_SLOTS * max(bm * bn for bm, bn, _ in _TILES)
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, floats: int, tiles: int) -> tuple[int, int]:
    key = (device.index, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < tiles:
        refuse_under_capture("the matmul split-k workspace")
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, WORKSPACE_FLOATS), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, WORKSPACE_SLOTS), dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


_PAIRS = {
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32),
}


def transposed(t: torch.Tensor) -> bool | None:
    """How a 2-D operand lies: False row-major contiguous, True the transpose of a
    row-major tensor (a ``.t()`` view), None neither."""
    if t.is_contiguous():
        return False
    return True if t.t().is_contiguous() else None


def tma_aligned(m: int, n: int, k: int, trans_a: bool, trans_b: bool, a: int, b: int) -> bool:
    """Whether a tensor map takes the operands as they lie: each one's rows (its inner
    dim as it lies) whole 16-byte pieces, n too (the output's rows), 16-byte aligned bases."""
    return ((m if trans_a else k) % 8 == 0 and (k if trans_b else n) % 8 == 0 and n % 8 == 0
            and a % 16 == 0 and b % 16 == 0)


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, k: int, config: MatmulConfig, path: str, sms: int):
    """(bm, bn, bk, splits, kernel) of a call on ``path``: the tile it launches
    (:meth:`MatmulConfig.on_path`), its k splits, and the kernel (0 cp.async or
    f32, 1 the TMA ring, 2 the persistent one, where :func:`uses_persistent` says)."""
    run = config.on_path(path)
    splits = (split_k_f32 if path == "simt_f32" else split_k)(m, n, k, run, sms)
    kernel = 0
    if path == "tma":
        kernel = 2 if uses_persistent(m, n, k, config, sms) else 1
    return (*run.tile(), splits, kernel)


def path_operands(lhs: torch.Tensor, rhs: torch.Tensor, trans_a: bool, trans_b: bool):
    """(path, lhs, rhs, trans_a, trans_b, copies) of a call: the path it takes and the
    operands it launches on.  bf16 takes the TMA path where a tensor map takes both
    operands as they lie (:func:`tma_aligned`; the TMA kernels read one operand
    transposed, so a second is copied).  Elsewhere each transposed operand is
    copied row-major, and bf16 then takes the TMA path if a tensor map takes the
    copies, else the cp.async kernel; f32 takes the f32 kernel.  ``copies`` counts
    the operands copied.  Device-free, so the CPU tests can ask it."""
    m, k = lhs.shape
    n = rhs.shape[1]
    bf16 = lhs.dtype == torch.bfloat16
    copies = 0
    if bf16 and trans_a and trans_b:
        rhs, trans_b, copies = rhs.contiguous(), False, 1
    if bf16 and tma_aligned(m, n, k, trans_a, trans_b, lhs.data_ptr(), rhs.data_ptr()):
        return "tma", lhs, rhs, trans_a, trans_b, copies
    copies += trans_a + trans_b
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    path = "simt_f32"
    if bf16:
        path = "tma" if tma_aligned(m, n, k, False, False, lhs.data_ptr(), rhs.data_ptr()) else "cp_async"
    return path, lhs, rhs, False, False, copies


def matmul_cuda(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    config: MatmulConfig = DEFAULT_CONFIG,
    *,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``lhs (m, k) @ rhs (k, n)`` through the CUDA kernel instantiation ``config``.

    Takes 2-D CUDA tensors of one dtype (bf16 or f32) on one device, each
    row-major contiguous or the transpose of a row-major tensor (``x.t()``);
    bf16 inputs may ask for an f32 output.  :func:`path_operands` picks the
    path: bf16 inputs take the TMA path where a tensor map takes the operands
    as they lie, a transposed one read in place, or else as row-major copies;
    the rest take the cp.async kernel.  Either splits k as :func:`split_k`
    says; on the TMA path the call runs the persistent kernel where
    :func:`uses_persistent` says, else the ring kernel.  f32 inputs take the
    f32 kernel, which splits k as :func:`split_k_f32` says.  Every copy of a
    transposed operand is counted by path (``TRANSPOSE_COPIES``); each path
    launches at the config's tile on it (:meth:`MatmulConfig.on_path`).
    Raises on anything the kernel does not take, and when the launch reports
    an error.
    """
    out_dtype = out_dtype or lhs.dtype
    if lhs.device.type != "cuda" or rhs.device != lhs.device:
        raise ValueError(f"matmul_cuda needs both operands on one CUDA device, got {lhs.device} and {rhs.device}")
    if lhs.ndim != 2 or rhs.ndim != 2:
        raise ValueError(f"matmul_cuda expects 2-D operands, got {tuple(lhs.shape)} @ {tuple(rhs.shape)}")
    trans_a, trans_b = transposed(lhs), transposed(rhs)
    if trans_a is None or trans_b is None:
        raise ValueError("matmul_cuda expects row-major contiguous operands or transposes of them (.t() views)")
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
    order = tile[3]
    lib = _lib()
    sms = _sm_count(lhs.device.index)
    bf16 = lhs.dtype == torch.bfloat16
    path, lhs, rhs, trans_a, trans_b, copies = path_operands(lhs, rhs, trans_a, trans_b)
    bm, bn, bk, splits, kernel = _plan(m, n, k, config, path, sms)
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    # The raw handle: torch.cuda.current_stream() builds a Stream object, ~5 us a call.
    stream = torch._C._cuda_getCurrentRawStream(lhs.device.index)
    a, b = lhs.data_ptr(), rhs.data_ptr()
    ws = counters = None
    if splits > 1:
        tiles = -(-m // bm) * -(-n // bn)
        ws, counters = _workspace(lhs.device, stream, tiles * splits * bm * bn, tiles)
    if bf16:
        err = lib.repro_matmul_bf16(bm, bn, bk, order, int(out_dtype == torch.float32), kernel, int(trans_a),
                                    int(trans_b), a, b, out.data_ptr(), m, n, k, splits, ws, counters, stream)
    else:
        err = lib.repro_matmul_f32(bm, bn, bk, order, a, b, out.data_ptr(), m, n, k, splits, ws, counters, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise launch_error(err, f"matmul kernel {config.name()} ({path}) failed to launch: cudaError {err} ({msg})")
    LAUNCHES[config.name()] += 1
    PATH_LAUNCHES[path] += 1
    SPLIT_LAUNCHES[path] += splits > 1
    TRANSPOSE_COPIES[path] += copies
    if path == "tma":
        TMA_KERNEL_LAUNCHES["persistent" if kernel == 2 else "ring"] += 1
        TRANSPOSED_READS["lhs"] += trans_a
        TRANSPOSED_READS["rhs"] += trans_b
    return out
