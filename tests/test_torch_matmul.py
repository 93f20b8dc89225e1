"""The port's GEMM path against the JAX package's, on the CPU.

``repro_torch.kernels.ops.matmul`` on CPU tensors runs the plain version of
the Hopper kernel; it is held against ``repro.kernels.ref.matmul_ref`` and
against ``matmul_pallas`` in interpret mode on the same numpy inputs.  The
CUDA kernel itself runs only on the card (``cuda`` marker; chip_smoke.py
holds every compiled config against the plain version there).

Tolerances: f32 outputs 1e-5 (the sums differ only in order; from f32 inputs
``matmul.f32_limit``, which grows as sqrt(K) above 16,384 terms); bf16 outputs
one bf16 ulp (2**-7 ~ 8e-3 relative), since a sum that lands near a rounding
boundary may round either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import MatmulConfig as TpuMatmulConfig
from repro.kernels.matmul import matmul_pallas
from repro.kernels.ref import matmul_ref as jax_matmul_ref
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import matmul_ref

_TPU_CONFIGS = (TpuMatmulConfig(8, 128, 128, "mnk"), TpuMatmulConfig(32, 256, 256, "nmk"))
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_SHAPES = [(1, 64, 96), (37, 100, 130), (16, 257, 128), (4, 128, 300)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k), dtype=np.float32), rng.standard_normal((k, n), dtype=np.float32)


def _tol(out_dtype):
    return dict(rtol=1e-5, atol=1e-5) if out_dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)


def _close(got: torch.Tensor, want, out_dtype, scale):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = _tol(out_dtype)
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale, **tol)


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("pair", ["f32->f32", "bf16->bf16", "bf16->f32"])
def test_ops_matmul_matches_reference(shape, pair):
    m, k, n = shape
    src, dst = pair.split("->")
    jdt, tdt = _DTYPES[src]
    jout, tout = _DTYPES[dst]
    a, b = _operands(m, k, n, seed=m * 1000 + k)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    got = ops.matmul(ta, tb, out_dtype=tout)
    assert got.dtype == tout and tuple(got.shape) == (m, n)
    want = jax_matmul_ref(ja, jb, out_dtype=jout)
    scale = float(np.abs(np.asarray(jnp.asarray(want, jnp.float32))).max())
    _close(got, want, tout, scale)
    for cfg in _TPU_CONFIGS:
        pallas = matmul_pallas(ja, jb, cfg, out_dtype=jout, interpret=True)
        _close(got, pallas, tout, scale)


def test_ops_matmul_keeps_leading_dims():
    a, b = _operands(6, 32, 48, seed=1)
    x = torch.from_numpy(a).reshape(2, 3, 32)
    out = ops.matmul(x, torch.from_numpy(b))
    assert tuple(out.shape) == (2, 3, 48)
    np.testing.assert_allclose(out.reshape(6, 48).numpy(), a @ b, rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_reference():
    a, b = _operands(5, 40, 24, seed=2)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    assert torch.equal(mm.matmul_plain(ta, tb, torch.float32), matmul_ref(ta, tb, out_dtype=torch.float32))


def test_config_space_is_the_compiled_set():
    space = mm.config_space()
    tiles = {(c.block_m, c.block_n, c.block_k) for c in space}
    assert tiles == set(mm._TILES) and len(tiles) >= 4
    assert {c.order for c in space} == {"mnk", "nmk"}
    assert any(c.block_m <= 16 for c in space)  # decode GEMV tiles
    assert mm.DEFAULT_CONFIG in space
    assert all(max(c.smem_bytes(p) for p in mm.PATHS) <= mm.SMEM_LIMIT for c in space)
    # The f32 kernel's cp.async ring: 3-4 stages of A (bm x bk) and B (bk x bn) f32 tiles,
    # as many as the ring budget holds; the library reports the same bytes (tile_row).
    for c in space:
        f = c.on_path("simt_f32")  # the tile its f32 launches run: its own, but for 128 x 256 x 64
        stage = (f.block_m * f.block_k + f.block_k * f.block_n) * 4
        assert 3 <= c.f32_stages() <= 4 and c.smem_bytes("simt_f32") == c.f32_stages() * stage
        assert c.f32_stages() == 3 or c.smem_bytes("simt_f32") <= mm.RING_BUDGET
        assert mm.tile_row(c)[-1] == c.smem_bytes("simt_f32")
    assert [mm.MatmulConfig(*t).smem_bytes("simt_f32") for t in mm._TILES] == [122880, 110592, 98304, 98304, 98304,
                                                                              98304]
    # Two CTAs of the default tile share an SM's 228 KB (1 KB reserved a CTA).
    assert 2 * (mm.DEFAULT_CONFIG.smem_bytes("simt_f32") + 1024) <= 228 * 1024
    assert set(mm.LAUNCHES) == {c.name() for c in space}
    assert not mm.MatmulConfig(128, 128, 512, "mnk").is_valid()  # the TPU default is not compiled


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul_cuda(a, torch.zeros(8, 4))
    # A meta tensor (the dry run's) takes the GEMM op's fake impl: shapes only, no launch.
    out = ops.matmul(torch.zeros(4, 8, device="meta"), torch.zeros(8, 4, device="meta"))
    assert out.is_meta and out.shape == (4, 4)
    # A tensor on a card never takes the plain path: it reaches the kernel's wrapper.
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.matmul(a, torch.zeros(8, 4))
    assert mm.total_launches() == 0


# ---------------------------------------------------------------------------
# split-k: the rule and the kernel's partition and reduction
# ---------------------------------------------------------------------------
# Every GEMM (k, n) that serving granite-8b, rwkv6-7b and hymba-1.5b gives the kernel,
# at the decode step's rows (batch 4 folded; 1 for a single lane) and the prefill buckets.
_SERVED_KN = {
    "granite-8b": [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 49152)],
    "rwkv6-7b": [(4096, 4096), (4096, 64), (64, 4096), (4096, 14336), (14336, 4096), (4096, 65536)],
    "hymba-1.5b": [(1600, 1600), (1600, 320), (1600, 3200), (1600, 48), (48, 1600), (1600, 16),
                   (1600, 5504), (5504, 1600), (1600, 32128)],
}
_SERVED_M = (1, 4, 32, 64, 128, 256)
# Every f32 GEMM that training granite-8b, hymba-1.5b and seamless-m4t-large-v2 gives the
# kernel at batch 8 x seq 128: each projection's (k, n) as its forward (1024, k, n), its
# grad_lhs (1024, n, k) and its grad_rhs (k, 1024, n). Seamless's (k, n): Q, K, V, O (self
# and cross), gate and up, down, the vocab head (a K = 256,256 reduction in grad_lhs).
_TRAIN_ROWS = 1024
_TRAINED_KN = {
    "granite-8b": _SERVED_KN["granite-8b"],
    "hymba-1.5b": _SERVED_KN["hymba-1.5b"],
    "seamless-m4t-large-v2": [(1024, 1024), (1024, 8192), (8192, 1024), (1024, 256256)],
}


def _gemms(arch: str) -> list[tuple[int, int, int]]:
    """(m, k, n) of every GEMM of ``arch``: served at _SERVED_M rows, or ("<arch> f32
    training") its training GEMMs at _TRAIN_ROWS rows."""
    if arch.endswith(" f32 training"):
        return [mkn for k, n in _TRAINED_KN[arch.split()[0]]
                for mkn in ((_TRAIN_ROWS, k, n), (_TRAIN_ROWS, n, k), (k, _TRAIN_ROWS, n))]
    return [(m, k, n) for m in _SERVED_M for k, n in _SERVED_KN[arch]]


@pytest.mark.parametrize("arch", sorted(_SERVED_KN) + [f"{a} f32 training" for a in sorted(_TRAINED_KN)])
@pytest.mark.parametrize("config", mm.config_space(), ids=lambda c: c.name())
def test_split_k_partitions_every_served_gemm(arch, config):
    bk = config.block_k
    f32 = arch.endswith(" f32 training")
    for m, k, n in _gemms(arch):
        splits = (mm.split_k_f32 if f32 else mm.split_k)(m, n, k, config)
        ranges = mm.k_ranges(k, bk, splits)
        assert len(ranges) == splits >= 1
        assert ranges[0][0] == 0 and ranges[-1][1] == k  # [0, k) covered ...
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # ... exactly once, in order
        assert all(stop > start for start, stop in ranges), (m, k, n, splits)  # no split is empty
        assert all((stop - start) % bk == 0 for start, stop in ranges[:-1])  # whole k steps
        tiles = -(-m // config.block_m) * -(-n // config.block_n)
        steps = -(-k // bk)
        min_steps = -(-mm.SPLIT_MIN_BYTES // (bk * config.block_n * 2))
        # the partials fit the workspace allocated once per stream
        assert tiles * splits * config.block_m * config.block_n <= mm.WORKSPACE_FLOATS or splits == 1
        if f32:  # split only a grid smaller than the card, up to two CTAs an SM
            fill = lambda s: tiles * s / (mm.H100_SMS * -(-tiles * s // mm.H100_SMS))
            if tiles >= mm.H100_SMS:
                assert splits == 1, (m, k, n, splits)
            else:
                cap = min(max(1, steps // mm.F32_SPLIT_MIN_STEPS), mm.F32_CTAS_PER_SM * mm.H100_SMS // tiles)
                assert splits <= cap and tiles * splits <= mm.F32_CTAS_PER_SM * mm.H100_SMS
                # no count the rule may take fills more of the card's last wave
                assert all(fill(splits) >= fill(s) for s in range(1, cap + 1)), (m, k, n, splits)
        elif tiles >= mm.SPLIT_CTAS:
            assert splits == 1
        else:  # the grid reaches SPLIT_CTAS, unless the weight bytes per split would run short
            assert tiles * splits >= mm.SPLIT_CTAS or splits >= (steps // min_steps) // 2, (m, k, n, splits)
            assert splits <= max(1, steps // min_steps) and tiles * (splits - 1) < mm.SPLIT_CTAS


def test_split_k_fills_the_card_at_decode():
    # granite-8b's K/V projection at batch 4 under the 16 x 64 tile: 16 output tiles.
    cfg = mm.MatmulConfig(16, 64, 128, "mnk")
    assert mm.split_k(4, 1024, 4096, cfg) == 4  # 16 x 4 = 64 CTAs, 8 k steps (128 KB of weight) each
    assert mm.k_ranges(4096, 128, 4) == [(0, 1024), (1024, 2048), (2048, 3072), (3072, 4096)]
    assert mm.split_k(4, 14336, 4096, cfg) == 1  # 224 tiles already hold the target
    # rwkv6-7b's (4096, 64): one tile; 32 steps of 16 KB allow 4 splits of 128 KB.
    assert mm.split_k(4, 64, 4096, cfg) == 4
    # hymba-1.5b's (48, 1600) under a 128-deep k step: one step, so one split.
    assert mm.split_k(4, 1600, 48, cfg) == 1
    # The 128 x 128 tile at (4096, 4096): 32 tiles, 2 splits; on a 32-SM card, none.
    assert mm.split_k(4, 4096, 4096, mm.DEFAULT_CONFIG) == 2
    assert mm.split_k(4, 4096, 4096, mm.DEFAULT_CONFIG, sm_count=32) == 1
    # f32 at 1024 training rows under the default 128 x 128 tile: granite-8b's K/V
    # projection and seamless's head gradient have 64 tiles, and 4 splits (256 CTAs, two
    # an SM) leave 8 of 264 CTA slots idle where 2 or 3 would leave 4 SMs or half a wave.
    assert mm.split_k_f32(1024, 1024, 4096, mm.DEFAULT_CONFIG) == 4
    assert mm.split_k_f32(1024, 1024, 256256, mm.DEFAULT_CONFIG) == 4
    assert mm.k_ranges(256256, 32, 4) == [(0, 64064), (64064, 128128), (128128, 192192), (192192, 256256)]
    assert mm.split_k_f32(1024, 4096, 4096, mm.DEFAULT_CONFIG) == 1  # 256 tiles fill the card
    assert mm.split_k_f32(1024, 1024, 4096, mm.DEFAULT_CONFIG, sm_count=64) == 1


def _split_mirror(a, b, config, splits, out_dtype):
    """The kernel's arithmetic in numpy: each split's f32 partial over its k
    range, then the partials summed in split order from 0, cast once."""
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for start, stop in mm.k_ranges(a.shape[1], config.block_k, splits):
        total = total + np.matmul(a[:, start:stop], b[start:stop, :], dtype=np.float32)
    return torch.from_numpy(total).to(out_dtype)


# k < block_k; k not a multiple of block_k * splits; m = 1; n = 16 (< block_n).
_RAGGED = [(1, 48, 1600), (4, 1000, 16), (3, 4100, 96), (1, 64, 4096), (4, 1600, 48)]


@pytest.mark.parametrize("shape", _RAGGED, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("out", ["bf16", "f32", "f32-in"])
def test_split_k_mirror_matches_reference(shape, out):
    """bf16 inputs to bf16 or f32 outputs under :func:`split_k`; "f32-in": f32 inputs and
    output under :func:`split_k_f32`, held at ``f32_limit(k)`` of max |reference|."""
    m, k, n = shape
    f32_in = out == "f32-in"
    jin, tin = _DTYPES["f32" if f32_in else "bf16"]
    jout, tout = _DTYPES["f32" if f32_in else out]
    a, b = _operands(m, k, n, seed=k + n)
    # The kernel's input type; the mirror sums their f32 values.
    ta, tb = torch.from_numpy(a).to(tin), torch.from_numpy(b).to(tin)
    a32, b32 = ta.float().numpy(), tb.float().numpy()
    want = jax_matmul_ref(jnp.asarray(a, jin), jnp.asarray(b, jin), out_dtype=jout)
    plain = mm.matmul_plain(ta, tb, tout)
    scale = float(np.abs(plain.float().numpy()).max())
    _close(plain, want, tout, scale)
    rule = mm.split_k_f32 if f32_in else mm.split_k
    split_seen = False
    for cfg in mm.config_space():
        splits = rule(m, n, k, cfg)
        split_seen |= splits > 1
        got = _split_mirror(a32, b32, cfg, splits, tout)
        assert got.dtype == tout and tuple(got.shape) == (m, n)
        if f32_in:
            want32 = np.asarray(want, np.float32)
            assert np.abs(got.numpy() - want32).max() / scale <= mm.f32_limit(k), (cfg, splits)
            assert np.abs(got.numpy() - plain.numpy()).max() / scale <= mm.f32_limit(k), (cfg, splits)
            continue
        _close(got, want, tout, scale)
        np.testing.assert_allclose(got.float().numpy() / scale, plain.float().numpy() / scale, **_tol(tout))
    assert split_seen or k <= 64  # each shape with more than one k step splits under some config


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    # (1024, 4096, 1024) and (64, 8192, 64): f32 splits under the wide tiles (split_k_f32).
    for m, k, n in [(1, 100, 96), (37, 4100, 1024), (128, 4096, 1024), (1024, 4096, 1024), (64, 8192, 64), *_RAGGED]:
        for src, dst, tol in [(torch.bfloat16, torch.bfloat16, 1e-2),
                              (torch.bfloat16, torch.float32, 1e-3),
                              (torch.float32, torch.float32, 1e-5)]:
            a = torch.randn(m, k, device="cuda", generator=g).to(src)
            b = torch.randn(k, n, device="cuda", generator=g).to(src)
            want = mm.matmul_plain(a, b, dst).float()
            for cfg in mm.config_space():
                first = mm.matmul_cuda(a, b, cfg, out_dtype=dst)
                second = mm.matmul_cuda(a, b, cfg, out_dtype=dst)  # counters left at 0 by the first
                for got in (first.float(), second.float()):
                    assert ((got - want).abs().max() / want.abs().max()).item() <= tol, cfg
                assert torch.equal(first, second), cfg  # split order fixes the sum


# ---------------------------------------------------------------------------
# the persistent kernel: its tiles, rings and schedule
# ---------------------------------------------------------------------------
def test_persistent_tiles_and_their_rings():
    """The persistent kernel's tiles (128 rows: two consumer warpgroups and a producer
    warpgroup, 384 threads) and its ring beside the epilogue's staging, one CTA an SM;
    the 128 x 256 x 64 tile's ring kernel takes the wide budget (one CTA an SM) and its
    cp.async and f32 launches the 128 x 128 x 32 tile."""
    assert set(mm.PERSISTENT_TILES) <= set(mm._TILES)
    wide = mm.MatmulConfig(128, 256, 64, "mnk")
    assert wide in mm.config_space() and wide.is_valid()
    assert [mm.persistent_row(mm.MatmulConfig(*t)) for t in mm.PERSISTENT_TILES] == [
        (128, 128, 32, 6, 218208, 384), (128, 256, 64, 4, 218176, 384)]
    assert [mm.MatmulConfig(*t).persistent_stage_k() for t in mm.PERSISTENT_TILES] == [64, 64]
    assert wide.tma_stages() == 4 and wide.smem_bytes("tma") == 197712
    assert wide.on_path("cp_async") == wide.on_path("simt_f32") == mm.MatmulConfig(128, 128, 32, "mnk")
    assert wide.on_path("tma") is wide and mm.DEFAULT_CONFIG.on_path("simt_f32") is mm.DEFAULT_CONFIG
    assert mm.tile_row(wide) == (128, 256, 64, 4, 197712, mm.DEFAULT_CONFIG.smem_bytes("cp_async"), 98304)
    for t in mm.PERSISTENT_TILES:
        c = mm.MatmulConfig(*t)
        assert 4 <= c.persistent_stages() <= mm.MAX_PERSISTENT_STAGES
        assert c.smem_bytes("persistent") <= mm.SMEM_LIMIT < 2 * (c.smem_bytes("persistent") + 1024)
    # setmaxnreg: 40 registers for the producer warpgroup, 232 for each consumer thread,
    # within the SM's 65,536 and what 384 threads launch with (168 each).
    assert 40 * 128 + 232 * 256 <= 168 * 384 <= 65536


def test_persistent_runs_the_compute_bound_calls():
    """uses_persistent: a persistent tile, one split, more than one tile row."""
    d, wide = mm.DEFAULT_CONFIG, mm.MatmulConfig(128, 256, 64, "nmk")
    assert mm.uses_persistent(16384, 14336, 4096, d) and mm.uses_persistent(16384, 14336, 4096, wide)
    for k, n in _SERVED_KN["granite-8b"][:4]:  # a granite-8b layer at 1024 training rows, all three GEMMs
        for m, kk, nn in ((_TRAIN_ROWS, k, n), (_TRAIN_ROWS, n, k), (k, _TRAIN_ROWS, n)):
            assert mm.uses_persistent(m, nn, kk, d) == (mm.split_k(m, nn, kk, d) == 1)
    assert not mm.uses_persistent(4, 14336, 4096, d)  # decode: the ring kernel's 64-row slabs
    assert not mm.uses_persistent(128, 14336, 4096, d)  # one tile row: one tile a cluster
    assert not mm.uses_persistent(1024, 4096, 4096, mm.MatmulConfig(64, 128, 32, "mnk"))
    assert mm.uses_persistent(256, 4096, 4096, d)  # two tile rows of 32 tiles: one split
    assert not mm.uses_persistent(256, 1024, 4096, d)  # 16 tiles: split k on the ring kernel


def _persistent_schedule(m: int, n: int, config: mm.MatmulConfig, clusters: int) -> list[list[tuple[int, int]]]:
    """The output tiles (tm, tn) each CTA of the persistent kernel stores, CTA by CTA
    (csrc/matmul.cu ``gemm_persistent_kernel``): ``clusters`` clusters of 2 (what
    the card holds at once, at most one per tile pair); cluster c walks the pairs of
    tile rows c, c + clusters, ... in the banded order ``tile_coords`` gives, and its
    CTA r takes row 2 * pair + r of each, storing nothing where that row is past m."""
    gm, gn = -(-m // config.block_m), -(-n // config.block_n)
    pairs = -(-gm // 2)
    units = pairs * gn
    clusters = min(clusters, units)
    out = []
    for c in range(clusters):
        for r in range(2):
            tiles = []
            for u in range(c, units, clusters):
                pair, tn = _tile_coords(config.order, pairs, gn, u)
                if 2 * pair + r < gm:
                    tiles.append((2 * pair + r, tn))
            out.append(tiles)
    return out


def _tile_coords(order: str, gm: int, gn: int, pid: int) -> tuple[int, int]:
    """csrc/matmul.cu ``tile_coords``: tile ``pid`` of a gm x gn grid, the order's fast
    axis walked in bands of 8."""
    fast_n, slow_n = (gn, gm) if order == "mnk" else (gm, gn)
    band, within = divmod(pid, 8 * slow_n)
    width = min(8, fast_n - band * 8)
    fast, slow = band * 8 + within % width, within // width
    return (slow, fast) if order == "mnk" else (fast, slow)


def _persistent_cases():
    """(m, n) of every harvested problem (rows folded up to 16,384) and granite-8b's
    training GEMMs, at every persistent config, that the persistent kernel runs; plus
    odd tile-row counts (a cluster's tail) at each."""
    from repro_torch.core import dataset

    shapes = {(min(m * b, 16384), k, n) for m, k, n, b in dataset.harvest_problems()}
    shapes |= {mkn for mkn in _gemms("granite-8b f32 training")}
    cases = []
    for c in mm.config_space():
        if c.tile() in mm.PERSISTENT_TILES:
            mn = sorted({(m, n) for m, k, n in shapes if mm.uses_persistent(m, n, k, c)})
            mn += [(3 * c.block_m + 5, 1000), (5 * c.block_m, 8 * c.block_n + 8)]
            cases.append((c, mn))
    return cases


@pytest.mark.parametrize("config,shapes", _persistent_cases(), ids=lambda x: x.name() if hasattr(x, "name") else "")
def test_persistent_schedule_stores_every_tile_once_in_order(config, shapes):
    """A numpy mirror of gemm_persistent_kernel's schedule: clusters of 2 walk pairs of
    tile rows with a fixed stride in tile_coords' banded order; every output tile is
    stored by exactly one CTA; a cluster's CTAs share each tile column (B) and take
    vertically adjacent rows; the second CTA of a pair past the m edge stores nothing."""
    assert shapes
    for m, n in shapes:
        gm, gn = -(-m // config.block_m), -(-n // config.block_n)
        pairs = -(-gm // 2)
        # tile_coords is a bijection of the pair grid, in bands of 8 along the order's fast axis
        walk = [_tile_coords(config.order, pairs, gn, u) for u in range(pairs * gn)]
        assert sorted(walk) == [(p, t) for p in range(pairs) for t in range(gn)]
        fast = [t if config.order == "mnk" else p for p, t in walk]
        assert all(f // 8 == walk_band for f, walk_band in zip(fast, sorted(f // 8 for f in fast)))
        for clusters in (66, 64, 7, 1):
            sched = _persistent_schedule(m, n, config, clusters)
            assert len(sched) == 2 * min(clusters, pairs * gn)
            stored = [t for cta in sched for t in cta]
            assert sorted(stored) == [(tm, tn) for tm in range(gm) for tn in range(gn)]  # each once
            for c in range(len(sched) // 2):
                top, bottom = sched[2 * c], sched[2 * c + 1]
                units = range(c, pairs * gn, len(sched) // 2)
                assert top == [(2 * p, t) for p, t in (walk[u] for u in units)]  # in order
                # the row below, on the same B columns; past m (an odd grid's last pair) nothing
                assert bottom == [(2 * p + 1, t) for p, t in (walk[u] for u in units) if 2 * p + 1 < gm]
                assert len(top) - len(bottom) == sum(1 for u in units if gm % 2 and walk[u][0] == pairs - 1)


# ---------------------------------------------------------------------------
# transposed operands (the backward's) and the gradient
# ---------------------------------------------------------------------------
def test_operand_layouts_and_the_tma_rule():
    a = torch.zeros(6, 8)
    assert mm.transposed(a) is False and mm.transposed(a.t()) is True
    assert mm.transposed(a[:, ::2]) is None and mm.transposed(torch.zeros(4, 1).t()) is False
    # the rows of each operand as it lies, and the output's, in whole 16-byte pieces
    assert mm.tma_aligned(1024, 4096, 4096, False, False, 0, 0)
    assert mm.tma_aligned(4096, 4096, 1024, True, False, 0, 0)  # grad_rhs: lhs^T (k, m) rows of m
    assert not mm.tma_aligned(4100, 4096, 1024, True, False, 0, 0)
    assert mm.tma_aligned(1024, 4096, 14336, False, True, 0, 0)  # grad_lhs: rhs^T (n, k) rows of k
    assert not mm.tma_aligned(1024, 4096, 100, False, True, 0, 0)
    assert not mm.tma_aligned(1024, 4100, 4096, False, True, 0, 0)  # the output's rows
    assert not mm.tma_aligned(8, 8, 8, False, False, 2, 0)


def _view(rows: int, cols: int, dtype: torch.dtype, offset: int = 0) -> torch.Tensor:
    """A (rows, cols) ``.t()`` view of a row-major (cols, rows) tensor whose base lies
    ``offset`` elements into its storage."""
    return torch.zeros(offset + rows * cols, dtype=dtype)[offset:].view(cols, rows).t()


# (case, lhs, rhs, path, lhs read transposed, rhs read transposed, copies)
_PATH_CASES = [
    ("grad_lhs in place", lambda: torch.zeros(16, 64, dtype=torch.bfloat16), lambda: _view(64, 32, torch.bfloat16),
     "tma", False, True, 0),
    ("grad_rhs in place", lambda: _view(64, 16, torch.bfloat16), lambda: torch.zeros(16, 32, dtype=torch.bfloat16),
     "tma", True, False, 0),
    # the view's rows (m = 12) are not whole 16-byte pieces; its row-major copy's (k = 64) are
    ("view rows ragged, copy aligned", lambda: _view(12, 64, torch.bfloat16),
     lambda: torch.zeros(64, 32, dtype=torch.bfloat16), "tma", False, False, 1),
    ("view base misaligned, copy aligned", lambda: _view(64, 16, torch.bfloat16, offset=1),
     lambda: torch.zeros(16, 32, dtype=torch.bfloat16), "tma", False, False, 1),
    ("view and copy ragged", lambda: _view(12, 20, torch.bfloat16), lambda: torch.zeros(20, 32, dtype=torch.bfloat16),
     "cp_async", False, False, 1),
    ("row-major base misaligned", lambda: torch.zeros(1 + 16 * 64, dtype=torch.bfloat16)[1:].view(16, 64),
     lambda: torch.zeros(64, 32, dtype=torch.bfloat16), "cp_async", False, False, 0),
    ("both transposed", lambda: _view(16, 64, torch.bfloat16), lambda: _view(64, 32, torch.bfloat16),
     "tma", True, False, 1),
    ("f32", lambda: _view(16, 64, torch.float32), lambda: torch.zeros(64, 32), "simt_f32", False, False, 1),
]


@pytest.mark.parametrize("case", _PATH_CASES, ids=lambda c: c[0])
def test_path_is_chosen_after_the_copy(case):
    """path_operands: a transposed view a tensor map cannot take is copied row-major,
    and the copy runs on the TMA path where a tensor map takes it."""
    _, lhs, rhs, path, ta, tb, copies = case
    lhs, rhs = lhs(), rhs()
    got = mm.path_operands(lhs, rhs, mm.transposed(lhs), mm.transposed(rhs))
    assert (got[0], got[3], got[4], got[5]) == (path, ta, tb, copies)
    assert mm.transposed(got[1]) is ta and mm.transposed(got[2]) is tb
    assert torch.equal(got[1], lhs) and torch.equal(got[2], rhs)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(37, 100, 130), (64, 256, 128), (1, 48, 16)], ids=lambda s: "x".join(map(str, s)))
def test_transposed_views_give_the_copies_bits(dtype, shape):
    """matmul_plain (and ops.matmul on the CPU) on a transposed view is bitwise the call
    on its row-major copy, either operand."""
    m, k, n = shape
    tdt = _DTYPES[dtype][1]
    a, b = _operands(m, k, n, seed=k + 7)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    at, bt = ta.t().contiguous().t(), tb.t().contiguous().t()  # same values, transposed layouts
    assert mm.transposed(at) == (min(m, k) > 1) and mm.transposed(bt) == (min(k, n) > 1)  # a vector is both
    assert torch.equal(at, ta) and torch.equal(bt, tb)
    for out in (tdt, torch.float32):
        want = mm.matmul_plain(ta, tb, out)
        assert torch.equal(mm.matmul_plain(at, tb, out), want)
        assert torch.equal(mm.matmul_plain(ta, bt, out), want)
        assert torch.equal(mm.matmul_plain(at, bt, out), want)
    assert torch.equal(ops.matmul(at, tb), ops.matmul(ta, tb)) and torch.equal(ops.matmul(ta, bt), ops.matmul(ta, tb))


@pytest.mark.parametrize("pair", ["f32->f32", "bf16->bf16", "bf16->f32"])
@pytest.mark.parametrize("lead,k,n", [((2, 9), 40, 24), ((5,), 64, 96), ((3, 4), 130, 8)])
def test_gemm_backward_matches_jax_vjp(pair, lead, k, n):
    """_gemm_backward (grad_lhs = g . rhs^T, grad_rhs = lhs2^T . g2, both on transposed
    views) against jax.vjp of the reference's matmul, at the tolerances above."""
    import jax

    src, dst = pair.split("->")
    jdt, tdt = _DTYPES[src]
    jout, tout = _DTYPES[dst]
    rng = np.random.default_rng(len(lead) * 100 + k)
    a = rng.standard_normal((*lead, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    g = rng.standard_normal((*lead, n), dtype=np.float32)
    ta = torch.from_numpy(a).to(tdt).requires_grad_(True)
    tb = torch.from_numpy(b).to(tdt).requires_grad_(True)
    out = ops.matmul(ta, tb, out_dtype=tout)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g).to(tout))
    assert ga.dtype == tdt and gb.dtype == tdt
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    _, vjp = jax.vjp(lambda x, w: jax_matmul_ref(x.reshape(-1, k), w, out_dtype=jout).reshape(*lead, n), ja, jb)
    wa, wb = vjp(jnp.asarray(g, jout))
    for got, want in ((ga, wa), (gb, wb)):
        scale = float(np.abs(np.asarray(jnp.asarray(want, jnp.float32))).max())
        _close(got, want, tdt, scale)
