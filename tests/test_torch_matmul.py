"""The port's GEMM path against the JAX package's, on the CPU.

``repro_torch.kernels.ops.matmul`` on CPU tensors runs the plain version of
the Hopper kernel; it is held against ``repro.kernels.ref.matmul_ref`` and
against ``matmul_pallas`` in interpret mode on the same numpy inputs.  The
CUDA kernel itself runs only on the card (``cuda`` marker; chip_smoke.py
holds every compiled config against the plain version there).

Tolerances: f32 outputs 1e-5 (the sums differ only in order); bf16 outputs one
bf16 ulp (2**-7 ~ 8e-3 relative), since a sum that lands near a rounding
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
    assert set(mm.LAUNCHES) == {c.name() for c in space}
    assert not mm.MatmulConfig(128, 128, 512, "mnk").is_valid()  # the TPU default is not compiled


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul_cuda(a, torch.zeros(8, 4))
    # A non-CPU tensor never takes the plain path: it reaches the kernel's wrapper.
    with pytest.raises(ValueError, match="CUDA"):
        ops.matmul(torch.zeros(4, 8, device="meta"), torch.zeros(8, 4, device="meta"))
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


@pytest.mark.parametrize("arch", sorted(_SERVED_KN))
@pytest.mark.parametrize("config", mm.config_space(), ids=lambda c: c.name())
def test_split_k_partitions_every_served_gemm(arch, config):
    bk = config.block_k
    for m in _SERVED_M:
        for k, n in _SERVED_KN[arch]:
            splits = mm.split_k(m, n, k, config)
            ranges = mm.k_ranges(k, bk, splits)
            assert len(ranges) == splits >= 1
            assert ranges[0][0] == 0 and ranges[-1][1] == k  # [0, k) covered ...
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # ... exactly once, in order
            assert all(stop > start for start, stop in ranges), (m, k, n, splits)  # no split is empty
            assert all((stop - start) % bk == 0 for start, stop in ranges[:-1])  # whole k steps
            tiles = -(-m // config.block_m) * -(-n // config.block_n)
            steps = -(-k // bk)
            min_steps = -(-mm.SPLIT_MIN_BYTES // (bk * config.block_n * 2))
            if tiles >= mm.SPLIT_CTAS:
                assert splits == 1
            else:  # the grid reaches SPLIT_CTAS, unless the weight bytes per split would run short
                assert tiles * splits >= mm.SPLIT_CTAS or splits >= (steps // min_steps) // 2, (m, k, n, splits)
                assert splits <= max(1, steps // min_steps) and tiles * (splits - 1) < mm.SPLIT_CTAS
                # the partials fit the workspace allocated once per stream
                assert tiles * splits * config.block_m * config.block_n <= mm.WORKSPACE_FLOATS


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
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_split_k_mirror_matches_reference(shape, out):
    m, k, n = shape
    jout, tout = _DTYPES[out]
    a, b = _operands(m, k, n, seed=k + n)
    # bf16 inputs, as the kernel takes them; the mirror sums their f32 values.
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    a32, b32 = ta.float().numpy(), tb.float().numpy()
    want = jax_matmul_ref(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), out_dtype=jout)
    plain = mm.matmul_plain(ta, tb, tout)
    scale = float(np.abs(plain.float().numpy()).max())
    _close(plain, want, tout, scale)
    split_seen = False
    for cfg in mm.config_space():
        splits = mm.split_k(m, n, k, cfg)
        split_seen |= splits > 1
        got = _split_mirror(a32, b32, cfg, splits, tout)
        assert got.dtype == tout and tuple(got.shape) == (m, n)
        _close(got, want, tout, scale)
        np.testing.assert_allclose(got.float().numpy() / scale, plain.float().numpy() / scale, **_tol(tout))
    assert split_seen or k <= 64  # each shape with more than one k step splits under some config


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(1, 100, 96), (37, 4100, 1024), (128, 4096, 1024), *_RAGGED]:
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
