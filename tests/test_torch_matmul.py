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
    assert all(max(c.smem_bytes(2), c.smem_bytes(4)) <= mm.SMEM_LIMIT for c in space)
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(1, 100, 96), (37, 4100, 1024), (128, 4096, 1024)]:
        for src, dst, tol in [(torch.bfloat16, torch.bfloat16, 1e-2),
                              (torch.bfloat16, torch.float32, 1e-3),
                              (torch.float32, torch.float32, 1e-5)]:
            a = torch.randn(m, k, device="cuda", generator=g).to(src)
            b = torch.randn(k, n, device="cuda", generator=g).to(src)
            want = mm.matmul_plain(a, b, dst).float()
            for cfg in mm.config_space():
                got = mm.matmul_cuda(a, b, cfg, out_dtype=dst).float()
                assert ((got - want).abs().max() / want.abs().max()).item() <= tol, cfg
