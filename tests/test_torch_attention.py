"""The port's flash attention against the JAX package's, on the CPU.

``attention_plain`` (the plain version of the Hopper kernel in
``csrc/attention.cu``) is held against the reference's oracle
``ref.flash_attention_ref`` and its Pallas kernel
``flash_attention_pallas(..., interpret=True)`` (as ``tests/test_kernels.py``
runs it) on the same numpy inputs, at sq <= skv: there every row sees at
least one column and both packages define the same function.  At sq > skv
(causal) the reference's oracle gives NaN rows; the port defines them as
zeros, which is checked on its own.  The CUDA kernel runs only on the card
(``cuda`` marker; chip_smoke.py holds every compiled config against the plain
version there).  Here a numpy mirror of the kernel's blocking
(``_kernel_mirror``: blocks of ``block_q`` rows, an online softmax over
blocks of ``block_kv`` columns, KV blocks above the diagonal skipped, ragged
tails loaded as zeros and masked) is held against the reference at every
compiled config, so the formulation the kernel computes is checked before
any card runs it.

Tolerances: f32 atol/rtol 1e-5 (f32 on both sides, sums in another order);
bf16 inputs within 1e-2 of max |reference| (the output is rounded to bf16 on
both sides, and a rounding step apart is 2^-8 relative).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import AttentionConfig as JaxAttentionConfig
from repro.kernels.attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jax_flash_attention_ref
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels import attention as at
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 1e-2


def _inputs(sq, skv, d, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    return f(*lead, sq, d), f(*lead, skv, d), f(*lead, skv, d)


_CASES = [(sq, skv) for sq in (1, 7, 50, 128) for skv in dict.fromkeys((sq, 130, 300)) if sq <= skv]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", _CASES)
def test_plain_matches_reference_f32(sq, skv, causal, d):
    q, k, v = _inputs(sq, skv, d, seed=sq * 7 + skv)
    got = at.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (sq, d)
    want = jax_flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    JaxAttentionConfig(128, 128), causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(1, 300), (7, 7), (50, 130), (128, 300)])
def test_plain_matches_reference_bf16(sq, skv, causal):
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _inputs(sq, skv, 64, seed=sq + skv)))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q, k, v))
    got = at.attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    for want in (jax_flash_attention_ref(q, k, v, causal=causal),
                 flash_attention_pallas(q, k, v, JaxAttentionConfig(128, 128), causal=causal, interpret=True)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= BF16_TOL, err


def test_leading_dims_are_independent_heads():
    q, k, v = _inputs(50, 130, 64, seed=3, lead=(2, 3))
    got = at.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    for b in range(2):
        for h in range(3):
            want = jax_flash_attention_ref(jnp.asarray(q[b, h]), jnp.asarray(k[b, h]), jnp.asarray(v[b, h]))
            np.testing.assert_allclose(got[b, h].numpy(), np.asarray(want), **TOL)


def test_rows_with_nothing_visible_are_zeros():
    """Causal, sq > skv: the first sq - skv rows see no column.  The port
    gives zeros there (the reference's oracle NaN); every other row is the
    reference's."""
    q, k, v = _inputs(40, 24, 64, seed=5)
    got = at.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True).numpy()
    want = np.asarray(jax_flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    assert np.isnan(want[:16]).all()
    assert (got[:16] == 0).all()
    np.testing.assert_allclose(got[16:], want[16:], **TOL)


def _kernel_mirror(q, k, v, causal, block_q, block_kv, scale=None):
    """csrc/attention.cu's blocking in numpy (f32): per block of ``block_q``
    query rows (rows past sq load as zeros and are not stored), the KV blocks
    the block needs (under the causal mask those up to its last live row's
    last visible column; none when that row sees nothing), an online softmax
    in log2 units over each block of ``block_kv`` columns (columns past skv
    load as zeros and are masked), and one division by l at the end (a row
    with l = 0 is zeros)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / d**0.5
    log2e = 1.4426950408889634
    out = np.zeros_like(q)
    for b in range(bh):
        for q0 in range(0, sq, block_q):
            live = min(block_q, sq - q0)
            qt = np.zeros((block_q, d), np.float32)
            qt[:live] = q[b, q0:q0 + live]
            rows = q0 + np.arange(block_q)
            n_blocks = -(-skv // block_kv)
            if causal:
                last_col = q0 + live - 1 + skv - sq
                n_blocks = 0 if last_col < 0 else min(n_blocks, last_col // block_kv + 1)
            m = np.full(block_q, -np.inf, np.float32)
            lsum = np.zeros(block_q, np.float32)
            acc = np.zeros((block_q, d), np.float32)
            for j in range(n_blocks):
                kv0 = j * block_kv
                n_kv = min(block_kv, skv - kv0)
                kt = np.zeros((block_kv, d), np.float32)
                vt = np.zeros((block_kv, d), np.float32)
                kt[:n_kv], vt[:n_kv] = k[b, kv0:kv0 + n_kv], v[b, kv0:kv0 + n_kv]
                cols = kv0 + np.arange(block_kv)
                ok = np.broadcast_to(cols[None, :] < skv, (block_q, block_kv))
                if causal:
                    ok = ok & (cols[None, :] <= rows[:, None] + skv - sq)
                s = np.where(ok, (qt @ kt.T) * np.float32(scale * log2e), -np.inf).astype(np.float32)
                mx = np.maximum(m, s.max(axis=1))
                base = np.where(mx == -np.inf, 0.0, mx).astype(np.float32)
                corr = np.exp2(m - base)
                m = mx
                p = np.exp2(s - base[:, None])
                lsum = lsum * corr + p.sum(axis=1)
                acc = acc * corr[:, None] + p @ vt
            inv = np.where(lsum > 0, 1.0 / np.where(lsum > 0, lsum, 1.0), 0.0)
            out[b, q0:q0 + live] = (acc * inv[:, None])[:live]
    return out


_MIRROR_CASES = [(1, 300), (7, 7), (50, 130), (128, 128), (64, 1000), (100, 250)]


@pytest.mark.parametrize("cfg", at.config_space(), ids=lambda c: c.name())
def test_kernel_blocking_matches_reference(cfg):
    for sq, skv in _MIRROR_CASES:
        for causal in (True, False):
            q, k, v = _inputs(sq, skv, 64, seed=sq + 3 * skv, lead=(2,))
            got = _kernel_mirror(q, k, v, causal, cfg.block_q, cfg.block_kv)
            for b in range(2):
                want = jax_flash_attention_ref(jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), causal=causal)
                np.testing.assert_allclose(got[b], np.asarray(want), **TOL)


@pytest.mark.parametrize("cfg", at.config_space()[::4], ids=lambda c: c.name())
def test_kernel_blocking_matches_plain_with_empty_rows(cfg):
    """sq > skv under the causal mask: whole query blocks see nothing (no KV
    block is loaded for them) and the mirror gives zeros, as the plain version."""
    for sq, skv in ((40, 24), (300, 20)):
        q, k, v = _inputs(sq, skv, 128, seed=sq, lead=(1,))
        got = _kernel_mirror(q, k, v, True, cfg.block_q, cfg.block_kv)
        want = at.attention_plain(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert (got[0, : sq - skv] == 0).all()


def test_ops_attention_on_cpu_runs_plain_and_logs_selection():
    q, k, v = map(torch.from_numpy, _inputs(7, 130, 64, seed=9, lead=(1, 4)))
    rt = KernelRuntime()
    rt.install(ops.FixedPolicy(attention_config=at.AttentionConfig(128, 32)))
    rt.set_selection_logging(True)
    with rt.activate():
        got = ops.attention(q, k, v)
        ops.attention(q, k, v, causal=False)
    torch.testing.assert_close(got, at.attention_plain(q, k, v), rtol=0, atol=0)
    assert rt.selection_log() == [("attention", (7, 130, 64), at.AttentionConfig(128, 32))] * 2
    assert rt.shape_cache_stats()["per_family"]["attention"] == {"hits": 1, "misses": 1, "size": 1}
    assert at.total_launches() == 0  # the plain version launches nothing


def test_selection_without_an_attention_policy_is_none():
    rt = KernelRuntime()
    assert rt.select_attention_config(1, 4096, 128) is None

    class MatmulOnly:
        def select_matmul(self, m, k, n, batch):
            return None

    rt.install(MatmulOnly())
    assert rt.select_attention_config(1, 4096, 128) is None
    assert rt.shape_cache_stats()["per_family"] == {}


def test_config_space_is_the_compiled_set():
    space = at.config_space()
    names = [c.name() for c in space]
    assert len(set(names)) == len(names) == 9
    for cfg in space:
        bq, bkv = map(int, re.fullmatch(r"fa_bq(\d+)_bkv(\d+)", cfg.name()).groups())
        assert at.AttentionConfig(bq, bkv) == cfg == at.AttentionConfig.from_dict(cfg.to_dict())
        assert cfg.is_valid() and cfg.smem_bytes(128, 2) <= at.SMEM_LIMIT and cfg.smem_bytes(128, 4) <= at.SMEM_LIMIT
    assert at.DEFAULT_ATTN_CONFIG in space
    assert not at.AttentionConfig(256, 512).is_valid()  # the reference's default: not compiled here
    src = (Path(at.__file__).parent / "csrc" / "attention.cu").read_text()
    body = src[src.index("#define REPRO_ATTENTION_CONFIGS"):src.index("#define REPRO_ATTENTION_HEAD_DIMS")]
    compiled = [tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+)\)", body)]
    assert compiled == [(c.block_q, c.block_kv) for c in space]
    assert re.search(r"REPRO_ATTENTION_HEAD_DIMS\(Y, bq, bkv\) Y\(64, bq, bkv\) Y\(128, bq, bkv\)", src)


@pytest.mark.parametrize("kind,err", [("head dim 96", ValueError), ("f16", TypeError), ("mixed", TypeError),
                                      ("gqa", ValueError), ("non-contiguous", ValueError), ("config", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, err):
    q, k, v = map(torch.from_numpy, _inputs(8, 16, 96 if kind == "head dim 96" else 64, lead=(1, 2)))
    cfg = at.DEFAULT_ATTN_CONFIG
    if kind == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif kind == "mixed":
        q = q.bfloat16()
    elif kind == "gqa":
        k, v = k[:, :1], v[:, :1]
    elif kind == "non-contiguous":
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif kind == "config":
        cfg = at.AttentionConfig(256, 512)
    with pytest.raises(err):
        at.attention_cuda(q, k, v, cfg)


def test_wrapper_needs_a_cuda_device():
    q, k, v = map(torch.from_numpy, _inputs(8, 16, 64, lead=(1, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        at.attention_cuda(q, k, v)
    # A non-CPU tensor never takes the plain path: it reaches the kernel's wrapper.
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert at.total_launches() == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for d in (64, 128):
        for sq, skv in ((1, 300), (7, 7), (50, 130), (40, 24)):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
                q, k, v = (torch.from_numpy(x).cuda().to(dtype) for x in _inputs(sq, skv, d, lead=(2, 3)))
                for causal in (True, False):
                    want = at.attention_plain(q, k, v, causal=causal).float()
                    for cfg in at.config_space():
                        got = at.attention_cuda(q, k, v, cfg, causal=causal).float()
                        assert torch.isfinite(got).all()
                        assert ((got - want).abs().max() / want.abs().max()).item() <= tol, (cfg, d, sq, skv)
