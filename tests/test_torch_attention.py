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
tails loaded as zeros and masked, and the split-KV path: each query block's
blocks cut by ``kv_ranges``, per-split partials combined in split order) is
held against the reference at every compiled config, so the formulation the
kernel computes is checked before any card runs it; the split rule
(``kv_splits``) is checked at the served problems.

Tolerances: f32 atol/rtol 1e-5 (f32 on both sides, sums in another order);
bf16 inputs within 1e-2 of max |reference| (the output is rounded to bf16 on
both sides, and a rounding step apart is 2^-8 relative).
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import AttentionConfig as JaxAttentionConfig
from repro.kernels.attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jax_flash_attention_ref
from repro_torch.core.attnmodel import harvest_attn_problems
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


def _kernel_mirror(q, k, v, causal, block_q, block_kv, scale=None, splits=1):
    """csrc/attention.cu's blocking in numpy (f32): per block of ``block_q``
    query rows (rows past sq load as zeros and are not stored), the KV blocks
    the block needs (under the causal mask those up to its last live row's
    last visible column; none when that row sees nothing), cut into ``splits``
    splits as ``kv_ranges`` cuts them.  Each split runs an online softmax in
    log2 units over its blocks of ``block_kv`` columns (columns past skv load
    as zeros and are masked) from m = -inf, l = 0, acc = 0; the partials
    (m, l, acc) are combined in split order, each weighed by exp2(m_z - max m)
    (0 for a split in which a row saw nothing), and divided by l once (a row
    with l = 0 is zeros).  One split is the kernel without split-KV."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / d**0.5
    log2e = 1.4426950408889634
    cfg = at.AttentionConfig(block_q, block_kv)
    out = np.zeros_like(q)
    for b in range(bh):
        for q0 in range(0, sq, block_q):
            live = min(block_q, sq - q0)
            qt = np.zeros((block_q, d), np.float32)
            qt[:live] = q[b, q0:q0 + live]
            rows = q0 + np.arange(block_q)
            parts = []
            for c0, c1 in at.kv_ranges(q0, sq, skv, cfg, causal, splits):
                m = np.full(block_q, -np.inf, np.float32)
                lsum = np.zeros(block_q, np.float32)
                acc = np.zeros((block_q, d), np.float32)
                for kv0 in range(c0, c1, block_kv):
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
                parts.append((m, lsum, acc))
            top = np.max([m for m, _, _ in parts], axis=0)
            base = np.where(top == -np.inf, 0.0, top).astype(np.float32)
            lsum = np.zeros(block_q, np.float32)
            acc = np.zeros((block_q, d), np.float32)
            for m, l_z, acc_z in parts:  # in split order
                w = np.exp2(m - base)
                lsum = lsum + l_z * w
                acc = acc + acc_z * w[:, None]
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


@functools.cache
def _references(sq, skv, causal, d=64):
    """The JAX oracle's and (sq <= skv) its Pallas kernel's answer on _inputs(sq, skv, d)."""
    q, k, v = map(jnp.asarray, _inputs(sq, skv, d, seed=sq + skv))
    refs = [np.asarray(jax_flash_attention_ref(q, k, v, causal=causal))]
    if sq <= skv:
        refs.append(np.asarray(flash_attention_pallas(q, k, v, JaxAttentionConfig(128, 128), causal=causal,
                                                      interpret=True)))
    return refs


@pytest.mark.parametrize("cfg", at.config_space(), ids=lambda c: c.name())
def test_split_mirror_matches_reference(cfg):
    """The split-KV path in numpy at 1-8 splits (as many as the blocks allow), with
    splits that cut the causal diagonal (sq = 16: a split holds columns only some rows
    see) and a ragged last block, against the JAX oracle and its Pallas kernel."""
    for sq in (1, 4, 16):
        for skv in (1, 300, 1000, 4103):
            for causal in (True, False):
                q, k, v = (x[None] for x in _inputs(sq, skv, 64, seed=sq + skv))
                blocks = at.kv_blocks(0, sq, skv, cfg, causal)
                for splits in range(1, min(8, blocks) + 1):
                    got = _kernel_mirror(q, k, v, causal, cfg.block_q, cfg.block_kv, splits=splits)[0]
                    blind = max(0, sq - skv) if causal else 0  # rows that see nothing: the oracle's NaN
                    assert (got[:blind] == 0).all()
                    for want in _references(sq, skv, causal):
                        np.testing.assert_allclose(got[blind:], want[blind:], **TOL,
                                                   err_msg=f"{sq, skv, causal, splits}")


def test_split_mirror_with_empty_splits():
    """The kernel takes any split count (scripts/attn_split_sweep.py forces them), so a
    split may hold no block: at sq > skv (causal) whole query blocks see nothing and the
    first one that sees a column has fewer blocks than splits.  Empty splits weigh 0 in
    the combine, and rows that see nothing stay zeros, as in the plain version.  (The
    rule itself never splits here: that query block sees fewer than block_q columns.)"""
    q, k, v = _inputs(300, 200, 64, seed=4, lead=(1,))
    want = at.attention_plain(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    for cfg in (at.AttentionConfig(32, 32), at.AttentionConfig(128, 64)):
        assert at.kv_splits(1, 300, 200, cfg, True, hd=64) == 1
        for splits in (2, 3, 7):
            got = _kernel_mirror(q, k, v, True, cfg.block_q, cfg.block_kv, splits=splits)
            np.testing.assert_allclose(got, want, **TOL)
            assert (got[0, :100] == 0).all()


# Every harvested attention problem of granite-8b and hymba-1.5b at (1, 32) heads, and
# chip_smoke.py phase 20's shapes: (heads, sq, skv, d).
_SERVED = [(32, sq, skv, d) for sq, skv, d in harvest_attn_problems(["granite-8b", "hymba-1.5b"])]
_SERVED += [(heads, sq, skv, d) for heads, d in ((32, 128), (25, 64))
            for sq, skv in ((512, 512), (2048, 2048), (4096, 4096), (1, 4096), (1, 32768))]


def _ranges_tile_the_blocks(bh, sq, skv, cfg, causal, splits):
    for q0 in range(0, sq, cfg.block_q):
        n = at.kv_blocks(q0, sq, skv, cfg, causal)
        ranges = at.kv_ranges(q0, sq, skv, cfg, causal, splits)
        assert len(ranges) == splits
        if n == 0:  # a query block that sees nothing: every split is empty
            assert all(c0 == c1 for c0, c1 in ranges)
            continue
        # whole blocks, in order, no gap, none empty, ending at the last block's end
        assert ranges[0][0] == 0 and ranges[-1][1] == min(skv, n * cfg.block_kv)
        assert all(r1[1] == r2[0] for r1, r2 in zip(ranges, ranges[1:]))
        assert all(c0 < c1 and c0 % cfg.block_kv == 0 for c0, c1 in ranges)
        if splits > 1:
            assert all(-(-(c1 - c0) // cfg.block_kv) >= at.SPLIT_MIN_BLOCKS for c0, c1 in ranges)


@pytest.mark.parametrize("resident", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_splits_leave_no_split_empty(causal, resident):
    shapes = [(1, 1, 1), (6, 1, 300), (6, 4, 4103), (6, 16, 1000), (6, 128, 128), (6, 300, 200), (1, 40, 24),
              (3, 1000, 1000), *((h, sq, skv) for h, sq, skv, _ in _SERVED)]
    for bh, sq, skv in shapes:
        for cfg in at.config_space():
            for hd in (64, 128):
                splits = at.kv_splits(bh, sq, skv, cfg, causal, hd=hd, resident=resident)
                assert splits >= 1
                _ranges_tile_the_blocks(bh, sq, skv, cfg, causal, splits)
                ctas = -(-sq // cfg.block_q) * bh
                assert ctas * splits <= max(ctas, at.split_target(cfg, hd, at.H100_SMS, resident))


@pytest.mark.parametrize("resident", [1, 2, 4])
def test_kv_splits_fill_the_wave_at_served_problems(resident):
    """At every decode problem the split fills the target (one more split would pass
    it); a grid that fills half the target or more is not split; a causal prefill whose
    first query block sees too few blocks splits only as far as they allow."""
    for heads, sq, skv, d in _SERVED:
        for cfg in at.config_space():
            target = at.split_target(cfg, d, at.H100_SMS, resident)
            splits = at.kv_splits(heads, sq, skv, cfg, True, hd=d, resident=resident)
            ctas = -(-sq // cfg.block_q) * heads
            if 2 * ctas > target:
                assert splits == 1
                continue
            fewest = min(n for q0 in range(0, sq, cfg.block_q) if (n := at.kv_blocks(q0, sq, skv, cfg, True)))
            filled = ctas * (splits + 1) > target
            assert filled or splits == max(1, fewest // at.SPLIT_MIN_BLOCKS), (heads, sq, skv, d, cfg)
            if sq == 1:
                assert splits > 1 and filled, (heads, skv, d, cfg, splits)


def test_kv_splits_is_one_when_the_grid_fills_the_target():
    cfg = at.AttentionConfig(64, 128)
    target = at.split_target(cfg, 128)
    for heads in (target // 2 + 1, target, 4 * target):
        assert at.kv_splits(heads, 1, 32768, cfg, True, hd=128) == 1
    assert at.kv_splits(target // 2, 1, 32768, cfg, True, hd=128) == 2
    assert at.kv_splits(1, 1, 32768, cfg, True, hd=128) == 256 // at.SPLIT_MIN_BLOCKS  # blocks limit


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
        assert cfg.is_valid()
        for hd in (64, 128):
            for path in (cfg.bf16_path(), "simt_f32"):
                assert cfg.smem_bytes(hd, path) <= at.SMEM_LIMIT, (cfg, hd, path)
            assert cfg.stages(hd) >= 2 and cfg.threads(cfg.bf16_path()) % 32 == 0
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
    """Every config against the plain version on the card, each called twice in a row
    (bitwise equal: the split combine runs in split order and leaves its counters at 0),
    on the path its block_q names, split where kv_splits says so."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [((1, 2), 128, 128), ((2, 3), 1, 300), ((2, 3), 7, 7), ((2, 3), 50, 130), ((2, 3), 40, 24),
             ((2, 3), 1, 4103), ((2, 3), 4, 4103), ((1, 4), 300, 200), ((1, 32), 1, 32768)]
    for d in (64, 128):
        for lead, sq, skv in cases:
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
                q, k, v = (torch.from_numpy(x).cuda().to(dtype) for x in _inputs(sq, skv, d, lead=lead))
                for causal in (False, True):
                    want = at.attention_plain(q, k, v, causal=causal).float()
                    for cfg in at.config_space():
                        paths = dict(at.PATH_LAUNCHES)
                        first = at.attention_cuda(q, k, v, cfg, causal=causal)
                        second = at.attention_cuda(q, k, v, cfg, causal=causal)
                        where = (cfg.name(), d, lead, sq, skv, dtype, causal)
                        for got in (first.float(), second.float()):
                            assert torch.isfinite(got).all(), where
                            assert ((got - want).abs().max() / want.abs().max()).item() <= tol, where
                        assert torch.equal(first, second), where
                        if causal and sq > skv:
                            assert (first[..., : sq - skv, :] == 0).all(), where
                        path = cfg.bf16_path() if dtype == torch.bfloat16 else "simt_f32"
                        split = dtype == torch.bfloat16 and at.launch_splits(q[..., 0, 0].numel(), sq, skv, d, cfg,
                                                                             causal, 0) > 1
                        delta = {p: c - paths[p] for p, c in at.PATH_LAUNCHES.items() if c != paths[p]}
                        assert delta == {path: 2, **({"split": 2} if split else {})}, (where, delta)
