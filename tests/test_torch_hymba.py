"""The port's Hymba model against the JAX package's, on the same weights.

Reduced hymba-1.5b in f32 on the CPU.  ``ArchConfig.reduced()`` gives 2
layers, and with global layers at {0, n // 2, n - 1} both are global, so the
model tests use 4 layers (``['global', 'swa', 'global', 'global']``, window
32): prefill logits on a 64-token bucket (the sliding-window layer's 32-slot
ring is written by the ring-buffer prefill path), every cache leaf, and three
chained decode steps (which wrap the ring) agree within rtol = atol = 1e-4
(the GEMMs and the scan sum in another order; the rest is elementwise).  The
Mamba head and the attention pieces Hymba adds (a sliding window, a ring
buffer's valid count and its prefill write) are held against the jnp ones on
random inputs, and the featurized GEMM and SSM problems against the
reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.configs import registry as jax_registry
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.kernels.matmul import DEFAULT_CONFIG as JAX_DEFAULT
from repro.kernels.ssm import DEFAULT_SSM_CONFIG as JAX_SSM_DEFAULT
from repro.models import layers as jl
from repro.models import mamba as jmb
from repro_torch.configs import registry
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.kernels.ssm import DEFAULT_SSM_CONFIG
from repro_torch.models import layers as tl
from repro_torch.models import mamba as tmb
from repro_torch.models.model import HymbaLM, build_model
from repro_torch.serve.kvpool import flatten_cache

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "hymba-1.5b"
N_LAYERS = 4  # the smallest depth with a sliding-window layer


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten_cache(tree).items()}


def _prompt(vocab, n_real, bucket, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, bucket), np.int32)
    toks[0, -n_real:] = rng.integers(1, vocab, n_real)  # left-padded with id 0
    toks[1] = rng.integers(1, vocab, bucket)
    return toks


def test_config_is_the_references():
    ours, ref = registry.get(ARCH), jax_registry.get(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
    assert (ours.n_layers, ours.d_model, ours.n_heads, ours.n_kv_heads, ours.head_dim, ours.d_ff, ours.vocab,
            ours.ssm_state, ours.window) == (32, 1600, 25, 5, 64, 5504, 32001, 16, 2048)
    assert isinstance(build_model(ours.reduced(), device="cpu"), HymbaLM)
    jm, _, tm, _ = reduced_pair(ARCH, N_LAYERS)
    assert tm._layer_kinds() == jm._layer_kinds() == ["global", "swa", "global", "global"]
    assert tm._layer_kinds()[:2] != HymbaLM(ours.reduced(), device="cpu")._layer_kinds()[:2]


def test_init_matches_reference_tree_and_constants():
    jm, jp, tm, _ = reduced_pair(ARCH, N_LAYERS)
    tp = tm.init(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {"".join(f"['{k}']" for k in path): t for path, t in flatten_cache(tp).items()}
    assert flat_t.keys() == flat_j.keys()
    for key, a in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, key
        if key.endswith("['a_log']"):  # 0.5 log(1..N): the two libraries' log may differ in the last bit
            np.testing.assert_allclose(t.numpy(), a, rtol=1e-6, err_msg=key)
        elif np.all(a == a.flat[0]):  # constant initializers (norms, d_skip) match exactly
            np.testing.assert_array_equal(t.numpy(), a, err_msg=key)
        else:  # random ones match in scale
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.25, key


def test_prefill_and_decode_match_reference():
    jm, jp, tm, tp = reduced_pair(ARCH, N_LAYERS)
    cfg, cache_len = tm.cfg, 128
    toks = _prompt(cfg.vocab, 40, 64, seed=3)  # bucket 64 >= the 32-slot ring
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tlogits, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (2, 1, cfg.padded_vocab())
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    want = _np(jcache)
    got = _np(tcache)
    assert got.keys() == want.keys() and got[("layer1", "k")].shape[1] == 32
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=str(key))

    rng = np.random.default_rng(4)
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(3):
        step = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))
        tlogits, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
    want, got = _np(jcache), _np(tcache)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=str(key))


def _mamba_params(cfg):
    jp = jax.tree.map(lambda a: a[0], jmb.init_mamba(jax.random.PRNGKey(0), cfg))
    return jp, {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}


def test_mamba_layer_and_decode_step_match_jnp():
    cfg = registry.get(ARCH).reduced()
    jp, tp = _mamba_params(jax_registry.get(ARCH).reduced())
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32) * 0.5
    want = jmb.mamba_layer(jp, jnp.asarray(x), cfg)
    got = tmb.mamba_layer(tp, torch.from_numpy(x), cfg)
    assert tuple(got[1].shape) == (2, cfg.d_model, cfg.ssm_state) and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    state = rng.standard_normal((2, cfg.d_model, cfg.ssm_state), dtype=np.float32) * 0.1
    want = jmb.mamba_decode_step(jp, jnp.asarray(x[:, :1]), jnp.asarray(state), cfg)
    got = tmb.mamba_decode_step(tp, torch.from_numpy(x[:, :1]), torch.from_numpy(state), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mamba_prefill_decode_consistency():
    """Prefill of 8 tokens then one decode step equals a prefill of 9
    (tests/test_ssm_kernel.py's invariant).  Both sides run the same f32
    recurrence, so the reference's 2e-3 tightens to 1e-4."""
    cfg = registry.get(ARCH).reduced()
    _, p = _mamba_params(jax_registry.get(ARCH).reduced())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, cfg.d_model), dtype=np.float32) * 0.5)
    y_full, h_full = tmb.mamba_layer(p, x, cfg)
    _, h_pre = tmb.mamba_layer(p, x[:, :8], cfg)
    y_dec, h_dec = tmb.mamba_decode_step(p, x[:, 8:9], h_pre, cfg)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, 8].numpy(), **TOL)
    np.testing.assert_allclose(h_dec.numpy(), h_full.numpy(), **TOL)


def _gqa(b, s, t, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, t, kvh, hd), dtype=np.float32)
    v = rng.standard_normal((b, t, kvh, hd), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "s,t,window,q_chunk,kv_chunk",
    [(16, 16, 5, 512, 1024), (5, 21, 4, 512, 1024), (21, 21, 3, 4, 8), (13, 13, 32, 5, 6), (40, 40, 32, 16, 8)],
)
def test_windowed_flash_attention_matches_jnp(s, t, window, q_chunk, kv_chunk):
    q, k, v = _gqa(2, s, t, 4, 2, 16, seed=s * 31 + t + window)
    want = jl.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _attn(seed):
    """One reduced-hymba attention layer's params in both packages and an input."""
    cfg = registry.get(ARCH).reduced()
    jp = jax.tree.map(lambda a: a[0], jl.init_attention(jax.random.PRNGKey(seed), jax_registry.get(ARCH).reduced()))
    tp = {k: torch.from_numpy(np.array(a)) for k, a in jp.items()}
    return cfg, jp, tp


@pytest.mark.parametrize("s,t_cache,window", [(13, 8, 8), (8, 8, 8), (40, 32, 32), (5, 8, 0)])
def test_prefill_ring_write_matches_reference(s, t_cache, window):
    """s >= T: the ring keeps the last T tokens at slots p % T; s < T: the
    prefix is written at [0, s)."""
    cfg, jp, tp = _attn(s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    zeros = np.zeros((2, t_cache, cfg.n_kv_heads, cfg.head_dim), np.float32)
    jcfg = jax_registry.get(ARCH).reduced()
    want, (jk, jv) = jl.attention_layer(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), window=window,
                                        cache=(jnp.asarray(zeros), jnp.asarray(zeros)))
    kc, vc = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    got = tl.attention_layer(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos).long(), cache=(kc, vc),
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(vc.numpy(), np.asarray(jv), **TOL)


def test_decode_with_cache_valid_matches_reference():
    """A ring's decode: write slot p % T, attend over min(p + 1, T) slots."""
    cfg, jp, tp = _attn(9)
    rng = np.random.default_rng(9)
    t = 8
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    kc = rng.standard_normal((3, t, cfg.n_kv_heads, cfg.head_dim), dtype=np.float32)
    vc = rng.standard_normal((3, t, cfg.n_kv_heads, cfg.head_dim), dtype=np.float32)
    positions = np.array([3, 8, 21], np.int32)
    cpos, cvalid = positions % t, np.minimum(positions + 1, t)
    jcfg = jax_registry.get(ARCH).reduced()
    want, (jk, jv) = jl.attention_layer(jp, jnp.asarray(x), jcfg, jnp.asarray(positions[:, None]),
                                        cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                        cache_positions=jnp.asarray(cpos), cache_valid=jnp.asarray(cvalid))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tl.attention_layer(tp, torch.from_numpy(x), cfg, torch.from_numpy(positions[:, None]).long(),
                             cache=(tk, tv), cache_positions=torch.from_numpy(cpos).long(),
                             cache_valid=torch.from_numpy(cvalid).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


class _Recorder:
    """Policy that records every matmul and ssm_scan problem it is asked about."""

    cacheable = False  # consult the policy on every selection, not once per shape

    def __init__(self, config, ssm_config):
        self.config, self.ssm_config = config, ssm_config
        self.seen, self.ssm_seen, self.calls, self.ssm_calls = set(), set(), 0, 0

    def select_matmul(self, m, k, n, batch):
        self.seen.add((m, k, n, batch))
        self.calls += 1
        return self.config

    def select_ssm(self, s, d):
        self.ssm_seen.add((s, d))
        self.ssm_calls += 1
        return self.ssm_config


def test_featurization_and_counts_match_reference():
    """Both packages select for the same matmul and ssm_scan problems over
    one prefill and one decode step; a forward runs 13 GEMMs a layer plus the
    vocab GEMM, a prefill one scan a layer, a decode step none."""
    jm, jp, tm, tp = reduced_pair(ARCH, N_LAYERS)
    n = tm.cfg.n_layers
    toks = _prompt(tm.cfg.vocab, 9, 32, seed=6)
    step, pos = np.array([[3], [5]], np.int32), np.array([32, 32], np.int32)

    jrec, jrt = _Recorder(JAX_DEFAULT, JAX_SSM_DEFAULT), JaxRuntime()
    jrt.install(jrec)
    with jrt.activate():
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
        jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))

    trec, trt = _Recorder(DEFAULT_CONFIG, DEFAULT_SSM_CONFIG), KernelRuntime()
    trt.install(trec)
    with trt.activate():
        _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 64)
        assert (trec.calls, trec.ssm_calls) == (13 * n + 1, n)
        tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        assert (trec.calls, trec.ssm_calls) == (2 * (13 * n + 1), n)

    assert trec.seen == jrec.seen and trec.ssm_seen == jrec.ssm_seen == {(32, 64)}
    assert (32, 64, 48, 2) in trec.seen and (32, 48, 64, 2) in trec.seen and (1, 64, 8, 2) in trec.seen
