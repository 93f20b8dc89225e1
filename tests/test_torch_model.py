"""The port's dense transformer against the JAX package's, on the same weights.

Reduced granite-8b and phi4-mini-3.8b in f32 on the CPU: prefill logits (on a
left-padded bucket prompt, as the engine admits it), the cache after prefill,
and three chained decode steps agree within 1e-4 (the GEMMs and attention
sum in another order; the rest is elementwise).  The attention functions are
held against the jnp ones on random GQA inputs, and the matmul featurization
against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.kernels.matmul import DEFAULT_CONFIG as JAX_DEFAULT
from repro.models import layers as jl
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-8b", "phi4-mini-3.8b"]


def _prompt(cfg, n_real, bucket, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, bucket), np.int32)
    toks[0, -n_real:] = rng.integers(1, cfg.vocab, n_real)  # left-padded with id 0
    toks[1] = rng.integers(1, cfg.vocab, bucket)
    return toks


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jm, jp, tm, tp = reduced_pair(arch)
    cfg, cache_len = tm.cfg, 64
    toks = _prompt(cfg, 11, 32, seed=3)
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tlogits, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tlogits.dtype == torch.float32 and tlogits.shape[-1] == cfg.padded_vocab()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    rng = np.random.default_rng(4)
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(3):
        step = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))
        tlogits, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


def _gqa(b, s, t, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, t, kvh, hd), dtype=np.float32)
    v = rng.standard_normal((b, t, kvh, hd), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "s,t,q_chunk,kv_chunk",
    [(16, 16, 512, 1024), (5, 21, 512, 1024), (10, 21, 4, 8), (13, 13, 5, 6)],
)
def test_flash_attention_matches_jnp(s, t, q_chunk, kv_chunk):
    q, k, v = _gqa(2, s, t, 4, 2, 16, seed=s * 31 + t)
    want = jl.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_jnp():
    q, k, v = _gqa(3, 1, 24, 8, 2, 16, seed=9)
    valid = np.array([1, 13, 24], np.int32)
    want = jl.decode_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
    got = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(valid).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_norm_and_rope_match_jnp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    w = rng.standard_normal((16,), dtype=np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.rope(torch.from_numpy(x), torch.from_numpy(pos).long()).numpy(),
                               np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos))), rtol=1e-4, atol=1e-4)


class _Recorder:
    """Policy that records every matmul problem it is asked about."""

    cacheable = False  # consult the policy on every selection, not once per shape

    def __init__(self, config):
        self.config = config
        self.seen = set()

    def select_matmul(self, m, k, n, batch):
        self.seen.add((m, k, n, batch))
        return self.config


def test_matmul_featurization_matches_reference():
    """Both packages select for the same (m, k, n, batch) problems over one
    prefill and one decode step.  JAX selects once per trace of the scanned
    layer body and eager torch once per call, so the counts differ by design;
    the sets of problems must not."""
    jm, jp, tm, tp = reduced_pair("granite-8b")
    toks = _prompt(tm.cfg, 9, 32, seed=6)
    step, pos = np.array([[3], [5]], np.int32), np.array([32, 32], np.int32)

    jrec, jrt = _Recorder(JAX_DEFAULT), JaxRuntime()
    jrt.install(jrec)
    with jrt.activate():
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
        jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))

    trec, trt = _Recorder(DEFAULT_CONFIG), KernelRuntime()
    trt.install(trec)
    with trt.activate():
        _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 64)
        tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())

    assert trec.seen == jrec.seen
    assert (32, 64, 64, 2) in trec.seen and (1, 64, 256, 2) in trec.seen
