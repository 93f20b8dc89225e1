"""The port's RWKV6 model against the JAX package's, on the same weights.

Reduced rwkv6-7b in f32 on the CPU (2 layers, d_model 64, 4 heads of
head_dim 16): prefill logits on a left-padded bucket prompt (as the engine
admits it), the wkv/x1/x2 caches after prefill, and three chained decode
steps agree within rtol = atol = 1e-4 (the GEMMs and the WKV sum in another
order; the rest is elementwise).  The layer pieces are held against the jnp
ones on random inputs, and the featurized GEMM and WKV problems against the
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
from repro.kernels.wkv import DEFAULT_WKV_CONFIG as JAX_WKV_DEFAULT
from repro.models import rwkv as jr
from repro_torch.configs import registry
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.kernels.wkv import DEFAULT_WKV_CONFIG
from repro_torch.models import rwkv as tr
from repro_torch.models.model import RWKV6LM, build_model

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "rwkv6-7b"
CACHE = ("wkv", "x1", "x2")


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
    assert (ours.n_layers, ours.d_model, ours.n_heads, ours.head_dim, ours.d_ff, ours.vocab) == (
        32, 4096, 64, 64, 14336, 65536)
    assert isinstance(build_model(ours.reduced(), device="cpu"), RWKV6LM)


def test_init_matches_reference_tree_and_constants():
    jm, jp, tm, _ = reduced_pair(ARCH)
    tp = tm.init(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}['{key}']")
            else:
                flat_t[f"{prefix}['{key}']"] = val

    walk(tp, "")
    assert flat_t.keys() == flat_j.keys()
    for key, a in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, key
        if np.all(a == a.flat[0]):  # constant initializers (mu, w0, u, ln_w, norms) match exactly
            assert torch.all(t == float(a.flat[0])), key
        else:  # random ones match in scale
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.25, key


def test_prefill_and_decode_match_reference():
    jm, jp, tm, tp = reduced_pair(ARCH)
    cfg, cache_len = tm.cfg, 64
    toks = _prompt(cfg.vocab, 11, 32, seed=3)
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tlogits, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cache_len)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (2, 1, cfg.padded_vocab())
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for key in CACHE:
        assert tcache[key].dtype == (torch.float32)
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)

    rng = np.random.default_rng(4)
    pos = np.full((2,), toks.shape[1], np.int32)
    for _ in range(3):
        step = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))
        tlogits, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
    for key in CACHE:
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_shift_matches_jnp(with_prev):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 8), dtype=np.float32)
    prev = rng.standard_normal((2, 8), dtype=np.float32) if with_prev else None
    want = jr._shift(jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    got = tr._shift(torch.from_numpy(x), None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tr._shift(torch.from_numpy(x[:, :1]), None if prev is None else torch.from_numpy(prev))
    assert tuple(one.shape) == (2, 1, 8)


def test_head_norm_and_decode_step_match_jnp():
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    o, w = f(2, 3, 4, 16), f(4, 16)
    np.testing.assert_allclose(tr._head_norm(torch.from_numpy(o), torch.from_numpy(w)).numpy(),
                               np.asarray(jr._head_norm(jnp.asarray(o), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    r, k, v = f(2, 1, 4, 16), f(2, 1, 4, 16), f(2, 1, 4, 16)
    logw = -np.exp(f(2, 1, 4, 16) * 0.5).clip(1e-3, 5.0)
    u, state = f(4, 16) * 0.3, f(2, 4, 16, 16) * 0.1
    want = jr.wkv_decode_step(*(jnp.asarray(a) for a in (r, k, v, logw, u, state)))
    got = tr.wkv_decode_step(*(torch.from_numpy(a) for a in (r, k, v, logw, u, state)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)


class _Recorder:
    """Policy that records every matmul and wkv problem it is asked about."""

    cacheable = False  # consult the policy on every selection, not once per shape

    def __init__(self, config, wkv_config):
        self.config, self.wkv_config = config, wkv_config
        self.seen, self.wkv_seen, self.calls = set(), set(), 0

    def select_matmul(self, m, k, n, batch):
        self.seen.add((m, k, n, batch))
        self.calls += 1
        return self.config

    def select_wkv(self, s, hd):
        self.wkv_seen.add((s, hd))
        return self.wkv_config


def test_featurization_and_gemm_count_match_reference(monkeypatch):
    """Both packages select for the same matmul and wkv problems over one
    prefill and one decode step, and a forward runs 10 GEMMs a layer plus the
    vocab GEMM.  Both select once per scanned layer body (JAX traces it once;
    the port's ``ops.scan_layers`` replays layer 0's selections), so the
    selection counts are equal; the port's GEMM calls are counted at the
    plain version it runs on the CPU."""
    from repro_torch.kernels import ops

    jm, jp, tm, tp = reduced_pair(ARCH)
    toks = _prompt(tm.cfg.vocab, 9, 32, seed=6)
    step, pos = np.array([[3], [5]], np.int32), np.array([32, 32], np.int32)

    jrec, jrt = _Recorder(JAX_DEFAULT, JAX_WKV_DEFAULT), JaxRuntime()
    jrt.install(jrec)
    with jrt.activate():
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
        jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))

    gemms = []
    plain = ops.matmul_plain
    monkeypatch.setattr(ops, "matmul_plain", lambda *a: gemms.append(1) or plain(*a))
    trec, trt = _Recorder(DEFAULT_CONFIG, DEFAULT_WKV_CONFIG), KernelRuntime()
    trt.install(trec)
    with trt.activate():
        _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, 64)
        assert trec.calls == 10 + 1 and len(gemms) == 10 * tm.cfg.n_layers + 1
        tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        assert trec.calls == jrec.calls == 2 * (10 + 1) and len(gemms) == 2 * (10 * tm.cfg.n_layers + 1)

    assert trec.seen == jrec.seen and trec.wkv_seen == jrec.wkv_seen == {(32, 16)}
    assert (32, 64, 64, 2) in trec.seen and (1, 64, 256, 2) in trec.seen and (32, 64, 128, 2) in trec.seen
