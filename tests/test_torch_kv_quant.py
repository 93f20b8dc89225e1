"""int8 KV cache in the port against the JAX package's (``tests/test_kv_quant.py``).

``quantize_kv`` must give the reference's int8 values and scales exactly on
the same f32 input (absmax over hd, round half to even, clip to ±127), and
round-trip within half a scale step.  An int8-cache model's prefill logits
equal the f32 cache's (attention runs on the unquantized k/v), its decode
logits stay close to them and keep the top token, and both are within 1e-4 of
the reference's int8 model on the same weights; the cache takes about half
the bytes of a bf16 one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.models.layers import quantize_kv as jax_quantize_kv
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.models.layers import quantize_kv
from repro_torch.models.model import build_model


def test_quantize_kv_roundtrip_matches_reference():
    x = np.random.default_rng(0).standard_normal((4, 16, 2, 32)).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 127.0]  # halves: round to even in both packages
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == x.shape and tuple(s.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = q.float() * s[..., None]
    assert torch.all((back - torch.from_numpy(x)).abs() <= s[..., None] * 0.5 + 1e-6)


def test_quantize_kv_zeros():
    q, s = quantize_kv(torch.zeros((2, 3, 4)))
    assert torch.all(q == 0) and torch.all(torch.isfinite(s))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-8b"])
def test_kv_quant_decode_close_to_fp_and_to_reference(arch):
    jm_fp, jp, tm_fp, tp = reduced_pair(arch)
    jm = jax_build_model(jm_fp.cfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=True)
    tm = build_model(tm_fp.cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=True)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 12))
    out_fp, cache_fp = tm_fp.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
    out_q8, cache_q8 = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
    jout, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks.astype(np.int32))}, 32)
    assert cache_q8["k"].dtype == torch.int8 and set(cache_q8) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    np.testing.assert_allclose(out_q8.numpy(), out_fp.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_q8.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    pos, nxt = np.full(2, 12), np.ones((2, 1), np.int64)
    log_fp, _ = tm_fp.decode_step(tp, cache_fp, torch.from_numpy(nxt), torch.from_numpy(pos))
    log_q8, cache_q8 = tm.decode_step(tp, cache_q8, torch.from_numpy(nxt), torch.from_numpy(pos))
    jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt.astype(np.int32)), jnp.asarray(pos.astype(np.int32)))
    assert cache_q8["k"].dtype == torch.int8
    np.testing.assert_allclose(log_q8.numpy(), log_fp.numpy(), rtol=0.1, atol=0.15)
    assert np.all(np.argmax(log_fp.numpy(), -1) == np.argmax(log_q8.numpy(), -1))
    np.testing.assert_allclose(log_q8.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache_q8[key].numpy(), np.asarray(jcache[key]), rtol=1e-4, atol=1e-6)


def test_kv_quant_cache_is_half_the_bytes():
    cfg = registry.get("granite-8b").reduced()
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.values())
    fp = build_model(cfg, dtype=torch.bfloat16, device="cpu").init_cache(4, 128)
    q8 = build_model(cfg, dtype=torch.bfloat16, device="cpu", kv_quant=True).init_cache(4, 128)
    assert nbytes(q8) < 0.65 * nbytes(fp)  # int8 + f32 / hd scales
