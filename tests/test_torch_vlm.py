"""The port's VLM pieces against the JAX package's, on the same numpy inputs.

Non-causal grouped-query attention with more or fewer query rows than key
rows (a prompt bucket against the image tokens) and the cross-attention
layer (no rope, no mask, k/v from the image) within 1e-5; reduced
llama-3.2-vision-90b at one and three groups: prefill logits, every cache leaf and
three decode steps within 1e-4, the selections one prefill and one decode
make (the grouped scans select once per traced body in both packages), and
an int8 cache against the f32 one and the reference's.  The serving engine's
pool classes the cross leaves as lane rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.kernels.matmul import DEFAULT_CONFIG as JAX_DEFAULT
from repro.models import layers as jl
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import DEFAULT_CONFIG
from repro_torch.kernels.ops import FixedPolicy
from repro_torch.models import layers as tl
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kvpool import KVPool, probe_cache_layout
from repro_torch.weights import params_from_jax

ARCH = "llama-3.2-vision-90b"
TOL = dict(rtol=1e-4, atol=1e-4)


def vlm_pair(n_layers=None, kv_quant=False):
    """Reduced llama-vision in both packages on the same f32 weights;
    ``n_layers`` a multiple of ``cross_every`` (2) gives more groups."""
    jcfg, tcfg = jax_registry.get(ARCH).reduced(), registry.get(ARCH).reduced()
    if n_layers is not None:
        jcfg, tcfg = dataclasses.replace(jcfg, n_layers=n_layers), dataclasses.replace(tcfg, n_layers=n_layers)
    jm = jax_build_model(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=kv_quant)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=kv_quant)
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu", dtype=torch.float32)


def _gqa(b, s, t, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, t, kvh, hd), dtype=np.float32),
            rng.standard_normal((b, t, kvh, hd), dtype=np.float32))


@pytest.mark.parametrize("s,t,q_chunk,kv_chunk", [(32, 16, 512, 1024), (5, 40, 512, 1024), (40, 24, 16, 10),
                                                  (1, 1024, 512, 1024)])
def test_non_causal_flash_attention_matches_jnp(s, t, q_chunk, kv_chunk):
    q, k, v = _gqa(2, s, t, 4, 2, 16, seed=s + t)
    want = jl.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cross_attention_layer_matches_reference():
    cfg = registry.get(ARCH).reduced()
    rng = np.random.default_rng(2)
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {"wq": rng.standard_normal((d, qd)), "wk": rng.standard_normal((d, kd)),
         "wv": rng.standard_normal((d, kd)), "wo": rng.standard_normal((qd, d))}
    p = {k: (v * 0.1).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    img = rng.standard_normal((2, cfg.n_image_tokens, d)).astype(np.float32)
    want, _ = jl.attention_layer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg, None,
                                 kv_input=jnp.asarray(img), causal=False, use_rope=False)
    got = tl.attention_layer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg, None,
                             kv_input=torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (2, 32)).astype(np.int32)
    toks[0, :20] = 0  # left-padded, as the engine admits a 12-token prompt
    img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return toks, img


@pytest.mark.parametrize("n_layers", [2, 6])
def test_grouped_prefill_and_decode_match_reference(n_layers):
    """One group, then three groups of two self layers and a cross block."""
    jm, jp, tm, tp = vlm_pair(n_layers)
    assert (tm.n_groups, tm.self_per_group) == (jm.n_groups, jm.self_per_group) == (n_layers // 2, 1)
    toks, img = _inputs(tm.cfg)
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "image_embs": jnp.asarray(img)}, 64)
    tl_, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(), "image_embs": torch.from_numpy(img)}, 64)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL, err_msg=key)
    assert torch.any(tc["cross_k"] != 0)
    pos = np.full(2, 32, np.int32)
    rng = np.random.default_rng(4)
    for _ in range(3):
        step = rng.integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(step), jnp.asarray(pos))
        tl_, tc = tm.decode_step(tp, tc, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
        pos = pos + 1
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL, err_msg=key)


class _Recorder:
    """Policy that records every matmul problem it is asked about, in order."""

    cacheable = False

    def __init__(self, config):
        self.config = config
        self.seen = []

    def select_matmul(self, m, k, n, batch):
        self.seen.append((m, k, n, batch))
        return self.config


def test_grouped_scans_select_as_the_reference_traces():
    """A 6-layer VLM (three groups): the reference traces each scanned body
    once, so one prefill selects layer 0's 7 calls, the cross block's 7 and
    the cached cross K/V's 2, then the head; one decode step layer 0's 7,
    the cross block's 5 and the head.  The port's nested ``scan_layers``
    select the same problems in the same order."""
    jm, jp, tm, tp = vlm_pair(6)
    toks, img = _inputs(tm.cfg)
    step, pos = np.array([[3], [5]], np.int32), np.array([32, 32], np.int32)
    jrec, jrt = _Recorder(JAX_DEFAULT), JaxRuntime()
    jrt.install(jrec)
    with jrt.activate():
        _, jc = jax.jit(lambda p, b: jm.prefill(p, b, 64))(jp, {"tokens": jnp.asarray(toks),
                                                                "image_embs": jnp.asarray(img)})
        n_prefill = len(jrec.seen)
        jax.jit(jm.decode_step)(jp, jc, jnp.asarray(step), jnp.asarray(pos))
    trec, trt = _Recorder(DEFAULT_CONFIG), KernelRuntime()
    trt.install(trec)
    with trt.activate():
        _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(), "image_embs": torch.from_numpy(img)}, 64)
        assert len(trec.seen) == n_prefill == 7 + 9 + 1
        tm.decode_step(tp, tc, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
    assert trec.seen == jrec.seen and len(trec.seen) == 17 + 7 + 5 + 1


def test_int8_cache_close_to_fp_and_to_reference():
    jm_fp, jp, tm_fp, tp = vlm_pair()
    jm = jax_build_model(jm_fp.cfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=True)
    tm = build_model(tm_fp.cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=True)
    toks, img = _inputs(tm.cfg, seed=1)
    toks = toks[:, :12]
    tb = {"tokens": torch.from_numpy(toks).long(), "image_embs": torch.from_numpy(img)}
    out_fp, cache_fp = tm_fp.prefill(tp, tb, 32)
    out_q8, cache_q8 = tm.prefill(tp, tb, 32)
    jout, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks), "image_embs": jnp.asarray(img)}, 32)
    assert set(cache_q8) == set(jcache) == {"k", "v", "k_scale", "v_scale", "cross_k", "cross_v"}
    assert cache_q8["k"].dtype == torch.int8 and cache_q8["cross_k"].dtype == torch.float32
    np.testing.assert_allclose(out_q8.numpy(), out_fp.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_q8.numpy(), np.asarray(jout), **TOL)
    pos, nxt = np.full(2, 12), np.ones((2, 1), np.int64)
    log_fp, _ = tm_fp.decode_step(tp, cache_fp, torch.from_numpy(nxt), torch.from_numpy(pos))
    log_q8, _ = tm.decode_step(tp, cache_q8, torch.from_numpy(nxt), torch.from_numpy(pos))
    jlog, _ = jm.decode_step(jp, jcache, jnp.asarray(nxt.astype(np.int32)), jnp.asarray(pos.astype(np.int32)))
    np.testing.assert_allclose(log_q8.numpy(), log_fp.numpy(), rtol=0.1, atol=0.15)
    assert np.all(np.argmax(log_fp.numpy(), -1) == np.argmax(log_q8.numpy(), -1))
    np.testing.assert_allclose(log_q8.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("block_size", [None, 16])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_pool_classes_cross_leaves_as_lane_rows(block_size, kv_quant):
    """k/v (and int8 scales) page by token; cross_k / cross_v, whose image
    axis does not follow cache_len, are one row per lane, in the dense and
    paged pools alike, and gather / scatter / admit carry them."""
    _, _, tm, tp = vlm_pair(4, kv_quant=kv_quant)
    specs = probe_cache_layout(tm.init_cache, 64, block_size or 64)
    for key in ("['cross_k']", "['cross_v']"):
        assert (specs[key].kind, specs[key].batch_axis) == ("lane", 1)
    assert specs["['k']"].kind == "paged"
    pool = KVPool(tm, lanes=2, cache_len=64, block_size=block_size)
    toks, img = _inputs(tm.cfg)
    _, one = tm.prefill(tp, {"tokens": torch.from_numpy(toks[1:]).long(), "image_embs": torch.from_numpy(img[1:])}, 64)
    assert pool.ensure(1, 32)
    pool.admit(1, one)
    got = pool.gather([1])
    for key in one:
        assert torch.equal(got[key], one[key]), key
    got["cross_k"].add_(1.0)
    pool.scatter([1], got)
    assert torch.equal(pool.gather([1])["cross_k"], one["cross_k"] + 1.0)


def test_engine_refuses_streaming_with_extras():
    """Extras keep the legacy admission even on a chunk-capable model, as in the reference."""
    cfg = registry.get("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rt = KernelRuntime()
    rt.install(FixedPolicy())
    eng = ServingEngine(model, params, runtime=rt, max_batch=2, cache_len=64, block_size=16,
                        extra_inputs={"unused": np.zeros(3, np.float32)})
    assert not eng._streaming and not eng._sharing
    assert tuple(eng.extra_inputs["unused"].shape) == (1, 3)
