"""The port's MoE FFN against the JAX package's, on the same numpy inputs.

``moe_ffn`` (router GEMM, softmax, top-k with renormalised gates, the Switch
aux loss, capacity buckets, the scatter, the expert SwiGLU einsums and the
gate-weighted combine) within 1e-5 in f32, out and aux, for both MoE
configs: their reduced shapes and their full expert counts at narrow widths,
with no drops (capacity above every expert's load), with drops (many tokens,
a skewed router), and with a zero router, where every probability ties and
the top-k must put the lower expert index first, as ``jax.lax.top_k`` does.
Then the reduced MoE models' ``prefill_chunk`` across a padded final chunk,
and an int8 cache against the f32 one and the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.configs import registry as jax_registry
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.configs.base import MoESpec
from repro_torch.models import moe
from repro_torch.models.model import build_model

MOE_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch):
    """(port cfg, reference cfg) of ``arch``: the reduced one, and one with the
    arch's full expert count and top-k at narrow widths."""
    full = registry.get(arch).moe
    cfgs = []
    for moe_spec in (None, MoESpec(full.n_experts, full.top_k)):
        cfg = registry.get(arch).reduced()
        jcfg = jax_registry.get(arch).reduced()
        if moe_spec is not None:
            cfg = dataclasses.replace(cfg, d_ff=32, moe=moe_spec)
            jcfg = dataclasses.replace(jcfg, d_ff=32, moe=type(jcfg.moe)(moe_spec.n_experts, moe_spec.top_k))
        cfgs.append((cfg, jcfg))
    return cfgs


CASES = [(arch, i) for arch in MOE_ARCHS for i in range(2)]


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": rng.standard_normal((d, e), dtype=np.float32) * (2.0 / (d + e)) ** 0.5,
        "w_gate": rng.standard_normal((e, d, ff), dtype=np.float32) * 0.02,
        "w_up": rng.standard_normal((e, d, ff), dtype=np.float32) * 0.02,
        "w_down": rng.standard_normal((e, ff, d), dtype=np.float32) * 0.02,
    }


def _both(p, x, cfg, jcfg):
    out, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfg)
    jout, jaux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)
    return out


def _max_load(p, x, cfg):
    """The most assignments any expert receives (the reference's routing)."""
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) @ jnp.asarray(p["router"])
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)
    return int(np.bincount(np.asarray(ids).reshape(-1), minlength=cfg.moe.n_experts).max())


def _capacity(cfg, t):
    return max(1, int(t * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor))


@pytest.mark.parametrize("arch, i", CASES)
def test_moe_ffn_without_drops(arch, i):
    cfg, jcfg = _cfgs(arch)[i]
    factor = cfg.moe.n_experts / cfg.moe.top_k  # capacity = T: no expert can overflow
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=factor))
    p = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    assert _max_load(p, x, cfg) <= _capacity(cfg, 10)
    out = _both(p, x, cfg, jcfg)
    assert torch.all(out.abs().sum(-1) > 0)  # every token reached its experts


@pytest.mark.parametrize("arch, i", CASES)
def test_moe_ffn_with_drops(arch, i):
    """64 tokens with a router leaning on expert 0: its load passes capacity,
    and the dropped assignments contribute nothing in both packages."""
    cfg, jcfg = _cfgs(arch)[i]
    p = _params(cfg, 2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32) + 0.5
    p["router"][:, 0] += 0.5 / cfg.d_model ** 0.5
    assert _max_load(p, x, cfg) > _capacity(cfg, 64)
    _both(p, x, cfg, jcfg)


@pytest.mark.parametrize("arch, i", CASES)
def test_moe_ffn_zero_router_breaks_ties_by_index(arch, i):
    """Every probability equal: both packages route every token to experts
    0 .. k-1 (the lower index first), so only their first buckets fill."""
    cfg, jcfg = _cfgs(arch)[i]
    p = _params(cfg, 4)
    p["router"][:] = 0.0
    x = np.random.default_rng(5).standard_normal((1, 24, cfg.d_model), dtype=np.float32)
    out = _both(p, x, cfg, jcfg)
    cap = _capacity(cfg, 24)
    kept = np.asarray(out.abs().sum(-1) > 0).reshape(-1)
    assert kept[:cap].all() and not kept[cap:].any()  # the first `cap` tokens fit experts 0 .. k-1


def test_moe_ffn_bf16_runs_in_activation_dtype():
    cfg, _ = _cfgs("qwen3-moe-235b-a22b")[1]
    p = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _params(cfg, 6).items()}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 3, cfg.d_model), dtype=np.float32))
    out, aux = moe.moe_ffn(p, x.to(torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32 and torch.isfinite(out.float()).all()


def test_init_moe_shapes_and_scales():
    cfg = registry.get("dbrx-132b").reduced()
    g = torch.Generator().manual_seed(0)
    normal = lambda shape, scale: torch.randn(shape, generator=g) * scale
    p = moe.init_moe(cfg, normal, n_layers=3)
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, d, e), "w_gate": (3, e, d, ff), "w_up": (3, e, d, ff), "w_down": (3, e, ff, d)}
    assert abs(p["w_gate"].std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_chunk_matches_reference(arch):
    """Logits and cache within 1e-4 at starts 0, 32 and 48, the last a padded
    final chunk whose rows cross cache_len = 64.  Each chunk routes its own
    tokens (capacity from the chunk's length), in both packages."""
    jm, jp, tm, tp = reduced_pair(arch)
    assert tm.is_moe and tm.supports_chunked_prefill()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, 80)
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64)
    for start, width, last in ((0, 32, 31), (32, 16, 10), (48, 32, 15)):
        chunk = np.zeros(width, np.int64)
        real = toks[start:start + width]
        chunk[:len(real)] = real
        jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(chunk[None].astype(np.int32)), jnp.int32(start), jnp.int32(last))
        tl, tc = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk[None]), torch.tensor(start), torch.tensor(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_int8_cache_close_to_fp_and_to_reference(arch):
    jm_fp, jp, tm_fp, tp = reduced_pair(arch)
    jm = jax_build_model(jm_fp.cfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=True)
    tm = build_model(tm_fp.cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=True)
    assert not tm.supports_chunked_prefill()
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
    np.testing.assert_allclose(log_q8.numpy(), log_fp.numpy(), rtol=0.1, atol=0.15)
    assert np.all(np.argmax(log_fp.numpy(), -1) == np.argmax(log_q8.numpy(), -1))
    np.testing.assert_allclose(log_q8.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    for key in cache_q8:
        if key in ("k", "v"):  # int8 values: a rounding tie may land one step apart
            assert np.abs(cache_q8[key].numpy().astype(int) - np.asarray(jcache[key]).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(cache_q8[key].numpy(), np.asarray(jcache[key]), rtol=1e-4, atol=1e-6)
