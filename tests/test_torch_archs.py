"""The remaining decoder architectures in the port against the JAX package's.

Reduced qwen2.5-32b (QKV bias, seeded nonzero so the bias add counts),
glm4-9b, qwen3-moe-235b-a22b, dbrx-132b and llama-3.2-vision-90b (seeded
image embeddings) in f32 on the CPU, on the same weights: prefill logits on a
left-padded bucket prompt, every cache leaf (a VLM's ``cross_k`` /
``cross_v`` included) and three chained decode steps within 1e-4.  The
registry holds the reference's ten configs in its order, so the default
harvests are the reference's; the encoder-decoder (seamless), which the
training slice ported, builds and converts (``tests/test_torch_loss.py`` and
``tests/test_torch_train.py`` hold it to the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import model_pair
from repro.configs import registry as jax_registry
from repro.core import attnmodel as jax_attnmodel
from repro.core import dataset as jax_dataset
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.core import attnmodel, dataset
from repro_torch.models.model import build_model
from repro_torch.weights import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2.5-32b", "glm4-9b", "qwen3-moe-235b-a22b", "dbrx-132b", "llama-3.2-vision-90b"]


def _batch(cfg, bucket=32, n_real=11, seed=3):
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, bucket), np.int32)
    toks[0, -n_real:] = rng.integers(1, cfg.vocab, n_real)  # left-padded with id 0, as the engine admits
    toks[1] = rng.integers(1, cfg.vocab, bucket)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "vlm":
        img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        jb["image_embs"], tb["image_embs"] = jnp.asarray(img), torch.from_numpy(img)
    return jb, tb


def _caches_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jm, jp, tm, tp = model_pair(arch)
    cfg, cache_len = tm.cfg, 64
    jb, tb = _batch(cfg)
    jlogits, jcache = jm.prefill(jp, jb, cache_len)
    tlogits, tcache = tm.prefill(tp, tb, cache_len)
    assert tlogits.dtype == torch.float32 and tlogits.shape[-1] == cfg.padded_vocab()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _caches_close(tcache, jcache)

    rng = np.random.default_rng(4)
    pos = np.full((2,), 32, np.int32)
    for _ in range(3):
        step = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(step), jnp.asarray(pos))
        tlogits, tcache = tm.decode_step(tp, tcache, torch.from_numpy(step).long(), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
    _caches_close(tcache, jcache)


def test_qkv_bias_changes_the_answer():
    """The seeded biases reach the logits: zero biases give other logits."""
    _, _, tm, tp = model_pair("qwen2.5-32b")
    _, tb = _batch(tm.cfg)
    with_bias, _ = tm.prefill(tp, tb, 64)
    for key in ("bq", "bk", "bv"):
        tp["blocks"]["attn"][key] = torch.zeros_like(tp["blocks"]["attn"][key])
    without, _ = tm.prefill(tp, tb, 64)
    assert (with_bias - without).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """``init`` gives the reference's tree: the same leaves and shapes (zero
    biases, the MoE and cross trees), on the port's own generator."""
    jm = jax_build_model(jax_registry.get(arch).reduced(), dtype=jnp.float32, param_dtype=jnp.float32)
    want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = build_model(registry.get(arch).reduced(), dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    got_params = tm.init(torch.Generator().manual_seed(0))
    got = _shapes(got_params)
    got["emb"].pop("embed_t", None)  # the port's load-time copy of embed.T (tied embeddings)
    assert got == want
    if tm.cfg.qkv_bias:
        assert all(not torch.any(got_params["blocks"]["attn"][k]) for k in ("bq", "bk", "bv"))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def test_init_draws_in_pieces_into_the_param_dtype(monkeypatch):
    """A weight larger than one piece is drawn piece by piece, in order, into a
    bf16 tensor; a weight within one piece is one draw of the whole."""
    from repro_torch.models import model as model_mod

    monkeypatch.setattr(model_mod, "_DRAW_ELEMS", 1000)
    cfg = registry.get("glm4-9b").reduced()
    tm = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device="cpu")
    normal, _ = model_mod._initializers(tm, torch.Generator().manual_seed(5))
    got = normal((3, 700), 0.5)
    g = torch.Generator().manual_seed(5)
    want = torch.cat([torch.randn(n, generator=g) * 0.5 for n in (1000, 1000, 100)]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.view(3, 700))
    whole = normal((10, 100), 0.5)  # one piece: one draw
    assert torch.equal(whole, (torch.randn((10, 100), generator=g) * 0.5).to(torch.bfloat16))


def test_registry_matches_reference():
    assert list(registry.ARCHS) == list(jax_registry.ARCHS)
    for name, cfg in registry.ARCHS.items():
        assert cfg.__dict__ == {**jax_registry.ARCHS[name].__dict__, "moe": cfg.moe}
        assert (cfg.moe is None) == (jax_registry.ARCHS[name].moe is None)
        if cfg.moe is not None:
            assert cfg.moe.__dict__ == jax_registry.ARCHS[name].moe.__dict__


def test_default_harvests_equal_reference():
    assert dataset.harvest_problems() == jax_dataset.harvest_problems()
    assert attnmodel.harvest_attn_problems(None) == jax_attnmodel.harvest_attn_problems(None)
    for arch in registry.ARCHS:
        for shape in registry.shapes_for(arch):
            assert registry.gemm_problems(arch, shape) == jax_registry.gemm_problems(arch, shape)


def test_seamless_is_refused_with_a_message():
    """Once refused until the training slice; now ``build_model`` builds the
    ``EncDecLM`` and ``params_from_jax`` converts its tree, leaf for leaf."""
    cfg = registry.get("seamless-m4t-large-v2").reduced()
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == "EncDecLM" and hasattr(model, "loss_fn")
    jm = jax_build_model(jax_registry.get("seamless-m4t-large-v2").reduced(), dtype=jnp.float32,
                         param_dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = params_from_jax(np_params, cfg, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(np_params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), params))[0])
    assert set(got) == set(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(got[path], arr)
    assert {k: tuple(v.shape) for k, v in model.init(torch.Generator().manual_seed(0))["decoder"]["cross"].items()} \
        == {k: tuple(v.shape) for k, v in params["decoder"]["cross"].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_routes_and_flags(arch):
    cfg = registry.get(arch).reduced()
    tm = build_model(cfg, device="cpu")
    assert tm.is_moe == (cfg.moe is not None) and tm.is_vlm == (cfg.family == "vlm")
    assert tm.supports_chunked_prefill() == (not tm.is_vlm)
    assert not build_model(cfg, device="cpu", kv_quant=True).supports_chunked_prefill()
    if tm.is_vlm:
        assert (tm.n_groups, tm.self_per_group, tm.n_self) == (1, 1, 1)
        assert set(tm.init_cache(3, 16)) == {"k", "v", "cross_k", "cross_v"}
        assert tuple(tm.init_cache(3, 16)["cross_k"].shape) == (1, 3, cfg.n_image_tokens, cfg.n_kv_heads,
                                                                cfg.head_dim)
