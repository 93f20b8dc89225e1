"""The port's data pipeline and elastic plan against the JAX package's.

``TokenPipeline.batch`` for every registered architecture (so every family:
dense, MoE, VLM image embeddings, hybrid, RWKV6, encoder-decoder frames) at
several steps and host shards: token ids equal, and the bf16 leaves equal
bit for bit (the reference rounds with ml_dtypes, the port with
``Tensor.to(torch.bfloat16)``; both round to nearest, ties to even, which a
test on exact ties checks).  ``reshard`` and ``elastic_plan``'s four cases
give equal results.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core.faults import elastic_plan as jax_elastic_plan
from repro.data import pipeline as jax_pipeline
from repro_torch.configs import registry
from repro_torch.core.faults import ElasticPlan, elastic_plan
from repro_torch.data import pipeline

ARCHS = sorted(registry.ARCHS)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16)


def _equal(tb: dict, jb: dict) -> None:
    assert set(tb) == set(jb)
    for key, ref in jb.items():
        got = tb[key]
        assert tuple(got.shape) == ref.shape, key
        if ref.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(_bits(got), _ref_bits(ref), err_msg=key)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_reference(arch):
    tcfg, jcfg = registry.get(arch).reduced(), jax_registry.get(arch).reduced()
    data = dict(seed=5, global_batch=4, seq_len=24)
    tp = pipeline.TokenPipeline(tcfg, pipeline.DataConfig(**data))
    jp = jax_pipeline.TokenPipeline(jcfg, jax_pipeline.DataConfig(**data))
    for step in (0, 1, 7):
        _equal(tp.batch(step), jp.batch(step))


@pytest.mark.parametrize("hosts", [(0, 2), (1, 2), (3, 4)])
def test_host_shards_equal_reference(hosts):
    index, count = hosts
    data = dict(seed=1, global_batch=8, seq_len=16, host_index=index, host_count=count)
    for arch in ("granite-8b", "llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        tp = pipeline.TokenPipeline(registry.get(arch).reduced(), pipeline.DataConfig(**data))
        jp = jax_pipeline.TokenPipeline(jax_registry.get(arch).reduced(), jax_pipeline.DataConfig(**data))
        assert tp.data.local_batch == jp.data.local_batch == 8 // count
        _equal(tp.batch(3), jp.batch(3))


def test_device_batch_keeps_bf16_leaves_and_ids():
    cfg = registry.get("seamless-m4t-large-v2").reduced()
    jcfg = jax_registry.get("seamless-m4t-large-v2").reduced()
    tp = pipeline.TokenPipeline(cfg, pipeline.DataConfig(global_batch=2, seq_len=8))
    jp = jax_pipeline.TokenPipeline(jcfg, jax_pipeline.DataConfig(global_batch=2, seq_len=8))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tb, jb = tp.device_batch(2, dtype=dtype, device="cpu"), jp.device_batch(2, dtype=jdtype)
        assert tb["frames"].dtype == torch.bfloat16 and jb["frames"].dtype == jnp.bfloat16
        assert tb["tokens"].dtype == torch.int64
        _equal(tb, {k: np.asarray(v) for k, v in jb.items()})


def test_bf16_rounding_is_nearest_even_as_ml_dtypes():
    # Every f32 bit pattern halfway between two bf16 values, the ones just beside it, and random draws.
    hi = np.arange(0, 1 << 16, 37, dtype=np.uint32) << 16
    ties = np.concatenate([hi | 0x8000, hi | 0x7FFF, hi | 0x8001, hi | 0x18000]).view(np.float32)
    draws = np.random.default_rng(0).standard_normal(100_000, dtype=np.float32)
    for x in (ties[np.isfinite(ties)], draws):
        got = torch.from_numpy(x).to(torch.bfloat16)
        np.testing.assert_array_equal(_bits(got), _ref_bits(x.astype(ml_dtypes.bfloat16)))


def test_markov_chain_and_reshard_equal_reference():
    tc, jc = pipeline.MarkovChain(300, 9), jax_pipeline.MarkovChain(300, 9)
    np.testing.assert_array_equal(tc.group_of, jc.group_of)
    np.testing.assert_array_equal(tc.peaks, jc.peaks)
    data = pipeline.DataConfig(seed=2, global_batch=12)
    got = pipeline.reshard(data, 2, 3)
    ref = jax_pipeline.reshard(jax_pipeline.DataConfig(seed=2, global_batch=12), 2, 3)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("case", [(1, 4), (0, 0), (0, 5), (4, 4)], ids=["ok", "no_hosts", "indivisible", "index"])
def test_elastic_plan_equal_reference(case):
    index, count = case
    got = elastic_plan(pipeline.DataConfig(global_batch=8), index, count)
    ref = jax_elastic_plan(jax_pipeline.DataConfig(global_batch=8), index, count)
    assert isinstance(got, ElasticPlan)
    assert (got.ok, got.reason) == (ref.ok, ref.reason)
    if ref.ok:
        assert dataclasses.asdict(got.data) == dataclasses.asdict(ref.data)
    else:
        assert got.data is None
