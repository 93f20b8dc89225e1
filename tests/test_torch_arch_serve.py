"""The port's engine serving the remaining decoder architectures, against the JAX engine.

Both engines serve the same requests on the same f32 weights, driven in
lockstep: reduced qwen3-moe-235b-a22b and dbrx-132b from a dense pool, then
paged with prefix sharing, then with 32-token chunks (an MoE chunk routes its
own tokens, so its capacity follows the chunk, in both); reduced
llama-3.2-vision-90b with seeded image embeddings as ``extra_inputs`` (the
legacy admission, dense and paged); reduced qwen2.5-32b with seeded nonzero
QKV biases.  Greedy streams, request states, every ``EngineStatus`` field,
the pool's ``stats()`` (to 1e-6), the program caches' keys and the
selections each runtime logged (one per call of each traced body) are equal.
"""
import numpy as np
import pytest
import torch

from _torch_parity import model_pair, reduced_pair
from _torch_toys import same_requests, status_equal
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.core.runtime import KernelRuntime
from repro_torch.serve.engine import ServingEngine

MOE_MODES = {
    "dense": dict(),
    "prefix": dict(block_size=16),
    "chunk32": dict(block_size=16, prefill_chunk_tokens=32),
}


def _log(rt):
    return [(op, tuple(int(v) for v in p)) for op, p, _ in rt.selection_log()]


def _serve_both(jm, jp, tm, tp, prompts, new_tokens=10, **kw):
    jrt, trt = JaxRuntime(), KernelRuntime()
    for rt in (jrt, trt):
        rt.set_selection_logging(True, cap=1 << 16)
    j = JaxEngine(jm, jp, runtime=jrt, max_batch=2, cache_len=128, **kw)
    t = ServingEngine(tm, tp, runtime=trt, max_batch=2, cache_len=128, **kw)
    assert (t._streaming, t._sharing) == (j._streaming, j._sharing)
    reqs = [(j.submit(p, max_new_tokens=new_tokens, priority=i % 2).request,
             t.submit(p, max_new_tokens=new_tokens, priority=i % 2).request) for i, p in enumerate(prompts)]
    js, ts = j.drain(), t.drain()
    status_equal(ts, js)
    assert ts.completed == len(prompts) and not ts.exhausted
    same_requests(reqs)
    assert all(len(tr.output) == new_tokens for _, tr in reqs)
    got, want = t.pool.stats(), j.pool.stats()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    for cache in ("_prefill_cache", "_decode_cache", "_chunk_cache"):
        assert set(getattr(t, cache)) == set(getattr(j, cache)), cache
    assert _log(trt) == _log(jrt)
    return j, t, ts


def _prompts(vocab, seed, system_len=32, tails=(9, 3, 20, 14)):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, system_len)
    return [np.concatenate([system, rng.integers(0, vocab, n)]).astype(np.int32) for n in tails]


@pytest.mark.parametrize("mode", list(MOE_MODES))
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_engines_match_reference(arch, mode):
    jm, jp, tm, tp = reduced_pair(arch)
    _, t, status = _serve_both(jm, jp, tm, tp, _prompts(tm.cfg.vocab, 41), **MOE_MODES[mode])
    if mode != "dense":
        assert t._streaming and t._sharing and status.prefix_hits >= 1
    if mode == "chunk32":
        assert set(t._chunk_cache) == {32}


@pytest.mark.parametrize("block_size", [None, 16])
def test_vlm_engine_with_image_embeddings_matches_reference(block_size):
    jm, jp, tm, tp = model_pair("llama-3.2-vision-90b")
    img = np.random.default_rng(5).standard_normal((1, tm.cfg.n_image_tokens, tm.cfg.d_model)).astype(np.float32)
    j, t, status = _serve_both(jm, jp, tm, tp, _prompts(tm.cfg.vocab, 42), block_size=block_size,
                               extra_inputs={"image_embs": img})
    assert not t._streaming and status.prefix_lookups == 0  # extras keep the legacy admission
    ref_kinds = {spec.path: spec.kind for spec in j.pool.specs}
    for key in ("['cross_k']", "['cross_v']"):
        assert t.pool.specs[key].kind == ref_kinds[key] == "lane"
    assert torch.any(t.pool.gather([0, 1])["cross_k"] != 0)


def test_vlm_streams_depend_on_the_image():
    """Other image embeddings give other streams: the cross blocks are on the path."""
    _, _, tm, tp = model_pair("llama-3.2-vision-90b")
    outs = []
    for seed in (5, 6):
        img = np.random.default_rng(seed).standard_normal((tm.cfg.n_image_tokens, tm.cfg.d_model)) * 3
        eng = ServingEngine(tm, tp, runtime=KernelRuntime(), max_batch=2, cache_len=128,
                            extra_inputs={"image_embs": img.astype(np.float32)})
        tickets = [eng.submit(p, max_new_tokens=8) for p in _prompts(tm.cfg.vocab, 43)]
        eng.drain()
        outs.append([t.request.output for t in tickets])
    assert outs[0] != outs[1]


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "glm4-9b"])
def test_dense_archs_engines_match_reference(arch):
    jm, jp, tm, tp = model_pair(arch)
    _serve_both(jm, jp, tm, tp, _prompts(tm.cfg.vocab, 44), block_size=16, prefill_chunk_tokens=32)
