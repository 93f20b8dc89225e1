"""The port's paged serving tier against the JAX engine's, on the same inputs.

The reference's paged, prefix, chunk and preemption tests
(``tests/test_serve_engine.py``) run on both engines at once over the echo+1
toy (next token = last + 1 mod 17, the cache records the tokens), each
package's toy built from its own tensors: equal outputs, request states,
preemption counts and every ``EngineStatus`` field (the pool's ratios to
1e-6).  Then both engines serve reduced granite-8b in f32 on the same
weights in the paged, prefix-shared, chunked (32 / 64 / whole ladder),
preempting and int8-cache modes, and reduced Hymba (4 layers) and RWKV6
under a paged pool (the legacy admission): equal greedy streams and
``EngineStatus``.  ``prefill_chunk`` is held to the reference's at several
offsets, a padded final chunk that crosses ``cache_len`` among them (logits
and cache within 1e-4), and a chunk program built at one offset runs at
another.  One test needs the card and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from _torch_toys import JaxToy, Toy, same_requests, status_equal
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.ops import FixedPolicy
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine

class Pair:
    """A JAX engine and a port engine, driven in lockstep."""

    def __init__(self, jmodel, jparams, tmodel, tparams, **kw):
        self.j = JaxEngine(jmodel, jparams, runtime=JaxRuntime(), **kw)
        self.t = ServingEngine(tmodel, tparams, runtime=KernelRuntime(), **kw)

    def submit(self, prompt, **kw):
        return self.j.submit(prompt, **kw).request, self.t.submit(prompt, **kw).request

    def step(self):
        a, b = self.j.step(), self.t.step()
        assert a == b
        return b

    def drain(self):
        js, ts = self.j.drain(), self.t.drain()
        status_equal(ts, js)
        return ts

    def status(self):
        js, ts = self.j.status(), self.t.status()
        status_equal(ts, js)
        return ts


def _toy_pair(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", 32)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    return Pair(JaxToy(), {}, Toy(), {}, **kw)


# ---------------------------------------------------------------------------
# the reference's toy tests, on both engines
# ---------------------------------------------------------------------------
def test_preemption_accounting_counts_each_request_once():
    """5 blocks of 8 tokens for two lanes that each want 3: the low-priority
    request is evicted, counted once, and finishes after re-admission."""
    pair = _toy_pair(max_batch=2, cache_len=32, block_size=8, n_blocks=5, prefill_buckets=(8, 16))
    reqs = []
    for uid, prio in ((0, 1), (1, 0)):
        jr = JaxRequest(uid=uid, prompt=np.arange(8, dtype=np.int32), max_new_tokens=16, priority=prio)
        tr = Request(uid=uid, prompt=np.arange(8, dtype=np.int32), max_new_tokens=16, priority=prio)
        pair.j.submit_request(jr)
        pair.t.submit_request(tr)
        reqs.append((jr, tr))
    (_, a), (_, b) = reqs
    saw_preempted = False
    for _ in range(200):
        if not pair.step():
            break
        st = pair.status()
        assert st.completed + st.in_flight + st.queued + st.preempted == 2
        if b.state == "preempted":
            saw_preempted = True
            assert st.preempted >= 1 and st.queued == 0
        same_requests(reqs)
        if a.done and b.done:
            break
    assert saw_preempted
    status = pair.drain()
    assert a.done and b.done and status.completed == 2
    assert a.preemptions == 0 and b.preemptions >= 1 and status.preempted == 1
    same_requests(reqs)


def test_chunked_prefill_output_invariant_to_chunk_size():
    prompt = list(range(1, 11))
    want = [(prompt[-1] + 1 + i) % 17 for i in range(4)]
    for chunk in (8, 16, None):
        pair = _toy_pair(prefill_chunk_tokens=chunk)
        assert pair.t._streaming and pair.j._streaming
        jr, tr = pair.submit(prompt, max_new_tokens=4)
        assert pair.drain().completed == 1 and tr.output == jr.output == want
        k = pair.t.pool.gather([0])["k"][0]
        np.testing.assert_array_equal(k[:len(prompt)].numpy(), prompt)  # left-aligned, no pad offset
        np.testing.assert_array_equal(k.numpy(), np.asarray(pair.j.pool.gather([0])["k"])[0])


def test_prefill_budget_spreads_chunks_over_steps():
    pair = _toy_pair(prefill_chunk_tokens=8, cache_len=64, max_batch=1)
    jw, tw = [], []
    pair.j.on_prefill, pair.t.on_prefill = jw.append, tw.append
    jr, tr = pair.submit(list(range(1, 34)), max_new_tokens=2)  # a 32-token body
    pair.step()
    assert tw == jw == [8] and tr.state == jr.state == "prefilling"
    pair.drain()
    assert tr.done and tw == jw and sum(tw) == 32
    assert list(pair.t._chunk_cache) == list(pair.j._chunk_cache) == [8]


def test_prefix_sharing_aliases_blocks_and_counts_hits():
    pair = _toy_pair(prefill_chunk_tokens=16, cache_len=64)
    sys_prompt = list(range(1, 17))
    r1 = pair.submit(sys_prompt + [3], max_new_tokens=2)
    pair.drain()
    assert pair.status().prefix_lookups == 1
    r2 = pair.submit(sys_prompt + [5], max_new_tokens=2)
    pair.drain()
    st = pair.status()
    assert st.prefix_hits == 1 and st.prefix_lookups == 2 and st.prefix_hit_rate == 0.5
    assert pair.t._prefix_reused_tokens == pair.j._prefix_reused_tokens == 16
    assert r1[1].output == [4, 5] and r2[1].output == [6, 7]
    same_requests([r1, r2])


def test_prefix_sharing_disabled_is_inert():
    pair = _toy_pair(prefill_chunk_tokens=16, cache_len=64, prefix_sharing=False)
    sys_prompt = list(range(1, 17))
    for tail in ([3], [5]):
        pair.submit(sys_prompt + tail, max_new_tokens=2)
    pair.drain()
    st = pair.status()
    assert st.prefix_lookups == 0 and st.shared_blocks == 0
    assert pair.t.prefix_overlap(sys_prompt + [9]) == pair.j.prefix_overlap(sys_prompt + [9]) == 0


def test_engine_status_reports_pool_health():
    pair = _toy_pair(prefill_chunk_tokens=16, cache_len=64)
    sys_prompt = list(range(1, 17))
    pair.submit(sys_prompt + [3], max_new_tokens=8)
    pair.step()
    pair.submit(sys_prompt + [5], max_new_tokens=8)
    pair.step()
    st = pair.status()
    assert 0.0 < st.pool_utilization <= 1.0 and 0.0 <= st.pool_fragmentation < 1.0
    assert st.shared_blocks == 2 and st.prefix_hits == 1
    assert pair.t.prefix_overlap(sys_prompt + [9]) == pair.j.prefix_overlap(sys_prompt + [9]) == 16


def test_pick_victim_protects_shared_prefix_holders():
    pair = _toy_pair(max_batch=3, cache_len=64, prefill_chunk_tokens=16, n_blocks=12)
    sys_prompt = list(range(1, 18))
    a = pair.submit(sys_prompt + [3], max_new_tokens=12)
    pair.step()
    b = pair.submit(sys_prompt + [5], max_new_tokens=12)
    c = pair.submit(list(range(60, 70)), max_new_tokens=12)
    while b[1].state != "active" or c[1].state != "active":
        assert pair.step()
    same_requests([a, b, c])
    eng = pair.t
    lanes = {r.uid: lane for lane, r in enumerate(eng.slots) if r is not None}
    assert eng.pool.lane_holds_shared(lanes[a[1].uid]) and eng.pool.lane_holds_shared(lanes[b[1].uid])
    assert not eng.pool.lane_holds_shared(lanes[c[1].uid])
    assert eng._pick_victim([r for r in eng.slots if r is not None]) is c[1]
    assert pair.j._pick_victim([r for r in pair.j.slots if r is not None]) is c[0]
    assert eng._pick_victim([b[1]]) is b[1]


def test_preempted_shared_prefix_request_readmits():
    pair = _toy_pair(max_batch=2, cache_len=64, prefill_chunk_tokens=16, n_blocks=8)
    sys_prompt = list(range(1, 18))
    a = pair.submit(sys_prompt + [3], max_new_tokens=30)
    pair.step()
    b = pair.submit(sys_prompt + [5], max_new_tokens=30)
    while b[1].state != "active":
        assert pair.step()
    assert pair.t.pool.shared_blocks == pair.j.pool.shared_blocks == 2
    status = pair.drain()
    assert a[1].done and b[1].done and not status.exhausted
    assert status.preempted >= 1 and a[1].preemptions + b[1].preemptions >= 1
    assert a[1].output == [(4 + i) % 17 for i in range(30)] and b[1].output == [(6 + i) % 17 for i in range(30)]
    same_requests([a, b])


# ---------------------------------------------------------------------------
# reduced models on the same weights
# ---------------------------------------------------------------------------
def _prompts(vocab, seed, system_len=32, tails=(9, 3, 20, 14)):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, system_len)
    return [np.concatenate([system, rng.integers(0, vocab, n)]).astype(np.int32) for n in tails]


MODES = {
    # mode: (engine kwargs, kv_quant, new tokens a request)
    "paged": (dict(block_size=16, prefix_sharing=False), False, 12),
    "prefix": (dict(block_size=16), False, 12),
    "chunk32": (dict(block_size=16, prefill_chunk_tokens=32), False, 12),
    "chunk64": (dict(block_size=16, prefill_chunk_tokens=64), False, 12),
    "chunk-dense": (dict(prefill_chunk_tokens=32), False, 12),
    # 8 blocks for two lanes of 46-52 prompt tokens growing by 40: the pool runs dry.
    "preempt": (dict(block_size=16, n_blocks=8, prefill_chunk_tokens=32), False, 40),
    "int8": (dict(block_size=16), True, 12),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_granite_modes_match_reference(mode):
    kw, kv_quant, new_tokens = MODES[mode]
    jm, jp, tm, tp = reduced_pair("granite-8b")
    if kv_quant:
        jm = jax_build_model(jm.cfg, dtype=jnp.float32, param_dtype=jnp.float32, kv_quant=True)
        tm = build_model(tm.cfg, dtype=torch.float32, param_dtype=torch.float32, device="cpu", kv_quant=True)
    pair = Pair(jm, jp, tm, tp, max_batch=2, cache_len=128, **kw)
    assert (pair.t._streaming, pair.t._sharing) == (pair.j._streaming, pair.j._sharing)
    prompts = _prompts(tm.cfg.vocab, 31, tails=(9, 3, 20, 14))
    reqs = [pair.submit(p, max_new_tokens=new_tokens, priority=i % 2) for i, p in enumerate(prompts)]
    status = pair.drain()
    assert status.completed == len(prompts) and not status.exhausted
    same_requests(reqs)
    assert all(len(tr.output) == new_tokens for _, tr in reqs)
    if mode == "preempt":
        assert status.preempted >= 1
    if pair.t._sharing:
        assert status.prefix_hits >= 1
    assert set(pair.t._chunk_cache) == set(pair.j._chunk_cache)
    assert set(pair.t._decode_cache) == set(pair.j._decode_cache)
    assert set(pair.t._prefill_cache) == set(pair.j._prefill_cache)


@pytest.mark.parametrize("arch, n_layers", [("hymba-1.5b", 4), ("rwkv6-7b", None)])
def test_recurrent_models_under_a_paged_pool(arch, n_layers):
    """No ``prefill_chunk``: the legacy admission over a paged pool (Hymba's
    global k/v in blocks, its ring and SSM state lane rows; RWKV6 all lane rows)."""
    jm, jp, tm, tp = reduced_pair(arch, n_layers)
    pair = Pair(jm, jp, tm, tp, max_batch=2, cache_len=128, block_size=16, n_blocks=10)
    assert not pair.t._streaming and not pair.j._streaming
    reqs = [pair.submit(p, max_new_tokens=10) for p in _prompts(tm.cfg.vocab, 32, system_len=8, tails=(5, 30, 12))]
    status = pair.drain()
    assert status.completed == 3
    same_requests(reqs)


def test_prefill_chunk_matches_reference():
    """Logits and cache within 1e-4 at starts 0, 32 and 48, the last a padded
    final chunk whose rows cross cache_len = 64 (its writes past the end dropped)."""
    jm, jp, tm, tp = reduced_pair("granite-8b")
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
    assert tm.supports_chunked_prefill() and not build_model(
        tm.cfg, dtype=torch.float32, device="cpu", kv_quant=True).supports_chunked_prefill()


def test_chunk_program_serves_every_offset():
    """A chunk program built (warmed up) at offset 0 runs at offset 32 and
    equals an eager ``prefill_chunk`` there: no host value depends on start."""
    _, _, tm, tp = reduced_pair("granite-8b")
    rt = KernelRuntime()
    rt.install(FixedPolicy())
    eng = ServingEngine(tm, tp, runtime=rt, max_batch=2, cache_len=64, block_size=16, prefill_chunk_tokens=32)
    rng = np.random.default_rng(3)
    seq = rng.integers(0, tm.cfg.vocab, 50)
    eng.pool.ensure(0, 64)
    prog = eng._chunk_fn(32)
    assert prog.runs == 0 and not torch.any(eng.pool.gather([0])["k"]).item()  # the warm-up wrote nothing
    blocks, lanes = eng.pool.row_ids([0])
    ref_cache = tm.init_cache(1, 64)
    for start in (0, 32):
        chunk = np.zeros(32, np.int64)
        real = seq[start:start + 32]
        chunk[:len(real)] = real
        prog.stage(tokens=chunk[None], start=start, last_row=len(real) - 1, blocks=blocks, lanes=lanes)
        out = prog.run(rt)
        want, ref_cache = tm.prefill_chunk(tp, ref_cache, torch.from_numpy(chunk[None]), torch.tensor(start),
                                           torch.tensor(len(real) - 1))
        assert torch.equal(out["logits"], want)
    view = eng.pool.gather([0])
    assert torch.equal(view["k"], ref_cache["k"]) and torch.equal(view["v"], ref_cache["v"])


@pytest.mark.cuda
def test_chunk_capture_replays_other_offsets_on_card():
    """On the card: a chunk program captured at start 0 replays at start 32 to
    an eager call's logits, and a drain in which a sibling aliases a shared
    prefix (its block ids repeated in the decode scatter's index) leaves the
    pool bitwise as the eager engine's drain does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    cfg = reduced_pair("granite-8b")[2].cfg
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    params = model.init(torch.Generator(device="cpu").manual_seed(0))

    def engine(graphs):
        rt = KernelRuntime()
        rt.install(FixedPolicy())
        return ServingEngine(model, params, runtime=rt, max_batch=2, cache_len=64, block_size=16,
                             prefill_chunk_tokens=32, cuda_graphs=graphs)

    eng = engine(True)
    eng.pool.ensure(0, 64)
    prog = eng._chunk_fn(32)  # captured with its inputs at zero: start 0
    assert isinstance(prog.graph, torch.cuda.CUDAGraph)
    seq = np.random.default_rng(3).integers(0, cfg.vocab, 50)
    chunk = np.zeros(32, np.int64)
    chunk[:18] = seq[32:]
    blocks, lanes = eng.pool.row_ids([0])
    prog.stage(tokens=chunk[None], start=32, last_row=17, blocks=blocks, lanes=lanes)
    got = prog.run(eng.runtime)["logits"].clone()
    with eng.runtime.activate():
        want, _ = model.prefill_chunk(params, eng.pool.gather([0]), torch.from_numpy(chunk[None]).cuda(),
                                      torch.tensor(32, device="cuda"), torch.tensor(17, device="cuda"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    pools = []
    for graphs in (True, False):
        eng = engine(graphs)
        first, second = _prompts(cfg.vocab, 9, tails=(4, 6))
        eng.submit(first, max_new_tokens=8)
        eng.step()  # the first request's chunks run and register its prefix
        eng.submit(second, max_new_tokens=8)
        eng.step()
        assert eng.status().shared_blocks == 2
        eng.drain()
        pools.append({k: t.clone() for k, t in eng.pool._store.items()})
    for key in pools[0]:
        assert torch.equal(pools[0][key], pools[1][key]), key
