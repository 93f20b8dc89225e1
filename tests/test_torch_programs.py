"""The engine's compiled programs against the JAX engine's jit caches.

The port keeps one program per prefill bucket (``_prefill_cache``) and one
per decode width (``_decode_cache``), as the reference keeps its jitted
programs; on the card each is a CUDA graph, on the CPU the same
static-buffer program runs its body eagerly.  These tests hold, on reduced
models in f32 on the CPU: the cache keys against the reference's after the
same prompts; greedy streams and ``EngineStatus`` (equality) and the lane
rows after a run (1e-4, the serving tests' tolerance) against the JAX
engine; fixed buffer addresses across a drain; a warm-up that leaves the pool
untouched; programs rebuilt on a policy install; no program shared between
engines.  One test needs the card and skips here.
"""
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.serve.engine import ServingEngine as JaxEngine
from repro_torch.configs import registry as torch_registry
from repro_torch.core.runtime import KernelRuntime
from repro_torch.kernels.matmul import DEFAULT_CONFIG, MatmulConfig
from repro_torch.kernels.ops import FixedPolicy
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kvpool import flatten_cache

KW = dict(max_batch=2, cache_len=128)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve_both(arch, n_layers, lengths, new_tokens, seed):
    jm, jp, tm, tp = reduced_pair(arch, n_layers)
    prompts = _prompts(tm.cfg.vocab, lengths, seed)
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(), **KW)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(), **KW)
    jt = [jeng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    js, ts = jeng.drain(), teng.drain()
    return jeng, teng, jt, tt, js, ts


def test_program_caches_keyed_as_reference():
    """Granite, prompts in buckets 32 and 64: the same prefill buckets and decode
    widths compiled, in the same order, and the same streams."""
    jeng, teng, jt, tt, js, ts = _serve_both("granite-8b", None, (3, 60, 17, 33, 9), 6, 21)
    assert list(teng._prefill_cache) == list(jeng._prefill_cache) == [32, 64]
    assert list(teng._decode_cache) == list(jeng._decode_cache)
    assert set(teng._decode_cache) <= set(teng._width_buckets)
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps, ts.exhausted) == (
        js.completed, js.in_flight, js.queued, js.steps, js.exhausted)
    for key in ("k", "v"):
        np.testing.assert_allclose(teng.cache[key].numpy(), np.asarray(jeng.cache[key]), rtol=1e-4, atol=1e-4)
    # On the CPU every program runs its body eagerly; each was built once.
    assert not teng.cuda_graphs and not any(r.captured for r in teng.program_log)
    assert sorted((r.kind, r.size) for r in teng.program_log) == sorted(
        [("prefill", b) for b in teng._prefill_cache] + [("decode", w) for w in teng._decode_cache])


def test_long_prompts_share_one_bucket():
    """Prompts of 101 and 121 tokens both prefill in the 128 bucket (the
    reference's tests/test_serve_engine.py::test_long_prompts_share_one_extended_bucket)."""
    _, _, tm, tp = reduced_pair("granite-8b")
    eng = ServingEngine(tm, tp, max_batch=2, cache_len=256, runtime=KernelRuntime())
    t1 = eng.submit(list(range(1, 101)), max_new_tokens=2)
    t2 = eng.submit(list(range(1, 121)), max_new_tokens=2)
    eng.drain()
    assert t1.done and t2.done and t1.request.truncated_tokens == t2.request.truncated_tokens == 0
    assert list(eng._prefill_cache) == [128]
    assert eng.programs()[("prefill", 128)]["runs"] == 2


@pytest.mark.parametrize("arch, n_layers, lengths, state_keys", [
    ("rwkv6-7b", None, (3, 60, 17), ("wkv", "x1", "x2")),
    ("hymba-1.5b", 4, (5, 40, 12), None),
])
def test_streams_and_lane_rows_match_reference(arch, n_layers, lengths, state_keys):
    jeng, teng, jt, tt, js, ts = _serve_both(arch, n_layers, lengths, 5, 22)
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert all(len(t.request.output) == 5 and t.done for t in tt)
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps, ts.exhausted) == (
        js.completed, js.in_flight, js.queued, js.steps, js.exhausted)
    assert (ts.pool_utilization, ts.pool_fragmentation) == pytest.approx((js.pool_utilization, js.pool_fragmentation))
    assert list(teng._prefill_cache) == list(jeng._prefill_cache)
    assert list(teng._decode_cache) == list(jeng._decode_cache)
    # Every lane's recurrent rows after the run, idle and retired lanes included.
    tview, jview = teng.cache, jeng.cache
    if state_keys is None:  # Hymba: every layer's SSM state and the sliding-window layer's ring
        pairs = [(tview[f"layer{i}"]["ssm"], jview[f"layer{i}"]["ssm"]) for i in range(4)]
        pairs += [(tview["layer1"][k], jview["layer1"][k]) for k in ("k", "v")]
    else:
        pairs = [(tview[k], jview[k]) for k in state_keys]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _addresses(engine, width):
    prog = engine._decode_cache[width]
    return ({name: t.data_ptr() for name, t in prog.inputs.items()},
            {k: t.data_ptr() for k, t in flatten_cache(prog.view).items()},
            {k: t.data_ptr() for k, t in engine.pool._store.items()})


@pytest.mark.parametrize("arch, n_layers", [("granite-8b", None), ("rwkv6-7b", None), ("hymba-1.5b", 4)])
def test_buffers_keep_their_addresses(arch, n_layers):
    """Static inputs, the decode view and every pool store tensor stay at one
    address from step to step across a drain (what a captured graph needs)."""
    _, _, tm, tp = reduced_pair(arch, n_layers)
    seen: dict[int, list] = {}
    eng = ServingEngine(tm, tp, runtime=KernelRuntime(), on_decode=lambda w: seen.setdefault(w, []).append(
        _addresses(eng, w)), **KW)
    for p in _prompts(tm.cfg.vocab, (4, 40, 9), 23):
        eng.submit(p, max_new_tokens=6)
    eng.drain()
    assert sum(map(len, seen.values())) == eng.steps > 3
    stores = {repr(addr[2]) for steps in seen.values() for addr in steps}
    assert len(stores) == 1
    for steps in seen.values():
        assert all(addr == steps[0] for addr in steps)


@pytest.mark.parametrize("arch, n_layers", [("rwkv6-7b", None), ("hymba-1.5b", 4)])
def test_warm_up_leaves_the_pool_untouched(arch, n_layers):
    """Building a decode program runs its body once without the scatter: the
    model advances the gathered copy of the lane states, the pool keeps them."""
    _, _, tm, tp = reduced_pair(arch, n_layers)
    eng = ServingEngine(tm, tp, runtime=KernelRuntime(), **KW)
    eng.submit(_prompts(tm.cfg.vocab, (30,), 24)[0], max_new_tokens=4)
    eng.step()  # the prefill fills lane 0, a width-1 decode advances it
    assert list(eng._decode_cache) == [1]
    before = {k: t.clone() for k, t in eng.pool._store.items()}
    prog = eng._decode_fn(2)  # the warm-up reads lane 0 into both rows of the view
    assert [(r.kind, r.size) for r in eng.program_log][-1] == ("decode", 2) and prog.runs == 0
    for key, t in eng.pool._store.items():
        assert torch.equal(t, before[key]), key
    view = {"".join(f"['{k}']" for k in path): t for path, t in flatten_cache(prog.view).items()}
    lane = [k for k, spec in eng.pool.specs.items() if spec.kind == "lane"]
    advanced = [k for k in lane if not torch.equal(view[k].select(eng.pool.specs[k].batch_axis, 0),
                                                   before[k].select(eng.pool.specs[k].batch_axis, 0))]
    assert advanced, "the warm-up did not run the model"


def test_prefill_program_outputs_the_reference_logits():
    """A prefill program's outputs hold the model's logits, as the reference's jitted
    prefill returns them: against the JAX engine's program on the same padded prompt
    (1e-4), with ``next`` their last row's argmax."""
    jm, jp, tm, tp = reduced_pair("rwkv6-7b")
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(), **KW)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(), **KW)
    prompt = np.zeros((1, 32), dtype=np.int64)
    prompt[0, -11:] = _prompts(tm.cfg.vocab, (11,), 4)[0]
    prog = teng._prefill_fn(32)
    prog.stage(tokens=prompt)
    out = prog.run(teng.runtime)
    jlogits, _ = jeng._prefill_fn(32)(jp, {"tokens": prompt.astype(np.int32)})
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert int(out["next"]) == int(torch.argmax(out["logits"][0, -1]))


def test_install_drops_and_rebuilds_programs():
    _, _, tm, tp = reduced_pair("granite-8b")
    rt = KernelRuntime()
    rt.install(FixedPolicy())
    rt.set_selection_logging(True, cap=1 << 16)
    eng = ServingEngine(tm, tp, runtime=rt, **KW)
    prompts = _prompts(tm.cfg.vocab, (5, 50), 25)
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    eng.drain()
    first = dict(eng._prefill_cache) | {("decode", w): p for w, p in eng._decode_cache.items()}
    epoch0 = rt.policy_epoch()
    assert all(v["epoch"] == epoch0 for v in eng.programs().values())
    assert {cfg for op, _, cfg in rt.selection_log() if op == "matmul"} == {DEFAULT_CONFIG}

    other = MatmulConfig(16, 128, 64, "nmk")
    assert other != DEFAULT_CONFIG
    rt.install(FixedPolicy(matmul_config=other))
    n_log, n_built = len(rt.selection_log()), len(eng.program_log)
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    eng.drain()
    assert rt.policy_epoch() == epoch0 + 1
    progs = eng.programs()
    assert set(progs) == {("prefill", 32), ("prefill", 64)} | {("decode", w) for w in eng._decode_cache}
    assert all(v["epoch"] == epoch0 + 1 for v in progs.values())
    assert len(eng.program_log) - n_built == len(progs)
    again = dict(eng._prefill_cache) | {("decode", w): p for w, p in eng._decode_cache.items()}
    assert not any(again[k] is first[k] for k in again.keys() & first.keys())
    after = [cfg for op, _, cfg in rt.selection_log()[n_log:] if op == "matmul"]
    assert after and set(after) == {other}


def test_engines_share_no_program():
    _, _, tm, tp = reduced_pair("granite-8b")
    engines = [ServingEngine(tm, tp, runtime=KernelRuntime(), **KW) for _ in range(2)]
    prompt = _prompts(tm.cfg.vocab, (7,), 26)[0]
    for eng in engines:
        eng.submit(prompt, max_new_tokens=3)
        eng.drain()
    objs = [{id(p) for c in (e._prefill_cache, e._decode_cache) for p in c.values()} for e in engines]
    tensors = [{t.data_ptr() for c in (e._prefill_cache, e._decode_cache) for p in c.values()
                for t in p.inputs.values()} for e in engines]
    assert objs[0] and not objs[0] & objs[1]
    assert not tensors[0] & tensors[1]
    assert engines[0].pool._store["['k']"].data_ptr() != engines[1].pool._store["['k']"].data_ptr()


def test_cuda_graphs_choice_on_cpu():
    _, _, tm, tp = reduced_pair("granite-8b")
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        ServingEngine(tm, tp, cuda_graphs=True, **KW)
    assert not ServingEngine(tm, tp, **KW).cuda_graphs
    assert not ServingEngine(tm, tp, cuda_graphs=False, **KW).cuda_graphs


@pytest.mark.cuda
def test_captured_programs_on_card():
    """On the card: the engine holds CUDA graphs by default; a captured decode
    replays to the eager body's logits bitwise on the engine's own stream; the
    SSM workspace refuses to be allocated during a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ssm

    cfg = torch_registry.get("granite-8b").reduced()
    model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32, device="cuda")
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    rt = KernelRuntime()
    rt.install(FixedPolicy())
    eng = ServingEngine(model, params, runtime=rt, **KW)
    eng.submit(_prompts(cfg.vocab, (9,), 27)[0], max_new_tokens=4)
    eng.step()
    prog = eng._decode_cache[1]
    assert eng.cuda_graphs and isinstance(prog.graph, torch.cuda.CUDAGraph)
    assert isinstance(eng._prefill_cache[32].graph, torch.cuda.CUDAGraph)
    snap = {k: t.clone() for k, t in eng.pool._store.items()}
    assert prog.stream is eng._stream
    other = ServingEngine(model, params, runtime=rt, **KW)._decode_fn(1)
    assert other.stream.cuda_stream != eng._stream.cuda_stream
    prog.replay()
    replayed = prog.outputs["logits"].clone()
    for k, t in eng.pool._store.items():
        t.copy_(snap[k])
    with rt.activate():
        eager = prog.body()["logits"]
    assert torch.equal(replayed, eager)

    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, d, n = 1, 2048, 64, 16
    x, dt, bv, cv = (torch.randn(shape, device="cuda", generator=g)
                     for shape in ((b, s, d), (b, s, d), (b, s, n), (b, s, n)))
    a = -torch.rand((d, n), device="cuda", generator=g)
    assert ssm.launch_segments(b, s, d, n, ssm.DEFAULT_SSM_CONFIG, True, 0) > 1
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="ssm workspace"):
        with torch.cuda.graph(graph, stream=stream):
            ssm.ssm_cuda_fused(x, dt.abs(), a, bv, cv)

