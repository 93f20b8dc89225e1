"""The port's serving engine against the JAX package's, on the same weights.

Both engines serve the same 5 prompts (3 to 60 tokens: prefill buckets 32 and
64) on reduced granite-8b in f32, dense KV layout, ``max_batch=2``,
``cache_len=128``, 8 new tokens each.  Greedy token streams and the engine
status partition must be identical.  Reduced rwkv6-7b is served the same way
(3 prompts of 3, 60 and 17 tokens), and its recurrent state, which both pools
keep one row per lane, must match after the run, idle and retired lanes
included.  Reduced hymba-1.5b at 4 layers (one sliding-window layer, its
ring of 32 a lane leaf beside every layer's SSM state) serves prompts of 5
and 40 tokens (buckets 32 and 64, both >= the ring) with ``cache_len=128``;
streams, status and pool statistics must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import reduced_pair
from repro.core.runtime import KernelRuntime as JaxRuntime
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.kvpool import probe_cache_layout as jax_probe
from repro_torch.core.runtime import KernelRuntime
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import ServingEngine, _bucket, _extend_ladder
from repro_torch.serve.kvpool import probe_cache_layout

LENGTHS = (3, 60, 17, 33, 9)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def test_engine_matches_reference_engine():
    jm, jp, tm, tp = reduced_pair("granite-8b")
    prompts = _prompts(tm.cfg.vocab)
    kw = dict(max_batch=2, cache_len=128)
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(), **kw)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(), **kw)
    jt = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=8) for p in prompts]
    # A live snapshot mid-run partitions the same way in both engines.
    jeng.step(), teng.step()
    js, ts = jeng.status(), teng.status()
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps) == (js.completed, js.in_flight, js.queued, js.steps)
    js, ts = jeng.drain(), teng.drain()
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert all(len(t.request.output) == 8 and t.done for t in tt)
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps, ts.exhausted) == (
        js.completed, js.in_flight, js.queued, js.steps, js.exhausted)
    assert teng.pool.stats()["used_blocks"] == jeng.pool.stats()["used_blocks"]
    # Dense view of the lanes after the run (retired lanes stay readable).
    for key in ("k", "v"):
        np.testing.assert_allclose(teng.cache[key].numpy(), np.asarray(jeng.cache[key]), rtol=1e-4, atol=1e-4)


def test_ladder_and_buckets_match_reference():
    from repro.serve import engine as ref

    for cache_len in (64, 128, 256, 1000):
        assert _extend_ladder((32, 64, 128), cache_len) == ref._extend_ladder((32, 64, 128), cache_len)
    for n in (1, 32, 33, 64, 65, 200, 5000):
        assert _bucket(n, (32, 64, 128, 256)) == ref._bucket(n, (32, 64, 128, 256))


def test_streaming_ticket_drives_the_engine():
    _, _, tm, tp = reduced_pair("granite-8b")
    eng = ServingEngine(tm, tp, max_batch=2, cache_len=64, runtime=KernelRuntime())
    ticket = eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    assert len(list(ticket.tokens())) == 4 and ticket.done
    assert eng.status().completed == 1 and not eng.pending()


def test_paged_layout_is_not_ported_yet():
    """The paged layout is ported: it builds with the reference's geometry and
    refuses what the reference's refuses (tests/test_torch_paged_serve.py holds
    its serving to the JAX engine)."""
    _, _, tm, tp = reduced_pair("granite-8b")
    eng = ServingEngine(tm, tp, max_batch=2, cache_len=64, block_size=16)
    assert (eng.pool.block_size, eng.pool.blocks_per_lane, eng.pool.n_blocks) == (16, 4, 8)
    assert eng._streaming and eng._sharing
    with pytest.raises(ValueError):
        ServingEngine(tm, tp, max_batch=2, cache_len=64, block_size=24)  # does not divide cache_len
    with pytest.raises(ValueError):
        ServingEngine(tm, tp, max_batch=2, cache_len=64, block_size=16, n_blocks=3)  # not one full lane


def test_cli_serves_on_cpu(capsys):
    outs = serve_cli.main(["--arch", "granite-8b", "--device", "cpu", "--requests", "3",
                           "--max-new-tokens", "4", "--max-batch", "2", "--cache-len", "64"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "served 3 requests on cpu" in capsys.readouterr().out


def test_rwkv_engine_matches_reference_engine():
    jm, jp, tm, tp = reduced_pair("rwkv6-7b")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32) for n in (3, 60, 17)]
    kw = dict(max_batch=2, cache_len=128)
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(), **kw)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(), **kw)
    jt = [jeng.submit(p, max_new_tokens=8) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=8) for p in prompts]
    jeng.step(), teng.step()
    js, ts = jeng.status(), teng.status()
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps) == (js.completed, js.in_flight, js.queued, js.steps)
    js, ts = jeng.drain(), teng.drain()
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert all(len(t.request.output) == 8 and t.done for t in tt)
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps, ts.exhausted) == (
        js.completed, js.in_flight, js.queued, js.steps, js.exhausted)
    assert (ts.pool_utilization, ts.pool_fragmentation) == pytest.approx(
        (js.pool_utilization, js.pool_fragmentation))
    tstats, jstats = teng.pool.stats(), jeng.pool.stats()
    assert {k: tstats[k] for k in tstats} == pytest.approx({k: jstats[k] for k in tstats})
    # Dense view of the lanes' recurrent state after the run.
    for key in ("wkv", "x1", "x2"):
        np.testing.assert_allclose(teng.cache[key].numpy(), np.asarray(jeng.cache[key]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-8b", "rwkv6-7b", "hymba-1.5b"])
def test_leaf_kinds_match_reference_probe(arch):
    """Leaf paths (keystr form) and kinds equal the reference probe's."""
    jm, _, tm, _ = reduced_pair(arch, 4 if arch == "hymba-1.5b" else None)
    for cache_len in (64, 128):
        jspecs, _ = jax_probe(jm.init_cache, cache_len, cache_len)
        want = {spec.path: (spec.kind, spec.batch_axis, spec.length_axis) for spec in jspecs}
        got = {key: (spec.kind, spec.batch_axis, spec.length_axis)
               for key, spec in probe_cache_layout(tm.init_cache, cache_len, cache_len).items()}
        assert got == want
    kinds = {spec.kind for spec in ServingEngine(tm, None, max_batch=2, cache_len=64).pool.specs.values()}
    assert kinds == {"granite-8b": {"paged"}, "rwkv6-7b": {"lane"}, "hymba-1.5b": {"paged", "lane"}}[arch]
    if arch == "hymba-1.5b":  # the sliding-window layer's ring and every SSM state are lane leaves
        lane = {key for key, (kind, _, _) in want.items() if kind == "lane"}
        assert lane == {"['layer1']['k']", "['layer1']['v']"} | {f"['layer{i}']['ssm']" for i in range(4)}


def test_lane_state_rows_follow_their_lanes():
    _, _, tm, tp = reduced_pair("rwkv6-7b")
    pool = ServingEngine(tm, tp, max_batch=3, cache_len=64, runtime=KernelRuntime()).pool
    assert pool.ensure(1, 8)
    cache1 = tm.init_cache(1, 64)
    for key in cache1:
        cache1[key].fill_(2.0)
    pool.admit(1, cache1)
    view = pool.gather([2, 1])  # lane 2 has no table: its own (zero) row, not a scratch block
    assert torch.all(view["wkv"][:, 0] == 0) and torch.all(view["wkv"][:, 1] == 2)
    view["x1"][:, 0] = 5.0
    pool.scatter([2, 1], view)
    assert torch.all(pool.gather([2])["x1"] == 5.0)
    pool.reset_lane_state(1)
    assert all(torch.all(t == 0) for t in pool.gather([1]).values())


def test_cli_serves_rwkv_on_cpu(capsys):
    outs = serve_cli.main(["--arch", "rwkv6-7b", "--device", "cpu", "--requests", "3",
                           "--max-new-tokens", "4", "--max-batch", "2", "--cache-len", "64"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "served 3 requests on cpu (rwkv6-7b" in capsys.readouterr().out


def test_hymba_engine_matches_reference_engine():
    jm, jp, tm, tp = reduced_pair("hymba-1.5b", 4)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32) for n in (5, 40)]
    kw = dict(max_batch=2, cache_len=128)
    jeng = JaxEngine(jm, jp, runtime=JaxRuntime(), **kw)
    teng = ServingEngine(tm, tp, runtime=KernelRuntime(), **kw)
    jt = [jeng.submit(p, max_new_tokens=4) for p in prompts]
    tt = [teng.submit(p, max_new_tokens=4) for p in prompts]
    jeng.step(), teng.step()
    js, ts = jeng.status(), teng.status()
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps) == (js.completed, js.in_flight, js.queued, js.steps)
    js, ts = jeng.drain(), teng.drain()
    assert [t.request.output for t in tt] == [t.request.output for t in jt]
    assert all(len(t.request.output) == 4 and t.done for t in tt)
    assert (ts.completed, ts.in_flight, ts.queued, ts.steps, ts.exhausted) == (
        js.completed, js.in_flight, js.queued, js.steps, js.exhausted)
    tstats, jstats = teng.pool.stats(), jeng.pool.stats()
    assert {k: tstats[k] for k in tstats} == pytest.approx({k: jstats[k] for k in tstats})
    # Dense view of every lane's ring and SSM state after the run, retired lanes included.
    tview, jview = teng.cache, jeng.cache
    for i in range(4):
        np.testing.assert_allclose(tview[f"layer{i}"]["ssm"].numpy(), np.asarray(jview[f"layer{i}"]["ssm"]),
                                   rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tview["layer1"][key].numpy(), np.asarray(jview["layer1"][key]),
                                   rtol=1e-4, atol=1e-4)


def test_cli_serves_hymba_on_cpu(capsys):
    outs = serve_cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests", "3",
                           "--max-new-tokens", "4", "--max-batch", "2", "--cache-len", "64"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert "served 3 requests on cpu (hymba-1.5b" in capsys.readouterr().out
