"""The port's fleet router against the JAX package's, decision for decision.

Each of the reference's router tests (``tests/test_router.py``: dispatch by
health, SLO calm, prefix affinity, load and name; streaming tickets; status
aggregation; ``DeploymentBundle.router``) runs on a JAX router and a port
router over the echo+1 toy engines (``_torch_toys.py``), poked and driven the
same way: every ``dispatch`` key, route, output and aggregate
``EngineStatus`` must be equal.  A scripted sequence of submits, steps and
health and SLO changes over prefix-sharing engines gives the same dispatch
keys at every point.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_toys import JaxToy, Toy, status_equal
from repro.core.bundle import DeploymentBundle as JaxBundle
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxEngine
from repro.serve.router import Router as JaxRouter
from repro_torch.core.bundle import DeploymentBundle
from repro_torch.serve import Router
from repro_torch.serve.engine import Request, ServingEngine

FIXTURE = Path(__file__).parent / "data" / "bundle_v5.json"
KW = dict(max_batch=2, cache_len=32, prefill_buckets=(8, 16))
SHARING = dict(max_batch=2, cache_len=64, block_size=8, prefill_buckets=(8, 16), prefill_chunk_tokens=16)


class Routers:
    """A JAX router and a port router over engines built alike; every call
    runs on both and returns the port's result after checking it equals the
    reference's.  The engines read a stopped clock: SLO mode enters only
    where a test sets it, never from the two packages' different step times."""

    def __init__(self, n=2, **kw):
        kw = dict(kw or KW, clock=lambda: 0.0)
        self.j = JaxRouter({f"dev{i}": JaxEngine(JaxToy(), {}, **kw) for i in range(n)}, name="test")
        self.t = Router({f"dev{i}": ServingEngine(Toy(), {}, **kw) for i in range(n)}, name="test")

    def dispatch(self, **kw):
        got, want = self.t.dispatch(**kw), self.j.dispatch(**kw)
        assert got == want
        return got

    def poke(self, key, **attrs):
        for router in (self.j, self.t):
            for name, value in attrs.items():
                setattr(router.engines[key], name, value)

    def engine_submit(self, key, prompt, **kw):
        self.j.engines[key].submit(prompt, **kw)
        self.t.engines[key].submit(prompt, **kw)

    def submit(self, prompt, **kw):
        jt, tt = self.j.submit(prompt, **kw), self.t.submit(prompt, **kw)
        assert tt.request.routed_to == jt.request.routed_to
        return jt, tt

    def step(self):
        got, want = self.t.step(), self.j.step()
        assert got == want
        return got

    def drain(self):
        got, want = self.t.drain(), self.j.drain()
        status_equal(got, want)
        return got

    def status(self):
        got, want = self.t.status(), self.j.status()
        status_equal(got, want)
        return got


def _prompt(n=4, start=3):
    return np.arange(start, start + n, dtype=np.int32)


# ---------------------------------------------------------------------------
# dispatch policy
# ---------------------------------------------------------------------------
def test_dispatch_least_loaded_with_name_tiebreak():
    r = Routers()
    assert r.dispatch() == "dev0"
    r.engine_submit("dev0", _prompt())
    assert r.dispatch() == "dev1"
    r.engine_submit("dev1", _prompt())
    r.engine_submit("dev1", _prompt())
    assert r.dispatch() == "dev0"


def test_dispatch_avoids_degraded_engines():
    r = Routers()
    r.poke("dev0", health="degraded")
    assert r.dispatch() == "dev1"
    r.poke("dev1", health="degraded")
    assert r.dispatch() == "dev0"
    assert r.status().health == "degraded"


def test_dispatch_routes_slo_traffic_away_from_pressured_engines():
    r = Routers()
    r.poke("dev0", _slo_mode=True)
    assert r.dispatch() == "dev0"
    assert r.dispatch(latency_target_ms=5.0) == "dev1"
    r.poke("dev1", _slo_mode=True)
    assert r.dispatch(latency_target_ms=5.0) == "dev0"


def test_submit_tags_route_and_balances():
    r = Routers()
    tickets = [r.submit(_prompt(), max_new_tokens=4) for _ in range(4)]
    assert {tt.request.routed_to for _, tt in tickets} == {"dev0", "dev1"}
    status = r.drain()
    assert status.completed == 4 and not status.exhausted
    assert all(tt.done and tt.request.output == jt.request.output for jt, tt in tickets)


# ---------------------------------------------------------------------------
# serving surface
# ---------------------------------------------------------------------------
def test_router_ticket_streams_across_the_fleet():
    r = Routers()
    (j0, t0), (j1, t1) = r.submit(_prompt(), max_new_tokens=5), r.submit(_prompt(start=7), max_new_tokens=5)
    assert t0.request.routed_to != t1.request.routed_to
    toks, jtoks = list(t0.tokens()), list(j0.tokens())
    assert toks == jtoks and len(toks) == 5 and t0.done
    assert len(t1.request.output) == len(j1.request.output) > 0  # the fleet progressed while one streamed
    r.drain()
    assert t1.done and t1.request.output == j1.request.output


def test_submit_request_respects_slo_dispatch():
    r = Routers()
    r.poke("dev0", _slo_mode=True)
    treq = Request(uid=99, prompt=_prompt(), max_new_tokens=3, latency_target_ms=50.0)
    jreq = JaxRequest(uid=99, prompt=_prompt(), max_new_tokens=3, latency_target_ms=50.0)
    ticket = r.t.submit_request(treq)
    jticket = r.j.submit_request(jreq)
    assert treq.routed_to == jreq.routed_to == "dev1"
    assert ticket.result() == jticket.result() == treq.output and treq.done


def test_drain_aggregates_per_engine_statuses():
    r = Routers()
    for i in range(5):
        r.submit(_prompt(start=2 + i), max_new_tokens=3)
    status = r.drain()
    assert status.completed == 5 and status.in_flight == 0 and status.queued == 0
    assert status.steps == max(r.t.engines[k].steps for k in sorted(r.t.engines))
    assert status.health == "healthy" and r.t.healths() == r.j.healths() == {"dev0": "healthy", "dev1": "healthy"}


def test_router_rejects_empty_fleet():
    with pytest.raises(ValueError):
        Router({})


def test_router_from_engine_iterable_keys_by_position():
    router = Router([ServingEngine(Toy(), {}, **KW), ServingEngine(Toy(), {}, **KW)])
    assert sorted(router.engines) == ["engine0", "engine1"]


# ---------------------------------------------------------------------------
# bundle.router() wiring
# ---------------------------------------------------------------------------
def test_bundle_router_builds_isolated_engines():
    """A two-device bundle (the reference's TPU fixture: on the CPU its
    configs are selections only) fronts one engine per device, each on its
    own runtime; the same routes as the reference's ``bundle.router``."""
    kw = dict(max_batch=2, cache_len=32, block_size=8, prefill_buckets=(8, 16))
    router = DeploymentBundle.load(FIXTURE).router(Toy(), {}, **kw)
    jrouter = JaxBundle.load(FIXTURE).router(JaxToy(), {}, **kw)
    assert sorted(router.engines) == sorted(jrouter.engines) == ["tpu_v4", "tpu_v5e"]
    assert len({eng.runtime for eng in router.engines.values()}) == 2
    for dev, eng in router.engines.items():
        assert eng.runtime.active_device() == dev and eng.device == dev
    tickets = [router.submit(_prompt(start=1 + i), max_new_tokens=3) for i in range(4)]
    jtickets = [jrouter.submit(_prompt(start=1 + i), max_new_tokens=3) for i in range(4)]
    status_equal(router.drain(), jrouter.drain())
    assert [t.request.routed_to for t in tickets] == [t.request.routed_to for t in jtickets]
    assert {t.request.routed_to for t in tickets} == {"tpu_v4", "tpu_v5e"}
    assert [t.request.output for t in tickets] == [t.request.output for t in jtickets]
    one = DeploymentBundle.load(FIXTURE).router(Toy(), {}, devices=["tpu_v4"], name="one", **kw)
    assert list(one.engines) == ["tpu_v4"] and one.name == "one"


def test_bundle_router_refuses_uncompiled_configs_for_a_cuda_model():
    """On a CUDA model a device entry whose configs the port has not compiled
    raises before any engine is built, as ``ServingEngine(bundle=)`` does."""

    class CardToy(Toy):
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="compiled space"):
        DeploymentBundle.load(FIXTURE).router(CardToy(), {}, max_batch=2, cache_len=32, block_size=8)


# ---------------------------------------------------------------------------
# prefix-affinity dispatch + pool-health aggregation
# ---------------------------------------------------------------------------
def test_dispatch_follows_cached_prefix():
    r = Routers(**SHARING)
    sys_prompt = list(range(1, 17))
    _, t = r.submit(sys_prompt + [3], max_new_tokens=2)
    assert t.request.routed_to == "dev0"
    r.drain()
    r.engine_submit("dev0", list(range(40, 50)), max_new_tokens=4)
    assert r.dispatch() == "dev1"
    assert r.dispatch(prompt=sys_prompt + [9]) == "dev0"
    assert r.t.engines["dev0"].status().prefix_lookups == 1  # the probe is read-only


def test_affinity_ignores_engines_without_overlap():
    r = Routers(**SHARING)
    assert r.dispatch(prompt=list(range(1, 17))) == "dev0"


def test_status_aggregates_pool_health():
    r = Routers(**SHARING)
    sys_prompt = list(range(1, 17))
    for tail in ([3], [5], [7], [9]):
        r.submit(sys_prompt + tail, max_new_tokens=2)
    r.drain()
    fleet = r.status()
    per = [r.t.engines[k].status() for k in sorted(r.t.engines)]
    assert fleet.prefix_lookups == sum(s.prefix_lookups for s in per) > 0
    assert fleet.prefix_hits == sum(s.prefix_hits for s in per)
    assert fleet.shared_blocks == sum(s.shared_blocks for s in per)
    assert fleet.pool_utilization == pytest.approx(sum(s.pool_utilization for s in per) / len(per))
    assert fleet.pool_fragmentation == pytest.approx(sum(s.pool_fragmentation for s in per) / len(per))
    assert 0.0 <= fleet.prefix_hit_rate <= 1.0


def test_scripted_dispatch_sequence_matches_reference():
    """Three prefix-sharing engines; submits with and without prompts and
    targets, steps, and health and SLO changes in between: equal dispatch keys
    (and routes, outputs and fleet status) at every point."""
    r = Routers(n=3, **SHARING)
    rng = np.random.default_rng(6)
    systems = [list(range(1, 17)), list(range(20, 36))]
    keys = []
    for i in range(24):
        prompt = systems[i % 2] + [int(x) for x in rng.integers(1, 16, int(rng.integers(1, 5)))]
        target = 4.0 if i % 3 == 0 else None
        keys.append(r.dispatch(prompt=prompt, latency_target_ms=target))
        keys.append(r.dispatch())
        r.submit(prompt, max_new_tokens=int(rng.integers(2, 6)), latency_target_ms=target)
        if i % 4 == 1:
            r.step()
        if i == 8:
            r.poke("dev1", health="degraded")
        if i == 12:
            r.poke("dev2", _slo_mode=True)
        if i == 16:
            r.poke("dev1", health="healthy")
        r.status()
    assert set(keys) == {"dev0", "dev1", "dev2"}
    r.drain()
