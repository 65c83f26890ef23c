"""The port's async front end (``repro_torch.api.aio``), on the CPU.

The five cases of ``tests/test_api_aio.py`` against the port's gateway
(``device="cpu"``, where top-k runs its plain PyTorch version): the
loop-safe ticket->future bridge, gather fan-out across a mid-stream
invalidate with exactly-once resolution and version pinning, async
answers equal to the sync ones, structured error propagation into
coroutines, direct reads and the wire entry point, and a ticket future on
an already resolved ticket."""
import asyncio

import numpy as np
import pytest

from repro_torch.api import ApiError, AsyncGateway, Gateway, ticket_future
from repro_torch.api.schema import ClosestConceptsRequest
from repro_torch.core.registry import EmbeddingRegistry
from repro_torch.core.serving import ServingEngine, TopKRequest

N, D = 40, 12


def _publish(registry, version, seed):
    rng = np.random.default_rng(seed)
    ids = [f"GO:{i:07d}" for i in range(N)]
    labels = [f"go term {i}" for i in range(N)]
    emb = rng.standard_normal((N, D)).astype(np.float32)
    registry.publish("go", version, "transe", ids, labels, emb,
                     ontology_checksum=f"ck-{version}", hyperparameters={})
    return ids


@pytest.fixture()
def registry(tmp_path):
    return EmbeddingRegistry(tmp_path / "registry")


@pytest.fixture()
def served(registry):
    ids = _publish(registry, "2024-01", seed=1)
    engine = ServingEngine(registry, cache_capacity=4, device="cpu")
    gateway = Gateway(engine)
    return engine, gateway, ids


def test_gather_64_across_midstream_invalidate(served, registry):
    """64 concurrent closest_concepts awaits; a release lands after the
    first 32 submits. Every call resolves exactly once, pinned to the
    version that was latest when it was submitted."""
    engine, gateway, ids = served
    ag = AsyncGateway(gateway, flush_after_ms=1.0)

    async def run():
        first = [asyncio.ensure_future(
            ag.closest_concepts("go", "transe", ids[i % N], k=5))
            for i in range(32)]
        # wait until every phase-1 coroutine has actually submitted
        while gateway.scheduler.stats["submitted"] < 32:
            await asyncio.sleep(0.001)
        _publish(registry, "2024-02", seed=2)
        engine.invalidate("go", "2024-02")
        second = [asyncio.ensure_future(
            ag.closest_concepts("go", "transe", ids[i % N], k=5))
            for i in range(32)]
        return await asyncio.gather(*(first + second))

    res = asyncio.run(run())
    gateway.close()                               # drains the flush loop
    assert len(res) == 64
    assert {r.version for r in res[:32]} == {"2024-01"}   # pinned pre-swap
    assert {r.version for r in res[32:]} == {"2024-02"}   # post-swap
    assert all(len(r.results) == 5 for r in res)
    st = gateway.scheduler.stats
    assert st["resolved"] == st["submitted"]              # exactly once
    assert st["failed"] == 0 and gateway.scheduler.pending() == 0
    # concurrent awaits actually coalesced (far fewer kernel calls than
    # requests — 64 sequential solo calls would be 64 batches)
    assert st["batches"] < 64


def test_async_results_match_sync_oracle(served):
    engine, gateway, ids = served
    ag = AsyncGateway(gateway, flush_after_ms=1.0)

    async def run():
        return await ag.closest_concepts_many(
            [ClosestConceptsRequest("go", "transe", ids[i], k=4)
             for i in range(8)])

    res = asyncio.run(run())
    for i, r in enumerate(res):
        oracle = gateway.closest_concepts("go", "transe", ids[i], k=4)
        assert [h.identifier for h in r.results] == \
               [h.identifier for h in oracle.results]
        assert [h.score for h in r.results] == \
               [h.score for h in oracle.results]
    gateway.close()


def test_async_error_propagation(served):
    engine, gateway, ids = served
    ag = AsyncGateway(gateway, flush_after_ms=1.0)

    async def run():
        with pytest.raises(ApiError) as ei:
            await ag.similarity("go", "transe", "BOGUS-A", "BOGUS-B")
        assert ei.value.code == "UNKNOWN_CLASS"
        assert ei.value.details["missing"] == ["BOGUS-A", "BOGUS-B"]
        with pytest.raises(ApiError) as ei:
            await ag.closest_concepts("go", "transe", ids[0], k=0)
        assert ei.value.code == "BAD_REQUEST"
        # gathered errors surface per-call with return_exceptions
        out = await ag.closest_concepts_many(
            [ClosestConceptsRequest("go", "transe", ids[0], k=3),
             ClosestConceptsRequest("go", "transe", "NOPE", k=3)],
            return_exceptions=True)
        assert len(out[0].results) == 3
        assert isinstance(out[1], ApiError)
        assert out[1].code == "UNKNOWN_CLASS"

    asyncio.run(run())
    gateway.close()
    st = gateway.scheduler.stats
    assert st["resolved"] == st["submitted"]
    # async resolution-time failures are counted in the gateway stats too
    assert gateway.counters["by_code"]["UNKNOWN_CLASS"] >= 2
    assert gateway.counters["by_code"]["BAD_REQUEST"] >= 1


def test_async_direct_reads_and_wire(served):
    engine, gateway, ids = served
    ag = AsyncGateway(gateway, flush_after_ms=1.0)

    async def run():
        page, vers, health, vec = await asyncio.gather(
            ag.download("go", "transe", limit=10),
            ag.versions("go"),
            ag.health(),
            ag.get_vector("go", "transe", ids[0]))
        assert page.total == N and len(page.rows) == 10
        assert vers.latest == "2024-01"
        assert health.scheduler_running is True        # aio started the loop
        assert vec.identifier == ids[0]
        wire = await ag.handle("/sim/go/transe", {"a": ids[0], "b": ids[1]})
        assert wire["type"] == "similarity_response"
        err = await ag.handle("/sim/go/transe", {"a": "NOPE", "b": "NOPE2"})
        assert err["code"] == "UNKNOWN_CLASS"
        assert err["details"]["missing"] == ["NOPE", "NOPE2"]
        assert (await ag.handle("/no/such/route"))["status"] == 404
        # same parsing contract as the sync handle: malformed payloads
        # and route/payload conflicts come back as wire errors, never
        # raised exceptions
        bad = await ag.handle("/sim/go/transe", "notadict")
        assert bad["code"] == "BAD_REQUEST"
        clash = await ag.handle("/sim/go/transe",
                                {"ontology": "hp", "a": ids[0], "b": ids[1]})
        assert clash["code"] == "BAD_REQUEST"
        assert clash["details"]["conflicting_fields"] == ["ontology"]

    asyncio.run(run())
    gateway.close()


def test_ticket_future_on_already_resolved_ticket(served):
    """The bridge must settle immediately for a ticket that resolved
    before the callback was attached (no lost-wakeup race)."""
    engine, gateway, ids = served
    ticket = gateway.scheduler.submit(TopKRequest("go", "transe", ids[0], 3))
    gateway.scheduler.flush()
    assert ticket.done()

    async def run():
        res = await asyncio.wait_for(ticket_future(ticket), timeout=5)
        assert len(res) == 3

    asyncio.run(run())
    gateway.close()
