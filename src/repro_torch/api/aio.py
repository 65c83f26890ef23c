"""Async front end over the gateway.

The port of ``repro.api.aio``: the same awaitables over the port's
gateway, whose flush loop resolves tickets through the top-k kernel on
the card.

``AsyncGateway`` exposes every gateway endpoint as an awaitable. The
similarity-shaped reads (``similarity`` / ``closest_concepts``) bridge
the scheduler's thread-resolved :class:`Ticket` into an
``asyncio.Future`` via ``Ticket.add_done_callback`` +
``loop.call_soon_threadsafe`` — the same loop-safe pattern as
``asyncio.wrap_future``, with zero polling and no executor thread
parked on a blocking ``result()``. Direct reads (download,
autocomplete, ops endpoints) run in the default executor so the event
loop never blocks on index builds or disk metadata.

    gw = Gateway(engine, flush_after_ms=2.0)
    ag = AsyncGateway(gw)
    a, b = await asyncio.gather(
        ag.closest_concepts("go", "transe", "GO:0000001"),
        ag.similarity("go", "transe", "GO:0000001", "GO:0000002"))

Concurrent coroutines coalesce exactly like concurrent threads do: each
``await`` submits a ticket and yields; the flush loop drains the queue
as one micro-batched kernel call.
"""
from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Sequence

from ..core.serving import SchedulerError, Ticket
from .gateway import TICKET_ROUTES, Gateway, _error_from_ticket
from .schema import (ApiError, AutocompleteResponse, ClosestConceptsRequest,
                     ClosestConceptsResponse, DownloadPage, HealthResponse,
                     JobListResponse, JobResultPage, JobStatusResponse,
                     LineageResponse, SimilarityRequest, SimilarityResponse,
                     StatsResponse, VectorResponse, VersionsResponse)


def ticket_future(ticket: Ticket,
                  loop: Optional[asyncio.AbstractEventLoop] = None
                  ) -> "asyncio.Future":
    """Bridge a scheduler Ticket to an asyncio Future on ``loop``
    (default: the running loop). Resolution happens on the flush-loop
    thread; the callback posts the transition through
    ``call_soon_threadsafe``, which is the only loop-safe way in."""
    loop = loop or asyncio.get_running_loop()
    fut = loop.create_future()

    def on_done(t: Ticket) -> None:
        # compute the outcome here on the resolver thread; the loop
        # callback only settles the future (keeps flush-loop time and
        # event-loop time both minimal)
        try:
            outcome, is_err = t.result(timeout=0), False
        except SchedulerError as e:
            outcome, is_err = _error_from_ticket(e), True
        except Exception as e:                     # pragma: no cover
            outcome, is_err = e, True

        def settle() -> None:
            if fut.cancelled() or fut.done():      # timed out / cancelled
                return
            if is_err:
                fut.set_exception(outcome)
            else:
                fut.set_result(outcome)
        # shutdown race: the ticket may resolve (on the flush thread)
        # after the client's event loop has already closed — e.g. a
        # drain at interpreter exit, or a test tearing the loop down
        # while a straggler flush lands. call_soon_threadsafe raises
        # RuntimeError("Event loop is closed") then; without the guard
        # that escapes into Ticket._fire_callbacks on the flush thread.
        # The is_closed() pre-check skips the common case cheaply and
        # the except covers the close-after-check race; the future is
        # dead with its loop either way, so dropping the result is the
        # only correct outcome.
        if loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(settle)
        except RuntimeError:
            pass                                   # closed under our feet

    ticket.add_done_callback(on_done)
    return fut


class AsyncGateway:
    """Awaitable wrapper over a :class:`Gateway`.

    Requires the scheduler's flush loop (there is no caller thread to
    drive a synchronous ``flush()``); if it isn't running yet it is
    started with ``flush_after_ms``.
    """

    def __init__(self, gateway: Gateway, *, flush_after_ms: float = 2.0):
        self.gateway = gateway
        #: async implementations of every ticket-routed endpoint; the
        #: coverage assert makes a new TICKET_ROUTES entry fail loudly
        #: here instead of silently degrading to an executor thread
        #: parked on ticket.result()
        self._ticket_impls = {"sim": self._handle_sim_wire,
                              "closest-concepts": self._handle_closest_wire}
        missing = set(TICKET_ROUTES) - set(self._ticket_impls)
        assert not missing, f"no async impl for ticket routes: {missing}"
        if not gateway.scheduler.running():
            gateway.scheduler.start(flush_after_ms=flush_after_ms)

    def close(self) -> None:
        self.gateway.close()

    async def __aenter__(self) -> "AsyncGateway":
        return self

    async def __aexit__(self, *exc) -> None:
        await asyncio.get_running_loop().run_in_executor(None, self.close)

    # ------------------- scheduler-routed (ticket) --------------------- #
    async def _settle(self, ticket: Ticket,
                      timeout: Optional[float] = None):
        loop = asyncio.get_running_loop()
        fut = ticket_future(ticket, loop)
        if timeout is None:
            timeout = self.gateway.timeout_s

        def expire() -> None:
            if not fut.done():
                fut.set_exception(ApiError(
                    "TIMEOUT",
                    f"request unresolved after {timeout}s",
                    details={"ticket": ticket.id}))

        # a call_later timer instead of asyncio.wait_for: wait_for wraps
        # every await in an extra Task, which is measurable overhead at
        # micro-batch request rates (see bench_gateway)
        timer = loop.call_later(timeout, expire)
        try:
            return await fut
        finally:
            timer.cancel()

    async def _settle_counted(self, ticket: Ticket,
                              timeout: Optional[float] = None):
        """_settle + gateway error accounting: resolution-time failures
        happen outside the _run wrapper here (the submit returned before
        the ticket resolved), so count them explicitly — /stats must not
        undercount under async traffic."""
        try:
            return await self._settle(ticket, timeout=timeout)
        except ApiError as e:
            self.gateway._count_error(e)
            raise

    async def similarity(self, ontology: str, model: str, a: str, b: str, *,
                         fuzzy: bool = False,
                         version: Optional[str] = None) -> SimilarityResponse:
        gw = self.gateway
        req = SimilarityRequest(ontology, model, a, b, fuzzy, version)
        staged = gw._run("sim", req, gw._submit_similarity)
        if isinstance(staged, SimilarityResponse):
            return staged                      # result-cache hit at staging
        score = await self._settle_counted(
            staged, timeout=gw._route_budget("sim"))
        resp = gw._similarity_response(req, staged, score)
        gw._cache_store(gw._cache_key("sim", req), resp)
        return resp

    async def closest_concepts(self, ontology: str, model: str, query: str, *,
                               k: int = 10, fuzzy: bool = False,
                               version: Optional[str] = None
                               ) -> ClosestConceptsResponse:
        gw = self.gateway
        req = ClosestConceptsRequest(ontology, model, query, k, fuzzy, version)
        staged = gw._run("closest-concepts", req, gw._submit_closest)
        if isinstance(staged, ClosestConceptsResponse):
            return staged                      # result-cache hit at staging
        result = await self._settle_counted(
            staged, timeout=gw._route_budget("closest-concepts"))
        resp = gw._closest_response(req, staged, result)
        gw._cache_store(gw._cache_key("closest-concepts", req), resp)
        return resp

    # -------------------------- fan-out helpers ------------------------ #
    async def closest_concepts_many(
            self, requests: Sequence[ClosestConceptsRequest], *,
            return_exceptions: bool = False) -> List:
        """``asyncio.gather`` fan-out: submit every request concurrently
        so the flush loop coalesces them into micro-batches."""
        return await asyncio.gather(
            *(self.closest_concepts(r.ontology, r.model, r.query, k=r.k,
                                    fuzzy=r.fuzzy, version=r.version)
              for r in requests),
            return_exceptions=return_exceptions)

    async def similarity_many(self, requests: Sequence[SimilarityRequest], *,
                              return_exceptions: bool = False) -> List:
        return await asyncio.gather(
            *(self.similarity(r.ontology, r.model, r.a, r.b, fuzzy=r.fuzzy,
                              version=r.version) for r in requests),
            return_exceptions=return_exceptions)

    # ------------------- direct reads (executor) ----------------------- #
    async def _blocking(self, fn, *args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: fn(*args, **kwargs))

    async def get_vector(self, ontology: str, model: str, query: str, *,
                         fuzzy: bool = False,
                         version: Optional[str] = None) -> VectorResponse:
        return await self._blocking(self.gateway.get_vector, ontology, model,
                                    query, fuzzy=fuzzy, version=version)

    async def download(self, ontology: str, model: str, *,
                       version: Optional[str] = None, offset: int = 0,
                       limit: int = 1000) -> DownloadPage:
        return await self._blocking(self.gateway.download, ontology, model,
                                    version=version, offset=offset,
                                    limit=limit)

    async def autocomplete(self, ontology: str, model: str, prefix: str, *,
                           limit: int = 10, version: Optional[str] = None
                           ) -> AutocompleteResponse:
        return await self._blocking(self.gateway.autocomplete, ontology,
                                    model, prefix, limit=limit,
                                    version=version)

    async def health(self) -> HealthResponse:
        return await self._blocking(self.gateway.health)

    async def stats(self) -> StatsResponse:
        return await self._blocking(self.gateway.stats)

    async def versions(self, ontology: str) -> VersionsResponse:
        return await self._blocking(self.gateway.versions, ontology)

    async def lineage(self, ontology: str,
                      version: Optional[str] = None) -> LineageResponse:
        return await self._blocking(self.gateway.lineage, ontology, version)

    # --------------------------- batch jobs ---------------------------- #
    # submit/poll/result/cancel are thin executor hops: the manager's own
    # locking is cheap, but submit validates coordinates against the
    # store (disk metadata) and result_rows may read a rows file, so none
    # of them belong on the event loop.
    async def submit_job(self, kind: str, ontology: str, *,
                         model: Optional[str] = None,
                         version: Optional[str] = None,
                         version_b: Optional[str] = None,
                         classes: Optional[Sequence[str]] = None,
                         k: int = 10,
                         models: Optional[Sequence[str]] = None,
                         sample: Optional[int] = None) -> JobStatusResponse:
        return await self._blocking(
            self.gateway.submit_job, kind, ontology, model=model,
            version=version, version_b=version_b, classes=classes, k=k,
            models=models, sample=sample)

    async def job_status(self, job_id: str) -> JobStatusResponse:
        return await self._blocking(self.gateway.job_status, job_id)

    async def job_result(self, job_id: str, *, offset: int = 0,
                         limit: int = 1000) -> JobResultPage:
        return await self._blocking(self.gateway.job_result, job_id,
                                    offset=offset, limit=limit)

    async def job_cancel(self, job_id: str) -> JobStatusResponse:
        return await self._blocking(self.gateway.job_cancel, job_id)

    async def jobs_list(self) -> JobListResponse:
        return await self._blocking(self.gateway.jobs_list)

    async def job_wait(self, job_id: str, *, poll_s: float = 0.02,
                       timeout: Optional[float] = None) -> JobStatusResponse:
        """Poll until the job reaches a terminal state, yielding the
        event loop between polls (unlike the sync ``Gateway.job_wait``,
        which parks its thread)."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        while True:
            status = await self.job_status(job_id)
            if status.state in ("DONE", "FAILED", "CANCELLED"):
                return status
            if deadline is not None and loop.time() >= deadline:
                raise ApiError(
                    "TIMEOUT", f"job {job_id} unfinished after {timeout}s",
                    details={"job_id": job_id, "state": status.state,
                             "progress": status.progress})
            await asyncio.sleep(poll_s)

    # ------------------------------ wire ------------------------------- #
    async def _handle_sim_wire(self, req: SimilarityRequest):
        return await self.similarity(req.ontology, req.model, req.a, req.b,
                                     fuzzy=req.fuzzy, version=req.version)

    async def _handle_closest_wire(self, req: ClosestConceptsRequest):
        return await self.closest_concepts(req.ontology, req.model,
                                           req.query, k=req.k,
                                           fuzzy=req.fuzzy,
                                           version=req.version)

    async def handle(self, route: str,
                     payload: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """Async ``Gateway.handle``: ticket routes (``TICKET_ROUTES``)
        await their future bridge, everything else runs in the executor.
        Never raises on request faults — errors come back as wire
        payloads. Parsing goes through the same ``_build_request`` as
        the sync entry point, so payload shape and route/payload-conflict
        rules are identical."""
        from .schema import to_wire
        try:
            name, handler, req = self.gateway._build_request(route, payload)
            impl = self._ticket_impls.get(name)
            if impl is None:
                # ops/direct read: reuse the already-parsed request via
                # the counted sync dispatcher, off the event loop
                return await self._blocking(
                    lambda: to_wire(self.gateway._run(name, req, handler)))
            return to_wire(await impl(req))
        except ApiError as e:
            self.gateway._count_error(e)
            return e.to_wire()
