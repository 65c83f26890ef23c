"""The batch-first gateway: one ``handle(route, payload)`` entry point
over the serving runtime.

``Gateway`` is the transport-agnostic public surface of Bio-KGvec2go
(the real HTTP front end over it lives in ``repro_torch.api.http``).
It is the port of ``repro.api.gateway`` without the batch-job routes
(``/jobs/...``), which come with the jobs/analytics slice. Design
points:

* **batch-first routing** — every similarity-shaped read (``sim`` AND
  single-query ``closest-concepts``) is submitted to the
  ``BatchScheduler``, so concurrent clients coalesce into micro-batched
  kernel calls instead of each taking a private launch. With a flush
  loop running (``flush_after_ms=``) callers block on their ticket while
  the loop drains; without one the gateway drives a synchronous
  ``flush()`` after submit — same contract, no idle thread.
* **boundary validation** — ``k <= 0``, ``limit <= 0``, empty
  query/prefix, wrong payload shapes and unknown routes all fail with
  structured ``ApiError`` codes *before* anything reaches the kernel
  path.
* **cursor-paginated download** — ``DownloadPage`` rows are a stable
  slice of the entity table for a pinned version; clients echo
  ``page.version``/``page.next_offset`` back to walk the full table
  consistently across a mid-pagination release.
* **freshness hook** — the gateway registers an invalidate listener on
  the engine; the updater's publish→invalidate evicts the cached
  versions/models metadata so ``versions``/``lineage`` reflect a new
  release immediately.
* **version-keyed result cache** — ``sim`` / ``closest-concepts`` /
  ``get-vector`` responses are deterministic per pinned snapshot
  version, so they are cached whole (``repro_torch.api.cache.ResultCache``,
  bounded by entries and bytes) under a key that includes the
  *resolved* version; the same invalidate listener purges an ontology's
  entries on publish, so a new release can never serve stale bytes.
* **admission control** — ``max_pending`` bounds scheduler intake
  (fast ``OVERLOADED`` rejects instead of an unbounded backlog) and
  per-route deadline budgets (``route_budgets``) let queued tickets
  expire before burning kernel time once their client has given up.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from ..core.metrics import LatencyHistogram
from ..core.serving import (BatchScheduler, SchedulerError, ServingEngine,
                            SimRequest, Ticket, TopKRequest)
from .cache import ResultCache, canonical_payload
from .schema import (ApiError, AutocompleteRequest, AutocompleteResponse,
                     ClosestConceptsRequest, ClosestConceptsResponse,
                     ConceptHit, DownloadPage, DownloadRequest,
                     GetVectorRequest, HealthRequest, HealthResponse,
                     LineageRequest, LineageResponse, SimilarityRequest,
                     SimilarityResponse, StatsRequest, StatsResponse,
                     VectorResponse, VersionsRequest, VersionsResponse,
                     payload_to, to_wire)

API_VERSION = "v1"

#: routes whose responses are pure functions of (resolved version,
#: payload) — the only ones the result cache may serve. download is
#: excluded (the HTTP layer already has ETag/304 + streaming for it),
#: ops routes report live state.
CACHED_ROUTES = ("sim", "closest-concepts", "get-vector")


def download_etag(ontology: str, model: str, version: str,
                  offset: int, limit: int,
                  requested_limit: Optional[int] = None) -> str:
    """Strong ETag for one download page. A pinned
    (ontology, model, version) snapshot is immutable, so the page's
    coordinates fully determine its bytes — hashing them (plus the API
    version, so a wire-format change invalidates cached pages) gives a
    validator the HTTP layer can check *without* building or touching
    the index. ``limit`` is the effective (clamped) page size;
    ``requested_limit`` (default: same) is what the client asked for —
    it is part of the key because the page *echoes* it, and a strong
    validator must identify bytes, not just rows (two clamped requests
    with different requested limits serve different bodies)."""
    if requested_limit is None:
        requested_limit = limit
    key = (f"{API_VERSION}|{ontology}|{model}|{version}|{offset}"
           f"|{limit}|{requested_limit}")
    return '"' + hashlib.sha1(key.encode("utf-8")).hexdigest()[:24] + '"'


# ------------------------- boundary validation ------------------------- #
def _req_str(name: str, value) -> str:
    if not isinstance(value, str) or not value.strip():
        raise ApiError("BAD_REQUEST",
                       f"{name} must be a non-empty string, got {value!r}",
                       details={"field": name})
    return value


def _req_int(name: str, value, minimum: int) -> int:
    if isinstance(value, bool) or not isinstance(value, int) \
            or value < minimum:
        raise ApiError("BAD_REQUEST",
                       f"{name} must be an integer >= {minimum}, "
                       f"got {value!r}", details={"field": name})
    return value


def _opt_version(value) -> Optional[str]:
    if value is None:
        return None
    return _req_str("version", value)


def _error_from_ticket(e: SchedulerError) -> ApiError:
    """SchedulerError (possibly carrying a structured code from the
    scheduler) -> ApiError. Unclassified faults surface as INTERNAL."""
    return ApiError(e.code or "INTERNAL", str(e), details=e.details)


class Gateway:
    """Versioned (v1) gateway over a :class:`ServingEngine`.

    Owns a :class:`BatchScheduler` unless one is passed in. All five
    paper endpoints plus the ops endpoints dispatch through
    :meth:`handle`; typed per-endpoint methods are the same handlers
    without the wire codec.
    """

    def __init__(self, engine: ServingEngine,
                 scheduler: Optional[BatchScheduler] = None, *,
                 max_batch: int = 64,
                 flush_after_ms: Optional[float] = None,
                 timeout_s: float = 30.0,
                 page_limit_max: int = 10_000,
                 max_pending: Optional[int] = None,
                 route_budgets: Optional[Dict[str, float]] = None,
                 result_cache_entries: int = 4096,
                 result_cache_bytes: int = 32 << 20):
        self.engine = engine
        self.scheduler = scheduler or BatchScheduler(
            engine, max_batch=max_batch, flush_after_ms=flush_after_ms,
            max_pending=max_pending, default_budget_s=timeout_s)
        self._owns_scheduler = scheduler is None
        self.timeout_s = timeout_s
        self.page_limit_max = page_limit_max
        #: route name -> deadline budget in seconds; unlisted ticket
        #: routes default to ``timeout_s`` (the client's own collect
        #: timeout — once that fires nobody reads the answer anyway)
        self.route_budgets: Dict[str, float] = dict(route_budgets or {})
        #: whole-response cache for CACHED_ROUTES; None = disabled
        #: (pass ``result_cache_entries=0``)
        self.result_cache: Optional[ResultCache] = None
        if result_cache_entries > 0 and result_cache_bytes > 0:
            self.result_cache = ResultCache(result_cache_entries,
                                            result_cache_bytes)
        self._closed = False
        self._meta_lock = threading.Lock()
        #: ("versions", ont) -> [versions]; ("models", ont, ver) -> [models]
        self._meta_cache: Dict[Tuple, List[str]] = {}
        self.counters: Dict[str, Any] = {
            "requests": 0, "errors": 0, "invalidations": 0,
            "by_route": Counter(), "by_code": Counter()}
        #: route name -> wall-time histogram over every _run (ok + error)
        self.latency: Dict[str, LatencyHistogram] = {}
        engine.add_invalidate_listener(self._on_invalidate)
        self._routes = (
            ("get-vector", ("get-vector", "{ontology}", "{model}"),
             GetVectorRequest, self._handle_get_vector),
            ("sim", ("sim", "{ontology}", "{model}"),
             SimilarityRequest, self._handle_similarity),
            ("closest-concepts", ("closest-concepts", "{ontology}", "{model}"),
             ClosestConceptsRequest, self._handle_closest),
            ("download", ("download", "{ontology}", "{model}"),
             DownloadRequest, self._handle_download),
            ("autocomplete", ("autocomplete", "{ontology}", "{model}"),
             AutocompleteRequest, self._handle_autocomplete),
            ("health", ("health",), HealthRequest, self._handle_health),
            ("stats", ("stats",), StatsRequest, self._handle_stats),
            ("versions", ("versions", "{ontology}"),
             VersionsRequest, self._handle_versions),
            ("lineage", ("lineage", "{ontology}"),
             LineageRequest, self._handle_lineage),
        )

    # --------------------------- lifecycle ----------------------------- #
    def close(self, timeout: float = 60.0) -> None:
        """Stop accepting requests; drain the owned scheduler so every
        in-flight ticket resolves. Post-close calls fail SHUTTING_DOWN.
        Unregisters the invalidate listener so the engine doesn't keep
        (and keep notifying) a dead gateway."""
        self._closed = True
        self.engine.remove_invalidate_listener(self._on_invalidate)
        if self._owns_scheduler:
            self.scheduler.stop(drain=True, timeout=timeout)

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise ApiError("SHUTTING_DOWN", "gateway is shutting down")

    # ------------------------ freshness hook --------------------------- #
    def _on_invalidate(self, ontology: str, version: Optional[str]) -> None:
        """Invalidate listener: a publish landed — evict this ontology's
        cached versions/models so ops endpoints see it immediately, and
        purge its result-cache entries. (Version keying alone already
        prevents stale hits — a new release resolves to a new version
        and thus a new key — the eager purge just frees the capacity.)"""
        with self._meta_lock:
            self.counters["invalidations"] += 1
            for key in [k for k in self._meta_cache if k[1] == ontology]:
                del self._meta_cache[key]
        if self.result_cache is not None:
            self.result_cache.invalidate_ontology(ontology)

    def _versions(self, ontology: str,
                  want: Optional[str] = None) -> List[str]:
        """Cached version list; re-reads the store when empty-cached or
        when ``want`` isn't in the cached list (so a pinned read of a
        just-published, not-yet-invalidated version still resolves)."""
        key = ("versions", ontology)
        with self._meta_lock:
            vs = self._meta_cache.get(key)
        if vs is None or (want is not None and want not in vs):
            vs = self.engine.registry.store.versions(ontology)
            # never cache an empty list: it would grow the cache without
            # bound under unique bogus names, and would 404 an ontology
            # forever if it is later published without an invalidate
            if vs:
                with self._meta_lock:
                    self._meta_cache[key] = vs
        return vs

    def _models(self, ontology: str, version: str,
                want: Optional[str] = None) -> List[str]:
        key = ("models", ontology, version)
        with self._meta_lock:
            ms = self._meta_cache.get(key)
        if ms is None or (want is not None and want not in ms):
            ms = self.engine.registry.store.models(ontology, version)
            if ms:                           # same no-empty-entries rule
                with self._meta_lock:
                    self._meta_cache[key] = ms
        return ms

    def _resolve_coords(self, ontology: str, model: Optional[str],
                        version: Optional[str]) -> str:
        """Validate (ontology, model, version) existence at the boundary;
        returns the resolved version. ``model=None`` skips model checks
        (version-level endpoints like lineage)."""
        _req_str("ontology", ontology)
        versions = self._versions(ontology, want=version)
        if not versions:
            raise ApiError("UNKNOWN_ONTOLOGY",
                           f"unknown ontology {ontology!r}",
                           details={"ontology": ontology})
        if version is None:
            version = self.engine.latest_version(ontology)
        elif version not in versions:
            raise ApiError("UNKNOWN_VERSION",
                           f"unknown version {version!r} for {ontology!r}",
                           details={"ontology": ontology, "version": version,
                                    "known_versions": versions})
        if model is not None:
            _req_str("model", model)
            models = self._models(ontology, version, want=model)
            if model not in models:
                raise ApiError(
                    "UNKNOWN_MODEL",
                    f"unknown model {model!r} for {ontology}/{version}",
                    details={"ontology": ontology, "version": version,
                             "model": model, "known_models": models})
        return version

    # ---------------------- scheduler round trip ----------------------- #
    def _route_budget(self, route_key: str) -> float:
        """Deadline budget for one ticket route (seconds): configured
        ``route_budgets`` entry, else the gateway-wide ``timeout_s``."""
        return float(self.route_budgets.get(route_key, self.timeout_s))

    def _collect_ticket(self, ticket: Ticket,
                        timeout: Optional[float] = None):
        """Block on an already-flushing ticket; translate failures."""
        if timeout is None:
            timeout = self.timeout_s
        try:
            return ticket.result(timeout=timeout)
        except SchedulerError as e:
            raise _error_from_ticket(e) from None
        except TimeoutError:
            raise ApiError(
                "TIMEOUT",
                f"request unresolved after {timeout}s",
                details={"ticket": ticket.id}) from None

    def _await_ticket(self, ticket: Ticket,
                      timeout: Optional[float] = None):
        """Block until the ticket resolves. Without a flush loop the
        gateway drives a synchronous flush itself (queues are popped
        under the scheduler lock, so coexisting callers/loops each
        resolve a ticket exactly once)."""
        if not self.scheduler.running():
            self.scheduler.flush()
        return self._collect_ticket(ticket, timeout=timeout)

    def _submit_similarity(self, req: SimilarityRequest) -> Ticket:
        self._check_open()
        _req_str("a", req.a)
        _req_str("b", req.b)
        version = self._resolve_coords(req.ontology, req.model,
                                       _opt_version(req.version))
        return self.scheduler.submit(SimRequest(
            req.ontology, req.model, req.a, req.b,
            fuzzy=bool(req.fuzzy), version=version,
            budget_s=self._route_budget("sim")))

    def _similarity_response(self, req: SimilarityRequest, ticket: Ticket,
                             score: float) -> SimilarityResponse:
        return SimilarityResponse(
            ontology=req.ontology, model=req.model, version=ticket.version,
            a=req.a, b=req.b, score=float(score))

    def _submit_closest(self, req: ClosestConceptsRequest) -> Ticket:
        self._check_open()
        _req_str("query", req.query)
        _req_int("k", req.k, minimum=1)
        version = self._resolve_coords(req.ontology, req.model,
                                       _opt_version(req.version))
        return self.scheduler.submit(TopKRequest(
            req.ontology, req.model, req.query, req.k,
            version=version, fuzzy=bool(req.fuzzy),
            budget_s=self._route_budget("closest-concepts")))

    def _closest_response(self, req: ClosestConceptsRequest, ticket: Ticket,
                          result) -> ClosestConceptsResponse:
        hits = [ConceptHit(c.identifier, c.label, float(c.score), c.url)
                for c in result]
        return ClosestConceptsResponse(
            ontology=req.ontology, model=req.model, version=ticket.version,
            query=req.query, k=req.k, results=hits)

    # ---------------------------- handlers ----------------------------- #
    def _handle_similarity(self, req: SimilarityRequest) -> SimilarityResponse:
        ticket = self._submit_similarity(req)
        score = self._await_ticket(ticket,
                                   timeout=self._route_budget("sim"))
        return self._similarity_response(req, ticket, score)

    def _handle_closest(self,
                        req: ClosestConceptsRequest) -> ClosestConceptsResponse:
        ticket = self._submit_closest(req)
        result = self._await_ticket(
            ticket, timeout=self._route_budget("closest-concepts"))
        return self._closest_response(req, ticket, result)

    def _handle_get_vector(self, req: GetVectorRequest) -> VectorResponse:
        self._check_open()
        _req_str("query", req.query)
        version = self._resolve_coords(req.ontology, req.model,
                                       _opt_version(req.version))
        index = self.engine._index(req.ontology, req.model, version)
        row = index.resolve(req.query, fuzzy=bool(req.fuzzy))
        if row is None:
            raise ApiError("UNKNOWN_CLASS",
                           f"unknown class {req.query!r}",
                           details={"missing": [req.query]})
        return VectorResponse(
            ontology=req.ontology, model=req.model, version=version,
            identifier=index.entity_ids[row], label=index.labels[row],
            vector=[float(x) for x in index.embeddings[row]])

    def _handle_download(self, req: DownloadRequest) -> DownloadPage:
        self._check_open()
        offset = _req_int("offset", req.offset, minimum=0)
        requested = _req_int("limit", req.limit, minimum=1)
        # clamp to the server's page cap, but ECHO both limits: a client
        # paging with limit=20_000 must see the shrink, not infer it
        limit = min(requested, self.page_limit_max)
        version = self._resolve_coords(req.ontology, req.model,
                                       _opt_version(req.version))
        index = self.engine._index(req.ontology, req.model, version)
        total = len(index.entity_ids)
        ids = index.entity_ids[offset:offset + limit]
        vecs = index.embeddings[offset:offset + limit]
        # full registry precision: the same class must serialize to the
        # same bytes here and on get-vector (wire-fidelity contract)
        rows = [[ident, [float(x) for x in vec]]
                for ident, vec in zip(ids, vecs)]
        end = offset + len(rows)
        return DownloadPage(
            ontology=req.ontology, model=req.model, version=version,
            offset=offset, limit=limit, total=total, rows=rows,
            next_offset=end if end < total else None,
            requested_limit=requested,
            etag=download_etag(req.ontology, req.model, version,
                               offset, limit, requested))

    def _handle_autocomplete(self,
                             req: AutocompleteRequest) -> AutocompleteResponse:
        self._check_open()
        _req_str("prefix", req.prefix)
        limit = _req_int("limit", req.limit, minimum=1)
        version = self._resolve_coords(req.ontology, req.model,
                                       _opt_version(req.version))
        index = self.engine._index(req.ontology, req.model, version)
        return AutocompleteResponse(
            ontology=req.ontology, model=req.model, version=version,
            prefix=req.prefix, completions=index.autocomplete(req.prefix,
                                                              limit))

    def _handle_health(self, req: HealthRequest) -> HealthResponse:
        accepting = not self._closed and self.scheduler.accepting()
        return HealthResponse(
            status="ok" if accepting else "shutting_down",
            api_version=API_VERSION,
            ontologies=self.engine.registry.store.ontologies(),
            scheduler_running=self.scheduler.running())

    def _handle_stats(self, req: StatsRequest) -> StatsResponse:
        with self.scheduler._lock:
            sched = dict(self.scheduler.stats)
        sched["pending"] = self.scheduler.pending()
        #: submit->resolve latency over every ticket (scheduler-side)
        sched["latency_ms"] = self.scheduler.latency.snapshot()
        with self._meta_lock:
            gw = {"requests": self.counters["requests"],
                  "errors": self.counters["errors"],
                  "invalidations": self.counters["invalidations"],
                  "by_route": dict(self.counters["by_route"]),
                  "by_code": dict(self.counters["by_code"])}
            hists = dict(self.latency)
        if self.result_cache is not None:
            gw["result_cache"] = self.result_cache.stats()
        return StatsResponse(
            scheduler=sched, cache=self.engine.cache_stats(), gateway=gw,
            latency={route: h.snapshot()
                     for route, h in sorted(hists.items())})

    def _handle_versions(self, req: VersionsRequest) -> VersionsResponse:
        _req_str("ontology", req.ontology)
        versions = self._versions(req.ontology)
        if not versions:
            raise ApiError("UNKNOWN_ONTOLOGY",
                           f"unknown ontology {req.ontology!r}",
                           details={"ontology": req.ontology})
        latest = self.engine.latest_version(req.ontology)
        return VersionsResponse(
            ontology=req.ontology, versions=list(versions), latest=latest,
            models=self._models(req.ontology, latest))

    def _handle_lineage(self, req: LineageRequest) -> LineageResponse:
        version = self._resolve_coords(req.ontology, None,
                                       _opt_version(req.version))
        store = self.engine.registry.store
        lineage = {m: store.load_metadata(req.ontology, version, m
                                          ).get("lineage")
                   for m in self._models(req.ontology, version)}
        return LineageResponse(ontology=req.ontology, version=version,
                               lineage=lineage)

    # ------------------------- typed front door ------------------------ #
    def get_vector(self, ontology: str, model: str, query: str, *,
                   fuzzy: bool = False,
                   version: Optional[str] = None) -> VectorResponse:
        return self._run("get-vector", GetVectorRequest(
            ontology, model, query, fuzzy, version), self._handle_get_vector)

    def similarity(self, ontology: str, model: str, a: str, b: str, *,
                   fuzzy: bool = False,
                   version: Optional[str] = None) -> SimilarityResponse:
        return self._run("sim", SimilarityRequest(
            ontology, model, a, b, fuzzy, version), self._handle_similarity)

    def closest_concepts(self, ontology: str, model: str, query: str, *,
                         k: int = 10, fuzzy: bool = False,
                         version: Optional[str] = None
                         ) -> ClosestConceptsResponse:
        return self._run("closest-concepts", ClosestConceptsRequest(
            ontology, model, query, k, fuzzy, version), self._handle_closest)

    def closest_concepts_batch(self, requests, *,
                               return_exceptions: bool = False
                               ) -> List:
        """Submit a page of closest-concepts requests as one wave, then
        collect — the blocking-thread equivalent of the async gather
        fan-out, and how a client should issue a burst (one submit per
        call would serialize on each ticket and defeat coalescing).

        With ``return_exceptions`` failed items come back as their
        ApiError in place; otherwise the first failure raises (tickets
        already in flight still resolve — results are discarded).
        """
        requests = list(requests)            # may be a one-shot iterable
        staged: List = []                    # Ticket | ApiError, in order
        try:
            for req in requests:
                try:
                    staged.append(self._run("closest-concepts", req,
                                            self._submit_closest))
                except ApiError as e:
                    if not return_exceptions:
                        raise
                    staged.append(e)
        finally:
            # flush even when a later submit raised: in sync mode nothing
            # else would drain the already-staged tickets
            if not self.scheduler.running():
                self.scheduler.flush()
        out: List = []
        for req, t in zip(requests, staged):
            if isinstance(t, ApiError):
                out.append(t)
                continue
            if isinstance(t, ClosestConceptsResponse):
                out.append(t)            # result-cache hit at staging time
                continue
            try:
                resp = self._closest_response(req, t,
                                              self._collect_ticket(t))
                self._cache_store(self._cache_key("closest-concepts", req),
                                  resp)
                out.append(resp)
            except ApiError as e:
                self._count_error(e)
                if not return_exceptions:
                    raise
                out.append(e)
        return out

    def download(self, ontology: str, model: str, *,
                 version: Optional[str] = None, offset: int = 0,
                 limit: int = 1000) -> DownloadPage:
        return self._run("download", DownloadRequest(
            ontology, model, version, offset, limit), self._handle_download)

    def autocomplete(self, ontology: str, model: str, prefix: str, *,
                     limit: int = 10, version: Optional[str] = None
                     ) -> AutocompleteResponse:
        return self._run("autocomplete", AutocompleteRequest(
            ontology, model, prefix, limit, version),
            self._handle_autocomplete)

    def health(self) -> HealthResponse:
        return self._run("health", HealthRequest(), self._handle_health)

    def stats(self) -> StatsResponse:
        return self._run("stats", StatsRequest(), self._handle_stats)

    def versions(self, ontology: str) -> VersionsResponse:
        return self._run("versions", VersionsRequest(ontology),
                         self._handle_versions)

    def lineage(self, ontology: str,
                version: Optional[str] = None) -> LineageResponse:
        return self._run("lineage", LineageRequest(ontology, version),
                         self._handle_lineage)

    # ---------------------------- dispatch ----------------------------- #
    def _count_error(self, e: ApiError) -> None:
        if getattr(e, "_counted", False):
            return
        e._counted = True
        with self._meta_lock:
            self.counters["errors"] += 1
            self.counters["by_code"][e.code] += 1

    def _route_latency(self, route_key: str) -> LatencyHistogram:
        h = self.latency.get(route_key)
        if h is None:
            with self._meta_lock:
                h = self.latency.setdefault(route_key, LatencyHistogram())
        return h

    # ------------------------- result cache ---------------------------- #
    def _cache_key(self, route_key: str, req) -> Optional[Tuple]:
        """Cache key for a request on a cacheable route, or None when the
        request can't (or shouldn't) be cached. The key pins the
        *resolved* version — a publish moves latest to a new version and
        therefore a new key — and carries the payload as canonical JSON:
        a raw field tuple would alias ``True`` with ``1`` (equal ints in
        Python) and serve a cached hit for a payload the validator
        rejects."""
        if self.result_cache is None or route_key not in CACHED_ROUTES \
                or self._closed:
            return None
        try:
            version = self._resolve_coords(req.ontology, req.model,
                                           _opt_version(req.version))
        except ApiError:
            return None        # let the handler classify and raise
        payload = dataclasses.asdict(req)
        # the resolved version already keys the entry: dropping the raw
        # field folds ``version=None`` and an explicit pin of the same
        # version onto one entry (their responses are identical bytes)
        payload.pop("version", None)
        canon = canonical_payload(payload)
        if canon is None:
            return None
        return (route_key, req.ontology, req.model, version, canon)

    def _cache_store(self, key: Optional[Tuple], resp) -> None:
        if key is None or self.result_cache is None:
            return
        try:
            nbytes = len(json.dumps(to_wire(resp)))
        except (TypeError, ValueError):
            return             # non-JSON response object: don't cache
        self.result_cache.put(key, resp, nbytes)

    def _run(self, route_key: str, req, handler):
        with self._meta_lock:
            self.counters["requests"] += 1
            self.counters["by_route"][route_key] += 1
        t0 = time.perf_counter()
        try:
            key = self._cache_key(route_key, req)
            if key is not None:
                hit = self.result_cache.get(key)
                if hit is not None:
                    return hit
            resp = handler(req)
            # ticket-submitting handlers (the async front end, batch
            # staging) return the Ticket itself — the caller stores the
            # built response once it settles
            if key is not None and not isinstance(resp, Ticket):
                self._cache_store(key, resp)
            return resp
        except ApiError as e:
            self._count_error(e)
            raise
        except Exception as e:
            err = ApiError("INTERNAL", f"internal error: {e}")
            self._count_error(err)
            raise err from e
        finally:
            # errors get timed too: a latency histogram that only sees
            # successes hides exactly the slow-path (timeout) traffic
            self._route_latency(route_key).observe(time.perf_counter() - t0)

    def _match(self, route: str):
        if not isinstance(route, str):
            raise ApiError("BAD_REQUEST",
                           f"route must be a string, got {route!r}")
        parts = tuple(p for p in route.strip("/").split("/") if p)
        for name, pattern, cls, handler in self._routes:
            if len(parts) != len(pattern):
                continue
            params = {}
            for seg, pat in zip(parts, pattern):
                if pat.startswith("{"):
                    params[pat[1:-1]] = seg
                elif seg != pat:
                    break
            else:
                return name, cls, handler, params
        # a distinct code from BAD_REQUEST: transports can map status
        # straight from the code, and by_code stats keep bad URLs apart
        # from malformed payloads
        raise ApiError("NOT_FOUND", f"unknown route {route!r}",
                       details={"route": route})

    def _build_request(self, route: str,
                       payload: Optional[Dict[str, Any]], match=None):
        """Shared route+payload -> (name, handler, request) parsing for
        the sync and async ``handle`` entry points; raises ApiError on
        any malformed input. ``match`` lets a transport that already ran
        :meth:`_match` (for query coercion) pass its result through
        instead of paying the route table twice per request."""
        if payload is None:
            payload = {}
        if not isinstance(payload, dict):
            raise ApiError(
                "BAD_REQUEST",
                f"payload must be an object, got {type(payload).__name__}")
        name, cls, handler, params = match or self._match(route)
        clash = sorted(k for k in params
                       if k in payload and payload[k] != params[k])
        if clash:
            # silently letting the path win would answer against the
            # wrong coordinates — surface the client mistake instead
            raise ApiError(
                "BAD_REQUEST",
                f"payload field(s) conflict with route: {', '.join(clash)}",
                details={"conflicting_fields": clash, "route": route})
        return name, handler, payload_to(cls, {**payload, **params})

    def handle(self, route: str,
               payload: Optional[Dict[str, Any]] = None, *,
               match=None) -> Dict[str, Any]:
        """THE entry point: dispatch a route string + payload dict to its
        handler; returns a wire dict (response, or a structured error
        payload — this method never raises on request faults)."""
        try:
            name, handler, req = self._build_request(route, payload, match)
            return to_wire(self._run(name, req, handler))
        except ApiError as e:
            self._count_error(e)
            return e.to_wire()
