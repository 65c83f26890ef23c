"""Bio-KGvec2go gateway API v1 on the port: the same routes and wire
bodies as ``repro.api``, served over the port's scheduler and kernels.

:class:`Gateway` dispatches route strings to typed handlers, every
similarity-shaped read rides the ``BatchScheduler``, and the HTTP front
end (:func:`serve_http`) is a thin shim over ``Gateway.handle``;
``api.workers.WorkerPool`` pre-forks N such HTTP stacks over one store.
The batch-job routes (``/jobs/...``) run in ``api.jobs.JobManager``, and
:class:`AsyncGateway` exposes the same surface as awaitables.
"""
from .aio import AsyncGateway, ticket_future
from .cache import ResultCache
from .gateway import API_VERSION, CACHED_ROUTES, Gateway, download_etag
from .http import GatewayHTTPServer, serve_http
from .schema import (CODE_STATUS, ApiError, AutocompleteRequest,
                     AutocompleteResponse, ClosestConceptsRequest,
                     ClosestConceptsResponse, ConceptHit, DownloadPage,
                     DownloadRequest, GetVectorRequest, HealthRequest,
                     HealthResponse, LineageRequest, LineageResponse,
                     SimilarityRequest, SimilarityResponse, StatsRequest,
                     StatsResponse, VectorResponse, VersionsRequest,
                     VersionsResponse, from_wire, payload_to, to_wire)
from .workers import StoreWatcher, WorkerPool, merge_stats_wires

__all__ = [
    "API_VERSION", "AsyncGateway", "Gateway", "ticket_future",
    "ResultCache", "CACHED_ROUTES",
    "GatewayHTTPServer", "serve_http", "download_etag",
    "CODE_STATUS", "ApiError", "from_wire", "payload_to", "to_wire",
    "GetVectorRequest", "VectorResponse",
    "SimilarityRequest", "SimilarityResponse",
    "ClosestConceptsRequest", "ClosestConceptsResponse", "ConceptHit",
    "DownloadRequest", "DownloadPage",
    "AutocompleteRequest", "AutocompleteResponse",
    "HealthRequest", "HealthResponse", "StatsRequest", "StatsResponse",
    "VersionsRequest", "VersionsResponse",
    "LineageRequest", "LineageResponse",
    "WorkerPool", "StoreWatcher", "merge_stats_wires",
]
