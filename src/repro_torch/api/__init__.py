"""Bio-KGvec2go gateway API v1 on the port: the same routes and wire
bodies as ``repro.api``, served over the port's scheduler and kernels.

:class:`Gateway` dispatches route strings to typed handlers, every
similarity-shaped read rides the ``BatchScheduler``, and the HTTP front
end (:func:`serve_http`) is a thin shim over ``Gateway.handle``.  The
batch-job routes, the async front end and the pre-forked worker pool are
not ported yet.
"""
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

__all__ = [
    "API_VERSION", "Gateway", "ResultCache", "CACHED_ROUTES",
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
]
