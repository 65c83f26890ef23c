"""Wire schema for the Bio-KGvec2go gateway API v1.

The port's copy of ``repro.api.schema``: ``CODE_STATUS``, ``_LEGACY`` and
``_TYPES`` stay equal to the reference's (the job types included, so the
wire codec of both packages is one), which keeps wire bodies identical.

Typed request/response dataclasses for the five paper endpoints
(``get-vector``, ``sim``, ``closest-concepts``, ``download``,
``autocomplete``) plus the ops endpoints (``health``, ``stats``,
``versions``, ``lineage``), a JSON codec (:func:`to_wire` /
:func:`from_wire`), and the structured error model (:class:`ApiError`)
that replaces the bare ``KeyError`` / ``ValueError`` surface of the
pre-gateway ``ServingEngine`` methods.

Everything here is transport-agnostic plain data: an HTTP shim maps
``ApiError.status`` to its response code and ``to_wire`` output to the
body; an in-process caller just uses the dataclasses directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# --------------------------------------------------------------------- #
# error model
# --------------------------------------------------------------------- #

#: stable machine-readable error codes -> default HTTP-ish status.
#: These strings are the public contract; the scheduler attaches them to
#: rejected tickets (see core/serving.py) and clients switch on them.
CODE_STATUS: Dict[str, int] = {
    "UNKNOWN_ONTOLOGY": 404,
    "UNKNOWN_MODEL": 404,
    "UNKNOWN_VERSION": 404,
    "UNKNOWN_CLASS": 404,
    "NOT_FOUND": 404,                # unknown *route* — not a bad payload
    "BAD_REQUEST": 400,
    "TIMEOUT": 408,
    "OVERLOADED": 429,               # admission control: intake bound hit
    "SHUTTING_DOWN": 503,
    "INTERNAL": 500,
    "JOB_NOT_FOUND": 404,            # unknown (or already-evicted) job id
    "JOB_CANCELLED": 409,            # results requested for a cancelled job
}

#: legacy exception type per code — what the deprecated ServingEngine
#: delegates re-raise so pre-gateway callers keep their except clauses
_LEGACY = {
    "UNKNOWN_ONTOLOGY": KeyError, "UNKNOWN_MODEL": KeyError,
    "UNKNOWN_VERSION": KeyError, "UNKNOWN_CLASS": KeyError,
    "NOT_FOUND": KeyError,
    "BAD_REQUEST": ValueError, "TIMEOUT": TimeoutError,
    "OVERLOADED": RuntimeError,
    "SHUTTING_DOWN": RuntimeError, "INTERNAL": RuntimeError,
    "JOB_NOT_FOUND": KeyError, "JOB_CANCELLED": RuntimeError,
}


class ApiError(Exception):
    """A gateway failure with a stable code, a human message, an
    HTTP-ish status, and machine-readable ``details`` (e.g. the *full*
    list of unresolvable class names under ``details["missing"]``)."""

    def __init__(self, code: str, message: str,
                 details: Optional[Dict[str, Any]] = None,
                 status: Optional[int] = None):
        if code not in CODE_STATUS:
            raise ValueError(f"unknown ApiError code {code!r}")
        super().__init__(message)
        self.code = code
        self.message = message
        self.details: Dict[str, Any] = dict(details or {})
        self.status = CODE_STATUS[code] if status is None else int(status)

    def to_wire(self) -> Dict[str, Any]:
        return {"type": "error", "code": self.code, "message": self.message,
                "status": self.status, "details": self.details}

    def legacy(self) -> Exception:
        """The pre-gateway exception equivalent (KeyError for UNKNOWN_*,
        ValueError for BAD_REQUEST, ...) for deprecated delegates."""
        return _LEGACY[self.code](self.message)

    def __eq__(self, other):
        if not isinstance(other, ApiError):
            return NotImplemented
        return (self.code, self.message, self.status, self.details) == \
               (other.code, other.message, other.status, other.details)

    def __hash__(self):
        return hash((self.code, self.message, self.status))

    def __repr__(self):
        return (f"ApiError({self.code}, {self.message!r}, "
                f"status={self.status}, details={self.details})")


# --------------------------------------------------------------------- #
# requests — one per route
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class GetVectorRequest:
    ontology: str
    model: str
    query: str
    fuzzy: bool = False
    version: Optional[str] = None    # None = latest at handle time


@dataclasses.dataclass
class SimilarityRequest:
    ontology: str
    model: str
    a: str
    b: str
    fuzzy: bool = False
    version: Optional[str] = None


@dataclasses.dataclass
class ClosestConceptsRequest:
    ontology: str
    model: str
    query: str
    k: int = 10
    fuzzy: bool = False
    version: Optional[str] = None


@dataclasses.dataclass
class DownloadRequest:
    """Cursor-paginated download: rows ``[offset, offset+limit)`` of the
    entity table. Pin ``version`` (echo back ``DownloadPage.version``) to
    keep the cursor stable across a mid-pagination release."""
    ontology: str
    model: str
    version: Optional[str] = None
    offset: int = 0
    limit: int = 1000


@dataclasses.dataclass
class AutocompleteRequest:
    ontology: str
    model: str
    prefix: str
    limit: int = 10
    version: Optional[str] = None


@dataclasses.dataclass
class HealthRequest:
    pass


@dataclasses.dataclass
class StatsRequest:
    pass


@dataclasses.dataclass
class VersionsRequest:
    ontology: str


@dataclasses.dataclass
class LineageRequest:
    ontology: str
    version: Optional[str] = None    # None = latest


@dataclasses.dataclass
class JobSubmitRequest:
    """Submit one async analytics job (``POST /v1/jobs/submit``).

    ``kind`` selects the workload:

    * ``"knn-join"`` — all-pairs top-``k`` neighbors for ``classes``
      (required, non-empty) under (ontology, model[, version]);
    * ``"drift"`` — per-entity neighborhood churn between ``version``
      (older; default: the release before ``version_b``) and
      ``version_b`` (newer; default: latest);
    * ``"compare"`` — per-model eval metrics for ``models`` (default:
      every model published under the resolved version), optionally
      subsampling the eval split to ``sample`` triples.
    """
    kind: str
    ontology: str
    model: Optional[str] = None      # knn-join/drift: required
    version: Optional[str] = None
    version_b: Optional[str] = None  # drift only: newer release
    classes: Optional[List[str]] = None
    k: int = 10
    models: Optional[List[str]] = None
    sample: Optional[int] = None


@dataclasses.dataclass
class JobStatusRequest:
    job_id: str


@dataclasses.dataclass
class JobResultRequest:
    """Cursor-paginated job results — same contract as ``download``:
    rows ``[offset, offset+limit)`` of the finished job's result table."""
    job_id: str
    offset: int = 0
    limit: int = 1000


@dataclasses.dataclass
class JobCancelRequest:
    job_id: str


@dataclasses.dataclass
class JobListRequest:
    pass


# --------------------------------------------------------------------- #
# responses
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ConceptHit:
    """One row of a closest-concepts ranking (paper Fig. 1 table)."""
    identifier: str
    label: str
    score: float
    url: str


@dataclasses.dataclass
class VectorResponse:
    ontology: str
    model: str
    version: str
    identifier: str                  # the resolved entity id
    label: str
    vector: List[float]


@dataclasses.dataclass
class SimilarityResponse:
    ontology: str
    model: str
    version: str
    a: str
    b: str
    score: float


@dataclasses.dataclass
class ClosestConceptsResponse:
    ontology: str
    model: str
    version: str
    query: str
    k: int
    results: List[ConceptHit]


@dataclasses.dataclass
class DownloadPage:
    """One page of the download payload. ``rows`` is a list of
    ``[identifier, vector]`` pairs in stable entity-table order, at the
    registry's full float32 precision (bit-identical to ``get-vector``
    for the same class — no endpoint-private quantization);
    ``next_offset`` is None on the final page.

    ``limit`` is the *effective* page size (the server clamps to its
    ``page_limit_max``); ``requested_limit`` echoes what the client
    asked for, so a shrunk page is visible, not silent. ``etag`` is a
    strong validator over ``(ontology, model, version, offset, limit,
    requested_limit)`` — a pinned page is immutable, so those
    coordinates determine the page's exact bytes and an
    ``If-None-Match`` re-fetch can be answered 304 with no index
    work."""
    ontology: str
    model: str
    version: str
    offset: int
    limit: int
    total: int
    rows: List[List[Any]]
    next_offset: Optional[int]
    requested_limit: Optional[int] = None
    etag: Optional[str] = None


@dataclasses.dataclass
class AutocompleteResponse:
    ontology: str
    model: str
    version: str
    prefix: str
    completions: List[str]


@dataclasses.dataclass
class HealthResponse:
    status: str                      # "ok" | "shutting_down"
    api_version: str
    ontologies: List[str]
    scheduler_running: bool


@dataclasses.dataclass
class StatsResponse:
    """Ops counters plus per-route latency histograms: ``latency`` maps
    route name -> a ``LatencyHistogram.snapshot()`` (fixed log-spaced
    buckets, p50/p99 derivable — see ``repro_torch.core.metrics``); the
    scheduler's submit->resolve histogram rides in
    ``scheduler["latency_ms"]``."""
    scheduler: Dict[str, Any]
    cache: Dict[str, Any]
    gateway: Dict[str, Any]
    latency: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VersionsResponse:
    ontology: str
    versions: List[str]
    latest: str
    models: List[str]                # models published under ``latest``


@dataclasses.dataclass
class JobStatusResponse:
    """One job's lifecycle snapshot (also the submit acknowledgement).

    ``state`` is one of PENDING / RUNNING / DONE / FAILED / CANCELLED;
    ``progress`` is a monotone fraction in [0, 1] (1.0 only at DONE);
    ``total`` is the expected result-row count once known; ``wall_s``
    is populated on terminal states; ``owner_pid`` names the worker
    process the job is pinned to (poll any worker — non-owners answer
    from the shared job state)."""
    job_id: str
    kind: str
    state: str
    progress: float
    ontology: str
    model: Optional[str] = None
    version: Optional[str] = None
    version_b: Optional[str] = None
    k: Optional[int] = None
    submitted_at: float = 0.0
    wall_s: Optional[float] = None
    total: Optional[int] = None
    error: Optional[str] = None
    summary: Optional[Dict[str, Any]] = None
    owner_pid: int = 0


@dataclasses.dataclass
class JobListResponse:
    jobs: List[JobStatusResponse]


@dataclasses.dataclass
class JobResultPage:
    """One page of a DONE job's result table. Mirrors the
    :class:`DownloadPage` cursor contract (effective ``limit`` vs
    ``requested_limit``, ``next_offset`` None on the final page) so the
    HTTP layer's ETag / If-None-Match / chunked-streaming machinery
    applies unchanged: a finished job's rows are immutable, so
    ``(job_id, offset, limit, requested_limit)`` determine the page's
    exact bytes. Row shape per kind — ``knn-join``:
    ``[identifier, [[neighbor_id, score], ...]]``; ``drift``:
    ``[identifier, jaccard]``; ``compare``: ``[model, metrics_dict]``."""
    job_id: str
    kind: str
    offset: int
    limit: int
    total: int
    rows: List[List[Any]]
    next_offset: Optional[int]
    requested_limit: Optional[int] = None
    etag: Optional[str] = None


@dataclasses.dataclass
class LineageResponse:
    """Per-model lineage metadata of one (ontology, version): how each
    snapshot was produced ({"parent_version", "mode", "delta"}),
    or None for snapshots published without lineage."""
    ontology: str
    version: str
    lineage: Dict[str, Optional[Dict[str, Any]]]


# --------------------------------------------------------------------- #
# codec
# --------------------------------------------------------------------- #
_TYPES = {
    GetVectorRequest: "get_vector_request",
    SimilarityRequest: "similarity_request",
    ClosestConceptsRequest: "closest_concepts_request",
    DownloadRequest: "download_request",
    AutocompleteRequest: "autocomplete_request",
    HealthRequest: "health_request",
    StatsRequest: "stats_request",
    VersionsRequest: "versions_request",
    LineageRequest: "lineage_request",
    JobSubmitRequest: "job_submit_request",
    JobStatusRequest: "job_status_request",
    JobResultRequest: "job_result_request",
    JobCancelRequest: "job_cancel_request",
    JobListRequest: "job_list_request",
    ConceptHit: "concept_hit",
    VectorResponse: "vector_response",
    SimilarityResponse: "similarity_response",
    ClosestConceptsResponse: "closest_concepts_response",
    DownloadPage: "download_page",
    AutocompleteResponse: "autocomplete_response",
    HealthResponse: "health_response",
    StatsResponse: "stats_response",
    VersionsResponse: "versions_response",
    LineageResponse: "lineage_response",
    JobStatusResponse: "job_status_response",
    JobListResponse: "job_list_response",
    JobResultPage: "job_result_page",
}
_BY_NAME = {name: cls for cls, name in _TYPES.items()}

#: list-of-dataclass fields that from_wire must reconstruct
_NESTED = {ClosestConceptsResponse: {"results": ConceptHit},
           JobListResponse: {"jobs": JobStatusResponse}}


def payload_to(cls, payload: Dict[str, Any]):
    """Build a schema dataclass from an untyped payload dict, rejecting
    unknown and missing fields with BAD_REQUEST (the codec validates
    *shape*; semantic validation — k > 0, non-empty query — happens at
    the gateway boundary)."""
    if not isinstance(payload, dict):
        raise ApiError("BAD_REQUEST",
                       f"payload must be an object, got {type(payload).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(payload) - set(fields))
    if unknown:
        raise ApiError("BAD_REQUEST",
                       f"unknown field(s) for {_TYPES[cls]}: {', '.join(unknown)}",
                       details={"unknown_fields": unknown})
    missing = sorted(
        name for name, f in fields.items()
        if name not in payload
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING)
    if missing:
        raise ApiError("BAD_REQUEST",
                       f"missing field(s) for {_TYPES[cls]}: {', '.join(missing)}",
                       details={"missing_fields": missing})
    kwargs = dict(payload)
    for fname, sub in _NESTED.get(cls, {}).items():
        if fname in kwargs and isinstance(kwargs[fname], list):
            kwargs[fname] = [payload_to(sub, x) if isinstance(x, dict) else x
                             for x in kwargs[fname]]
    return cls(**kwargs)


def to_wire(obj) -> Dict[str, Any]:
    """Schema object (or ApiError) -> JSON-serializable dict with a
    ``"type"`` tag."""
    if isinstance(obj, ApiError):
        return obj.to_wire()
    cls = type(obj)
    if cls not in _TYPES:
        raise ValueError(f"not a wire type: {cls.__name__}")
    return {"type": _TYPES[cls], **dataclasses.asdict(obj)}


def from_wire(data: Dict[str, Any]):
    """Inverse of :func:`to_wire`. Error payloads come back as ApiError
    *instances* (returned, not raised — the caller decides). Malformed
    input raises ApiError(BAD_REQUEST)."""
    if not isinstance(data, dict):
        raise ApiError("BAD_REQUEST",
                       f"wire value must be an object, got {type(data).__name__}")
    tag = data.get("type")
    if tag == "error":
        body = {k: v for k, v in data.items() if k != "type"}
        unknown = sorted(set(body) - {"code", "message", "status", "details"})
        if unknown or not isinstance(body.get("code"), str) \
                or not isinstance(body.get("details", {}), dict) \
                or isinstance(body.get("status"), bool) \
                or not isinstance(body.get("status", 0), int):
            raise ApiError("BAD_REQUEST", f"malformed error payload: {data!r}")
        try:
            return ApiError(body["code"], body.get("message", ""),
                            details=body.get("details"),
                            status=body.get("status"))
        except ValueError as e:
            raise ApiError("BAD_REQUEST", str(e))
    cls = _BY_NAME.get(tag)
    if cls is None:
        raise ApiError("BAD_REQUEST", f"unknown wire type {tag!r}",
                       details={"type": tag})
    return payload_to(cls, {k: v for k, v in data.items() if k != "type"})
