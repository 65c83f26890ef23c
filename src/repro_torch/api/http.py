"""HTTP service layer over the gateway — the paper's actual web API.

Stdlib-only (``http.server.ThreadingHTTPServer``; the container adds no
deps): URL paths map 1:1 onto the existing ``Gateway.handle(route,
payload)`` route table, so the HTTP surface *is* the v1 wire schema —
a body served over a socket is byte-for-byte the dict ``handle``
returns in-process, and ``ApiError.status``/``code`` become the real
HTTP status line plus a structured JSON error body.

Transport semantics added on top of the gateway (and only transport
semantics — nothing here reaches past ``Gateway``'s public surface):

* **GET + query strings** — ``GET /sim/go/transe?a=GO:1&b=GO:2``.
  Query values are strings; they are coerced to the matched request
  dataclass's field types (int/bool) before dispatch, so GET and POST
  hit identical validation. ``POST`` takes the payload as a JSON body;
  query params on a POST URL merge into it (they are part of the
  resource identity — caches key on the full URL), and a body/query
  disagreement is a 400.
* **keep-alive** — HTTP/1.1 with correct framing (Content-Length or
  chunked), so a client connection serves many requests; the
  ``ThreadingHTTPServer`` gives each connection its own thread and the
  shared ``BatchScheduler`` coalesces across all of them.
* **ETag / If-None-Match** — every download page carries a strong ETag
  keyed ``(ontology, model, version, offset, limit)`` (pinned pages are
  immutable). A conditional re-fetch whose ETag matches is answered
  ``304 Not Modified`` *before* the gateway runs: no kernel, no index
  build, no download-route counter increment.
* **streaming download** — ``GET /download/{ont}/{model}?stream=true``
  answers ``Transfer-Encoding: chunked``, walking the gateway's cursor
  pages (pinned to the first page's version) and emitting the paper's
  ``{class: vector}`` JSON object one page-sized chunk at a time — the
  full body of a >100k-class ontology is never materialized.
* **latency histograms** — requests dispatch through ``Gateway._run``,
  so ``/stats`` over HTTP reports the same per-route histograms as the
  in-process gateway, now including this transport's traffic.

Usage::

    server = serve_http(gateway, port=8080)       # daemon thread
    ...                                           # curl away
    server.close()

or ``python -m repro_torch.launch.serve --http 8080`` for a full service.

This is the port of ``repro.api.http`` without the batch-job result
routes and without the worker-pool hooks (an adopted listening socket,
a cross-worker ``/stats`` merge); those come with their own slices.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from ..core.metrics import LatencyHistogram
from .gateway import API_VERSION, Gateway, download_etag
from .schema import ApiError, DownloadRequest

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))

#: download defaults come from the schema, not a re-typed literal — a
#: drifted copy here would silently kill the 304 fast path (the ETag is
#: keyed on the effective limit)
_DOWNLOAD_DEFAULTS = {f.name: f.default
                      for f in dataclasses.fields(DownloadRequest)}


def _parse_bool(raw) -> Any:
    """Query-string boolean; non-boolean text passes through so the
    schema boundary rejects it with a structured BAD_REQUEST."""
    if isinstance(raw, bool):
        return raw
    if isinstance(raw, str):
        if raw.lower() in _TRUE:
            return True
        if raw.lower() in _FALSE:
            return False
    return raw


#: per-request-class field->type-string maps (constant per class; the
#: hot path must not rebuild them per request)
_FIELD_TYPES: Dict[type, Dict[str, str]] = {}


def coerce_query_params(cls, raw: Dict[str, str]) -> Dict[str, Any]:
    """Coerce query-string values (always strings) to the matched
    request dataclass's field types, so GET requests go through exactly
    the same boundary validation as typed/POST payloads. Values that
    don't parse pass through unchanged — the schema layer turns them
    into structured BAD_REQUEST errors instead of a transport 500."""
    types = _FIELD_TYPES.get(cls)
    if types is None:
        types = {f.name: str(f.type) for f in dataclasses.fields(cls)}
        _FIELD_TYPES[cls] = types
    out: Dict[str, Any] = {}
    for name, value in raw.items():
        t = types.get(name, "str")
        if "bool" in t:
            out[name] = _parse_bool(value)
        elif "int" in t:
            try:
                out[name] = int(value)
            except (TypeError, ValueError):
                out[name] = value
        else:
            out[name] = value
    return out


def _params_dict(query: str):
    """Query string -> dict, surfacing conflicting duplicate keys
    (?a=x&a=y) instead of silently keeping the last — the same
    no-silent-winner rule applied to body/query and payload/route
    conflicts. Returns (params, conflicting_keys)."""
    out: Dict[str, str] = {}
    dup = set()
    for k, v in parse_qsl(query, keep_blank_values=True):
        if k in out and out[k] != v:
            dup.add(k)
        out[k] = v
    return out, sorted(dup)


def _etag_matches(if_none_match: str, etag: str) -> bool:
    """RFC 7232 weak comparison over an If-None-Match header list."""
    if if_none_match.strip() == "*":
        return True
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


class GatewayHTTPHandler(BaseHTTPRequestHandler):
    """One request — GET (query-string payload) or POST (JSON body) —
    dispatched to ``server.gateway.handle``."""

    protocol_version = "HTTP/1.1"          # keep-alive by default
    server_version = f"BioKGvec2go/{API_VERSION}"
    #: write-buffer the response so status line + headers + body leave in
    #: one send(); with Nagle off (below) small replies never sit behind
    #: a delayed-ACK stall
    wbufsize = 64 * 1024
    disable_nagle_algorithm = True

    # quiet by default: a 16-client benchmark must not serialize on
    # stderr writes (set server.verbose_log = True to re-enable)
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose_log", False):
            super().log_message(fmt, *args)

    #: (unix_second, formatted) — strftime per response is measurable at
    #: micro-batch request rates; one render per second is plenty
    _date_cache = (0, "")

    def date_time_string(self, timestamp=None):
        if timestamp is not None:
            return super().date_time_string(timestamp)
        now = int(time.time())
        cached = GatewayHTTPHandler._date_cache
        if cached[0] != now:
            cached = (now, super().date_time_string(now))
            GatewayHTTPHandler._date_cache = cached
        return cached[1]

    # ------------------------------ verbs ------------------------------ #
    def do_GET(self) -> None:
        self.server._count("requests")
        split = urlsplit(self.path)
        raw, dup = _params_dict(split.query)
        if dup:
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"conflicting duplicate query parameter(s): "
                f"{', '.join(dup)}",
                details={"conflicting_fields": dup}))
        self._dispatch(split.path, raw, coerce=True)

    #: request bodies past this are refused outright (the largest legal
    #: payload is a download request — a few hundred bytes)
    max_body_bytes = 1 << 20

    def do_POST(self) -> None:
        self.server._count("requests")
        split = urlsplit(self.path)
        te = self.headers.get("Transfer-Encoding")
        if te:
            # a chunked request body would sit unread in the pipe and
            # desync every later request on this keep-alive connection —
            # refuse it loudly and drop the connection
            self.close_connection = True
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"encoded request bodies are not supported "
                f"(Transfer-Encoding: {te}); send Content-Length"))
        length = self.headers.get("Content-Length")
        try:
            n = int(length) if length is not None else 0
        except ValueError:
            n = -1
        if n < 0 or n > self.max_body_bytes:
            # unreadable framing: the body (if any) is still in the pipe,
            # so keep-alive would parse garbage — close after answering.
            # A negative length must never reach read(): read(-1) blocks
            # until the client hangs up.
            self.close_connection = True
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"missing, malformed or oversized Content-Length: "
                f"{length!r}"))
        body = self.rfile.read(n) if n else b""
        if not body:
            payload: Dict[str, Any] = {}
        else:
            try:
                payload = json.loads(body)
            except json.JSONDecodeError as e:
                return self._send_error(ApiError(
                    "BAD_REQUEST", f"request body is not valid JSON: {e}"))
        if not isinstance(payload, dict):
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"request body must be a JSON object, "
                f"got {type(payload).__name__}"))
        # query params on a POST URL (incl. the stream flag) are handled
        # by _dispatch: merged into the payload, conflicts rejected
        extra, dup = _params_dict(split.query)
        if dup:
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"conflicting duplicate query parameter(s): "
                f"{', '.join(dup)}",
                details={"conflicting_fields": dup}))
        self._dispatch(split.path, payload, coerce=False, extra=extra)

    # ---------------------------- dispatch ----------------------------- #
    def _dispatch(self, path: str, payload: Dict[str, Any],
                  coerce: bool, extra: Optional[Dict[str, str]] = None
                  ) -> None:
        gw: Gateway = self.server.gateway
        try:
            # match first: unknown paths 404 before any payload work, and
            # the matched request class drives query-string coercion
            try:
                name, cls, _handler, route_params = gw._match(path)
            except ApiError:
                name, cls, _handler, route_params = None, None, None, {}
            # `stream` is a transport flag on the download route only; on
            # any other route it stays in the payload so the schema
            # rejects it exactly like the in-process entry point would
            stream = False
            if name == "download":
                flags = []
                if "stream" in payload:
                    flags.append(payload.pop("stream"))
                if extra and "stream" in extra:
                    flags.append(extra.pop("stream"))
                parsed_flags = []
                for raw in flags:
                    parsed = _parse_bool(raw)
                    if not isinstance(parsed, bool):
                        # a typo'd flag must fail loudly, not quietly
                        # serve one page where the client wanted a stream
                        return self._send_error(ApiError(
                            "BAD_REQUEST",
                            f"stream must be a boolean, got {raw!r}",
                            details={"field": "stream"}))
                    parsed_flags.append(parsed)
                if len(set(parsed_flags)) > 1:
                    # body and query disagreeing is a client error, the
                    # same rule every other field follows
                    return self._send_error(ApiError(
                        "BAD_REQUEST",
                        "query parameter(s) conflict with request body: "
                        "stream",
                        details={"conflicting_fields": ["stream"]}))
                stream = bool(parsed_flags and parsed_flags[0])
            if cls is not None and coerce:
                payload = coerce_query_params(cls, payload)
            if extra:
                # POST: query-string params are part of the resource
                # identity (caches key on the full URL) — merge them into
                # the body payload; a disagreement is a client error,
                # never a silent winner
                qp = coerce_query_params(cls, extra) if cls is not None \
                    else dict(extra)
                clash = sorted(k for k in qp
                               if k in payload and payload[k] != qp[k])
                if clash:
                    return self._send_error(ApiError(
                        "BAD_REQUEST",
                        f"query parameter(s) conflict with request body: "
                        f"{', '.join(clash)}",
                        details={"conflicting_fields": clash}))
                payload = {**qp, **payload}
            if name == "download":
                # 304 is defined only for GET/HEAD (RFC 9110): a POST
                # with a stored validator must execute, not short-circuit
                if not stream and self.command == "GET" \
                        and self._maybe_not_modified(gw, route_params,
                                                     payload):
                    return
                if stream:
                    return self._stream_download(gw, route_params, payload)
            match = (name, cls, _handler, route_params) if name else None
            wire = gw.handle(path, payload, match=match)
            if wire.get("type") == "stats_response":
                # transport-level block: 304s and streams are answered
                # before dispatch, so without this they'd be invisible
                # exactly when ETag traffic makes "cheap hit" the common
                # case
                wire = {**wire, "http": self.server.http_snapshot()}
            status = wire.get("status", 200) if wire.get("type") == "error" \
                else 200
            headers: Tuple[Tuple[str, str], ...] = ()
            if wire.get("type") == "download_page" and wire.get("etag"):
                headers = (("ETag", wire["etag"]),)
            self._send_json(status, wire, headers)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        except Exception as e:                       # pragma: no cover
            self.server._count("internal_errors")
            try:
                self._send_error(ApiError("INTERNAL",
                                          f"http layer error: {e}"))
            except Exception:
                self.close_connection = True

    # ------------------------- conditional GET ------------------------- #
    def _maybe_not_modified(self, gw: Gateway, route_params: Dict[str, str],
                            payload: Dict[str, Any]) -> bool:
        """If-None-Match short circuit for download pages. Computes the
        expected ETag from the request coordinates alone — coordinate
        *existence* is validated through the gateway's cached metadata
        (version lists, latest pointer), so a 304 does zero kernel/index
        work and never increments the gateway's download route counter.
        Any validation failure falls through to the full path, which
        produces the proper structured 4xx — ETags are computable by
        anyone, so a matching validator must never vouch for
        coordinates the gateway would reject."""
        t0 = time.perf_counter()
        inm = self.headers.get("If-None-Match")
        if not inm or gw._closed:
            # a draining gateway must answer 503 everywhere — a 304 from
            # the shortcut would keep load balancers routing here
            return False
        # the shortcut must be at least as strict as the full path: an
        # unknown field, a payload/route clash, or any malformed value
        # falls through so the gateway produces its structured 4xx
        ontology = route_params.get("ontology")
        model = route_params.get("model")
        if set(payload) - set(_DOWNLOAD_DEFAULTS):
            return False               # unknown fields → full path 400s
        if payload.get("ontology", ontology) != ontology \
                or payload.get("model", model) != model:
            return False               # route conflict → full path 400s
        version = payload.get("version")
        offset = payload.get("offset", _DOWNLOAD_DEFAULTS["offset"])
        limit = payload.get("limit", _DOWNLOAD_DEFAULTS["limit"])
        if not (isinstance(ontology, str) and isinstance(model, str)
                and isinstance(offset, int) and isinstance(limit, int)
                and not isinstance(offset, bool)
                and not isinstance(limit, bool)
                and (version is None or isinstance(version, str))
                and limit >= 1 and offset >= 0):
            return False               # malformed → full path rejects it
        try:
            version = gw._resolve_coords(ontology, model, version)
        except Exception:
            return False               # unknown coords → full path 404s
        etag = download_etag(ontology, model, version, offset,
                             min(limit, gw.page_limit_max), limit)
        if not _etag_matches(inm, etag):
            return False
        self.server._count("not_modified")
        # 304s never reach Gateway._run, so they get their own transport
        # histogram — otherwise the cheapest responses in the system
        # would be the only ones with no latency record
        self.server._observe_304(time.perf_counter() - t0)
        self.send_response(304)
        self.send_header("ETag", etag)
        self.end_headers()             # 304 carries no body by definition
        return True

    # ------------------------- streaming download ---------------------- #
    def _stream_download(self, gw: Gateway, route_params: Dict[str, str],
                         payload: Dict[str, Any]) -> None:
        """Chunked ``{class: vector}`` stream over the gateway's cursor
        pages. ``offset``/``limit`` select rows ``[offset,
        offset+limit)`` exactly like the page endpoint, but the limits
        differ by design: with no ``limit`` the stream serves to the
        end of the table, and an explicit ``limit`` is not clamped by
        ``page_limit_max`` — streaming exists precisely to move the
        bodies the page cap refuses. The page size is the server's
        ``stream_page_rows`` knob. Every page after the first is pinned
        to the first page's version, so a release landing mid-stream
        cannot tear the body. Peak memory is one page of encoded rows,
        never the full table."""
        known = set(_DOWNLOAD_DEFAULTS)          # the schema's field set
        unknown = sorted(set(payload) - known)
        if unknown:
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"unknown field(s) for download stream: {', '.join(unknown)}",
                details={"unknown_fields": unknown}))
        # the same route-vs-payload conflict rule as _build_request: the
        # URL's coordinates win or the request fails, never a silent
        # payload override (a URL-keyed cache would store the wrong body)
        clash = sorted(k for k in route_params
                       if k in payload and payload[k] != route_params[k])
        if clash:
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"payload field(s) conflict with route: {', '.join(clash)}",
                details={"conflicting_fields": clash}))
        ontology = route_params.get("ontology")
        model = route_params.get("model")
        cap = payload.get("limit")
        if cap is not None and (isinstance(cap, bool)
                                or not isinstance(cap, int) or cap < 1):
            return self._send_error(ApiError(
                "BAD_REQUEST",
                f"limit must be an integer >= 1, got {cap!r}",
                details={"field": "limit"}))
        page_rows = self.server.stream_page_rows
        try:
            page = gw.download(
                ontology, model, version=payload.get("version"),
                offset=payload.get("offset", 0),
                limit=page_rows if cap is None else min(cap, page_rows))
        except ApiError as e:
            return self._send_error(e)
        self.server._count("streams")
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Bio-KGvec2go-Version", page.version)
        self.send_header("X-Bio-KGvec2go-Total", str(page.total))
        self.end_headers()
        try:
            self._write_chunk(b"{")
            first = True
            remaining = cap
            while True:
                rows = page.rows if remaining is None \
                    else page.rows[:remaining]
                parts = []
                for ident, vec in rows:
                    parts.append(("" if first else ", ")
                                 + json.dumps(ident) + ": " + json.dumps(vec))
                    first = False
                if parts:
                    self._write_chunk("".join(parts).encode("utf-8"))
                if remaining is not None:
                    remaining -= len(rows)
                    if remaining <= 0:
                        break
                if page.next_offset is None:
                    break
                page = gw.download(
                    ontology, model, version=page.version,
                    offset=page.next_offset,
                    limit=page_rows if remaining is None
                    else min(remaining, page_rows))
            self._write_chunk(b"}")
            self.wfile.write(b"0\r\n\r\n")           # chunked terminator
        except Exception:
            # headers are gone — the only honest signal left is a torn
            # chunked body, which every client treats as a failed fetch
            self.close_connection = True

    def _write_chunk(self, data: bytes) -> None:
        if not data:
            return                     # empty chunk would terminate early
        self.server._observe_chunk(len(data))
        self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")

    # ----------------------------- replies ----------------------------- #
    #: error codes whose responses advise the client when to come back
    _RETRY_CODES = frozenset(("OVERLOADED", "SHUTTING_DOWN"))

    def _send_json(self, status: int, obj: Dict[str, Any],
                   headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        if obj.get("type") == "error" and obj.get("code") in self._RETRY_CODES:
            # 429/503 carry Retry-After (RFC 6585 / RFC 9110): the
            # scheduler's reject details hold a sub-second hint derived
            # from the flush cadence; the header is whole seconds, so
            # round up and never advise less than 1
            retry = (obj.get("details") or {}).get("retry_after_s")
            try:
                secs = max(1, math.ceil(float(retry)))
            except (TypeError, ValueError):
                secs = 1
            headers = (*headers, ("Retry-After", str(secs)))
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # tell the client (framing-hygiene 400s drop the connection;
            # without this header an HTTP/1.1 client would reuse it and
            # see a reset on its next request)
            self.send_header("Connection", "close")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error(self, e: ApiError) -> None:
        self._send_json(e.status, e.to_wire())


class GatewayHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP server bound to one :class:`Gateway`.

    One daemon thread per live connection; all of them funnel into the
    gateway's shared scheduler, so concurrent HTTP clients coalesce into
    micro-batched kernel calls exactly like in-process threads do.
    """

    daemon_threads = True
    allow_reuse_address = True
    #: accept backlog: 16+ clients connecting in the same instant must
    #: not overflow the default backlog of 5 (a dropped SYN costs the
    #: client a ~1s retransmit — it dominated p99 in bench_http)
    request_queue_size = 128

    def __init__(self, gateway: Gateway,
                 address: Tuple[str, int] = ("127.0.0.1", 0), *,
                 stream_page_rows: int = 2048, verbose_log: bool = False):
        super().__init__(address, GatewayHTTPHandler)
        self.gateway = gateway
        #: page size (rows) the streaming path requests per cursor step —
        #: the peak-memory bound of a streamed download
        self.stream_page_rows = stream_page_rows
        self.verbose_log = verbose_log
        self._stats_lock = threading.Lock()
        #: transport-level counters (the gateway never sees a 304)
        self.http_stats: Dict[str, int] = {
            "requests": 0, "not_modified": 0, "streams": 0,
            "internal_errors": 0, "max_chunk_bytes": 0}
        #: pre-dispatch 304 answer latency — these requests never reach
        #: the gateway's per-route histograms, and cheap hits must still
        #: be observable
        self.not_modified_latency = LatencyHistogram()
        self._thread: Optional[threading.Thread] = None
        #: set while serve_forever is on some thread's stack — close()
        #: must not call shutdown() otherwise (BaseServer.shutdown waits
        #: on an event only serve_forever sets: calling it when the
        #: accept loop never ran would block forever)
        self._serving = threading.Event()

    def serve_forever(self, *args, **kwargs) -> None:
        self._serving.set()
        try:
            super().serve_forever(*args, **kwargs)
        finally:
            self._serving.clear()

    # ------------------------------ stats ------------------------------ #
    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.http_stats[key] += 1

    def _observe_chunk(self, nbytes: int) -> None:
        with self._stats_lock:
            if nbytes > self.http_stats["max_chunk_bytes"]:
                self.http_stats["max_chunk_bytes"] = nbytes

    def _observe_304(self, seconds: float) -> None:
        self.not_modified_latency.observe(seconds)

    def http_counts(self) -> Dict[str, int]:
        """Point-in-time copy of the transport counters.  The lock makes
        the snapshot consistent across counters — callers must use this
        instead of copying ``http_stats`` while request threads mutate
        it."""
        with self._stats_lock:
            return dict(self.http_stats)

    def http_snapshot(self) -> Dict[str, Any]:
        """Transport counters + 304 latency for /stats bodies."""
        counts: Dict[str, Any] = self.http_counts()
        counts["latency_ms"] = {
            "not_modified": self.not_modified_latency.snapshot()}
        return counts

    # ---------------------------- lifecycle ---------------------------- #
    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        host = self.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "GatewayHTTPServer":
        """Serve in a named daemon thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.serve_forever, name="gateway-http", daemon=True)
            self._thread.start()
        return self

    def close(self, close_gateway: bool = False) -> None:
        """Stop accepting, join the serve thread, release the socket.
        Safe to call whether or not the accept loop ever ran. The
        gateway is left running unless ``close_gateway`` — it may be
        shared with in-process callers."""
        # shutdown() is only meaningful with a live accept loop; a
        # started thread counts (its serve_forever observes the shutdown
        # request on entry even if close() wins the startup race)
        if self._serving.is_set() or (
                self._thread is not None and self._thread.is_alive()):
            self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.server_close()
        if close_gateway:
            self.gateway.close()

    def __enter__(self) -> "GatewayHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_http(gateway: Gateway, host: str = "127.0.0.1", port: int = 0, *,
               stream_page_rows: int = 2048, start: bool = True,
               verbose_log: bool = False) -> GatewayHTTPServer:
    """Stand up the HTTP front end over ``gateway``. ``port=0`` binds an
    ephemeral port (see ``server.port``/``server.url``). With ``start``
    (default) the accept loop runs in a daemon thread; pass
    ``start=False`` to drive ``serve_forever()`` yourself (e.g. the
    ``launch.serve --http`` foreground mode)."""
    server = GatewayHTTPServer(gateway, (host, port),
                               stream_page_rows=stream_page_rows,
                               verbose_log=verbose_log)
    if start:
        server.start()
    return server
