"""Stdlib-only JSON API over a `FleetStore` — the dashboard wire.

Five endpoint families (JSON in both directions except ingest blobs):

    /v1/fleet                    fleet OFU series (+ ?qs=10,50,90)
    /v1/jobs                     the monitored population
    /v1/jobs/<job_id>            one job's series + ingest metadata
    /v1/alerts                   fired alerts + open episodes (?limit=N)
    /v1/query?kind=...           structured queries:
        kind=top_regressions     &k=5&window=4&min_duration=2
                                 &factor_threshold=1.5
        kind=goodput             &healthy_ofu=0.40
        kind=divergence          &flag_rel_err=0.30&ofu_floor=0.02
        kind=correlation         &ratio_high=1.5&ratio_low=&min_buckets=1
                                 &ofu_floor=0.02&window=8 — the OFU<->MFU
                                 join (r with/without the flagged set,
                                 per-scale error table, miscalc findings)
        kind=series              &scope=fleet|job|group&id=...&qs=...
    /v1/mfu                      app-MFU ingest (needs an aggregator):
        POST                     JSON body {"job_id", "samples":
                                 [[t_s, mfu], ...]} or an
                                 `MfuRollup.to_payload()` bucket dump;
                                 200 {"applied"} rows accepted
    /v1/ingest                   the WRITE half (needs an aggregator):
        POST                     body = `StreamingRollup.delta_bytes()`
                                 blob, `X-Fleet-Host: <host-id>` header;
                                 200 {"applied", "acked", "shard"},
                                 409 + {"acked"} on a sequence gap
                                 (re-encode from `acked`), 429 +
                                 `Retry-After` under shard backpressure
        GET                      aggregator counters (hosts/applied/
                                 duplicates/gaps/rejected per shard)
    /dashboard                   the HUMAN client: one static HTML page
                                 (`repro_torch.serve.dashboard`) whose inline
                                 JS polls the JSON API above

Every response carries an `ETag` derived from the store GENERATION plus
a per-process boot nonce (so validators never collide across daemon
restarts), and a matching `If-None-Match` is answered with an empty 304
— the query itself is a generation-cache dict hit, so a dashboard
polling every few seconds between collector rounds costs lookups, not
readouts.  Invalid paths/params stay 404/400 even when the client's
validator is current (routing runs before the ETag check).

`FleetAPIServer` wraps `ThreadingHTTPServer` on an ephemeral port by
default (`port=0`), serving from a background thread — the shape both
the CLI (`tools/fleet_serve.py`) and the tests use.  No dependencies
beyond the standard library: deploying the dashboard API costs nothing
the collector didn't already cost.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from repro_torch.serve.aggregator import Backpressure, SnapshotGap
from repro_torch.serve.dashboard import DASHBOARD_HTML
from repro_torch.serve.store import FleetStore


class ApiError(Exception):
    """An HTTP-mappable request error."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = int(status)


def _num(params: dict, key: str, default, cast=float):
    raw = params.get(key)
    if raw is None:
        return default
    try:
        val = cast(raw)
    except ValueError:
        raise ApiError(400, f"query param {key}={raw!r} is not a "
                       f"{cast.__name__}") from None
    # nan/inf would poison cache keys (nan != nan) and leak bare NaN
    # tokens into response bodies — the wire format is strict JSON
    if val != val or val in (float("inf"), float("-inf")):
        raise ApiError(400, f"query param {key}={raw!r} must be finite")
    return val


def _qs_param(params: dict) -> tuple:
    raw = params.get("qs")
    if raw is None:
        return (10, 50, 90)
    try:
        qs = tuple(float(x) for x in raw.split(",") if x.strip())
    except ValueError:
        raise ApiError(400, f"qs={raw!r} must be comma-separated "
                       "percentiles") from None
    if not qs or not all(0 <= q <= 100 for q in qs):
        raise ApiError(400, f"qs={raw!r} must hold percentiles in "
                       "[0, 100]")
    return qs


def _route(store: FleetStore, path: str, params: dict) -> dict:
    parts = [unquote(p) for p in path.split("/") if p]
    if not parts or parts[0] != "v1":
        raise ApiError(404, f"unknown path {path!r} (API root is /v1)")
    rest = parts[1:]
    try:
        if rest == ["fleet"]:
            return store.fleet_series(qs=_qs_param(params))
        if rest == ["jobs"]:
            return store.jobs()
        if len(rest) == 2 and rest[0] == "jobs":
            return store.job_series(rest[1], qs=_qs_param(params))
        if rest == ["alerts"]:
            limit = _num(params, "limit", None, int)
            return store.alerts(limit=limit)
        if rest == ["query"]:
            return _query(store, params)
    except KeyError as e:
        raise ApiError(404, str(e.args[0]) if e.args else "not found") \
            from None
    except ValueError as e:
        raise ApiError(400, str(e)) from None
    raise ApiError(404, f"unknown path {path!r}")


def _query(store: FleetStore, params: dict) -> dict:
    kind = params.get("kind")
    if kind == "top_regressions":
        kw = {}
        for name, cast in (("window", int), ("min_duration", int),
                           ("factor_threshold", float)):
            val = _num(params, name, None, cast)
            if val is not None:
                kw[name] = val
        return store.top_regressions(k=_num(params, "k", 5, int), **kw)
    if kind == "goodput":
        return store.goodput(
            healthy_ofu=_num(params, "healthy_ofu", 0.40))
    if kind == "divergence":
        return store.divergence(
            flag_rel_err=_num(params, "flag_rel_err", 0.30),
            ofu_floor=_num(params, "ofu_floor", 0.02))
    if kind == "correlation":
        return store.correlation(
            ratio_high=_num(params, "ratio_high", 1.5),
            ratio_low=_num(params, "ratio_low", None),
            min_buckets=_num(params, "min_buckets", 1, int),
            ofu_floor=_num(params, "ofu_floor", 0.02),
            window=_num(params, "window", 8, int))
    if kind == "series":
        scope = params.get("scope", "fleet")
        name = params.get("id")
        qs = _qs_param(params)
        if scope == "fleet":
            return store.fleet_series(qs=qs)
        if scope == "job":
            if not name:
                raise ApiError(400, "scope=job needs an id param")
            return store.job_series(name, qs=qs)
        if scope == "group":
            if not name:
                raise ApiError(400, "scope=group needs an id param")
            return store.group_series(name, qs=qs)
        raise ApiError(400, f"unknown scope {scope!r}")
    raise ApiError(400, f"unknown query kind {kind!r} (want "
                   "top_regressions, goodput, divergence, correlation, "
                   "or series)")


def _make_handler(store: FleetStore, aggregator=None):
    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-fleet-serve/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):     # quiet: this is a library
            pass

        def _send(self, status: int, payload: dict,
                  etag: Optional[str] = None,
                  headers: Optional[dict] = None) -> None:
            try:
                # the wire format is STRICT JSON: a NaN that slipped
                # past the store's cleaning must fail here, not emit a
                # bare token no conforming parser accepts
                body = json.dumps(payload, allow_nan=False).encode()
            except ValueError as e:
                status = 500
                body = json.dumps({"error": f"non-finite value in "
                                   f"response payload ({e})",
                                   "path": self.path}).encode()
                etag = None
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-cache")
            if etag is not None:
                self.send_header("ETag", etag)
            for name, val in (headers or {}).items():
                self.send_header(name, val)
            self.end_headers()
            self.wfile.write(body)

        def _is_ingest(self, path: str) -> bool:
            return [unquote(p) for p in path.split("/") if p] \
                == ["v1", "ingest"]

        def _is_mfu(self, path: str) -> bool:
            return [unquote(p) for p in path.split("/") if p] \
                == ["v1", "mfu"]

        def _send_html(self, html: str) -> None:
            body = html.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            sp = urlsplit(self.path)
            # the one non-JSON route: the static dashboard page (its
            # inline JS polls the /v1 JSON API like any other client)
            if sp.path.rstrip("/") == "/dashboard":
                self._send_html(DASHBOARD_HTML)
                return
            params = {k: v[-1] for k, v in
                      parse_qs(sp.query, keep_blank_values=True).items()}
            # route BEFORE the ETag check, so an invalid path or param
            # is a 404/400 even when the client's validator is current;
            # the store's generation cache keeps the repeat-poll path a
            # dict lookup, so 304s stay cheap
            try:
                if self._is_ingest(sp.path):
                    if aggregator is None:
                        raise ApiError(404, "no ingest tier configured "
                                       "on this server")
                    payload = aggregator.stats()
                else:
                    payload = _route(store, sp.path, params)
            except ApiError as e:
                self._send(e.status, {"error": str(e), "path": self.path})
                return
            except Exception as e:    # noqa: BLE001 — a handler must answer
                self._send(500, {"error": f"{type(e).__name__}: {e}",
                                 "path": self.path})
                return
            gen = payload.get("generation")
            if gen is None:           # ingest stats: live counters, no ETag
                self._send(200, payload)
                return
            # the boot nonce keeps validators from a previous server
            # process (whose generations restarted at 0) from colliding
            # into false 304s after a daemon restart
            etag = f'"gen-{store.boot}-{gen}"'
            if self.headers.get("If-None-Match") == etag:
                self.send_response(304)
                self.send_header("ETag", etag)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self._send(200, payload, etag=etag)

        def do_POST(self) -> None:
            sp = urlsplit(self.path)
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            # drain the body before answering anything, or the client's
            # keep-alive connection desynchronizes on the next request
            blob = self.rfile.read(length) if length else b""
            try:
                if self._is_mfu(sp.path):
                    if aggregator is None:
                        raise ApiError(404, "no ingest tier configured "
                                       "on this server")
                    if not blob:
                        raise ApiError(400, "POST /v1/mfu needs a JSON "
                                       "body")
                    try:
                        payload = json.loads(blob.decode())
                    except (UnicodeDecodeError,
                            json.JSONDecodeError) as e:
                        raise ApiError(400, f"POST /v1/mfu body is not "
                                       f"valid JSON ({e})") from None
                    out = aggregator.submit_mfu(payload)
                    self._send(200, out)
                    return
                if not self._is_ingest(sp.path):
                    raise ApiError(404, f"unknown POST path "
                                   f"{sp.path!r} (want /v1/ingest or "
                                   "/v1/mfu)")
                if aggregator is None:
                    raise ApiError(404, "no ingest tier configured on "
                                   "this server")
                host = self.headers.get("X-Fleet-Host")
                if not host:
                    raise ApiError(400, "POST /v1/ingest needs an "
                                   "X-Fleet-Host header")
                if not blob:
                    raise ApiError(400, "POST /v1/ingest needs a "
                                   "delta-blob body")
                out = aggregator.submit(host, blob)
            except ApiError as e:
                self._send(e.status, {"error": str(e), "path": self.path})
                return
            except Backpressure as e:
                self._send(429, {"error": str(e),
                                 "retry_after_s": e.retry_after_s},
                           headers={"Retry-After":
                                    f"{e.retry_after_s:g}"})
                return
            except SnapshotGap as e:
                self._send(409, {"error": str(e), "host": e.host,
                                 "acked": e.acked})
                return
            except ValueError as e:
                self._send(400, {"error": str(e), "path": self.path})
                return
            except Exception as e:    # noqa: BLE001 — a handler must answer
                self._send(500, {"error": f"{type(e).__name__}: {e}",
                                 "path": self.path})
                return
            self._send(200, {"host": host, **out})

    return Handler


class FleetAPIServer:
    """Threaded HTTP server over a `FleetStore`.

    `port=0` (default) binds an ephemeral port — read `.port`/`.url`
    after construction.  `start()` serves from a daemon thread;
    `stop()` (or the context manager) shuts it down.
    """

    def __init__(self, store: FleetStore, *, host: str = "127.0.0.1",
                 port: int = 0, aggregator=None):
        self.store = store
        self.aggregator = aggregator
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(store, aggregator))
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetAPIServer":
        if self._thread is not None:
            raise ValueError("server already started")
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="fleet-api", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)
        self._thread = None

    def __enter__(self) -> "FleetAPIServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
