"""Thin Python clients for the fleet API (`repro_torch.serve.http`).

Stdlib `urllib` only, both directions of the wire:

  * `FleetClient` — the READ half.  Keeps a per-URL (ETag, payload)
    cache and sends `If-None-Match` on every repeat request: when the
    store generation hasn't moved, the server answers 304 with no body
    and the client returns its cached payload — the polling pattern
    every dashboard widget uses, measured by `hits_304`.  Every request
    carries a socket timeout, and transient transport failures (timeout,
    connection reset) are retried with the shared capped exponential
    backoff before surfacing as `FleetAPIError(status=0)`.
  * `IngestClient` — the WRITE half.  Owns the ack cursor for one
    host's rollup: each `push()` re-encodes `delta_bytes(acked)` and
    POSTs it to `/v1/ingest`, honouring 429 `Retry-After` (shard
    backpressure) and recovering from 409 sequence gaps by re-encoding
    from the generation the aggregator reports it HAS.

    client = FleetClient(server.url)
    fleet = client.fleet()                    # GET /v1/fleet
    job = client.job("prod-llm-7b")           # GET /v1/jobs/prod-llm-7b
    worst = client.top_regressions(k=3)       # GET /v1/query?kind=...
    again = client.fleet()                    # 304 -> cached payload

    pusher = IngestClient(server.url, "host-00", roll)
    roll.observe(...); pusher.push()          # ships only the new rows
"""
from __future__ import annotations

import json
import time
from typing import Callable, Iterator, Optional, Sequence
from urllib.error import HTTPError, URLError
from urllib.parse import quote, urlencode
from urllib.request import Request, urlopen


def backoff_delays(retries: int, *, base_s: float = 0.05,
                   cap_s: float = 2.0) -> Iterator[float]:
    """Capped exponential backoff schedule: base, 2*base, 4*base, ...
    clamped to `cap_s`, one delay per retry.  Shared by the read client
    (transient transport errors) and the ingest client (429/timeouts),
    so both halves of the wire pace themselves identically."""
    if retries < 0:
        raise ValueError(f"retries={retries} must be >= 0")
    if base_s <= 0 or cap_s <= 0:
        raise ValueError("backoff base_s and cap_s must be > 0")
    for attempt in range(retries):
        yield min(base_s * (2.0 ** attempt), cap_s)


class FleetAPIError(RuntimeError):
    """A non-2xx API answer (carries the HTTP status)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = int(status)


class FleetClient:
    """ETag-caching client over one server's base URL.

    `timeout_s` bounds every socket operation (a stalled server can
    never hang a dashboard poll); `retries` transient transport failures
    are retried with capped exponential backoff before giving up.
    """

    def __init__(self, base_url: str, *, timeout_s: float = 10.0,
                 retries: int = 2, backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self._cache: dict = {}        # url -> (etag, payload)
        self.requests = 0
        self.hits_304 = 0
        self.retried = 0

    def _get(self, path: str, params: Optional[dict] = None) -> dict:
        url = self.base_url + path
        if params:
            url += "?" + urlencode({k: v for k, v in params.items()
                                    if v is not None})
        req = Request(url, headers={"Accept": "application/json"})
        cached = self._cache.get(url)
        if cached is not None:
            req.add_header("If-None-Match", cached[0])
        delays = backoff_delays(self.retries, base_s=self.backoff_s,
                                cap_s=self.backoff_cap_s)
        while True:
            self.requests += 1
            try:
                with urlopen(req, timeout=self.timeout_s) as resp:
                    etag = resp.headers.get("ETag")
                    payload = json.loads(resp.read().decode())
            except HTTPError as e:
                # an HTTP answer means the server is alive — a non-2xx
                # status is the API's verdict, not a transport fault,
                # so it is never retried
                if e.code == 304 and cached is not None:
                    self.hits_304 += 1
                    return cached[1]
                try:
                    msg = json.loads(e.read().decode()).get("error",
                                                            e.reason)
                except Exception:      # noqa: BLE001 — error body optional
                    msg = str(e.reason)
                raise FleetAPIError(e.code, msg) from None
            # HTTPError subclasses URLError subclasses OSError, and
            # socket.timeout is TimeoutError — order matters above
            except (TimeoutError, URLError, OSError) as e:
                reason = getattr(e, "reason", e)
                delay = next(delays, None)
                if delay is None:
                    raise FleetAPIError(
                        0, f"cannot reach {url}: {reason}") from None
                self.retried += 1
                self._sleep(delay)
                continue
            if etag is not None:
                self._cache[url] = (etag, payload)
            return payload

    @staticmethod
    def _qs(qs: Optional[Sequence]) -> Optional[str]:
        return None if qs is None else ",".join(f"{q:g}" for q in qs)

    # -- endpoints ------------------------------------------------------
    def fleet(self, qs: Optional[Sequence] = None) -> dict:
        return self._get("/v1/fleet", {"qs": self._qs(qs)})

    def jobs(self) -> dict:
        return self._get("/v1/jobs")

    def job(self, job_id: str, qs: Optional[Sequence] = None) -> dict:
        return self._get(f"/v1/jobs/{quote(job_id, safe='')}",
                         {"qs": self._qs(qs)})

    def alerts(self, limit: Optional[int] = None) -> dict:
        return self._get("/v1/alerts", {"limit": limit})

    def query(self, kind: str, **params) -> dict:
        return self._get("/v1/query", {"kind": kind, **params})

    # -- conveniences over /v1/query ------------------------------------
    def top_regressions(self, k: int = 5, **detector_kw) -> dict:
        return self.query("top_regressions", k=k, **detector_kw)

    def goodput(self, healthy_ofu: Optional[float] = None) -> dict:
        return self.query("goodput", healthy_ofu=healthy_ofu)

    def divergence(self, flag_rel_err: Optional[float] = None,
                   ofu_floor: Optional[float] = None) -> dict:
        return self.query("divergence", flag_rel_err=flag_rel_err,
                          ofu_floor=ofu_floor)

    def correlation(self, **params) -> dict:
        """kind=correlation: the OFU<->MFU join report (params:
        ratio_high, ratio_low, min_buckets, ofu_floor, window)."""
        return self.query("correlation", **params)

    def post_mfu(self, job_id: str, samples) -> dict:
        """Ship app-reported MFU samples ([[t_s, mfu], ...] pairs, or
        `telemetry.mfu.MfuSample`s) to POST /v1/mfu.  One plain POST, no
        cursor: MFU rows are additive observations, so at-least-once
        delivery only needs the caller not to re-send the same batch."""
        rows = [[s.t_s, s.mfu] if hasattr(s, "mfu") else
                [float(s[0]), float(s[1])] for s in samples]
        body = json.dumps({"job_id": job_id, "samples": rows}).encode()
        url = self.base_url + "/v1/mfu"
        req = Request(url, data=body, method="POST",
                      headers={"Content-Type": "application/json"})
        delays = backoff_delays(self.retries, base_s=self.backoff_s,
                                cap_s=self.backoff_cap_s)
        while True:
            self.requests += 1
            try:
                with urlopen(req, timeout=self.timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except HTTPError as e:
                try:
                    msg = json.loads(e.read().decode()).get("error",
                                                            e.reason)
                except Exception:  # noqa: BLE001 — error body optional
                    msg = str(e.reason)
                raise FleetAPIError(e.code, msg) from None
            except (TimeoutError, URLError, OSError) as e:
                reason = getattr(e, "reason", e)
                delay = next(delays, None)
                if delay is None:
                    raise FleetAPIError(
                        0, f"cannot reach {url}: {reason}") from None
                self.retried += 1
                self._sleep(delay)
                continue


class IngestClient:
    """One host's delta shipper: POSTs `rollup.delta_bytes(acked)` to
    `/v1/ingest` and advances the ack cursor from the server's answer.

    The cursor (`acked`) makes delivery self-healing: a duplicate POST
    is a no-op on the server (the blob's seq orders it out), a 409 gap
    answer resets the cursor to what the aggregator HAS so the next
    encode carries everything it is missing, and a 429 waits out the
    shard's `Retry-After` hint (never less than the local backoff step,
    never more than `backoff_cap_s`).
    """

    def __init__(self, base_url: str, host_id: str, rollup, *,
                 timeout_s: float = 10.0, retries: int = 5,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        if not host_id:
            raise ValueError("host_id must be non-empty")
        self.base_url = base_url.rstrip("/")
        self.host_id = host_id
        self.rollup = rollup
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._sleep = sleep
        self.acked = 0                # server-confirmed generation
        self.pushes = 0
        self.backpressure_hits = 0

    def push(self) -> dict:
        """Ship everything newer than the ack cursor; returns the
        server's answer ({"applied", "acked", "shard", ...}).

        The delta is RE-ENCODED from the live rollup on every attempt —
        rows observed while waiting out a 429 ride along on the retry
        instead of needing their own round trip.
        """
        url = self.base_url + "/v1/ingest"
        delays = backoff_delays(self.retries, base_s=self.backoff_s,
                                cap_s=self.backoff_cap_s)
        resyncs = 0
        while True:
            blob = self.rollup.delta_bytes(self.acked)
            req = Request(url, data=blob, method="POST",
                          headers={"Content-Type":
                                   "application/octet-stream",
                                   "X-Fleet-Host": self.host_id})
            self.pushes += 1
            try:
                with urlopen(req, timeout=self.timeout_s) as resp:
                    out = json.loads(resp.read().decode())
            except HTTPError as e:
                try:
                    body = json.loads(e.read().decode())
                except Exception:      # noqa: BLE001 — error body optional
                    body = {}
                if e.code == 429:
                    self.backpressure_hits += 1
                    delay = next(delays, None)
                    if delay is None:
                        raise FleetAPIError(
                            429, body.get("error",
                                          "shard backpressure")) from None
                    hint = body.get("retry_after_s") \
                        or e.headers.get("Retry-After") or 0.0
                    self._sleep(min(max(float(hint), delay),
                                    self.backoff_cap_s))
                    continue
                if e.code == 409 and "acked" in body:
                    # sequence gap: the aggregator lost a delta (or was
                    # restarted) — resync the cursor to what it HAS and
                    # re-encode; no backoff, this converges in one hop
                    # (the bound only guards a server that keeps moving)
                    resyncs += 1
                    if resyncs > self.retries + 1:
                        raise FleetAPIError(
                            409, body.get("error",
                                          "gap resync loop")) from None
                    self.acked = int(body["acked"])
                    continue
                raise FleetAPIError(
                    e.code, body.get("error", str(e.reason))) from None
            except (TimeoutError, URLError, OSError) as e:
                reason = getattr(e, "reason", e)
                delay = next(delays, None)
                if delay is None:
                    raise FleetAPIError(
                        0, f"cannot reach {url}: {reason}") from None
                self._sleep(delay)
                continue
            self.acked = int(out["acked"])
            return out
