"""Serving layer: the read/query side of the fleet pipeline.

`FleetStore` indexes collector state into cacheable, generation-
versioned query answers; `ServiceDaemon` runs a collector on a real
wall clock (pacing, stream churn, snapshot persistence, recording tee);
`FleetAPIServer`/`FleetClient` put a stdlib-only JSON dashboard API in
front of it.  The WRITE half is `IngestAggregator` (sharded per-host
delta mirrors behind `POST /v1/ingest`) with `IngestClient` shipping
`delta_bytes()` blobs under capped-backoff retry.  See
docs/ARCHITECTURE.md § "The serving layer" and § "The ingest tier".
"""
from repro_torch.serve.aggregator import (  # noqa: F401
    Backpressure, IngestAggregator, SnapshotGap)
from repro_torch.serve.client import (  # noqa: F401
    FleetAPIError, FleetClient, IngestClient, backoff_delays)
from repro_torch.serve.daemon import ServiceDaemon, SimClock  # noqa: F401
from repro_torch.serve.http import ApiError, FleetAPIServer  # noqa: F401
from repro_torch.serve.store import FleetStore, alert_payload  # noqa: F401
