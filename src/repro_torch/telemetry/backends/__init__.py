"""Live counter acquisition: the deploy tier under `CounterBackend`.

The paper's acquisition story is deliberately thin — OFU needs exactly
two per-device counters (PIPE_TENSOR_ACTIVE + SM_CLOCK), polled with no
application instrumentation.  This package is that tier:

  * `transport` — the injectable `FieldTransport` seam: "read these
    field ids for this GPU now", nothing else.  Everything above it
    (staleness, retry, §IV-C window policy) lives in the backend;
    everything below (dcgmi subprocess, NVML bindings, the CI fake) is a
    transport.
  * `dcgm` — `DcgmFieldBackend` (a `CounterBackend`: the rest of the
    pipeline runs unchanged via `BackendSource`) plus the real
    transports: `DcgmiTransport` (one `dcgmi dmon` snapshot per poll
    round) and `PynvmlTransport` (NVML bindings, gated on the module
    being installed).
  * `fake` — `FakeDcgmTransport`, driven by the simulator engine with
    the SAME chunk seeding as `SimulatorSource`, so the full live path
    (transport → backend → `BackendSource` → `Collector` → serve) runs
    deterministically without hardware and its rollup is
    bucketwise-identical to the simulator's chunks replayed the same way.

There is no TPU backend: an H100 machine has no libtpu to read.
"""
from repro_torch.telemetry.backends.dcgm import (  # noqa: F401
    DcgmFieldBackend, DcgmiTransport, PynvmlTransport, make_dcgm_backends,
    parse_dmon,
)
from repro_torch.telemetry.backends.fake import FakeDcgmTransport  # noqa: F401
from repro_torch.telemetry.backends.transport import (  # noqa: F401
    DCGM_FI_DEV_SM_CLOCK, DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, FieldSample,
    FieldTransport, TransportError,
)
