"""Telemetry layer of the port: counters, the clock model, scrapes, the
sources behind the collector (simulated on the card, replayed, or an
in-memory grid), the DCGM acquisition tier, the app-MFU reporter and the
columnar trace archives."""
from repro_torch.telemetry.backends import (  # noqa: F401
    DcgmFieldBackend, DcgmiTransport, FakeDcgmTransport, FieldTransport,
    PynvmlTransport, TransportError, make_dcgm_backends,
)
from repro_torch.telemetry.clock import ClockModel  # noqa: F401
from repro_torch.telemetry.counters import (  # noqa: F401
    MAX_HW_AVG_WINDOW_S, CounterBackend, Event, SimulatedDeviceBackend,
    StepProfile, check_scrape_interval, duty_grid, event_factors,
)
from repro_torch.telemetry.mfu import (  # noqa: F401
    MfuReplaySource, MfuReporter, MfuSample, compute_mfu,
    extract_tflops_from_log, reported_tflops_per_gpu,
)
from repro_torch.telemetry.scrape import DeviceGrid, ScrapeSeries, scrape  # noqa: F401
from repro_torch.telemetry.source import (  # noqa: F401
    BackendSource, GridSource, SimulatorSource, TelemetrySource,
    TraceReplaySource, read_trace, write_trace,
)
from repro_torch.telemetry.tracestore import (  # noqa: F401
    TraceReader, TraceWriter, read_archive, write_archive,
)
