from repro_torch.telemetry.clock import ClockModel  # noqa: F401
from repro_torch.telemetry.counters import (  # noqa: F401
    MAX_HW_AVG_WINDOW_S, CounterBackend, Event, SimulatedDeviceBackend,
    StepProfile, check_scrape_interval, duty_grid, event_factors,
)
from repro_torch.telemetry.scrape import DeviceGrid, ScrapeSeries, scrape  # noqa: F401
