"""Host milliseconds a step inside the program's data pipeline spans,
`data.synthetic_batch` and `data.to_device`, from their durations."""
import phases


def read(r):
    return phases.host_ms(r, ("data.synthetic_batch", "data.to_device"))
