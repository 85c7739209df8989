"""Host milliseconds a step in the benchmark's span around the data
pipeline: `synthetic_batch` and `to_device` of the window's steps."""


def read(r):
    spans = r.window["spans"].get("batch") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
