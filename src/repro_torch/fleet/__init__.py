"""Fleet layer of the port: the torch engine, device-side rollup ingest,
the rollup wire formats, the detectors, goodput, the correlation tier,
the continuous collector and the recovery service.

Exports resolve lazily (PEP 562), so the replay path (`fleet.streaming`
and the detectors fed by a `TraceReplaySource`) never loads the
generative simulator (engine, jobs).
"""
from __future__ import annotations

from importlib import import_module

_EXPORTS = {
    "AdaptiveConfig": "repro_torch.fleet.collector",
    "AdaptiveScrapeController": "repro_torch.fleet.collector",
    "Alert": "repro_torch.fleet.collector",
    "AlertDeduper": "repro_torch.fleet.collector",
    "Collector": "repro_torch.fleet.collector",
    "CollectorConfig": "repro_torch.fleet.collector",
    "FleetCollector": "repro_torch.fleet.collector",
    "JobStream": "repro_torch.fleet.collector",
    "RoundReport": "repro_torch.fleet.collector",
    "DivergenceReport": "repro_torch.fleet.divergence",
    "JobPoint": "repro_torch.fleet.divergence",
    "analyze": "repro_torch.fleet.divergence",
    "analyze_rollup": "repro_torch.fleet.divergence",
    "DEFAULT_OFU_FLOOR": "repro_torch.fleet.divergence",
    "CorrelationConfig": "repro_torch.fleet.correlation",
    "CorrelationReport": "repro_torch.fleet.correlation",
    "MfuRollup": "repro_torch.fleet.correlation",
    "MiscalcFinding": "repro_torch.fleet.correlation",
    "analyze_correlation": "repro_torch.fleet.correlation",
    "joined_series": "repro_torch.fleet.correlation",
    "rolling_pearson": "repro_torch.fleet.correlation",
    "scan_miscalc": "repro_torch.fleet.correlation",
    "tile_quant_factor": "repro_torch.fleet.correlation",
    # defined in the telemetry layer: resolving it must not load the
    # simulator
    "DeviceGrid": "repro_torch.telemetry.scrape",
    "CounterFault": "repro_torch.fleet.engine",
    "EngineParams": "repro_torch.fleet.engine",
    "JobSlot": "repro_torch.fleet.engine",
    "apply_faults": "repro_torch.fleet.engine",
    "fault_factors": "repro_torch.fleet.engine",
    "simulate_devices": "repro_torch.fleet.engine",
    "simulate_jobs_torch": "repro_torch.fleet.engine_torch",
    "FleetRollup": "repro_torch.fleet.goodput",
    "GoodputEvent": "repro_torch.fleet.goodput",
    "goodput_from_rollup": "repro_torch.fleet.goodput",
    "rollup": "repro_torch.fleet.goodput",
    "scan_goodput": "repro_torch.fleet.goodput",
    "JobSpec": "repro_torch.fleet.jobs",
    "JobTelemetry": "repro_torch.fleet.jobs",
    "build_profile": "repro_torch.fleet.jobs",
    "simulate_fleet": "repro_torch.fleet.jobs",
    "simulate_job": "repro_torch.fleet.jobs",
    "BucketStats": "repro_torch.fleet.streaming",
    "StreamingRollup": "repro_torch.fleet.streaming",
    "WindowedRollup": "repro_torch.fleet.streaming",
    "precision_label": "repro_torch.fleet.streaming",
    "host_partition": "repro_torch.fleet.distributed",
    "tree_reduce": "repro_torch.fleet.distributed",
    "RecoveryAction": "repro_torch.fleet.recovery",
    "RecoveryService": "repro_torch.fleet.recovery",
    "StragglerMonitor": "repro_torch.fleet.recovery",
    "Regression": "repro_torch.fleet.regression",
    "detect_regressions": "repro_torch.fleet.regression",
    "scan_rollup": "repro_torch.fleet.regression",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    val = getattr(import_module(mod), name)
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
