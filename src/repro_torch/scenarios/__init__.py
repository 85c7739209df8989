"""Scenario library + detector scorecard (see scenarios.library)."""
from repro_torch.scenarios.library import (  # noqa: F401
    DETECTORS, SCENARIOS, GroundTruthEvent, Scenario, build,
    scenario_names,
)
from repro_torch.scenarios.scorecard import (  # noqa: F401
    FLOORS, SCHEMA, DetectorScore, ScenarioRun, check_floors,
    run_scenario, run_scorecard, score_alerts,
)
