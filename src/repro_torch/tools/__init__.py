"""The fleet tools' command lines, run with
`python -m repro_torch.tools.<name>` (trace_convert, fleet_serve,
fleet_ingest, fleet_live, fleet_correlate, fleet_scorecard).  Each runs
on the card unless `--device` names another device."""
