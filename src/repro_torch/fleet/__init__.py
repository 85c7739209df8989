"""Fleet layer of the port: the torch engine, device-side rollup ingest,
the rollup wire formats, and the regression / divergence detectors."""
