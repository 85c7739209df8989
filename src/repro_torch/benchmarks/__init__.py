"""The paper's benchmark suite on the port, one module per table or
figure (`python -m repro_torch.benchmarks.run [module] [--device DEV]`)."""
