"""The paper harness of the port: one module per paper table or figure
(`python -m repro_torch.benchmarks.run` runs them all)."""
