"""The benchmark harness of the PyTorch and CUDA port: one general loop
that runs a cell of BENCHMARK.json from its data files (configs/,
traffic/, checks/) and the metric readers (metrics/)."""
