"""The benchmark of cm3d_tpu_torch, the PyTorch and CUDA port (see
BENCHMARK.json at the root of the checkout and PERF.md). It drives the port
only: nothing here imports JAX or the JAX package."""
