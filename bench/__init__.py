"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): run a cell
with ``python3 -m bench.run``; ``BENCHMARK.json`` lists the cells."""
