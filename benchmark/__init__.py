"""The benchmark of the PyTorch/CUDA port (``dct_tpu_torch``): one cell run
by ``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; configurations, traffic mixes, cells, step drivers and
per-layer metric readers are files found by the names in
``BENCHMARK.json``."""
