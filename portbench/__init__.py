"""The benchmark of ``clearvae_torch`` on one NVIDIA H100: ``python -m
portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Cells, configurations, traffic mixes and per-layer metrics are files under
this package, found by the names in ``BENCHMARK.json``."""
