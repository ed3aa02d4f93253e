"""Benchmark of ``pairwise_perturbation_tpu_torch`` on an NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md says how
the cells, configurations, traffic mixes and per-layer metrics are
found by name.
"""
