"""Benchmark scripts of the port, each the counterpart of the JAX
package's script of the same name under ``scripts/`` and the entry point
of the kernels it times. Run as modules:

    python -m pairwise_perturbation_tpu_torch.scripts.bench_firstpair
    python -m pairwise_perturbation_tpu_torch.scripts.bench_rankpos
    python -m pairwise_perturbation_tpu_torch.scripts.bench_midvariants

Each runs on ``cuda`` unless given ``--device cpu``, at the coil-100
shape (3, 128, 128, 7200) and rank 10 unless given ``--shape`` and
``--rank``, prints one row per measurement and a final JSON line of its
rows, and exits nonzero if any error check exceeds its tolerance.
"""
