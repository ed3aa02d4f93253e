"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W power limit). A frozen copy: the
bandwidth is ``scripts/_bench.HBM_BYTES_PER_S`` of the port, pinned to it
by benchmark/tests/test_bench_copies.py."""

HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores


def least_time_s(flops: float, nbytes: float):
    """(least seconds, "memory" or "compute"): the larger of the bytes
    over the HBM bandwidth and the float32 operations over the peak
    rate."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_op = flops / F32_FLOPS_PER_S
    return (t_mem, "memory") if t_mem >= t_op else (t_op, "compute")
