"""Device time of a training step's matrix multiplications (cuBLAS's and
CUTLASS's GEMM kernels: the model's forward and backward)."""

from port_bench import readers


def read(ctx):
    return readers.device_ms(ctx, "step", "gemm")
