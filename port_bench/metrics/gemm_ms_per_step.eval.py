"""Device ms in matrix-product kernels (cuBLAS, CUTLASS; convolutions
excepted) per beam-search step of the traced window."""

from port_bench.readers import CONV, GEMM, device_ms, per_decode_step


def read(run):
    return per_decode_step(run, device_ms(run, GEMM, CONV))
