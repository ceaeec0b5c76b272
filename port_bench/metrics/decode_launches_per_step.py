"""CUDA kernels launched in the traced window per beam-search step."""

from port_bench.readers import per_decode_step


def read(run):
    return per_decode_step(run, len(run.trace.kernels)) if run.trace is not None else None
