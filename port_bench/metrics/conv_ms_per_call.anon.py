"""Device ms in convolution kernels (cuDNN) per anonymize call of the
traced window."""

from port_bench.readers import CONV, device_ms


def read(run):
    ms = device_ms(run, CONV)
    return ms / len(run.calls) if ms is not None and run.calls else None
