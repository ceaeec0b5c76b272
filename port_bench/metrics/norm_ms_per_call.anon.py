"""Device ms per anonymize call of the traced window in the blocks'
epilogue kernels, matched by name: K8 (``norm_silu_*``, where the program
has it), cuDNN's batch norm (``bn_fw_*``, which runs PyTorch's InstanceNorm),
and PyTorch's elementwise kernels (the convolutions' bias adds, the SiLU's
sigmoid and multiply, and the frontend normalizer's few small ones)."""

import re

from port_bench.readers import device_ms

EPILOGUE = re.compile(r"\bnorm_silu_\w+|bn_fw_|elementwise_kernel")


def read(run):
    ms = device_ms(run, EPILOGUE)
    return ms / len(run.calls) if ms is not None and run.calls else None
