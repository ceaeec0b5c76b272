"""Device ms a beam-search step between the CUDA events of the program's
``decode.ctc`` spans (the CTC prefix scorer's scoring, and its advance of the
chosen prefixes' state, each with any idle time inside it), summed over the
traced window and divided by its ``decode.step`` spans (port_bench/spans.py)."""

from port_bench.spans import device_ms_per


def read(run):
    return device_ms_per(run, "decode.ctc", "decode.step")
