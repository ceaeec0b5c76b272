"""Host ms a beam-search step: the mean duration of the program's
``decode.step`` spans in the traced window (port_bench/spans.py)."""

from port_bench.spans import mean_ms


def read(run):
    return mean_ms(run, "decode.step")
