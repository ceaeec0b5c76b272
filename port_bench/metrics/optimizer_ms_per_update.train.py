"""Host ms an optimizer update: the mean duration of the program's
``train.optimizer`` spans (the mask, the clip, Adam, the reset) in the
traced window (port_bench/spans.py)."""

from port_bench.spans import mean_ms


def read(run):
    return mean_ms(run, "train.optimizer")
