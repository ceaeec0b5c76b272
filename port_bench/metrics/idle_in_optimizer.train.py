"""The share of the traced window in which no kernel ran while the host was
inside a ``train.optimizer`` span (port_bench/spans.py)."""

from port_bench.spans import idle_inside


def read(run):
    return idle_inside(run, "train.optimizer")
