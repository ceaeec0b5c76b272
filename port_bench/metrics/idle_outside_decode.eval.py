"""The share of the traced window in which no kernel ran while the host was
inside no ``decode`` span: the test stage's work around its decodes
(port_bench/spans.py)."""

from port_bench.spans import idle_outside


def read(run):
    return idle_outside(run, "decode")
