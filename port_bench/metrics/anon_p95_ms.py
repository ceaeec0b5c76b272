"""The 95th percentile of every anonymize call's latency in the window,
each call ended by a synchronise."""

from port_bench.readers import latency_quantile_ms


def read(run):
    return latency_quantile_ms(run, 95.0)
