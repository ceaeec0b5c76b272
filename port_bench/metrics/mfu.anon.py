"""Model FLOPs of the traced window's calls over its wall time at the
configuration's peak (port_bench/flops.py, port_bench/work.py)."""

from port_bench.readers import mfu as read  # noqa: F401
