"""The share of the traced window in which no kernel, copy or set ran on
the device."""

from port_bench.readers import idle_share as read  # noqa: F401
