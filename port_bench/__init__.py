"""The benchmark of ``speech_anonymization_tpu_torch``: ``python -m port_bench.run``."""
