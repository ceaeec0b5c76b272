"""Audio seconds trained per wall second: the audio of every micro-batch
over the window's start to the last completion."""

from port_bench.readers import audio_rate as read  # noqa: F401
