"""Audio seconds anonymized per wall second: the audio of every call over
the window's start to the last completion."""

from port_bench.readers import audio_rate as read  # noqa: F401
