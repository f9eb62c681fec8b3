"""launches_per_frame.replay: ``launches_per_frame`` in the chunked
replay, where it moves the device time a frame (each launch costs the
device a few microseconds however small its work)."""

from .launches_per_frame import read  # noqa: F401
