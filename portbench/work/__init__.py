"""The yardstick's work counts and the table of peaks."""

import json
import os


def load_peaks() -> dict:
    """The chip's published peaks (``peaks.json``)."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)
