"""frames_per_s.replay: ``frames_per_s`` read in the cells whose host clock
spreads too widely for a bound (the chunked replay): every frame whose
pose came back in the window, over all the time of the window."""

from .frames_per_s import read  # noqa: F401
