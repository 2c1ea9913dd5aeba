"""frame_ms_p95.respawn: `frame_ms_p95` where the mix respawns the
particles, read in the traced run as a per-layer metric: the 95th
percentile (nearest rank) of the time between consecutive frame-end
events over the window's frames outside the traced stretch, in ms. With
a respawn before every 10th frame it is the respawn frames' median,
which swings between their device time and their host time with the
host's speed; the end-to-end `frame_ms_p95` is not held there."""

from benchmark.harness import p95


def read(view):
    return p95(view.intervals_ms) if view.intervals_ms else None
