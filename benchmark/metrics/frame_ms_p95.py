"""frame_ms_p95: the 95th percentile (nearest rank), over all the
window's frames, of the time between consecutive frame-end events (the
first from an event recorded as the window opens), in ms."""

from benchmark.harness import p95


def read(run):
    return p95(run.intervals_ms) if run.intervals_ms else None
