"""spawn_device_ms: the device time of a respawn, in ms: the summed
duration of the device operations launched inside the harness's
`bench.spawn` span (`traffic.Feed`, the mix's respawn before a frame's
entry) in the traced stretch, over the respawns in it. Where the host
runs ahead, a respawn frame's interval is its device time, which this
adds to. Nothing to read where the stretch holds no respawn."""


def read(view):
    count, us = view.span_calls.get("spawn", (0, 0.0))
    if not count:
        return None
    return us / count / 1e3
