"""spawn_host_ms: the host's cost of a respawn, in ms: the harness's
host-clock span around the mix's respawn call (`traffic.Feed`, span
`spawn`: `spawn_ball(...).spawn(eng)`, no synchronize), as the mean over
the window's respawns outside the traced stretch. Nothing to read where
the window held no respawn."""


def read(view):
    spans = view.spans.get("spawn")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
