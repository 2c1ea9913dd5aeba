"""host_ms: the host's dispatch cost of a frame. The harness's host-clock
span around its calls into the program for one frame (the entry and the
input modules, no synchronize; `traffic.Feed`, span `frame`), as the mean
over the window's frames outside the traced stretch, in ms."""


def read(view):
    spans = view.spans.get("frame")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
