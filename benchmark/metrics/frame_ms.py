"""frame_ms: the window's wall time, from its first frame's start to the
synchronize that ends it, over the frames completed in it, in ms."""


def read(run):
    return run.frame_ms
