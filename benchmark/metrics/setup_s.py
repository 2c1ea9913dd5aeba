"""setup_s: from the process's start to the window's: the imports, the
kernels' build or load, the engine's set-up and spawn on the device, the
mix's warm frames, in s."""


def read(run):
    return run.setup_s
