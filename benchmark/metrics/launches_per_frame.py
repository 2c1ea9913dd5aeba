"""launches_per_frame: the host's CUDA runtime launch calls in the traced
frames (`cudaLaunchKernel` and its kin; a CUDA graph's launch counts as
one) over the number of frames."""


def read(view):
    if view.stretch is None or not view.frames:
        return None
    return view.launch_calls / view.frames
