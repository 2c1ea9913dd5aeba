"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA kernels
of the fused draw (`draw_cuda`), the gathers (`gather_cuda`), the point
splat (`splat_cuda`) and the merge reorder (`reorder_cuda`)."""


def not_ported(what, item):
    """The error for a branch the port does not have yet; names its
    ROADMAP.md queue-1 item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})")
