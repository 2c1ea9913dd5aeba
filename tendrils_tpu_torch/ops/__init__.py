"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA kernels
of the fused draw (`draw_cuda`), the gathers (`gather_cuda`), the point
splat (`splat_cuda`) and the merge reorder (`reorder_cuda`)."""
