"""reorder_device_ms: the device time of the merge reorder's two kernels,
K10 (`compact_kernel`) and K11 (`apply_kernel`, both in
`tendrils_tpu_torch/csrc/reorder.cu`), summed over the traced frames and
divided by their count: ms a frame. Both run in every frame that tries
the merge, whether it keeps the merge's order or falls back to the flat
sort. Nothing to read where neither kernel ran."""

from benchmark.metrics.k2_roofline_pct import kernel_name

REORDER_KERNELS = ("compact_kernel", "apply_kernel")


def launches(view):
    """`{kernel: (launches, device us)}` of K10 and K11 in the stretch."""
    out = {k: (0, 0.0) for k in REORDER_KERNELS}
    for name, s, e in view.device_ops:
        k = kernel_name(name)
        if k in out:
            count, us = out[k]
            out[k] = (count + 1, us + e - s)
    return out


def read(view):
    us = sum(us for _, us in launches(view).values())
    if us <= 0 or not view.frames:
        return None
    return us / 1e3 / view.frames
