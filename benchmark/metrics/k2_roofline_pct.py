"""k2_roofline_pct: K2's (`tendrils_tpu_torch/csrc/splat.cu`) least time
over its device time in the traced frames, in %.

The device time is the summed duration of the launches of the kernels in
`K2_KERNELS` (its plan, tile pass, stray pass and conversion). The least
time is K2's bytes over the card's published 3.35 TB/s (`trace.bound_ms`),
counted from the cell's shapes as `chip_smoke.splat_work` counts them
(a frozen copy of its byte term, `chip_smoke.py:645-657`): the sorted
stream's i32 words read once, one row a particle (3 words; 4 with the
rgba8 colours of a textured colour map, 5 with the p0 words as well), and
the padded grid's 11 f32 planes written once (6 when the flow channels
are pruned), plus the 128 bytes of its scalars; one K2 call a frame. The
variant, and with it the words, is the one the program's launch counters
name in the stretch. So the count is the same work whatever implements
it. Nothing to read where no kernel of the list ran or the counters name
no single variant.
"""

import re

from benchmark import trace

# The padded grid's geometry, a frozen copy of
# `tendrils_tpu_torch/ops/tile_geom.py:14-25`.
TILE_H, TILE_W = 16, 256
REGION_H, REGION_W = 32, 384
PAD_LO_H, PAD_LO_W = TILE_H, TILE_W
PAD_HI_H, PAD_HI_W = REGION_H, REGION_W

K2_KERNELS = ("splat_plan_kernel", "splat_tile_kernel",
              "splat_stray_kernel", "splat_convert_kernel")
# The program's counter of each K2 variant -> (i32 words a row, planes).
VARIANTS = {
    "splat": (3, 11), "splat_rgba": (4, 11), "splat_p0_rgba": (5, 11),
    "splat_view": (3, 6), "splat_rgba_view": (4, 6),
    "splat_p0_rgba_view": (5, 6),
}


def pad_dims(h, w):
    hp = (PAD_LO_H + h + PAD_HI_H + TILE_H - 1) // TILE_H * TILE_H
    wp = (PAD_LO_W + w + PAD_HI_W + TILE_W - 1) // TILE_W * TILE_W
    return hp, wp


def k2_bytes(n, grid_hw, words, planes):
    """K2's bytes for `n` rows on a `grid_hw` grid."""
    hp, wp = pad_dims(*grid_hw)
    return 4 * words * n + planes * hp * wp * 4 + 128


def kernel_name(name):
    """A trace's kernel name without its return type, namespaces and
    arguments: `(anonymous namespace)::splat_tile_kernel(Params, ...)` ->
    `splat_tile_kernel`."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return re.split(r"[\s:]+", name.strip())[-1]


def read(view):
    variants = [k for k in view.counters if k in VARIANTS]
    if len(variants) != 1 or not view.frames:
        return None
    us = sum(e - s for name, s, e in view.device_ops
             if kernel_name(name) in K2_KERNELS)
    if us <= 0:
        return None
    words, planes = VARIANTS[variants[0]]
    eng = view.config["engine"]
    n = eng["root_num"] ** 2
    nbytes = k2_bytes(n, tuple(eng["view_res"]), words, planes)
    return 100.0 * trace.bound_ms(nbytes * view.frames) / (us / 1e3)
