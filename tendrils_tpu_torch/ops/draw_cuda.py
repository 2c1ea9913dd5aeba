"""Fused draw: both render passes (flow payload + view colour) from ONE
segment sort, on hand-written CUDA kernels.

The port of `tendrils_tpu/ops/draw_pallas.py`, with in-kernel line widths
up to `KMAX_WIDTH`, in the four gather modes (`gather_mode`), which say how
the row ids cross the sort: 0 none; 1 the combined `tile << 20 | row id`
key (up to 2^20 rows and 2048 tiles); 3, resident frames beyond that,
`tile << 19 | id & (2^19 - 1)` with the id's five high bits hidden in the
low mantissa bits of the riding positions (x: 2, y: 3) and cleared after
the sort; 2 the tile alone, the ids a stream of their own:

  K1 `pack`    (csrc/pack.cu)    per segment: sort key, fixed-point p1,
                                 q15 velocity word with the live bit, and
                                 optionally the fixed-point p0 word and the
                                 rgba8 colour word;
  sort         `torch.sort` of the key (the JAX package sorts with
               `lax.sort` too), the other streams follow by index; or, on
               resident frames that carry the previous order
               (`reorder=`), the merge reorder (`reorder_cuda`: K10, K11),
               falling back to the sort when its guards trip;
  K2 `splat`   (csrc/splat.cu)   box-footprint deposits into the padded
                                 11-channel accumulator: per output tile
                                 (in shared memory) the samples that fit
                                 their key tile's region, then per
                                 (segment, sample) the strays (global
                                 atomics); three launches;
  K3 `resolve` (csrc/resolve.cu) per pixel: order-independent blend of
                                 both grids, fade, the decayed flow `eff`;
                                 or the XLA resolve tail (`_widen_excess`,
                                 `composite_over`) for line widths above
                                 `KMAX_WIDTH` and the paused draw;
  K6 `reconstruct_resident` (csrc/gather.cu) per sorted row: the state
                                 reassembly alone, for frames that gather
                                 the force after editing the flow.

Two stream layouts reach the splat. The resident frame (a step just before
the draw) derives p0 in the splat from p1 and the velocity (`derive_p0`),
its sort key from the same re-derivation (`key_recon`). Every other draw
sends the exact p0 word and keys by it. Colours come from a 1x1 colour
map's four scalars, computed in the splat, or, for a textured map, as the
rgba8 word K1 packs. K1 and K2 are one kernel each whose optional streams
are switched by null pointers; each variant counts under its own name
(`pack`, `pack_rgba`, `pack_p0_rgba`, with `_g2` or `_g3` in gather modes
2 and 3; `splat`, `splat_rgba`, `splat_p0_rgba`; `_variant`).

Each kernel's wrapper takes the plain PyTorch version (`pack_plain`,
`splat_plain`, `resolve_plain`, `reconstruct_resident_plain`) when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device. The packed words, the keys and the sorted order are the
reference's contracts and match it bit for bit; the accumulator is summed
in f32 (the TPU's matmul operands are bf16) with shared and global float
atomics, in run-dependent order.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..const import INERT
from . import cuda_lib, not_ported, reorder_cuda
from .splat import composite_over
from .tile_geom import HALF, PAD_LO_H, PAD_LO_W, TILE_H, TILE_W, pad_dims

N_CHAN = 11
# flow channels (vx·α, vy·α, wf·α, α, log(1-α)) lead the stack, then the
# view's (r·α, g·α, b·α, a·α, α, log(1-α)).
N_FLOW = 5
# Gather mode 1 (the combined 20-bit key|id word) bounds.
G1_MAX_ROWS = 1 << 20
G1_MAX_TILES = 1 << 11
# Gather mode 3 (resident, beyond mode 1): the id's low PACK_IDX_BITS share
# the key word, its high bits (at most 5) ride the positions' LSBs.
PACK_IDX_BITS = 19
PACK_MAX_TILES = 1 << 12
PACK_MAX_IDS = 1 << 24
COLOR_MAX = 4.0
KMAX_WIDTH = 8.0
KSPAN = 9  # texels a box of width <= KMAX_WIDTH can touch along one axis
MAX_BLUR = 32  # the XLA tail's largest box-blur radius

_F32 = torch.float32
_I32 = torch.int32


def _pos_scale(hp, wp):
    """Subpixel steps per pixel (power of two) so coords fit 15 bits."""
    p = 64
    while p > 1 and max(hp, wp) * p > HALF:
        p //= 2
    return p


def pos_scale_for(grid_hw):
    """The fixed-point sub-pixel scale the fused draw uses for `grid_hw`."""
    return _pos_scale(*pad_dims(*grid_hw))


def _vec(v, device):
    """`v` as a flat f32 tensor on `device`. Numbers become device fills,
    never host-to-device copies, so building the scalars does not wait
    for the device."""
    if isinstance(v, (int, float)):
        return torch.full((1,), float(v), dtype=_F32, device=device)
    return torch.as_tensor(v, dtype=_F32, device=device).reshape(-1)


def seg_tile_count(grid_hw):
    """Tile count of the fused draw's segment keys for `grid_hw`: the
    merge-reorder carry histogram's length (`engine.seed_sort_carry`)."""
    hp, wp = pad_dims(*grid_hw)
    return (hp // TILE_H) * (wp // TILE_W)


def gather_mode(n, num_tiles, *, ids, resident, idx_bound=None):
    """How a draw's row ids cross its sort (`draw_pallas.py:1148-1174`,
    condition for condition; the port has no pad rows): 0 without ids; 1
    (`tile << 20 | id`) when the rows, the tiles and `idx_bound` (an
    exclusive bound on the id values) fit; 3 on a `resident` stream
    (exact positions riding the sort) within PACK_MAX_TILES and
    PACK_MAX_IDS; else 2."""
    if not ids:
        return 0
    if n <= G1_MAX_ROWS and num_tiles <= G1_MAX_TILES \
            and (idx_bound is None or idx_bound <= n):
        return 1
    if resident and num_tiles <= PACK_MAX_TILES \
            and (n if idx_bound is None else idx_bound) <= PACK_MAX_IDS:
        return 3
    return 2


def _idx_bits(gather):
    """Bits of the row id in the sort key (0: the key is the tile)."""
    return {1: 20, 3: PACK_IDX_BITS}.get(gather, 0)


def _variant(kernel, p0, rgba, gather=0):
    """Counter name of a K1/K2 variant: `kernel[_p0][_rgba][_g2|_g3]`."""
    return (kernel + ("_p0" if p0 else "") + ("_rgba" if rgba else "")
            + (f"_g{gather}" if gather in (2, 3) else ""))


def _unq15(q):
    """q15 field -> [-1, 1] (`q * f32(2/HALF) - 1`)."""
    return q.to(_F32) * (2.0 / HALF) - 1.0


def _qpos(x, y, grid_hw, pscale):
    """Window px -> fixed-point words, clamped into the padded margin."""
    h, w = grid_hw
    xp = torch.clamp(x + PAD_LO_W, 1.0, PAD_LO_W + w + 1.0)
    yp = torch.clamp(y + PAD_LO_H, 1.0, PAD_LO_H + h + 1.0)
    return (torch.round(xp * pscale).to(_I32),
            torch.round(yp * pscale).to(_I32))


def _q15(v):
    t = torch.clamp((v + 1.0) / 2.0, 0.0, 1.0)
    return torch.round(t * HALF).to(_I32)


# --- K1 pack -----------------------------------------------------------------


def pack(scal, p1_pix, vel, live, idx, *, grid_hw, pscale, p0_pix=None,
         pos=None, mapped=None, gather=None):
    """K1: per-segment sort key, p1 and velocity words (`i32[N]` each),
    and optionally the p0 and rgba8 words.

    `scal`: `f32[32]` per-frame scalars (`_draw_scal`); `p1_pix`: `f32[N, 2]`
    end points in window px; `vel`: `f32[2, N]`; `live`: `f32[N]`; `idx`:
    `i32[N]` row ids or None; `gather` (1 with ids, 0 without, by default):
    key = tile << 20 | id in mode 1, tile << 19 | (id & (2^19 - 1)) in
    mode 3, the tile alone in modes 0 and 2 (mode 2's ids ride the sort
    apart). With `p0_pix` (`f32[N, 2]`) the p0 word is emitted
    and the key comes from the exact quantised p0 (`emit_p0`); without it,
    from the p0 the splat re-derives from p1 and the velocity
    (`key_recon`). With `mapped` (`f32[4, N]`, the colour-map lookup times
    colorMapAlpha) and `pos` (`f32[2, N]` NDC positions, for the vignette)
    the render colour model is packed to an rgba8 word (`emit_rgba`).
    Returns `(keym, p1, vl, p0 or None, rgba or None)`."""
    gather = _check_gather(idx, gather)
    tensors = [t for t in (scal, p1_pix, vel, live, idx, p0_pix, pos, mapped)
               if t is not None]
    if cuda_lib.on_cpu(*tensors):
        return pack_plain(scal, p1_pix, vel, live, idx, grid_hw=grid_hw,
                          pscale=pscale, p0_pix=p0_pix, pos=pos,
                          mapped=mapped, gather=gather)
    n = p1_pix.shape[0]
    h, w = grid_hw
    cuda_lib.check(scal, "scal", _F32, (32,))
    cuda_lib.check(p1_pix, "p1_pix", _F32, (n, 2))
    cuda_lib.check(vel, "vel", _F32, (2, n))
    cuda_lib.check(live, "live", _F32, (n,))
    if idx is not None:
        cuda_lib.check(idx, "idx", _I32, (n,))
    if p0_pix is not None:
        cuda_lib.check(p0_pix, "p0_pix", _F32, (n, 2))
    if mapped is not None:
        cuda_lib.check(mapped, "mapped", _F32, (4, n))
        cuda_lib.check(pos, "pos", _F32, (2, n))

    def new():
        return torch.empty(n, dtype=_I32, device=p1_pix.device)

    keym, p1, vl = new(), new(), new()
    p0 = None if p0_pix is None else new()
    rgba = None if mapped is None else new()
    tiles_x = pad_dims(h, w)[1] // TILE_W
    bits = _idx_bits(gather)
    cuda_lib.launch("tt_pack", _variant("pack", p0 is not None,
                                        rgba is not None, gather),
                    scal, p1_pix, vel, live, idx if bits else None, p0_pix,
                    None if mapped is None else pos, mapped, n, h, w,
                    tiles_x, bits, float(pscale), keym, p1, vl, p0, rgba)
    return keym, p1, vl, p0, rgba


def _check_gather(idx, gather):
    """`gather` for K1's `idx` (1 with ids, 0 without, by default)."""
    if gather is None:
        gather = 0 if idx is None else 1
    if gather not in (0, 1, 2, 3) or (idx is None) != (gather == 0):
        raise ValueError(f"gather mode {gather} with idx "
                         f"{'absent' if idx is None else 'given'}")
    return gather


def _color_model(scal, vnx, vny, posx, posy, mapped):
    """The render colour model (`src/render/index.vert:57-94`) of segments
    with velocity / speedLimit `vnx`, `vny` at NDC positions `posx`, `posy`
    and colour-map values `mapped = (r, g, b, a)`: `[r, g, b, a]` before
    any clamp or quantisation, op for op as `draw_pallas._emit_render_rgba`
    (K1's rgba8 word) and the splat's scalar colour (K2), which share it."""
    mr, mg, mb, ma = mapped
    base, flow_c = scal[7:11], scal[11:15]
    speed_rate = torch.clamp(
        (vnx * vnx + vny * vny) / torch.clamp(scal[4], min=1e-12), max=1.0)
    al0 = vnx
    al1 = vnx * -0.5 + vny * -0.8660254037844385
    al2 = vnx * -0.5 + vny * 0.8660254037844387
    k1 = 1.0 - scal[6]
    sin_decay = scal[5]

    def falign(a_, a_gbr):
        return (a_ + (a_gbr * k1 - a_) * sin_decay) * 0.5 + 0.5

    fa = (falign(al0, al1), falign(al1, al2), falign(al2, al0))

    def clip01(v):
        return torch.clamp(v, 0.0, 1.0)

    rgb = [clip01(base[k] * base[3]) + clip01((mr, mg, mb)[k] * ma)
           + clip01(flow_c[k] * fa[k] * flow_c[3]) for k in range(3)]
    ca = clip01(base[3]) + clip01(ma) + clip01(flow_c[3])
    d = torch.sqrt(posx * posx + posy * posy)
    amt = torch.clamp(1.0 - d, max=1.0)
    ut = 1.0 - amt
    bz = (0.2 * ut + amt) * ut + amt
    vig = torch.clamp(torch.clamp(bz, min=0.0), 0.2, 1.0)
    return [*rgb, ca * speed_rate * vig]


def _render_rgba(scal, vnx, vny, posx, posy, mapped):
    """The render colour model packed to rgba8
    (`draw_pallas._emit_render_rgba`): r, g, b take 255 levels of [0,
    COLOR_MAX], a 127 (bit 31 stays clear)."""
    r, g, b, a = _color_model(scal, vnx, vny, posx, posy, mapped)

    def q8(v, levels):
        return torch.round(torch.clamp(v / COLOR_MAX, 0.0, 1.0)
                           * levels).to(_I32)

    return (q8(r, 255) + q8(g, 255) * 256 + q8(b, 255) * 65536
            + q8(a, 127) * 16777216)


def pack_plain(scal, p1_pix, vel, live, idx, *, grid_hw, pscale, p0_pix=None,
               pos=None, mapped=None, gather=None):
    """Plain version of K1 (`draw_pallas._pack_core`)."""
    gather = _check_gather(idx, gather)
    cuda_lib.plain_calls[_variant("pack", p0_pix is not None,
                                  mapped is not None, gather)] += 1
    h, w = grid_hw
    tiles_x = pad_dims(h, w)[1] // TILE_W
    sl_raw = scal[0]
    sl = torch.clamp(sl_raw, min=1e-12)
    x1q, y1q = _qpos(p1_pix[:, 0], p1_pix[:, 1], grid_hw, pscale)
    p1 = y1q * (HALF + 1) + x1q
    vnx = vel[0] / sl
    vny = vel[1] / sl
    qx = _q15(vnx)
    qy = _q15(vny)
    live_bit = (live > 0.5).to(_I32) * (1 << 30)
    vl = live_bit + qy * (HALF + 1) + qx
    rgba = None if mapped is None else _render_rgba(scal, vnx, vny, pos[0],
                                                    pos[1], mapped)

    hwm = torch.maximum(torch.clamp(scal[2], 1.0, KMAX_WIDTH),
                        torch.clamp(scal[3], 1.0, KMAX_WIDTH)) * 0.5
    inv_p = 1.0 / pscale
    p0 = None
    if p0_pix is None:
        # Key from the p0 the splat will reconstruct (bit for bit).
        p1xd = x1q.to(_F32) * inv_p
        p1yd = y1q.to(_F32) * inv_p
        p0xd = torch.clamp(
            p1xd - _unq15(qx) * sl_raw * (scal[30] * 0.5 * w), 1.0,
            PAD_LO_W + w + 1.0)
        p0yd = torch.clamp(
            p1yd - _unq15(qy) * sl_raw * (scal[31] * 0.5 * h), 1.0,
            PAD_LO_H + h + 1.0)
        top_x = torch.clamp(torch.minimum(p0xd, p1xd) - hwm, min=0.0)
        top_y = torch.clamp(torch.minimum(p0yd, p1yd) - hwm, min=0.0)
    else:
        x0q, y0q = _qpos(p0_pix[:, 0], p0_pix[:, 1], grid_hw, pscale)
        p0 = y0q * (HALF + 1) + x0q
        top_x = torch.clamp(torch.minimum(x0q, x1q).to(_F32) * inv_p - hwm,
                            min=0.0)
        top_y = torch.clamp(torch.minimum(y0q, y1q).to(_F32) * inv_p - hwm,
                            min=0.0)
    krow = torch.floor(top_y).to(_I32) // TILE_H
    kcol = torch.floor(top_x).to(_I32) // TILE_W
    key = krow * tiles_x + kcol
    bits = _idx_bits(gather)
    keym = key if not bits else key * (1 << bits) + (idx & ((1 << bits) - 1))
    return keym, p1, vl, p0, rgba


# --- K2 splat ----------------------------------------------------------------

# Launches of one `splat` call, each counted under the variant's name: the
# plan, the tile pass and the stray pass (`csrc/splat.cu`).
SPLAT_LAUNCHES = 3
# Words of K2's plan: per output tile (`INFO`) the run starts of its source
# tiles, its parts and its weighted rows; the queue's head, the counts of
# queued parts and of strays, before its (tile, part) pairs.
SPLAT_INFO = 8
SPLAT_QUEUE_HEAD = 2


def splat(scal, keym_s, p1, vl, *, idx_bits, samples, grid_hw, pscale,
          p0=None, rgba=None):
    """K2: expand each sorted segment into `samples` deposit points and
    accumulate both passes' box footprints. `keym_s`: the tile-sorted
    keys, `tile << idx_bits | id` (`_idx_bits`); `p0`: the sorted p0
    words, or None to derive p0 from p1 and the velocity; `rgba`: the
    sorted rgba8 words, or None to compute the colour model of a 1x1
    colour map from the scalars. Returns the padded accumulator `f32[N_CHAN,
    hp, wp]`, every texel written by the kernels (`csrc/splat.cu`: the
    plan that finds each output tile's source rows in the sorted keys,
    the tile pass that adds each sample fitting its key tile's region in
    shared memory, and the stray pass for the rest)."""
    tensors = [t for t in (scal, keym_s, p1, vl, p0, rgba) if t is not None]
    if cuda_lib.on_cpu(*tensors):
        return splat_plain(scal, p1, vl, samples=samples, grid_hw=grid_hw,
                           pscale=pscale, p0=p0, rgba=rgba)
    return splat_planned(scal, keym_s, p1, vl, idx_bits=idx_bits,
                         samples=samples, grid_hw=grid_hw, pscale=pscale,
                         p0=p0, rgba=rgba)[0]


def splat_planned(scal, keym_s, p1, vl, *, idx_bits, samples, grid_hw,
                  pscale, p0=None, rgba=None):
    """`splat`'s three launches on CUDA tensors: `(accum, info, queue)`,
    the accumulator and the plan it ran (per tile `SPLAT_INFO` words: the
    run starts of its source tiles above-left, above, left and its own,
    and the end of its own, at 0-5, its parts at 6, its weighted rows at
    7; the queue's counts of parts and strays at 0 and 1)."""
    n = p1.shape[0]
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    cuda_lib.check(scal, "scal", _F32, (32,))
    for t, name in ((keym_s, "keym_s"), (p1, "p1"), (vl, "vl"), (p0, "p0"),
                    (rgba, "rgba")):
        if t is not None:
            cuda_lib.check(t, name, _I32, (n,))
    tiles_y, tiles_x = splat_tiles(grid_hw)
    chunk = split_chunk(n)
    cap = queue_cap(n, chunk)
    dev = p1.device
    accum = torch.empty((N_CHAN, hp, wp), dtype=_F32, device=dev)
    info = torch.empty(SPLAT_INFO * tiles_y * tiles_x, dtype=_I32,
                       device=dev)
    queue = torch.empty(SPLAT_QUEUE_HEAD + 2 * cap, dtype=_I32, device=dev)
    name = _variant("splat", p0 is not None, rgba is not None)
    cuda_lib.launch("tt_splat_plan", name, keym_s, n, idx_bits, hp, wp,
                    chunk, info, queue, cap, accum)
    args = (scal, keym_s, p1, vl, p0, rgba, n, samples, h, w, hp, wp,
            idx_bits, float(pscale))
    cuda_lib.launch("tt_splat_tiles", name, *args, info, queue, cap, accum)
    cuda_lib.launch("tt_splat_strays", name, *args, queue, accum)
    return accum, info, queue


def _scalar_colors(scal, vx, vy, p1x, p1y, grid_hw):
    """Render colour model of a 1x1 colour map (draw_pallas `_kernel`
    scalar_color) from the un-quantised velocity, the vignette position
    derived from p1 -> (r, g, b, a) clamped to [0, COLOR_MAX]."""
    h, w = grid_hw
    inv_sl = 1.0 / torch.clamp(scal[0], min=1e-12)
    posx = ((p1x - PAD_LO_W) * (2.0 / w) - 1.0) \
        / torch.clamp(scal[30], min=1e-12)
    posy = ((p1y - PAD_LO_H) * (2.0 / h) - 1.0) \
        / torch.clamp(scal[31], min=1e-12)
    return [torch.clamp(c, 0.0, COLOR_MAX) for c in _color_model(
        scal, vx * inv_sl, vy * inv_sl, posx, posy, scal[16:20])]


def _cover(idx, lo, hi):
    """Box-overlap coverage of texel `idx` by the footprint [lo, hi)."""
    return torch.clamp(torch.minimum(idx + 1.0, hi) - torch.maximum(idx, lo),
                       0.0, 1.0)


def _splat_terms(scal, p1, vl, *, samples, grid_hw, pscale, p0=None,
                 rgba=None):
    """K2's per-sample arithmetic over all segments and samples at once:
    `(gx, gy, groups)`, the quantised centres `f32[S, N]` and, for the
    flow and the view channel group, `(chans [C, S, N], first plane, 1 /
    width, (lo_y, hi_y, floor lo_y), (lo_x, hi_x, floor lo_x))`."""
    h, w = grid_hw
    dev = p1.device
    sl = scal[0]
    inv_p = 1.0 / pscale
    p1x = (p1 & HALF).to(_F32) * inv_p
    p1y = (p1 >> 15).to(_F32) * inv_p
    live = (vl >> 30).to(_F32)
    vel_u = vl & ((1 << 30) - 1)
    vx = _unq15(vel_u & HALF) * sl
    vy = _unq15(vel_u >> 15) * sl
    if p0 is None:
        # derive_p0: Euler inverse in pixel space.
        p0x = torch.clamp(p1x - vx * (scal[30] * 0.5 * w), 1.0,
                          PAD_LO_W + w + 1.0)
        p0y = torch.clamp(p1y - vy * (scal[31] * 0.5 * h), 1.0,
                          PAD_LO_H + h + 1.0)
    else:
        p0x = (p0 & HALF).to(_F32) * inv_p
        p0y = (p0 >> 15).to(_F32) * inv_p
    dx = p1x - p0x
    dy = p1y - p0y
    ascale = live * torch.clamp(torch.maximum(dx.abs(), dy.abs()), min=1.0) \
        / samples
    if rgba is None:
        cr, cg, cb, ca = _scalar_colors(scal, vx, vy, p1x, p1y, grid_hw)
    else:
        c8 = COLOR_MAX / 255.0
        cr, cg, cb = (((rgba >> k) & 255).to(_F32) * c8 for k in (0, 8, 16))
        ca = ((rgba >> 24) & 127).to(_F32) * (COLOR_MAX / 127.0)
    wf = torch.clamp(torch.sqrt(vx * vx + vy * vy) / sl, max=1.0)

    # All samples at once: [S, N].
    ts = torch.tensor([(s + 0.5) / samples for s in range(samples)],
                      dtype=_F32, device=dev)[:, None]
    xu = p0x + dx * ts
    yu = p0y + dy * ts
    xp = torch.clamp(xu, 1.0, PAD_LO_W + w + 1.0)
    yp = torch.clamp(yu, 1.0, PAD_LO_H + h + 1.0)
    a = torch.where((xu != xp) | (yu != yp), 0.0, ascale)
    gx = torch.round(xp * pscale) * inv_p - 0.5
    gy = torch.round(yp * pscale) * inv_p - 0.5
    av = torch.clamp(ca * a, 0.0, 1.0 - 1e-4)
    af = torch.clamp(wf * a, max=1.0 - 1e-4)
    groups = []
    for chans, ch0, width in (
            (torch.stack([vx * af, vy * af, wf * af, af, torch.log1p(-af)]),
             0, scal[2]),
            (torch.stack([cr * av, cg * av, cb * av, ca * av, av,
                          torch.log1p(-av)]), N_FLOW, scal[3])):
        width = torch.clamp(width, 1.0, KMAX_WIDTH)
        hw = width * 0.5
        lo_y, hi_y = gy + (0.5 - hw), gy + (0.5 + hw)
        lo_x, hi_x = gx + (0.5 - hw), gx + (0.5 + hw)
        groups.append((chans, ch0, 1.0 / width,
                       (lo_y, hi_y, torch.floor(lo_y)),
                       (lo_x, hi_x, torch.floor(lo_x))))
    return gx, gy, groups


def _add_boxes(accum, groups, hp, wp):
    """Add the box footprints of `groups` (`_splat_terms`) into the flat
    `f32[N_CHAN * hp * wp]` accumulator with one `index_add_` per
    footprint offset (<= 9 x 9 offsets, both channel groups and all
    samples at once)."""
    for oy in range(KSPAN):
        for ox in range(KSPAN):
            index, value = [], []
            for chans, ch0, inv_w, (lo_y, hi_y, r0), (lo_x, hi_x, c0) \
                    in groups:
                r = r0 + oy
                c = c0 + ox
                wr = _cover(r, lo_y, hi_y) * inv_w
                wc = _cover(c, lo_x, hi_x)
                ok = (wr > 0) & (wc > 0) & (r >= 0) & (r < hp) \
                    & (c >= 0) & (c < wp)
                value.append(torch.where(ok, (wr * chans) * wc, 0.0))
                planes = (ch0 + torch.arange(len(chans), device=r.device)) \
                    * (hp * wp)
                texel = (torch.clamp(r, 0, hp - 1) * wp
                         + torch.clamp(c, 0, wp - 1)).to(torch.int64)
                index.append(planes[:, None, None] + texel)
            accum.index_add_(0, torch.cat([i.reshape(-1) for i in index]),
                             torch.cat([v.reshape(-1) for v in value]))
    return accum


def splat_plain(scal, p1, vl, *, samples, grid_hw, pscale, p0=None,
                rgba=None):
    """Plain version of K2: the same per-sample arithmetic, deposited with
    one `index_add_` per footprint offset (<= 9 x 9 offsets, both channel
    groups and all samples at once)."""
    cuda_lib.plain_calls[_variant("splat", p0 is not None,
                                  rgba is not None)] += 1
    hp, wp = pad_dims(*grid_hw)
    _, _, groups = _splat_terms(scal, p1, vl, samples=samples,
                                grid_hw=grid_hw, pscale=pscale, p0=p0,
                                rgba=rgba)
    accum = torch.zeros(N_CHAN * hp * wp, dtype=_F32, device=p1.device)
    return _add_boxes(accum, groups, hp, wp).reshape(N_CHAN, hp, wp)


# --- K2's tile partition -----------------------------------------------------
# The contract K2's tile pass rests on (`draw_pallas.py:82-85`, `:255-263`):
# the segments arrive tile-sorted, a segment's key tile is the top-left
# corner of its bounding box, and a sample whose footprint lies inside its
# key tile's REGION_H x REGION_W region deposits only into the 2 x 2
# output tiles from there. The tile ranges, the parts and the fit test are
# `csrc/splat.cu`'s; `tests/test_torch_splat_tiles.py` holds them, in a
# Python transcription, to the reference's rule.


def splat_tiles(grid_hw):
    """`(tiles_y, tiles_x)` of the padded grid: `pad_dims` rounds it to
    whole tiles, so the tiles cover it exactly."""
    hp, wp = pad_dims(*grid_hw)
    return hp // TILE_H, wp // TILE_W


def split_chunk(n):
    """The most weighted rows (`csrc/splat.cu` W_DIAG..W_OWN, sixteenths
    of a row by source tile) one tile-pass block takes: a tile whose
    source rows weigh more is split into parts that add into it with
    global atomics. The weights of all tiles sum to 26n; a part stays
    under 1/520 of that (~264 blocks run at once on an H100), and a tile
    of uniform density at configs 2 and 3 stays whole."""
    return max(4096, n // 20)


def queue_cap(n, chunk):
    """Room for the parts of split tiles: a split tile weighs over `chunk`
    and has at most `2 weight / chunk` parts, and the weights of all tiles
    sum to 26n."""
    return -(-2 * 26 * n // chunk)


# --- sort + orchestration --------------------------------------------------


def _draw_scal(speed_limit, time, flow_width, line_width, speed_alpha,
               sin_decay, flow_decay, base_color, flow_color, mapped_scalar,
               view_size, device):
    """The per-frame scalars as one `f32[32]` device tensor, in the JAX
    `scal` layout (draw_pallas.py:1188-1202): no launch reads a device
    value back to the host."""
    return torch.cat([_vec(v, device) for v in (
        speed_limit, time, flow_width, line_width, speed_alpha, sin_decay,
        flow_decay, base_color, flow_color, 0.0, mapped_scalar,
        torch.zeros(10, device=device), view_size)])


def _hide_id_bits(ride, idx):
    """Gather mode 3: the ids' bits above PACK_IDX_BITS into the low
    mantissa bits of the riding positions (x: 2, y: 3;
    `draw_pallas.py:1175-1183`), through an int32 view of their bits."""
    hi = idx >> PACK_IDX_BITS
    xi = ride[0].view(_I32)
    yi = ride[1].view(_I32)
    return [((xi & ~3) | (hi & 3)).view(_F32),
            ((yi & ~7) | (hi >> 2)).view(_F32)]


def _read_ok(ok):
    """The merge's `ok` on the host: the merge frame's one synchronisation
    (a function of its own so that `frame_profile.py` can time it)."""
    return bool(ok)


def _merge_or_sort(keym, reorder, n_tiles, idx_bits):
    """The merge reorder against the carried order `reorder = (prev_key,
    prev_hist)` (`reorder_cuda.merge_reorder`, K10 and K11), or the flat
    sort when its guards trip. Its `ok` is read on the host, the frame's
    one synchronisation (the JAX package picks with `lax.cond` on the
    device); each read counts in `cuda_lib.events` as `reorder_merged` or
    `reorder_fallback`. Returns `(keym_s, perm, carry)`, carry = the
    sorted keys and their tile census, the next frame's `reorder`."""
    ok, keym_s, perm, hist = reorder_cuda.merge_reorder(
        keym, *reorder, n_tiles=n_tiles, idx_bits=idx_bits)
    if _read_ok(ok):
        cuda_lib.events["reorder_merged"] += 1
    else:
        cuda_lib.events["reorder_fallback"] += 1
        keym_s, perm = torch.sort(keym)
        hist = reorder_cuda.tile_hist(keym >> idx_bits, n_tiles)
    return keym_s, perm, (keym_s, hist)


def _bin_and_splat(scal, words, ride, *, idx, gather, samples, grid_hw,
                   pscale, reorder=None):
    """Sort the segments by their key, then splat them (K2).

    `words`: K1's `(keym, p1, vl, p0, rgba)`, p0 and rgba None when not
    emitted. `ride`: the exact f32 positions `[x, y]` riding the sort
    (resident stream), or None; in gather mode 3 they carry the ids' high
    bits, which are read back and cleared after the sort (the cleaned
    positions are what every later stage sees). In gather mode 1 keys are
    unique, so the order is fully determined; in modes 0, 2 and 3 only the
    key order is (mode 3 keys tie where ids share their low bits and tile;
    the deposits are sums and the ids follow their rows). With `ride`, the
    sorted p1 word is recomputed from the sorted exact positions (the JAX
    `p1_from_ride`: the same f32 pixel transform, clip and round as the
    pack, so bit-identical); without it, p1 is sorted. `reorder`: the
    merge reorder's carry (`_merge_or_sort`) in place of the sort.
    Returns `(accum, aux, ride_sorted, carry)`: aux = `(idx_s, p1_s)`, the
    sorted row ids (from the key in modes 1 and 3, sorted along in mode 2)
    and p1 words (None in mode 0), ride_sorted = `[x_s, y_s, vl_s]` (None
    without `ride`), carry None without `reorder`."""
    h, w = grid_hw
    keym, p1, vl, p0, rgba = words
    carry = None
    if reorder is None:
        keym_s, perm = torch.sort(keym)
    else:
        keym_s, perm, carry = _merge_or_sort(
            keym, reorder, seg_tile_count(grid_hw), _idx_bits(gather))
    vl_s = vl[perm]
    p0_s = None if p0 is None else p0[perm]
    rgba_s = None if rgba is None else rgba[perm]
    ride_s = None
    if ride is None:
        p1_s = p1[perm]
    else:
        x_s, y_s = ride[0][perm], ride[1][perm]
        if gather == 3:
            xi, yi = x_s.view(_I32), y_s.view(_I32)
            id_hi = ((xi & 3) << PACK_IDX_BITS) \
                | ((yi & 7) << (PACK_IDX_BITS + 2))
            x_s, y_s = (xi & ~3).view(_F32), (yi & ~7).view(_F32)
        x1q, y1q = _qpos((x_s * scal[30] * 0.5 + 0.5) * w,
                         (y_s * scal[31] * 0.5 + 0.5) * h, grid_hw, pscale)
        p1_s = y1q * (HALF + 1) + x1q
        ride_s = [x_s, y_s, vl_s]
    accum = splat(scal, keym_s, p1_s, vl_s, idx_bits=_idx_bits(gather),
                  samples=samples, grid_hw=grid_hw, pscale=pscale, p0=p0_s,
                  rgba=rgba_s)
    aux = None
    if gather == 2:
        aux = (idx[perm], p1_s)
    elif gather:
        bits = _idx_bits(gather)
        idx_s = keym_s & ((1 << bits) - 1)
        aux = (idx_s | id_hi if gather == 3 else idx_s, p1_s)
    return accum, aux, ride_s, carry


def fused_draw_accumulate(grid_hw, p0_pix, p1_pix, vel, pos_ndc, mapped,
                          live, speed_limit, time, *, idx=None, ride=None,
                          idx_bound=None, samples=2, flow_width=1.0,
                          line_width=1.0, speed_alpha=1.0, sin_decay=0.0,
                          flow_decay=0.0, base_color=None, flow_color=None,
                          derive_p0=False, view_size=None,
                          mapped_scalar=None, raw_accum=False, reorder=None,
                          flow_off=False):
    """Pack (K1), sort and splat (K2) both passes of a draw.

    The arguments are those of the JAX function. `derive_p0=True` (with
    `view_size`; a step just preceded the draw) drops the p0 stream, which
    the splat re-derives; otherwise `p0_pix` is packed. `mapped_scalar`
    (`f32[4]`, with derive_p0) moves the colour model of a 1x1 colour map
    into the splat; otherwise `mapped` (`f32[4, N]`) and `pos_ndc` are
    packed to rgba8. `idx` (aux streams for the force gather, bounded by
    `idx_bound`) selects gather mode 1, 2 or 3 (`gather_mode`) and
    `ride=[x, y]` the resident stream. `reorder=(prev_key, prev_hist)`
    (resident frames): the merge reorder's carry, used where
    `reorder_cuda.merge_eligible` admits the stream. Returns
    `(accum f32[11, hp, wp], None, aux, ride_sorted)` with `raw_accum`,
    else `(flow_parts, view_parts, aux, ride_sorted)`, each part
    `(num, wsum, logt)` over the content grid (`draw_pallas.py:1030-1035`);
    aux is None without `idx`, ride_sorted None without `ride` (see
    `_bin_and_splat`). With `reorder` a fifth element is the next frame's
    carry, None when the merge was not admitted. All over the N real rows:
    the TPU's block padding has no counterpart."""
    if derive_p0 == (p0_pix is not None):
        raise ValueError("give p0_pix exactly when derive_p0 is False")
    if (mapped_scalar is None) == (mapped is None):
        raise ValueError("give exactly one of mapped and mapped_scalar")
    if mapped_scalar is not None and not derive_p0:
        raise ValueError("mapped_scalar requires derive_p0")
    if ride is not None and len(ride) != 2:
        raise not_ported("live targets riding the sort", 7)
    if flow_off:
        raise not_ported("flow_off (flowWeight == 0)", 7)
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    n = p1_pix.shape[0]
    gather = gather_mode(n, seg_tile_count(grid_hw), ids=idx is not None,
                         resident=derive_p0 and ride is not None,
                         idx_bound=idx_bound)
    if gather == 3:
        ride = _hide_id_bits(ride, idx)
    merge = reorder if reorder is not None \
        and reorder_cuda.merge_eligible(n, gather) else None
    pscale = _pos_scale(hp, wp)
    dev = p1_pix.device
    zeros4 = torch.zeros(4, device=dev)
    scal = _draw_scal(speed_limit, time, flow_width, line_width,
                      speed_alpha, sin_decay, flow_decay,
                      zeros4 if base_color is None else base_color,
                      zeros4 if flow_color is None else flow_color,
                      zeros4 if mapped_scalar is None else mapped_scalar,
                      torch.zeros(2, device=dev) if view_size is None
                      else view_size, dev)
    words = pack(scal, p1_pix, vel, live, idx, grid_hw=grid_hw,
                 pscale=pscale, p0_pix=p0_pix,
                 pos=None if mapped is None else pos_ndc.contiguous(),
                 mapped=mapped, gather=gather)
    accum, aux, ride_s, carry = _bin_and_splat(
        scal, words, ride, idx=idx, gather=gather, samples=samples,
        grid_hw=grid_hw, pscale=pscale, reorder=merge)
    tail = () if reorder is None else (carry,)
    if raw_accum:
        return (accum, None, aux, ride_s, *tail)
    out = accum[:, PAD_LO_H:PAD_LO_H + h, PAD_LO_W:PAD_LO_W + w]
    # The flow payload's stamp numerator is time x wsum (constant stamp).
    fnum = torch.cat([out[0:2], (time * out[3])[None], out[2:3]])
    return ((fnum, out[3], out[4]), (out[5:9], out[9], out[10]), aux, ride_s,
            *tail)


# --- the XLA resolve tail ----------------------------------------------------


def _widen_plan(width):
    """`(radius, scale)` of `_widen_excess` for a host line width, in f32
    as the JAX function computes them on the device."""
    f = np.float32
    width = max(f(width), f(1.0))
    w_in = min(width, f(KMAX_WIDTH))  # applied in-kernel
    rem = np.sqrt(max(width * width - w_in * w_in, f(0.0)))
    return max((rem - f(1.0)) * f(0.5), f(0.0)), width / w_in


def _box_blur(img, radius):
    """Separable box blur of `img: f32[C, H, W]` over rows, then columns,
    of radius `round(radius)` clamped to MAX_BLUR: edge-padded cumulative
    sums (the port of `draw_pallas._box_blur_traced`, with the radius a
    host number)."""
    r = int(np.clip(np.round(np.float32(radius)), 0, MAX_BLUR))
    inv = float(np.float32(1.0) / np.float32(2 * r + 1))

    def blur_axis(x, axis):
        pad = ((0, 0, MAX_BLUR + 1, MAX_BLUR) if axis == 1
               else (MAX_BLUR + 1, MAX_BLUR, 0, 0))
        csum = torch.cumsum(F.pad(x[None], pad, mode="replicate")[0],
                            dim=axis)
        n = x.shape[axis]
        return (csum.narrow(axis, MAX_BLUR + 1 + r, n)
                - csum.narrow(axis, MAX_BLUR - r, n)) * inv

    return blur_axis(blur_axis(img, 1), 2)


def _widen_excess(parts, width):
    """Widths <= KMAX_WIDTH are applied in the splat: the identity. Wider
    strokes get the excess as a variance-matched box blur of the
    accumulation and their mass scaled to the width
    (`draw_pallas._widen_excess`). The JAX function branches on the device
    with `lax.cond`; here `width` is a host number and the branch is taken
    on the host. A tensor width is read back (one synchronisation)."""
    radius, scale = _widen_plan(float(width))
    if radius < 0.5 and scale == 1.0:
        return parts
    num, wsum, logt = parts
    stack = torch.cat([num, wsum[None], logt[None]])
    if radius >= 0.5:
        stack = _box_blur(stack, radius)
    stack = stack * float(scale)
    return stack[:-2], stack[-2], stack[-1]


# --- K3 resolve --------------------------------------------------------------


def _resolve_scal(fade_rgba, auto_clear, time, read_time, flow_decay,
                  flow_width, line_width, device):
    """The resolve's scalars as one `f32[16]` device tensor (JAX layout,
    draw_pallas.py:1428-1434)."""
    def scale_of(width):
        width = torch.clamp(_vec(width, device), min=1.0)
        return width / torch.clamp(width, max=KMAX_WIDTH)

    return torch.cat([_vec(v, device) for v in (
        time, read_time, flow_decay, auto_clear, fade_rgba,
        scale_of(flow_width), scale_of(line_width), 1e-6,
        torch.zeros(5, device=device))])


def resolve(rscal, accum, flow, view, *, want_eff=False):
    """K3: blend the padded accumulator over the previous flow `f32[4, H,
    W]` and view `f32[4, H, W]`. Returns fresh `(new_flow, new_view[,
    eff f32[2, H, W]])`."""
    if cuda_lib.on_cpu(rscal, accum, flow, view):
        return resolve_plain(rscal, accum, flow, view, want_eff=want_eff)
    _, h, w = view.shape
    hp, wp = pad_dims(h, w)
    cuda_lib.check(rscal, "rscal", _F32, (16,))
    cuda_lib.check(accum, "accum", _F32, (N_CHAN, hp, wp))
    cuda_lib.check(flow, "flow", _F32, (4, h, w))
    cuda_lib.check(view, "view", _F32, (4, h, w))
    new_flow = torch.empty_like(flow)
    new_view = torch.empty_like(view)
    eff = torch.empty((2, h, w), dtype=_F32, device=view.device) \
        if want_eff else None
    cuda_lib.launch("tt_resolve", "resolve", rscal, accum, flow, view, h, w,
                    hp, wp, new_flow, new_view, eff)
    return (new_flow, new_view, eff) if want_eff else (new_flow, new_view)


def resolve_plain(rscal, accum, flow, view, *, want_eff=False):
    """Plain version of K3 (`draw_pallas._resolve_kernel`)."""
    cuda_lib.plain_calls["resolve"] += 1
    _, h, w = view.shape
    a = accum[:, PAD_LO_H:PAD_LO_H + h, PAD_LO_W:PAD_LO_W + w]
    time, read_time, fdecay, clear = rscal[0], rscal[1], rscal[2], rscal[3]
    fade, sf, sv, eps = rscal[4:8], rscal[8], rscal[9], rscal[10]

    wsum_f = a[3] * sf
    t_f = torch.exp(a[4] * sf)
    gain_f = (1.0 - t_f) / torch.maximum(wsum_f, eps)
    fnum = (a[0] * sf, a[1] * sf, time * wsum_f, a[2] * sf)
    nf = torch.stack([flow[k] * t_f + fnum[k] * gain_f for k in range(4)])

    fa = fade[3]
    wsum_v = a[N_FLOW + 4] * sv
    t_v = torch.exp(a[N_FLOW + 5] * sv)
    gain_v = (1.0 - t_v) / torch.maximum(wsum_v, eps)
    nv = torch.stack([
        (fade[k] * fa + (view[k] * (1.0 - clear)) * (1.0 - fa)) * t_v
        + (a[N_FLOW + k] * sv) * gain_v for k in range(4)])
    if not want_eff:
        return nf, nv
    decay = torch.clamp(1.0 - (read_time - nf[2]) * fdecay, min=0.0)
    return nf, nv, nf[:2] * decay


def resolve_fused(accum, flow, view, fade_rgba, auto_clear, time, read_time,
                  flow_decay, flow_width, line_width, *, want_eff=False,
                  flow_off=False):
    """Resolve both passes' padded accumulator over the previous flow/view
    grids (K3), with `autoClearView` + fade of the previous view. Returns
    `(new_flow, new_view)` or, with `want_eff`, also the decayed flow at
    `read_time` (content layout, for the next force gather)."""
    if flow_off:
        raise not_ported("the view-only resolve of flow_off", 7)
    rscal = _resolve_scal(fade_rgba, auto_clear, time, read_time, flow_decay,
                          flow_width, line_width, accum.device)
    return resolve(rscal, accum, flow, view, want_eff=want_eff)


# --- K6 reconstruct ----------------------------------------------------------


def reconstruct_resident(npx, npy, vl, speed_limit):
    """K6: the resident frame's state reassembly from the sorted ride
    streams, without the gather (for frames that edit the flow before
    the force is gathered): `npx`, `npy` `f32[M]` exact positions, `vl`
    `i32[M]` q15 velocity words, `speed_limit` the (clamped) speedLimit.
    Returns `(particles, previous)` `f32[4, M]`. (The JAX function also
    re-stacks riding targets; the port does not ride live targets yet.)"""
    sl = torch.as_tensor(speed_limit, dtype=_F32,
                         device=npx.device).reshape(1)
    if cuda_lib.on_cpu(npx, npy, vl, sl):
        return reconstruct_resident_plain(npx, npy, vl, sl)
    m = npx.shape[0]
    cuda_lib.check(npx, "npx", _F32, (m,))
    cuda_lib.check(npy, "npy", _F32, (m,))
    cuda_lib.check(vl, "vl", _I32, (m,))
    particles = torch.empty((4, m), dtype=_F32, device=npx.device)
    previous = torch.empty((4, m), dtype=_F32, device=npx.device)
    cuda_lib.launch("tt_reconstruct", "reconstruct_resident", npx, npy, vl,
                    sl, m, particles, previous)
    return particles, previous


def reconstruct_resident_plain(npx, npy, vl, speed_limit):
    """Plain version of K6 (`reconstruct_rows`)."""
    cuda_lib.plain_calls["reconstruct_resident"] += 1
    return reconstruct_rows(speed_limit, npx, npy, vl)


def reconstruct_rows(sl, npx, npy, vl):
    """Resident-stream reassembly (plain; K4's and K6's): un-quantise the
    q15 velocity word, prev = pos - vel for live rows. Returns
    `(particles, previous)` `f32[4, M]`."""
    vel_u = vl & ((1 << 30) - 1)
    nvx = _unq15(vel_u & HALF) * sl
    nvy = _unq15(vel_u >> 15) * sl
    alive = (npx != INERT) | (npy != INERT)
    return (torch.stack([npx, npy, nvx, nvy]),
            torch.stack([torch.where(alive, npx - nvx, npx),
                         torch.where(alive, npy - nvy, npy), nvx, nvy]))


def fused_draw(flow, view, p0_pix, p1_pix, vel, pos_ndc, mapped, live,
               params, time, *, grid_hw, samples=2, idx=None, ride=None,
               idx_bound=None, psum=None, derive_p0=False, view_size=None,
               mapped_scalar=None, resolve="kernel", read_time=None,
               want_eff=False, flow_off=False, reorder=None,
               host_widths=None):
    """Full fused draw: accumulate (K1, sort, K2) with the in-kernel line
    widths and colour model, then resolve both blends: with K3
    (`resolve="kernel"`, widths <= KMAX_WIDTH, which also applies
    `autoClearView` and the fade to `view`), or with the XLA tail
    (`resolve="xla"`: `_widen_excess` and `composite_over`, over a `view`
    the caller has already cleared and faded). `host_widths`: the
    `(flowWidth, lineWidth)` host numbers that decide the tail's blur
    branch (read back from `params` when not given). Returns `(new_flow,
    new_view, aux, ride_sorted[, eff][, carry])`; `eff`, the flow decayed
    to `read_time`, only from K3; `carry` (the merge reorder's, see
    `fused_draw_accumulate`) only with `reorder`."""
    if resolve not in ("kernel", "xla"):
        raise ValueError(f"unknown resolve: {resolve}")
    if psum is not None:
        raise not_ported("the sharded draw", 12)
    kernel = resolve == "kernel"
    out = fused_draw_accumulate(
        grid_hw, p0_pix, p1_pix, vel, pos_ndc, mapped, live,
        params["speedLimit"], time, idx=idx, ride=ride,
        idx_bound=idx_bound, samples=samples, derive_p0=derive_p0,
        view_size=view_size, mapped_scalar=mapped_scalar,
        flow_width=params["flowWidth"], line_width=params["lineWidth"],
        speed_alpha=params["speedAlpha"],
        sin_decay=torch.sin(time * params["flowDecay"]),
        flow_decay=params["flowDecay"], base_color=params["baseColor"],
        flow_color=params["flowColor"], raw_accum=kernel, flow_off=flow_off,
        reorder=reorder)
    aux, ride_s, tail = out[2], out[3], out[4:]
    if kernel:
        res = resolve_fused(
            out[0], flow, view, params["fadeColor"] * params["autoFade"],
            params["autoClearView"], time,
            time if read_time is None else read_time, params["flowDecay"],
            params["flowWidth"], params["lineWidth"], want_eff=want_eff)
        return (res[0], res[1], aux, ride_s, *res[2:], *tail)
    fw, lw = host_widths or (params["flowWidth"], params["lineWidth"])
    return (composite_over(flow, *_widen_excess(out[0], fw)),
            composite_over(view, *_widen_excess(out[1], lw)), aux, ride_s,
            *tail)
