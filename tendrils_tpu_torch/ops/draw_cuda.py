"""Fused draw: both render passes (flow payload + view colour) from ONE
segment sort, on hand-written CUDA kernels.

The port of `tendrils_tpu/ops/draw_pallas.py` for the resident frame's
variant (p0 derived from p1 and the velocity, a 1x1 colour map, the
combined `tile << 20 | row id` sort key, in-kernel line widths up to
`KMAX_WIDTH`):

  K1 `pack`    (csrc/pack.cu)    per segment: sort key, fixed-point p1,
                                 q15 velocity word with the live bit;
  sort         `torch.sort` of the combined key (the JAX package sorts
               with `lax.sort` too), the other streams follow by index;
  K2 `splat`   (csrc/splat.cu)   per (segment, sample): box-footprint
                                 deposits into the padded 11-channel
                                 accumulator;
  K3 `resolve` (csrc/resolve.cu) per pixel: order-independent blend of
                                 both grids, fade, the decayed flow `eff`;
  K6 `reconstruct_resident` (csrc/gather.cu) per sorted row: the state
                                 reassembly alone, for frames that gather
                                 the force after editing the flow.

Each kernel's wrapper takes the plain PyTorch version (`pack_plain`,
`splat_plain`, `resolve_plain`, `reconstruct_resident_plain`) when its
tensors lie on the CPU and launches the kernel when they lie on a CUDA
device. The packed words, the keys and the sorted order are the
reference's contracts and match it bit for bit; the accumulator is summed
in f32 (the TPU's matmul operands are bf16) with float atomics, in
run-dependent order.
"""

import torch

from ..const import INERT
from . import cuda_lib, not_ported
from .tile_geom import HALF, PAD_LO_H, PAD_LO_W, TILE_H, TILE_W, pad_dims

N_CHAN = 11
# flow channels (vx·α, vy·α, wf·α, α, log(1-α)) lead the stack, then the
# view's (r·α, g·α, b·α, a·α, α, log(1-α)).
N_FLOW = 5
# Gather mode 1 (the combined 20-bit key|id word) bounds.
G1_MAX_ROWS = 1 << 20
G1_MAX_TILES = 1 << 11
COLOR_MAX = 4.0
KMAX_WIDTH = 8.0
KSPAN = 9  # texels a box of width <= KMAX_WIDTH can touch along one axis

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


def pack(scal, p1_pix, vel, live, idx, *, grid_hw, pscale):
    """K1: per-segment sort key, p1 and velocity words (`i32[N]` each).

    `scal`: `f32[32]` per-frame scalars (`_draw_scal`); `p1_pix`: `f32[N, 2]`
    end points in window px; `vel`: `f32[2, N]`; `live`: `f32[N]`; `idx`:
    `i32[N]` row ids. Returns `(keym, p1, vl)`, keym = tile << 20 | id."""
    if cuda_lib.on_cpu(scal, p1_pix, vel, live, idx):
        return pack_plain(scal, p1_pix, vel, live, idx, grid_hw=grid_hw,
                          pscale=pscale)
    n = p1_pix.shape[0]
    h, w = grid_hw
    cuda_lib.check(scal, "scal", _F32, (32,))
    cuda_lib.check(p1_pix, "p1_pix", _F32, (n, 2))
    cuda_lib.check(vel, "vel", _F32, (2, n))
    cuda_lib.check(live, "live", _F32, (n,))
    cuda_lib.check(idx, "idx", _I32, (n,))
    keym, p1, vl = (torch.empty(n, dtype=_I32, device=p1_pix.device)
                    for _ in range(3))
    tiles_x = pad_dims(h, w)[1] // TILE_W
    cuda_lib.launch("tt_pack", "pack", scal, p1_pix, vel, live, idx, n, h,
                    w, tiles_x, float(pscale), keym, p1, vl)
    return keym, p1, vl


def pack_plain(scal, p1_pix, vel, live, idx, *, grid_hw, pscale):
    """Plain version of K1 (`draw_pallas._pack_core` with key_recon, no
    rgba, gather mode 1)."""
    cuda_lib.plain_calls["pack"] += 1
    h, w = grid_hw
    tiles_x = pad_dims(h, w)[1] // TILE_W
    sl_raw = scal[0]
    sl = torch.clamp(sl_raw, min=1e-12)
    x1q, y1q = _qpos(p1_pix[:, 0], p1_pix[:, 1], grid_hw, pscale)
    p1 = y1q * (HALF + 1) + x1q
    qx = _q15(vel[0] / sl)
    qy = _q15(vel[1] / sl)
    live_bit = (live > 0.5).to(_I32) * (1 << 30)
    vl = live_bit + qy * (HALF + 1) + qx

    # Segment key from the p0 the splat will reconstruct (bit for bit).
    hwm = torch.maximum(torch.clamp(scal[2], 1.0, KMAX_WIDTH),
                        torch.clamp(scal[3], 1.0, KMAX_WIDTH)) * 0.5
    inv_p = 1.0 / pscale
    p1xd = x1q.to(_F32) * inv_p
    p1yd = y1q.to(_F32) * inv_p
    p0xd = torch.clamp(p1xd - _unq15(qx) * sl_raw * (scal[30] * 0.5 * w),
                       1.0, PAD_LO_W + w + 1.0)
    p0yd = torch.clamp(p1yd - _unq15(qy) * sl_raw * (scal[31] * 0.5 * h),
                       1.0, PAD_LO_H + h + 1.0)
    top_x = torch.clamp(torch.minimum(p0xd, p1xd) - hwm, min=0.0)
    top_y = torch.clamp(torch.minimum(p0yd, p1yd) - hwm, min=0.0)
    krow = torch.floor(top_y).to(_I32) // TILE_H
    kcol = torch.floor(top_x).to(_I32) // TILE_W
    return (krow * tiles_x + kcol) * (1 << 20) + idx, p1, vl


# --- K2 splat ----------------------------------------------------------------


def splat(scal, p1, vl, *, samples, grid_hw, pscale):
    """K2: expand each sorted segment into `samples` deposit points and
    accumulate both passes' box footprints. Returns the padded accumulator
    `f32[N_CHAN, hp, wp]` (the wrapper zeroes it; the kernel adds)."""
    if cuda_lib.on_cpu(scal, p1, vl):
        return splat_plain(scal, p1, vl, samples=samples, grid_hw=grid_hw,
                           pscale=pscale)
    n = p1.shape[0]
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    cuda_lib.check(scal, "scal", _F32, (32,))
    cuda_lib.check(p1, "p1", _I32, (n,))
    cuda_lib.check(vl, "vl", _I32, (n,))
    accum = torch.zeros((N_CHAN, hp, wp), dtype=_F32, device=p1.device)
    cuda_lib.launch("tt_splat", "splat", scal, p1, vl, n, samples, h, w, hp,
                    wp, float(pscale), accum)
    return accum


def _scalar_colors(scal, vx, vy, p1x, p1y, grid_hw):
    """Render colour model of a 1x1 colour map (`src/render/index.vert:
    57-94`; draw_pallas `_kernel` scalar_color) -> (r, g, b, a)."""
    h, w = grid_hw
    inv_sl = 1.0 / torch.clamp(scal[0], min=1e-12)
    vnx = vx * inv_sl
    vny = vy * inv_sl
    mr, mg, mb, ma = scal[16], scal[17], scal[18], scal[19]
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
    posx = ((p1x - PAD_LO_W) * (2.0 / w) - 1.0) \
        / torch.clamp(scal[30], min=1e-12)
    posy = ((p1y - PAD_LO_H) * (2.0 / h) - 1.0) \
        / torch.clamp(scal[31], min=1e-12)
    d2 = torch.sqrt(posx * posx + posy * posy)
    amt = torch.clamp(1.0 - d2, max=1.0)
    ut = 1.0 - amt
    bz = (0.2 * ut + amt) * ut + amt
    vig = torch.clamp(torch.clamp(bz, min=0.0), 0.2, 1.0)
    ca = ca * speed_rate * vig
    return [torch.clamp(c, 0.0, COLOR_MAX) for c in (*rgb, ca)]


def _cover(idx, lo, hi):
    """Box-overlap coverage of texel `idx` by the footprint [lo, hi)."""
    return torch.clamp(torch.minimum(idx + 1.0, hi) - torch.maximum(idx, lo),
                       0.0, 1.0)


def splat_plain(scal, p1, vl, *, samples, grid_hw, pscale):
    """Plain version of K2: the same per-sample arithmetic, deposited with
    one `index_add_` per footprint offset (<= 9 x 9 offsets, both channel
    groups and all samples at once)."""
    cuda_lib.plain_calls["splat"] += 1
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    dev = p1.device
    sl = scal[0]
    inv_p = 1.0 / pscale
    p1x = (p1 & HALF).to(_F32) * inv_p
    p1y = (p1 >> 15).to(_F32) * inv_p
    live = (vl >> 30).to(_F32)
    vel_u = vl & ((1 << 30) - 1)
    vx = _unq15(vel_u & HALF) * sl
    vy = _unq15(vel_u >> 15) * sl
    # derive_p0: Euler inverse in pixel space.
    p0x = torch.clamp(p1x - vx * (scal[30] * 0.5 * w), 1.0,
                      PAD_LO_W + w + 1.0)
    p0y = torch.clamp(p1y - vy * (scal[31] * 0.5 * h), 1.0,
                      PAD_LO_H + h + 1.0)
    dx = p1x - p0x
    dy = p1y - p0y
    ascale = live * torch.clamp(torch.maximum(dx.abs(), dy.abs()), min=1.0) \
        / samples
    cr, cg, cb, ca = _scalar_colors(scal, vx, vy, p1x, p1y, grid_hw)
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
        planes = (ch0 + torch.arange(len(chans), device=dev)) * (hp * wp)
        groups.append((chans, planes[:, None, None], 1.0 / width,
                       (lo_y, hi_y, torch.floor(lo_y)),
                       (lo_x, hi_x, torch.floor(lo_x))))

    accum = torch.zeros(N_CHAN * hp * wp, dtype=_F32, device=dev)
    for oy in range(KSPAN):
        for ox in range(KSPAN):
            index, value = [], []
            for chans, planes, inv_w, (lo_y, hi_y, r0), (lo_x, hi_x, c0) \
                    in groups:
                r = r0 + oy
                c = c0 + ox
                wr = _cover(r, lo_y, hi_y) * inv_w
                wc = _cover(c, lo_x, hi_x)
                ok = (wr > 0) & (wc > 0) & (r >= 0) & (r < hp) \
                    & (c >= 0) & (c < wp)
                value.append(torch.where(ok, (wr * chans) * wc, 0.0))
                texel = (torch.clamp(r, 0, hp - 1) * wp
                         + torch.clamp(c, 0, wp - 1)).to(torch.int64)
                index.append(planes + texel)
            accum.index_add_(0, torch.cat([i.reshape(-1) for i in index]),
                             torch.cat([v.reshape(-1) for v in value]))
    return accum.reshape(N_CHAN, hp, wp)


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


def _bin_and_splat(scal, keym, vl, ride, *, samples, grid_hw, pscale):
    """Sort the segments by their combined key, then splat them (K2).

    `ride`: the exact f32 positions `[x, y]` riding the sort (resident
    stream). Keys are unique in gather mode 1, so the order is fully
    determined. The sorted p1 word is recomputed from the sorted exact
    positions (the JAX `p1_from_ride`: the same f32 pixel transform, clip
    and round as the pack, so bit-identical). Returns `(accum, aux,
    ride_sorted)`: aux = `(idx_s, p1_s)`, ride_sorted = `[x_s, y_s, vl_s]`."""
    h, w = grid_hw
    keym_s, perm = torch.sort(keym)
    vl_s = vl[perm]
    x_s, y_s = ride[0][perm], ride[1][perm]
    x1q, y1q = _qpos((x_s * scal[30] * 0.5 + 0.5) * w,
                     (y_s * scal[31] * 0.5 + 0.5) * h, grid_hw, pscale)
    p1_s = y1q * (HALF + 1) + x1q
    idx_s = keym_s & ((1 << 20) - 1)
    accum = splat(scal, p1_s, vl_s, samples=samples, grid_hw=grid_hw,
                  pscale=pscale)
    return accum, (idx_s, p1_s), [x_s, y_s, vl_s]


def fused_draw_accumulate(grid_hw, p0_pix, p1_pix, vel, pos_ndc, mapped,
                          live, speed_limit, time, *, idx=None, ride=None,
                          idx_bound=None, samples=2, flow_width=1.0,
                          line_width=1.0, speed_alpha=1.0, sin_decay=0.0,
                          flow_decay=0.0, base_color=None, flow_color=None,
                          derive_p0=False, view_size=None,
                          mapped_scalar=None, raw_accum=False, reorder=None,
                          flow_off=False):
    """Pack (K1), sort and splat (K2) both passes of the resident frame.

    The arguments are those of the JAX function. The port runs its
    resident variant only: `derive_p0=True` with `view_size`,
    `mapped_scalar` (1x1 colour map), `idx` and `ride=[x, y]`, and
    `raw_accum=True`; `p0_pix`, `pos_ndc` and `mapped` are then unused
    (the JAX pack ignores them too). Returns `(accum f32[11, hp, wp], aux,
    ride_sorted)` (see `_bin_and_splat`) over the N real rows — the TPU's
    block padding has no counterpart."""
    del p0_pix, pos_ndc, mapped
    if not (derive_p0 and mapped_scalar is not None and idx is not None
            and ride is not None):
        raise not_ported("the fused draw without the resident stream "
                         "(p0 stream, textured colour map)", 7)
    if len(ride) != 2:
        raise not_ported("live targets riding the sort", 7)
    if not raw_accum:
        raise not_ported("the XLA resolve tail (line widths above "
                         "KMAX_WIDTH)", 7)
    if flow_off:
        raise not_ported("flow_off (flowWeight == 0)", 7)
    if reorder is not None:
        raise not_ported("the merge reorder", 10)
    h, w = grid_hw
    hp, wp = pad_dims(h, w)
    n = p1_pix.shape[0]
    if n > G1_MAX_ROWS or (hp // TILE_H) * (wp // TILE_W) > G1_MAX_TILES \
            or (idx_bound is not None and idx_bound > n):
        raise not_ported("gather modes 2 and 3 (over 2^20 rows or 2048 "
                         "tiles: configs 3 and 5)", 7)
    pscale = _pos_scale(hp, wp)
    dev = p1_pix.device
    scal = _draw_scal(speed_limit, time, flow_width, line_width,
                      speed_alpha, sin_decay, flow_decay,
                      torch.zeros(4, device=dev) if base_color is None
                      else base_color,
                      torch.zeros(4, device=dev) if flow_color is None
                      else flow_color,
                      mapped_scalar, view_size, dev)
    keym, _, vl = pack(scal, p1_pix, vel, live, idx, grid_hw=grid_hw,
                       pscale=pscale)
    return _bin_and_splat(scal, keym, vl, ride, samples=samples,
                          grid_hw=grid_hw, pscale=pscale)


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
               want_eff=False, flow_off=False, reorder=None):
    """Full fused draw: accumulate (K1, sort, K2) with the in-kernel line
    widths and colour model, then resolve both blends (K3). Returns
    `(new_flow, new_view, aux, ride_sorted[, eff])`."""
    if resolve != "kernel":
        raise not_ported("the XLA resolve tail (line widths above "
                         "KMAX_WIDTH)", 7)
    if psum is not None:
        raise not_ported("the sharded draw", 12)
    accum, aux, ride_s = fused_draw_accumulate(
        grid_hw, p0_pix, p1_pix, vel, pos_ndc, mapped, live,
        params["speedLimit"], time, idx=idx, ride=ride,
        idx_bound=idx_bound, samples=samples, derive_p0=derive_p0,
        view_size=view_size, mapped_scalar=mapped_scalar,
        flow_width=params["flowWidth"], line_width=params["lineWidth"],
        speed_alpha=params["speedAlpha"],
        sin_decay=torch.sin(time * params["flowDecay"]),
        flow_decay=params["flowDecay"], base_color=params["baseColor"],
        flow_color=params["flowColor"], raw_accum=True, flow_off=flow_off,
        reorder=reorder)
    res = resolve_fused(
        accum, flow, view, params["fadeColor"] * params["autoFade"],
        params["autoClearView"], time,
        time if read_time is None else read_time, params["flowDecay"],
        params["flowWidth"], params["lineWidth"], want_eff=want_eff)
    return (res[0], res[1], aux, ride_s, *res[2:])
