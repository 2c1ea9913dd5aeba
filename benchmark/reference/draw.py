"""The resident frame's draw, in plain PyTorch, transcribed from the
semantics of the JAX package's fused draw (`ops/draw_pallas.py`: the pack,
the splat kernel's segment expansion and box footprints, the fused
resolve; `ops/gather_pallas.py`: the keyed carried-force gather;
`engine.draw_sim`, `resident=True`, 1x1 colour map).

Each segment runs from p0 to p1, the particle's position before and after
the step, in the padded grid's pixels: p1 quantised to 1/pscale px, the
velocity to its q15 word, p0 derived from them. Each of `samples` points
along it deposits a box of the pass's line width, its centre quantised to
1/pscale px, into 11 channels: the flow's (vx a, vy a, wf a, a,
log(1 - a)) and the view's (r a, g a, b a, a_c a, a, log(1 - a)). The
resolve blends both grids over the previous ones by order-independent
transparency; the next step's force is the decayed flow gathered
bilinearly at p1.

The positions of the samples are worked out in float32, in the JAX
kernel's order, because they are quantised: a float64 centre would land
in the next quantum wherever the float32 one lies within its rounding of
a boundary. Everything after them (the deposits, their sums, the resolve,
the gather) is float64. The deposits sum exactly: each channel's samples
are first summed at their quantised centres, then spread by the box
weights, which depend on a centre's place within its texel alone.
"""

import torch

from benchmark.reference.logic import F32, HALF, INERT, q15

F64 = torch.float64
TILE_H, TILE_W = 16, 256
PAD_LO_H, PAD_LO_W = TILE_H, TILE_W
PAD_HI_H, PAD_HI_W = 32, 384
KMAX_WIDTH = 8.0
COLOR_MAX = 4.0
EPS = 1e-6  # the resolve's least weight sum


def pad_dims(h, w):
    hp = (PAD_LO_H + h + PAD_HI_H + TILE_H - 1) // TILE_H * TILE_H
    wp = (PAD_LO_W + w + PAD_HI_W + TILE_W - 1) // TILE_W * TILE_W
    return hp, wp


def pos_scale(h, w):
    """Quanta a pixel: the largest power of two up to 64 at which the
    padded grid's coordinates fit 15 bits."""
    hp, wp = pad_dims(h, w)
    p = 64
    while p > 1 and max(hp, wp) * p > HALF:
        p //= 2
    return p


def p1_words(pos, view_size, h, w, ps):
    """The quantised p1 of positions `pos` (`f32[2, N]`, NDC): `(xq, yq)`,
    in 1/ps px of the padded grid."""
    xpix = (pos[0] * view_size[0] * 0.5 + 0.5) * w
    ypix = (pos[1] * view_size[1] * 0.5 + 0.5) * h
    xp = torch.clamp(xpix + PAD_LO_W, 1.0, PAD_LO_W + w + 1.0)
    yp = torch.clamp(ypix + PAD_LO_H, 1.0, PAD_LO_H + h + 1.0)
    return torch.round(xp * ps), torch.round(yp * ps)


def decayed(flow, read_time, flow_decay):
    """The flow's velocity at `read_time`, each texel decayed by the age of
    its stamp: `[2, H, W]`."""
    age = (read_time - flow[2]) * flow_decay
    return flow[:2] * torch.clamp(1.0 - age, min=0.0)[None]


def gather(grid, xq, yq, ps):
    """Bilinear samples of `grid` (`[C, H, W]`) at the quantised p1 words,
    clamped to the texel centres at the edge: `[C, N]`."""
    return sample(grid, xq.to(F64) / ps - PAD_LO_W,
                  yq.to(F64) / ps - PAD_LO_H)


def sample(grid, x, y):
    """Bilinear samples of `grid` (`[C, H, W]`) at texel coordinates `x`,
    `y` (`(0.5, 0.5)` the centre of texel [0, 0]), clamped to the texel
    centres at the edge: `f64[C, N]`."""
    _, h, w = grid.shape
    gx = torch.clamp(x.to(F64), 0.5, w - 0.5) - 0.5
    gy = torch.clamp(y.to(F64), 0.5, h - 0.5) - 0.5
    c0, r0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - c0, gy - r0
    c0, r0 = c0.long(), r0.long()
    c1, r1 = (c0 + 1).clamp(max=w - 1), (r0 + 1).clamp(max=h - 1)
    g = grid.to(F64)
    return (g[:, r0, c0] * ((1 - fx) * (1 - fy))
            + g[:, r0, c1] * (fx * (1 - fy))
            + g[:, r1, c0] * ((1 - fx) * fy) + g[:, r1, c1] * (fx * fy))


def _samples(pos, vel, live, p, view_size, h, w, ps, samples):
    """Each sample's quantised centre and its 11 channel values:
    `(xq, yq i64[S], values f64[11, S])`."""
    sl = p["speedLimit"]
    xq1, yq1 = p1_words(pos, view_size, h, w, ps)
    qx, qy = q15(vel[0], sl), q15(vel[1], sl)
    inv_p = 1.0 / ps
    p1x, p1y = xq1 * inv_p, yq1 * inv_p
    vx = (qx * (2.0 / HALF) - 1.0) * sl
    vy = (qy * (2.0 / HALF) - 1.0) * sl
    # p0 = p1 - vel in pixels, as the splat re-derives it.
    p0x = torch.clamp(p1x - vx * (view_size[0] * 0.5 * w), 1.0,
                      PAD_LO_W + w + 1.0)
    p0y = torch.clamp(p1y - vy * (view_size[1] * 0.5 * h), 1.0,
                      PAD_LO_H + h + 1.0)
    dx, dy = p1x - p0x, p1y - p0y

    d = {k: v.to(F64) for k, v in (("vx", vx), ("vy", vy), ("dx", dx),
                                   ("dy", dy), ("p1x", p1x), ("p1y", p1y))}
    s64 = sl.double()
    ascale = live.double() * torch.clamp(
        torch.maximum(d["dx"].abs(), d["dy"].abs()), min=1.0) / samples
    wf = torch.clamp(torch.sqrt(d["vx"] ** 2 + d["vy"] ** 2) / s64, max=1.0)
    color = _colors(d, p, view_size, h, w)

    xs, ys, vals = [], [], []
    for s in range(samples):
        ts = (s + 0.5) / samples
        x_un, y_un = p0x + dx * ts, p0y + dy * ts
        xp = torch.clamp(x_un, 1.0, PAD_LO_W + w + 1.0)
        yp = torch.clamp(y_un, 1.0, PAD_LO_H + h + 1.0)
        moved = (x_un != xp) | (y_un != yp)
        a = torch.where(moved, 0.0, ascale)
        af = torch.clamp(wf * a, max=1.0 - 1e-4)
        av = torch.clamp(color[3] * a, 0.0, 1.0 - 1e-4)
        xs.append(torch.round(xp * ps).long())
        ys.append(torch.round(yp * ps).long())
        vals.append(torch.stack([
            d["vx"] * af, d["vy"] * af, wf * af, af, torch.log1p(-af),
            color[0] * av, color[1] * av, color[2] * av, color[3] * av, av,
            torch.log1p(-av)]))
    return torch.cat(xs), torch.cat(ys), torch.cat(vals, dim=1)


def _colors(d, p, view_size, h, w):
    """The render colour model of a 1x1 colour map (`src/render/
    index.vert:57-94`): `[4, N]` rgba, clamped to [0, COLOR_MAX]."""
    sl = p["speedLimit"].double()
    vnx = d["vx"] / torch.clamp(sl, min=1e-12)
    vny = d["vy"] / torch.clamp(sl, min=1e-12)
    speed_rate = torch.clamp((vnx * vnx + vny * vny)
                             / torch.clamp(p["speedAlpha"].double(),
                                           min=1e-12), max=1.0)
    flow_decay = p["flowDecay"].double()
    sin_decay = torch.sin(p["flowDecay"].double() * p["time"].double())
    k1 = 1.0 - flow_decay
    al = (vnx, vnx * -0.5 + vny * -0.8660254037844385,
          vnx * -0.5 + vny * 0.8660254037844387)

    def falign(a, a_gbr):
        return (a + (a_gbr * k1 - a) * sin_decay) * 0.5 + 0.5

    fa = (falign(al[0], al[1]), falign(al[1], al[2]), falign(al[2], al[0]))
    base = p["baseColor"].double()
    flow_c = p["flowColor"].double()
    mapped = p["mapped"].double()

    def clip01(v):
        return torch.clamp(v, 0.0, 1.0)

    rgb = [clip01(base[k] * base[3]) + clip01(mapped[k] * mapped[3])
           + clip01(flow_c[k] * fa[k] * flow_c[3]) for k in range(3)]
    ca = (clip01(base[3]) + clip01(mapped[3]) + clip01(flow_c[3])) \
        * torch.ones_like(vnx)
    vs = view_size.double()
    posx = ((d["p1x"] - PAD_LO_W) * (2.0 / w) - 1.0) / torch.clamp(vs[0],
                                                                    min=1e-12)
    posy = ((d["p1y"] - PAD_LO_H) * (2.0 / h) - 1.0) / torch.clamp(vs[1],
                                                                    min=1e-12)
    amt = torch.clamp(1.0 - torch.sqrt(posx * posx + posy * posy), max=1.0)
    ut = 1.0 - amt
    vig = torch.clamp(torch.clamp((0.2 * ut + amt) * ut + amt, min=0.0),
                      0.2, 1.0)
    ca = ca * speed_rate * vig
    return [torch.clamp(c, 0.0, COLOR_MAX) for c in (*rgb, ca)]


def _box_weights(ps, hw):
    """`{d: f64[ps]}`: the share of texel `b + d` that a box of half-width
    `hw` centred at `b + q/ps` covers, for each quantum q of a texel."""
    q = torch.arange(ps, dtype=F64) / ps
    out = {}
    for d in range(-int(KMAX_WIDTH) - 2, int(KMAX_WIDTH) + 3):
        wgt = torch.clamp(torch.minimum(torch.tensor(d + 1.0), q + hw)
                          - torch.maximum(torch.tensor(float(d)), q - hw),
                          0.0, 1.0)
        if bool((wgt > 0).any()):
            out[d] = wgt
    return out


def _spread(hist, ps, hw, axis):
    """Sum `hist` (quanta along `axis`, ps to a texel) into texels along
    that axis by the box weights of half-width `hw`."""
    n = hist.shape[axis] // ps
    q = hist.unflatten(axis, (n, ps))
    shape = list(hist.shape)
    shape[axis] = n
    out = torch.zeros(shape, dtype=F64, device=hist.device)
    for d, wgt in _box_weights(ps, hw).items():
        for qi in range(ps):
            wv = float(wgt[qi])
            if wv == 0.0:
                continue
            part = q.select(axis + 1, qi)
            if d >= 0:
                out.narrow(axis, d, n - d).add_(part.narrow(axis, 0, n - d),
                                                alpha=wv)
            else:
                out.narrow(axis, 0, n + d).add_(part.narrow(axis, -d, n + d),
                                                alpha=wv)
    return out


def accumulate(pos, vel, live, p, view_size, h, w, samples):
    """The draw's padded accumulator, `f64[11, hp, wp]`."""
    ps = pos_scale(h, w)
    hp, wp = pad_dims(h, w)
    xq, yq, vals = _samples(pos, vel, live, p, view_size, h, w, ps, samples)
    lin = yq * (wp * ps) + xq
    widths = [torch.clamp(p[k].double(), 1.0, KMAX_WIDTH).item()
              for k in ("flowWidth", "lineWidth")]
    out = torch.empty(11, hp, wp, dtype=F64, device=pos.device)
    hist = torch.empty(hp * ps * wp * ps, dtype=F64, device=pos.device)
    for c in range(11):
        width = widths[0] if c < 5 else widths[1]
        hist.zero_()
        hist.index_add_(0, lin, vals[c])
        rows = _spread(hist.view(hp * ps, wp * ps), ps, width / 2, 0)
        out[c] = _spread(rows, ps, width / 2, 1) / width
    return out


def resolve(accum, flow, view, p, h, w):
    """The new flow and view (`f64[4, H, W]` each) from the accumulator over
    the previous grids: each pass's deposits blended by their summed
    weights, over the old grid by their joint transmittance; the flow's
    stamp channel is the frame's time; the old view cleared and faded
    first."""
    a = accum[:, PAD_LO_H:PAD_LO_H + h, PAD_LO_W:PAD_LO_W + w]
    t = p["time"].double()
    wsum_f, trans_f = a[3], torch.exp(a[4])
    gain_f = (1.0 - trans_f) / torch.clamp(wsum_f, min=EPS)
    fnum = (a[0], a[1], t * wsum_f, a[2])
    new_flow = torch.stack([flow[k].double() * trans_f + fnum[k] * gain_f
                            for k in range(4)])
    fade = (p["fadeColor"] * p["autoFade"]).double()
    clear = p["autoClearView"].double()
    wsum_v, trans_v = a[9], torch.exp(a[10])
    gain_v = (1.0 - trans_v) / torch.clamp(wsum_v, min=EPS)
    new_view = []
    for k in range(4):
        v0 = view[k].double() * (1.0 - clear)
        v0 = fade[k] * fade[3] + v0 * (1.0 - fade[3])
        new_view.append(v0 * trans_v + a[5 + k] * gain_v)
    return new_flow, torch.stack(new_view)


def frame_draw(pos_in, pos, vel, flow, view, p, view_size, samples,
               lowp=False):
    """The draw and the next step's force from the stepped state, every row
    in one order: `pos_in` the positions before the step (`f32[2, N]`),
    `pos`, `vel` after it as the resident frame holds them (`f32[2, N]`),
    `flow`, `view` the grids before the frame. Returns `{flow, view,
    force}` (float64). `lowp`: the draw's sums and outputs held in
    bfloat16, the control."""
    h, w = flow.shape[1:]
    alive = (pos[0] != INERT) | (pos[1] != INERT)
    alive_in = (pos_in[0] != INERT) | (pos_in[1] != INERT)
    live = (alive & alive_in).to(F32)
    accum = accumulate(pos, vel, live, p, view_size, h, w, samples)
    if lowp:
        accum = _bf16(accum)
    new_flow, new_view = resolve(accum, flow, view, p, h, w)
    if lowp:
        new_flow, new_view = _bf16(new_flow), _bf16(new_view)
    ps = pos_scale(h, w)
    xq, yq = p1_words(pos, view_size, h, w, ps)
    eff = decayed(new_flow, p["read_time"].double(), p["flowDecay"].double())
    force = gather(eff, xq, yq, ps)
    if lowp:
        force = _bf16(force)
    return {"flow": new_flow, "view": new_view, "force": force}


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)
