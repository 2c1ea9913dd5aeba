"""The set-up and the logic step, in float32 as the configurations state
them, transcribed from the semantics of the JAX package (`state.py`,
`ops/spawn.py`, `ops/rand.py`, `ops/logic.py`, `ops/noise.py`) and of the
resident frame's state reassembly (`ops/draw_pallas.py`): the q15
velocity word, prev = pos - vel, and in gather mode 3 the cleared low
position bits.

Float32 throughout, in the order the JAX functions evaluate: the noise
picks its gradients by `floor` of float32 products, so a float64 step
would pick other gradients where those land on an integer.
"""

import torch

F32 = torch.float32
INERT = -1.0e6
HALF = 32767
TAU = 6.28318530717958647692
# Gather mode 3 (more than 2^20 rows on a resident frame): the ids' high
# bits ride the positions' low mantissa bits (x: 2, y: 3) and are cleared
# after the sort, so every later stage sees the cleared positions.
G1_MAX_ROWS = 1 << 20

# The engine's parameters (`src/index.js:29-66`, `state.default_state`).
DEFAULTS = {
    "damping": 0.043, "speedLimit": 0.01,
    "forceWeight": 0.016, "varyForce": -0.1,
    "flowWeight": 1.0, "varyFlow": 0.2,
    "noiseWeight": 0.002, "varyNoise": 0.3,
    "flowDecay": 0.005, "flowWidth": 5.0,
    "noiseScale": 2.125, "varyNoiseScale": 0.5,
    "noiseSpeed": 0.00025, "varyNoiseSpeed": 0.1,
    "target": 0.0, "varyTarget": 1.0,
    "lineWidth": 1.0, "speedAlpha": 0.000001, "colorMapAlpha": 0.4,
    "baseColor": [1.0, 1.0, 1.0, 0.5],
    "flowColor": [1.0, 1.0, 1.0, 0.04],
    "fadeColor": [0.1333, 0.1333, 0.1333, 0.0],
    "autoClearView": 0.0, "autoFade": 1.0,
}


def params(values, device):
    """`{name: f32 tensor}` of the parameters `values` (DEFAULTS updated)."""
    out = dict(DEFAULTS)
    out.update(values)
    return {k: torch.tensor(v, dtype=F32, device=device)
            for k, v in out.items()}


def cover_aspect(w, h):
    """`max(w, h) / (w, h)` as float32 (`coords.cover_aspect`)."""
    m = max(w, h)
    return torch.tensor([m / w, m / h], dtype=F32)


def coords_of(idx, r):
    """`(uv f32[2, N], index01 f32[N])` of particle ids `idx`
    (`state.particle_coords_from_idx`)."""
    i = idx.to(F32)
    ix = torch.remainder(i, r)
    iy = torch.floor(i / r)
    uv = torch.stack([(ix + 0.5) / r, (iy + 0.5) / r])
    index01 = ((ix + 0.5) + (iy + 0.5) * r) / (r * r)
    return uv, index01


def _hash(x, y):
    """`glsl-random` (`rand.glsl_random`)."""
    d = x * 12.9898 + y * 78.233
    d = torch.remainder(d, 3.14)
    s = torch.sin(d) * 43758.5453
    return s - torch.floor(s)


def ball(idx, root_num, radius, speed):
    """`spawn_ball(radius, speed)`'s particles `f32[4, N]` for the particle
    ids `idx`, a row each (`spawn.ball`): a disc from the hash of each
    row's data-texture coordinate, the texel centre of its id."""
    r = root_num
    i = idx.to(torch.int64)
    fx = ((i % r).to(F32) + 0.5) / r * r
    fy = ((i // r).to(F32) + 0.5) / r * r
    u = [_hash(fx * a + b, fy * a + b) for a, b in (
        (1.7654, 2.3675), (1.23494, 0.36434), (0.327789, 3.498787),
        (9.0374, 0.2773))]
    rad = torch.tensor(radius, dtype=F32, device=idx.device)
    spd = torch.tensor(speed, dtype=F32, device=idx.device)

    def vec(angle, length):
        return torch.stack([torch.cos(angle) * length,
                            torch.sin(angle) * length])

    return torch.cat([vec(u[0] * TAU, u[1] * rad),
                      vec(u[2] * TAU, u[3] * spd)])


def start(root_num, view_res, radius, speed, device):
    """The state after set-up and `spawn_ball(radius, speed)`: particles on
    a disc (`ball`), previous all inert, grids zero."""
    n = root_num * root_num
    idx = torch.arange(n, dtype=torch.int32, device=device)
    particles = ball(idx, root_num, radius, speed)
    inert = torch.cat([torch.full((2, n), INERT, dtype=F32, device=device),
                       torch.zeros(2, n, dtype=F32, device=device)])
    h, w = view_res
    return {"particles": particles, "previous": inert,
            "targets": torch.zeros(4, n, dtype=F32, device=device),
            "flow": torch.zeros(4, h, w, dtype=F32, device=device),
            "view": torch.zeros(1, 4, h, w, dtype=F32, device=device),
            "color_map": torch.zeros(4, 1, 1, dtype=F32, device=device),
            "idx": idx}


# --- simplex noise (`noise.snoise3_xyz`) -------------------------------------


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289(((x * 34.0) + 1.0) * x)


def snoise(vx, vy, vz):
    """Simplex 3D noise (Ashima / Gustavson), component-wise."""
    cx, cy = 1.0 / 6.0, 1.0 / 3.0
    s = (vx + vy + vz) * cy
    ix, iy, iz = torch.floor(vx + s), torch.floor(vy + s), torch.floor(vz + s)
    t = (ix + iy + iz) * cx
    x0 = (vx - ix + t, vy - iy + t, vz - iz + t)
    g = ((x0[0] >= x0[1]).to(F32), (x0[1] >= x0[2]).to(F32),
         (x0[2] >= x0[0]).to(F32))
    l_ = tuple(1.0 - v for v in g)
    i1 = (torch.minimum(g[0], l_[2]), torch.minimum(g[1], l_[0]),
          torch.minimum(g[2], l_[1]))
    i2 = (torch.maximum(g[0], l_[2]), torch.maximum(g[1], l_[0]),
          torch.maximum(g[2], l_[1]))
    x1 = tuple(x0[k] - i1[k] + cx for k in range(3))
    x2 = tuple(x0[k] - i2[k] + cy for k in range(3))
    x3 = tuple(x0[k] - 0.5 for k in range(3))
    ix, iy, iz = _mod289(ix), _mod289(iy), _mod289(iz)

    def corner(az, ay, ax):
        return _permute(_permute(_permute(iz + az) + iy + ay) + ix + ax)

    ps = (corner(0.0, 0.0, 0.0), corner(i1[2], i1[1], i1[0]),
          corner(i2[2], i2[1], i2[0]), corner(1.0, 1.0, 1.0))
    nx, ny, nz = 2.0 / 7.0, 0.5 / 7.0 - 1.0, 1.0 / 7.0
    nzz = torch.tensor(nz, dtype=F32) * torch.tensor(nz, dtype=F32)

    def grad(p, xc):
        j = p - 49.0 * torch.floor(p * nzz.item())
        x_ = torch.floor(j * nz)
        y_ = torch.floor(j - 7.0 * x_)
        x = x_ * nx + ny
        y = y_ * nx + ny
        h = 1.0 - torch.abs(x) - torch.abs(y)
        sx = torch.floor(x) * 2.0 + 1.0
        sy = torch.floor(y) * 2.0 + 1.0
        sh = -(h <= 0.0).to(F32)
        ax = x + sx * sh
        ay = y + sy * sh
        norm = 1.79284291400159 - 0.85373472095314 * (ax * ax + ay * ay
                                                       + h * h)
        return ax * norm * xc[0] + ay * norm * xc[1] + h * norm * xc[2]

    def fall(xc):
        m = torch.clamp(0.6 - (xc[0] * xc[0] + xc[1] * xc[1]
                               + xc[2] * xc[2]), min=0.0)
        m = m * m
        return m * m

    out = None
    for p, xc in zip(ps, (x0, x1, x2, x3)):
        term = fall(xc) * grad(p, xc)
        out = term if out is None else out + term
    return 42.0 * out


# --- the logic step (`logic.step_particles`) ---------------------------------


def vary(base, offset, variance):
    return base + (offset * variance * base)


def step(particles, force, targets, idx, p, time, dt, root_num):
    """One logic step with the flow force `force` (`f32[2, N]`, gathered at
    the end of the previous frame): the new positions and the velocity
    before its q15 word, `(pos f32[2, N], vel f32[2, N])`."""
    pos, vel = particles[:2], particles[2:]
    alive = (pos[0] != INERT) | (pos[1] != INERT)
    uv, index01 = coords_of(idx, root_num)
    noise_scale = vary(p["noiseScale"], index01, p["varyNoiseScale"])
    noise_speed = vary(p["noiseSpeed"], index01, p["varyNoiseSpeed"])
    npos = pos * noise_scale
    ntime = time * noise_speed
    za = uv[0] + ntime
    zb = uv[1] + ntime + 1234.5678
    wander = torch.stack([snoise(npos[0], npos[1], za),
                          snoise(npos[0], npos[1], zb)])
    force_w = vary(p["forceWeight"], index01, p["varyForce"])
    flow_w = vary(p["flowWeight"], index01, p["varyFlow"])
    noise_w = vary(p["noiseWeight"], index01, p["varyNoise"])
    new_vel = (vel * p["damping"] * dt
               + force_w * (force * dt * flow_w + wander * dt * noise_w))
    target_w = vary(p["target"], index01, p["varyTarget"])
    new_vel = new_vel + (targets[:2] - pos) * target_w
    speed = torch.sqrt(new_vel[0] * new_vel[0] + new_vel[1] * new_vel[1])
    scale = (torch.minimum(speed, p["speedLimit"])
             / torch.clamp(speed, min=1e-12))
    new_vel = new_vel * scale
    new_pos = pos + new_vel
    return (torch.where(alive, new_pos, pos),
            torch.where(alive, new_vel, vel))


def q15(v, speed_limit):
    """The q15 word of a velocity component (`draw_pallas._pack_core`)."""
    sl = torch.clamp(speed_limit, min=1e-12)
    t = torch.clamp((v / sl + 1.0) / 2.0, 0.0, 1.0)
    return torch.round(t * HALF)


def unq15(q, speed_limit):
    """The velocity the q15 word stands for (`reconstruct_rows`)."""
    sl = torch.clamp(speed_limit, min=1e-12)
    return (q * (2.0 / HALF) - 1.0) * sl


def clear_low_bits(x, bits):
    """`x` with its `bits` low mantissa bits cleared (gather mode 3)."""
    xi = x.view(torch.int32)
    return (xi & ~((1 << bits) - 1)).view(F32)


def reassemble(pos, vel, speed_limit):
    """The resident frame's state after its draw: `(particles, previous)`
    `f32[4, N]`, the velocity from its q15 word, the positions with mode
    3's cleared bits where the frame has more than 2^20 rows."""
    if pos.shape[1] > G1_MAX_ROWS:
        pos = torch.stack([clear_low_bits(pos[0], 2),
                           clear_low_bits(pos[1], 3)])
    v = unq15(q15(vel, speed_limit), speed_limit)
    alive = (pos[0] != INERT) | (pos[1] != INERT)
    prev = torch.where(alive, pos - v, pos)
    return torch.cat([pos, v]), torch.cat([prev, v])


def ticks_time(start_ms, dt, k):
    """The fixed-step timer's time after `k` ticks from `start_ms`, summed
    as the timer sums it (`timer.tick`)."""
    t = start_ms
    for _ in range(k):
        t += dt
    return t
