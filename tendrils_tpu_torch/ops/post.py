"""Post-processing: copy, blend compositing, vignette blur, bokeh.

Mirrors `tendrils_tpu/ops/post.py`, the reference's screen-space passes
(SURVEY §2.6):

  - Blend (`src/screen/blend/index.js` + `blend/main.frag`): N-texture
    weighted premultiplied sum, elementwise.
  - Blur (`src/screen/blur.frag`): vignette-masked hash blur, strongest at
    the edges. As in the JAX module, a blur *stack* at static radii
    (repeated edge-replicated boxes) is lerped per pixel between levels,
    the level from `_level_lut`'s offline least-squares match of each
    lerped stack kernel to the reference's tap pattern; the hash grain is
    approximated by jittering the level.
  - Bokeh (`src/screen/bokeh.frag` + `libs/bokeh/index.glsl`): brightness-
    weighted disc blur, computed as blur(col·w) / blur(w) over the same
    stack.

The stack's levels are linear operators, run as the sequential boxes.
The JAX module also runs them as banded matrices (`blur_stack_matrices`,
two matmuls a level, for the TPU's matrix unit); the port keeps the
boxes alone: for a bokeh at 2160 x 3840 an H100 took 17.07 ms on them
and 41.43 ms on the matmuls, which came no closer to a float64 bokeh
(tests/test_torch_post.py holds the boxes to both JAX forms). The port
sums each box's window (`F.avg_pool2d` over an edge-replicated pad) where
the JAX module takes differences of a running sum: bokeh's weights reach
~1e5 at `bokeh=(3, 40)`, so a running sum along a 3840-wide row reaches
~1e8, whose f32 step would land on every box. No Pallas kernel stands
behind this module.

Radii are static; strengths are host numbers or tensors. Every function
computes in the dtype of its image (f32, or f64 for a reference).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import coords
from .filters import vignette
from .rand import glsl_random

# Reference constants: blur.frag:21-22, bokeh.frag:23-25.
BLUR_FALLOFF = (0.0, 1.0, 1.0)
BOKEH_FALLOFF = (0.0, 1.0, 1.0, 1.0)
MID = 0.5
BOKEH_LIMIT = 0.6


def copy(view):
    """FBO blit — ref `src/screen/copy.frag` (FXAA disabled there too)."""
    return view


def blend(views, alphas):
    """Premultiplied weighted sum of views — ref `screen/blend/main.frag:
    17-29` + `src/blend/sum.glsl`. `views`: sequence of `f32[4, H, W]`;
    `alphas`: `f32[N]` (a tensor or numbers)."""
    out = torch.zeros_like(views[0])
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        out = out + torch.cat([v[:3] * a[None], a[None]])
    return out


def blend_multiply(views, alphas):
    """`src/blend/multiply.glsl` variant: running premultiplied product."""
    out = None
    for i, v in enumerate(views):
        a = v[3] * alphas[i]
        pre = torch.cat([v[:3] * a[None], a[None]])
        out = pre if out is None else out * pre
    return out


def _box_blur_axis(img, r, axis):
    """Edge-replicated box blur of radius `r` along `axis` (1: rows, 2:
    columns) of `img: [C, H, W]`: each output the mean of its 2r + 1
    window, summed over the window itself (no running sum)."""
    if r <= 0:
        return img
    k = 2 * r + 1
    pad, kernel = ((0, 0, r, r), (k, 1)) if axis == 1 else ((r, r, 0, 0),
                                                              (1, k))
    padded = F.pad(img[None], pad, mode="replicate")
    return F.avg_pool2d(padded, kernel, stride=1)[0]


def box_blur(img, r):
    """Separable box blur of `[C, H, W]`, radius static."""
    return _box_blur_axis(_box_blur_axis(img, r, 1), r, 2)


def blur_stack(img, radii=(2, 6, 16)):
    """Progressively blurred copies of `[C, H, W]` (repeated boxes ≈
    gaussian), level 0 the image: each level two more boxes over the
    previous one."""
    stack = [img]
    cur = img
    prev_r = 0
    for r in radii:
        cur = box_blur(cur, max(1, (r - prev_r) // 2 + 1))
        cur = box_blur(cur, max(1, (r - prev_r) // 2 + 1))
        stack.append(cur)
        prev_r = r
    return stack


def _stack_lerp(stack, level):
    """Blend between stack levels by a per-pixel fractional level `[H, W]`."""
    n = len(stack) - 1
    level = torch.clamp(level, 0.0, float(n))
    out = stack[0]
    for i in range(n):
        t = torch.clamp(level - i, 0.0, 1.0)[None]
        out = out + (stack[i + 1] - out) * t
    return out


# --- kernel-matched level calibration (static, per radii tuple) --------------


def _stack_kernels_1d(radii):
    """1D separable kernel of each stack level (level 0 = identity)."""
    ks = [np.array([1.0])]
    cur = np.array([1.0])
    prev = 0
    for r in radii:
        rr = max(1, (r - prev) // 2 + 1)
        box = np.full(2 * rr + 1, 1.0 / (2 * rr + 1))
        cur = np.convolve(np.convolve(cur, box), box)
        ks.append(cur)
        prev = r
    return ks


def _centered(k1d, size):
    out = np.zeros(size)
    c = size // 2
    h = len(k1d) // 2
    out[c - h:c + h + 1] = k1d
    return out


def _splat_taps(x, y, w, size):
    """Bilinear-splat tap offsets (px) into a size×size kernel."""
    c = size // 2
    K = np.zeros((size, size))
    xi = np.floor(x).astype(int)
    yi = np.floor(y).astype(int)
    fx, fy = x - xi, y - yi
    for dx, wx in ((0, 1 - fx), (1, fx)):
        for dy, wy in ((0, 1 - fy), (1, fy)):
            np.add.at(K, (np.clip(c + yi + dy, 0, size - 1),
                          np.clip(c + xi + dx, 0, size - 1)), w * wx * wy)
    return K / w.sum()


def _disc_taps(strength):
    """Expected tap density of the reference hash blur: 20 samples uniform
    on a disc of radius `strength` px (`sqrt(u)·(sin, cos)(v·τ)` — the
    bundle-inlined `glsl-hash-blur` `mult()`), Monte-Carlo with a fixed
    seed (the expectation over the per-pixel hash streams)."""
    rng = np.random.RandomState(0)
    n = 20000
    rad = np.sqrt(rng.rand(n) + 0.001) * strength
    th = rng.rand(n) * 2.0 * np.pi
    return rad * np.sin(th), rad * np.cos(th), np.full(n, 1.0)


_GOLDEN = 2.39996323


def _bokeh_taps(strength):
    """The 20 deterministic golden-angle taps of `libs/bokeh/index.glsl`
    at disc parameter `strength` px (offset `(r-1)·R(golden)^j·(0, s)`)."""
    xs, ys = [], []
    r = 1.0
    ang = np.array([0.0, strength])
    rot = np.array([[np.cos(_GOLDEN), np.sin(_GOLDEN)],
                    [-np.sin(_GOLDEN), np.cos(_GOLDEN)]])
    for _ in range(20):
        r += 1.0 / r
        ang = rot @ ang
        xs.append((r - 1.0) * ang[0])
        ys.append((r - 1.0) * ang[1])
    return np.asarray(xs), np.asarray(ys), np.full(20, 1.0)


@functools.lru_cache(maxsize=None)
def _level_lut(radii, kind):
    """Offline least-squares match: for a grid of per-pixel strengths,
    the fractional stack level whose lerped kernel best matches the exact
    tap kernel (`kind`: "disc" hash blur | "bokeh" golden-angle disc).
    Returns (strengths, levels) as float32 tuples for `interp`."""
    taps_of = _disc_taps if kind == "disc" else _bokeh_taps
    extent = 1.0 if kind == "disc" else 5.5  # max tap offset per strength
    k1d = _stack_kernels_1d(radii)
    top = max(len(k) for k in k1d) // 2
    smax = radii[-1] * (2.5 if kind == "disc" else 1.0)
    size = 2 * int(np.ceil(max(top, smax * extent))) + 3
    K2 = [np.outer(_centered(k, size), _centered(k, size)) for k in k1d]
    grid = np.linspace(0.0, smax, 17)
    levels = [0.0]
    for s in grid[1:]:
        x, y, w = taps_of(s)
        D = _splat_taps(x, y, w, size)
        best = (np.inf, 0.0)
        for i in range(len(K2) - 1):
            d = K2[i + 1] - K2[i]
            t = float(np.clip(((D - K2[i]) * d).sum()
                              / max((d * d).sum(), 1e-12), 0.0, 1.0))
            e = float(((K2[i] + t * d - D) ** 2).sum())
            if e < best[0]:
                best = (e, i + t)
        levels.append(best[1])
    # enforce monotonicity (ties between adjacent segments can wobble)
    levels = np.maximum.accumulate(np.asarray(levels))
    return (tuple(np.float32(v) for v in grid),
            tuple(np.float32(v) for v in levels))


def interp(x, xp, fp):
    """Piecewise-linear interpolation of `x` over the sorted knots `xp`
    with values `fp`, constant beyond the ends: `jnp.interp`, expression
    for expression (torch has no counterpart)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _matched_level(strength, radii, kind):
    s, lv = _level_lut(tuple(radii), kind)
    return interp(strength.contiguous(),
                  torch.tensor(s, device=strength.device).to(strength.dtype),
                  torch.tensor(lv, device=strength.device).to(strength.dtype))


def vignette_blur(view, radius, limit, radii=(1, 3, 8), grain=0.75):
    """Edge blur — ref `src/screen/blur.frag:24-32`.

    Per-pixel disc radius = `radius * (1 - vignette(uv, mid, limit,
    falloff))` px, mapped onto the blur stack through the kernel-matched
    LUT. The reference's per-pixel hash grain is reproduced by jittering
    the per-pixel stack level with the same `fract(sin)` hash (`grain`
    scales it; 0 = smooth); crisp (level-0) pixels stay untouched. Alpha
    passes through unblurred (ref blur.frag:30-31)."""
    _, h, w = view.shape
    uv = coords.uv_grid((h, w), dtype=view.dtype, device=view.device)
    amount = 1.0 - vignette(uv, (MID, MID), limit, BLUR_FALLOFF)
    strength = radius * amount  # in pixels of disc radius
    level = _matched_level(strength, radii, "disc")
    if grain:
        jitter = glsl_random(
            uv * torch.tensor([w, h], dtype=view.dtype,
                              device=view.device)) - 0.5
        level = level + jitter * grain * torch.clamp(level, max=1.0)
    blurred = _stack_lerp(blur_stack(view, radii), level)
    return torch.cat([blurred[:3], view[3:4]])


def bokeh(view, radius, amount, radii=(2, 6, 16)):
    """Vignette bokeh — ref `src/screen/bokeh.frag:27-34` +
    `libs/bokeh/index.glsl`: blur of col·w over blur of w with the
    reference's highlight weights `pow(col², 9)·amt + 0.4`, the disc (20
    golden-angle taps out to ≈5.4·radius px) kernel-matched onto the
    stack, scaled per pixel by the vignette power."""
    _, h, w = view.shape
    uv = coords.uv_grid((h, w), dtype=view.dtype, device=view.device)
    power = 1.0 - vignette(uv, (MID, MID), BOKEH_LIMIT, BOKEH_FALLOFF)
    col = view[:3]
    # Contrast boost for highlights — libs/bokeh/index.glsl:34.
    col2 = col * col * 1.5
    # libs/bokeh/index.glsl:27: `amount += radius*500` (px radius).
    amt = amount * power + (radius * power) * 500.0
    # pow(x, 9) by squarings, as the JAX module computes it.
    c4 = col2 * col2
    c4 = c4 * c4
    wgt = c4 * c4 * col2 * amt[None] + 0.4
    num = blur_stack(torch.cat([col2 * wgt, wgt]), radii)
    blurred = _stack_lerp(num, _matched_level(radius * power, radii,
                                              "bokeh"))
    out = blurred[:3] / torch.clamp(blurred[3:], min=1e-6)
    return torch.cat([out, view[3:4]])
