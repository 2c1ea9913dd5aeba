"""The bokeh screen pass in float64, transcribed from the semantics of the
JAX package's `ops/post.py` (`bokeh`, its blur stack, its kernel-matched
levels) and `ops/filters.py` (`vignette`, `bezier`): a brightness-weighted
blur, blur(col w) / blur(w) with the weights pow(col^2, 9) amt + 0.4 of
the contrast-boosted colour, over a stack of repeated edge-replicated box
blurs, each pixel lerping between the stack's levels by the level whose
kernel best matches the reference's 20-tap golden-angle disc at its
vignetted strength.
"""

import functools

import numpy as np
import torch

F64 = torch.float64
RADII = (2, 6, 16)
MID, LIMIT = 0.5, 0.6
FALLOFF = (0.0, 1.0, 1.0, 1.0)
GOLDEN = 2.39996323


def _box_blur_axis(img, r, axis):
    """Box blur of radius `r` along `axis`, edges replicated."""
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device)
    out = torch.zeros_like(img)
    for d in range(-r, r + 1):
        out += img.index_select(axis, (idx + d).clamp(0, n - 1))
    return out / (2 * r + 1)


def blur_stack(img):
    """The image and its progressively blurred copies."""
    stack, cur, prev = [img], img, 0
    for r in RADII:
        rr = max(1, (r - prev) // 2 + 1)
        for _ in range(2):
            cur = _box_blur_axis(_box_blur_axis(cur, rr, 1), rr, 2)
        stack.append(cur)
        prev = r
    return stack


def _stack_kernels_1d():
    ks, cur, prev = [np.array([1.0])], np.array([1.0]), 0
    for r in RADII:
        rr = max(1, (r - prev) // 2 + 1)
        box = np.full(2 * rr + 1, 1.0 / (2 * rr + 1))
        cur = np.convolve(np.convolve(cur, box), box)
        ks.append(cur)
        prev = r
    return ks


def _taps(strength):
    """The 20 golden-angle taps of `libs/bokeh/index.glsl` at disc
    parameter `strength` px."""
    xs, ys, r = [], [], 1.0
    ang = np.array([0.0, strength])
    rot = np.array([[np.cos(GOLDEN), np.sin(GOLDEN)],
                    [-np.sin(GOLDEN), np.cos(GOLDEN)]])
    for _ in range(20):
        r += 1.0 / r
        ang = rot @ ang
        xs.append((r - 1.0) * ang[0])
        ys.append((r - 1.0) * ang[1])
    return np.asarray(xs), np.asarray(ys)


def _tap_kernel(x, y, size):
    """The taps splatted bilinearly into a size x size kernel, summing
    to 1."""
    c = size // 2
    k = np.zeros((size, size))
    xi, yi = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - xi, y - yi
    for dx, wx in ((0, 1 - fx), (1, fx)):
        for dy, wy in ((0, 1 - fy), (1, fy)):
            np.add.at(k, (np.clip(c + yi + dy, 0, size - 1),
                          np.clip(c + xi + dx, 0, size - 1)), wx * wy)
    return k / len(x)


@functools.lru_cache(maxsize=None)
def level_table():
    """`(strengths, levels)`: for 17 strengths from 0 to the stack's top
    radius, the fractional level whose lerped kernel is nearest, in least
    squares, to the tap kernel; made monotone."""
    k1d = _stack_kernels_1d()
    top = max(len(k) for k in k1d) // 2
    smax = float(RADII[-1])
    size = 2 * int(np.ceil(max(top, smax * 5.5))) + 3

    def centred(k):
        out = np.zeros(size)
        c, h = size // 2, len(k) // 2
        out[c - h:c + h + 1] = k
        return out

    k2 = [np.outer(centred(k), centred(k)) for k in k1d]
    grid = np.linspace(0.0, smax, 17)
    levels = [0.0]
    for s in grid[1:]:
        target = _tap_kernel(*_taps(s), size)
        best = (np.inf, 0.0)
        for i in range(len(k2) - 1):
            d = k2[i + 1] - k2[i]
            t = float(np.clip(((target - k2[i]) * d).sum()
                              / max((d * d).sum(), 1e-12), 0.0, 1.0))
            e = float(((k2[i] + t * d - target) ** 2).sum())
            if e < best[0]:
                best = (e, i + t)
        levels.append(best[1])
    return grid, np.maximum.accumulate(np.asarray(levels))


def _interp(x, xs, ys):
    """Piecewise-linear `ys(x)` over the increasing `xs`, clamped at the
    ends (`numpy.interp`)."""
    xs = torch.as_tensor(xs, dtype=F64, device=x.device)
    ys = torch.as_tensor(ys, dtype=F64, device=x.device)
    i = torch.searchsorted(xs, x.contiguous(), right=True)
    i = i.clamp(1, len(xs) - 1)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    t = ((x - x0) / (x1 - x0)).clamp(0.0, 1.0)
    return y0 + (y1 - y0) * t


def _bezier4(cp, t):
    ut = 1.0 - t
    a1 = cp[1] * ut + cp[2] * t
    return (((cp[0] * ut + cp[1] * t) * ut + a1 * t) * ut
            + (a1 * ut + (cp[2] * ut + cp[3] * t) * t) * t)


def bokeh(view, radius, amount):
    """The bokeh screen of `view` (`[4, H, W]`, float64 out)."""
    view = view.to(F64)
    _, h, w = view.shape
    ys = (torch.arange(h, dtype=F64, device=view.device) + 0.5) / h
    xs = (torch.arange(w, dtype=F64, device=view.device) + 0.5) / w
    dist = torch.sqrt((xs[None, :] - MID) ** 2 + (ys[:, None] - MID) ** 2)
    amt = torch.clamp(1.0 - dist / LIMIT, max=1.0)
    power = 1.0 - torch.clamp(_bezier4(FALLOFF, amt), min=0.0)
    col = view[:3]
    col2 = col * col * 1.5
    a = amount * power + (radius * power) * 500.0
    c4 = col2 * col2
    c4 = c4 * c4
    wgt = c4 * c4 * col2 * a[None] + 0.4
    stack = blur_stack(torch.cat([col2 * wgt, wgt]))
    strengths, levels = level_table()
    level = _interp(radius * power, strengths, levels).clamp(0.0,
                                                            len(RADII))
    out = stack[0]
    for i in range(len(RADII)):
        t = (level - i).clamp(0.0, 1.0)[None]
        out = out + (stack[i + 1] - out) * t
    return torch.cat([out[:3] / torch.clamp(out[3:], min=1e-6), view[3:4]])
