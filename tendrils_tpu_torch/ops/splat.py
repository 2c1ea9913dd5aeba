"""Line-segment splatting — the stand-in for GL line rasterisation.

Mirrors `tendrils_tpu/ops/splat.py`: each segment becomes `samples` points
along it (times `rows` perpendicular offsets for the line width), each
bilinearly splatted with alpha scaled by the segment's major-axis extent,
then resolved order-independently over the target grid:

    T      = prod_i (1 - a_i)                 (total transmittance)
    out_c  = dst_c * T + (sum_i c_i*a_i) / max(sum_i a_i, eps) * (1 - T)

Backends of the point splat, as the JAX package's:
  - "kernel" (the default, as the port's `EngineConfig`'s): K9
    (`splat_cuda.splat_accumulate`, the JAX package's "pallas"), int64
    fixed-point sums; on CPU tensors its plain version;
  - "xla": `splat_accumulate_xla`, an f32 `index_add_` scatter, the JAX
    package's portable backend (its `EngineConfig` default); plain
    PyTorch on any device (on a CUDA device its float atomics add in no
    fixed order, so its sums are not bit-reproducible).
"""

import torch

_EPS = 1e-6
BACKENDS = ("xla", "kernel")


def segment_samples(p0_pix, p1_pix, alpha, samples, rows, width):
    """Expand segments `f32[N, 2]` (window px) of source alpha `f32[N]`
    into weighted sample points. `samples`, `rows`: ints; `width`: number
    or 0-d tensor (px). Returns `(x, y, a)` `f32[M]`, M = N*samples*rows,
    sample-major within a segment, rows innermost."""
    d = p1_pix - p0_pix
    length = torch.sqrt(torch.sum(d * d, dim=-1))
    inv_len = 1.0 / torch.clamp(length, min=_EPS)
    perp = torch.stack([-d[:, 1], d[:, 0]], dim=-1) * inv_len[:, None]
    # GL's DDA lights one fragment per MAJOR-axis pixel (GL 2.0 §3.4.2), so
    # the deposit mass scales with the major extent, not the length.
    major = torch.maximum(torch.abs(d[:, 0]), torch.abs(d[:, 1]))
    a_s = alpha * torch.clamp(major, min=1.0) / samples
    ts = (torch.arange(samples, dtype=torch.float32, device=d.device)
          + 0.5) / samples
    pts = p0_pix[:, None, :] + d[:, None, :] * ts[None, :, None]  # [N, S, 2]
    if rows > 1:
        offs = (torch.arange(rows, dtype=torch.float32, device=d.device)
                - (rows - 1) / 2.0)
        offs = offs * (width / rows)
        pts = pts[:, :, None, :] + perp[:, None, None, :] \
            * offs[None, None, :, None]
        a = a_s[:, None, None].expand(pts.shape[:3])
        # Rows beyond the width are masked so narrow lines stay narrow.
        row_live = (torch.abs(offs) * 2.0
                    <= torch.clamp(torch.as_tensor(width), min=1.0)).to(
                        torch.float32)
        a = (a * row_live[None, None, :]).reshape(-1)
    else:
        a = a_s[:, None].expand(pts.shape[:2]).reshape(-1)
    x, y = pts.reshape(-1, 2).T.contiguous()
    return x, y, a


def _bilinear_corners(x, y, h, w):
    """Bilinear splat footprint at window coords (x, y) (pixel centres at
    integer + 0.5): 4 corner indices `i64[4, M]` (clamped into the grid),
    weights `f32[4, M]` and validity `f32[4, M]`."""
    gx = x - 0.5
    gy = y - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    wgt = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy,
                       fx * fy])
    xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1])
    ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1])
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs = torch.clamp(xs, 0, w - 1)
    ys = torch.clamp(ys, 0, h - 1)
    return ys * w + xs, wgt, valid.to(torch.float32)


def splat_accumulate_xla(grid_hw, x, y, values, alpha):
    """Scatter-accumulate weighted samples in f32 (the "xla" backend, JAX
    `splat.splat_accumulate_xla`). `x`, `y`, `alpha`: `f32[M]` (window
    px); `values`: `f32[C, M]`. Returns `(num f32[C, H, W] = sum val*a,
    wsum f32[H, W] = sum a, logt f32[H, W] = sum log(1-a))`."""
    h, w = grid_hw
    idx, wgt, valid = _bilinear_corners(x, y, h, w)
    a4 = (alpha[None, :] * wgt * valid).reshape(-1)
    idxf = idx.reshape(-1)
    wsum = torch.zeros(h * w, dtype=torch.float32, device=x.device)
    wsum.index_add_(0, idxf, a4)
    # Transmittance accumulates as the bilinear-weighted log: a sample of
    # footprint weight w on a pixel contributes (1 - alpha)^w.
    log1a = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-4))
    logt = torch.zeros(h * w, dtype=torch.float32, device=x.device)
    logt.index_add_(0, idxf, (log1a[None, :] * wgt * valid).reshape(-1))
    c = values.shape[0]
    vals4 = (values[:, None, :] * (alpha[None, :] * wgt * valid)[None]
             ).reshape(c, -1)
    num = torch.zeros((c, h * w), dtype=torch.float32, device=x.device)
    num.index_add_(1, idxf, vals4)
    return num.reshape(c, h, w), wsum.reshape(h, w), logt.reshape(h, w)


def composite_over(dst, num, wsum, logt):
    """Resolve accumulated splats over `dst: f32[C, H, W]`
    (order-independent `SRC_ALPHA, ONE_MINUS_SRC_ALPHA`)."""
    t = torch.exp(logt)
    src = num / torch.clamp(wsum, min=_EPS)
    return dst * t + src * (1.0 - t)


def composite_premultiplied(dst, num, wsum, logt):
    """Resolve for premultiplied-alpha targets: dst*T + sum(c*a)."""
    del wsum
    return dst * torch.exp(logt) + num


def splat_segments_accumulate(p0_pix, p1_pix, values, alpha, *, grid_hw,
                              width=1.0, samples=4, rows=1, backend="kernel"):
    """Expand segments into samples and scatter-add them on `backend`
    ("xla" or "kernel", K9). `values`: `f32[C, N]` per-segment payload.
    Returns the `(num, wsum, logt)` partial sums."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown splat backend: {backend}")
    x, y, a = segment_samples(p0_pix, p1_pix, alpha, samples, rows, width)
    vals = torch.repeat_interleave(values, samples * rows, dim=1)
    if backend == "xla":
        return splat_accumulate_xla(grid_hw, x, y, vals, a)
    from . import splat_cuda
    return splat_cuda.splat_accumulate(grid_hw, x, y, vals, a)


def splat_segments(dst, p0_pix, p1_pix, values, alpha, *, grid_hw,
                   width=1.0, samples=4, rows=1, backend="kernel",
                   premultiplied=False):
    """Accumulate + resolve in one call over `dst: f32[C, H, W]` (blended
    over, not cleared). `p0_pix`/`p1_pix`: `f32[N, 2]` window px;
    `values`: `f32[C, N]`; `alpha`: `f32[N]`."""
    num, wsum, logt = splat_segments_accumulate(
        p0_pix, p1_pix, values, alpha, grid_hw=grid_hw, width=width,
        samples=samples, rows=rows, backend=backend)
    resolve = composite_premultiplied if premultiplied else composite_over
    return resolve(dst, num, wsum, logt)
