"""Line-segment splatting — the stand-in for GL line rasterisation.

Mirrors `tendrils_tpu/ops/splat.py`: each segment becomes `samples` points
along it (times `rows` perpendicular offsets for the line width), each
bilinearly splatted with alpha scaled by the segment's major-axis extent,
then resolved order-independently over the target grid:

    T      = prod_i (1 - a_i)                 (total transmittance)
    out_c  = dst_c * T + (sum_i c_i*a_i) / max(sum_i a_i, eps) * (1 - T)

The point splat is K9 (`splat_cuda.splat_accumulate`, the JAX package's
"pallas" backend); on CPU tensors it runs its plain version. The port has
no other backend.
"""

import torch

from . import splat_cuda

_EPS = 1e-6


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
                              width=1.0, samples=4, rows=1):
    """Expand segments into samples and scatter-add them. `values`:
    `f32[C, N]` per-segment payload. Returns the `(num, wsum, logt)`
    partial sums."""
    x, y, a = segment_samples(p0_pix, p1_pix, alpha, samples, rows, width)
    vals = torch.repeat_interleave(values, samples * rows, dim=1)
    return splat_cuda.splat_accumulate(grid_hw, x, y, vals, a)


def splat_segments(dst, p0_pix, p1_pix, values, alpha, *, grid_hw,
                   width=1.0, samples=4, rows=1, premultiplied=False):
    """Accumulate + resolve in one call over `dst: f32[C, H, W]` (blended
    over, not cleared). `p0_pix`/`p1_pix`: `f32[N, 2]` window px;
    `values`: `f32[C, N]`; `alpha`: `f32[N]`."""
    num, wsum, logt = splat_segments_accumulate(
        p0_pix, p1_pix, values, alpha, grid_hw=grid_hw, width=width,
        samples=samples, rows=rows)
    resolve = composite_premultiplied if premultiplied else composite_over
    return resolve(dst, num, wsum, logt)
