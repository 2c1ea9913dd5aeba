"""The generic point splat (K9), on a hand-written CUDA kernel.

The port of `tendrils_tpu/ops/splat_pallas.py`: `splat_accumulate` adds M
bilinear points with C payload channels into `(num f32[C, H, W], wsum
f32[H, W], logt f32[H, W])` (csrc/splat_points.cu, float atomics into an
unpadded accumulator). `splat_accumulate_plain` is its plain version, the
port of `ops/splat.splat_accumulate_xla` with `index_add_`; the wrapper
takes it for CPU tensors only. The TPU kernel's tile sort, padded margin
and "moved => alpha 0" rule exist for its region DMAs and compute the same
function as the per-corner validity test both versions here use.
"""

import torch

from . import cuda_lib

_F32 = torch.float32


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
    return ys * w + xs, wgt, valid.to(_F32)


def splat_accumulate(grid_hw, x, y, values, alpha):
    """K9: scatter-accumulate weighted samples. `x`, `y`, `alpha`:
    `f32[M]` (window px); `values`: `f32[C, M]`. Returns `(num f32[C, H,
    W] = sum val*a, wsum f32[H, W] = sum a, logt f32[H, W] = sum
    log(1-a))`, views of one fresh accumulator."""
    if cuda_lib.on_cpu(x, y, values, alpha):
        return splat_accumulate_plain(grid_hw, x, y, values, alpha)
    h, w = grid_hw
    c, m = values.shape
    cuda_lib.check(x, "x", _F32, (m,))
    cuda_lib.check(y, "y", _F32, (m,))
    cuda_lib.check(values, "values", _F32, (c, m))
    cuda_lib.check(alpha, "alpha", _F32, (m,))
    accum = torch.zeros((c + 2, h, w), dtype=_F32, device=x.device)
    cuda_lib.launch("tt_splat_points", "splat_points", x, y, values, alpha,
                    c, m, h, w, accum)
    return accum[:c], accum[c], accum[c + 1]


def splat_accumulate_plain(grid_hw, x, y, values, alpha):
    """Plain version of K9 (`splat.splat_accumulate_xla`)."""
    cuda_lib.plain_calls["splat_points"] += 1
    h, w = grid_hw
    idx, wgt, valid = _bilinear_corners(x, y, h, w)
    a4 = (alpha[None, :] * wgt * valid).reshape(-1)
    idxf = idx.reshape(-1)
    wsum = torch.zeros(h * w, dtype=_F32, device=x.device)
    wsum.index_add_(0, idxf, a4)
    # Transmittance accumulates as the bilinear-weighted log.
    log1a = torch.log1p(-torch.clamp(alpha, max=1.0 - 1e-4))
    logt = torch.zeros(h * w, dtype=_F32, device=x.device)
    logt.index_add_(0, idxf, (log1a[None, :] * wgt * valid).reshape(-1))
    c = values.shape[0]
    vals4 = (values[:, None, :] * (alpha[None, :] * wgt * valid)[None]
             ).reshape(c, -1)
    num = torch.zeros((c, h * w), dtype=_F32, device=x.device)
    num.index_add_(1, idxf, vals4)
    return num.reshape(c, h, w), wsum.reshape(h, w), logt.reshape(h, w)
